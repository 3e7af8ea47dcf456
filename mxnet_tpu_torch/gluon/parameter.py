"""Gluon ``Parameter``, ``Constant`` and ``ParameterDict`` (port of
``mxnet_tpu/gluon/parameter.py``; reference python/mxnet/gluon/
parameter.py).

A parameter holds one NDArray per context it was initialized on (the
reference's per-device copies; ``initialize(ctx=[...])``), with
``list_data``/``list_grad``/``list_ctx`` in that order.  Each copy is a
marked variable of :mod:`mxnet_tpu_torch.autograd` with its own gradient
NDArray: a recording op reads it as an autograd leaf, and
``autograd.backward`` writes its gradient by ``grad_req``.  ``data(ctx)``
is the copy on ``ctx`` (a Block's forward asks for the copy on its
input's context, so each slice of ``split_and_load`` meets its own
copy; where two contexts name one torch device, the first copy serves
both); a ``Trainer`` sums the copies' gradients and updates every copy
alike.  Initialization fills the array on the host with the port's
initializers (the JAX package's draws) and copies it to each context
given to ``initialize`` (default: the current context, the card).  A
parameter of unknown shape defers its initialization to the first
forward (``DeferredInitializationError`` until then).
``ParameterDict.save``/``load`` write and read the reference's ``.params``
bytes (:mod:`mxnet_tpu_torch.ndarray.serialization`), so either package
loads what the other saved.
"""
from __future__ import annotations

import warnings
from collections import OrderedDict
from typing import Optional

import numpy as np
import torch

from .. import autograd as _ag
from ..base import MXNetError
from ..context import cpu, current_context
from ..initializer import Initializer, InitDesc, Uniform, \
    create as init_create
from ..ndarray.ndarray import NDArray, array as nd_array, zeros as nd_zeros
from ..symbol.symbol import Variable

__all__ = ["DeferredInitializationError", "Parameter", "Constant",
           "ParameterDict"]


class DeferredInitializationError(MXNetError):
    """A parameter's data was asked for before its deferred
    initialization (its shape is known only at the first forward)."""


def _ctx_list(ctx):
    return list(ctx) if isinstance(ctx, (list, tuple)) else [ctx]


class Parameter:
    """A weight of a Block: its name, shape, dtype, ``grad_req``,
    ``lr_mult``/``wd_mult`` and initializer, then its data and gradient
    NDArrays."""

    def __init__(self, name, grad_req="write", shape=None, dtype=np.float32,
                 lr_mult=1.0, wd_mult=1.0, init=None,
                 allow_deferred_init=False, differentiable=True,
                 stype="default", grad_stype="default"):
        self._var = None
        self._data_list: list = []
        self._grad_list: list = []
        self._ctx_list: list = []
        self._deferred_init = ()
        self._differentiable = differentiable
        self._allow_deferred_init = allow_deferred_init
        self._grad_req = None
        self.name = name
        if isinstance(shape, int):
            shape = (shape,)
        self.shape = tuple(shape) if shape is not None else None
        self.dtype = dtype
        self.lr_mult = lr_mult
        self.wd_mult = wd_mult
        self.grad_req = grad_req
        self.init = init
        self._stype = stype
        self._grad_stype = grad_stype

    def __repr__(self):
        return "Parameter %s (shape=%s, dtype=%s)" % (
            self.name, self.shape, self.dtype)

    @property
    def _data(self) -> Optional[NDArray]:
        """The first copy (None before initialization)."""
        return self._data_list[0] if self._data_list else None

    @property
    def _grad(self) -> Optional[NDArray]:
        return self._grad_list[0] if self._grad_list else None

    def _index(self, ctx):
        """The copy on ``ctx`` (a Context, else anything with a torch
        device): equal contexts first, then the same torch device, else
        the current context's copy, else the first."""
        if len(self._data_list) <= 1:
            return 0
        if ctx is None:
            from ..context import Context
            ctx = getattr(Context._default_ctx, "value", None)
            if ctx is None:
                return 0
        for i, c in enumerate(self._ctx_list):
            if c == ctx:
                return i
        from ..context import as_torch_device
        dev = as_torch_device(ctx)
        for i, d in enumerate(self._data_list):
            if d._handle.device == dev:
                return i
        return 0

    @property
    def grad_req(self):
        return self._grad_req

    @grad_req.setter
    def grad_req(self, req):
        assert req in ("write", "add", "null"), req
        if not self._differentiable:
            req = "null"
        if self._grad_req == req:
            return
        self._grad_req = req
        if req == "null":
            self._grad_list = []
            if self._data_list:
                _ag.mark_variables(self._data_list,
                                   [None] * len(self._data_list), "null")
        elif self._data_list:
            self._init_grad()

    def _check_and_get(self, arr, ctx):
        if arr is not None:
            return arr
        if self._deferred_init:
            raise DeferredInitializationError(
                "Parameter '%s' has not been initialized yet because "
                "initialization was deferred. Actual initialization happens "
                "during the first forward pass." % self.name)
        raise RuntimeError(
            "Parameter '%s' has not been initialized. You should initialize "
            "parameters with Block.collect_params().initialize()" % self.name)

    def _finish_deferred_init(self):
        if not self._deferred_init:
            return
        init, ctx, default_init, data = self._deferred_init
        self._deferred_init = ()
        assert self.shape is not None and all(s > 0 for s in self.shape), \
            "Cannot initialize Parameter '%s' because it has invalid " \
            "shape: %s." % (self.name, str(self.shape))
        if data is None:
            host = nd_zeros(self.shape, dtype=self.dtype, ctx=cpu())
            initializer = init or self.init or default_init or Uniform()
            if isinstance(initializer, str):
                initializer = init_create(initializer)
            initializer(InitDesc(self.name), host)
            data = host
        self._init_impl(data, ctx)

    def _init_impl(self, data, ctx):
        """``data`` on the first context of ``ctx``, and a copy of it on
        each of the others."""
        from ..context import as_torch_device
        self._ctx_list = _ctx_list(ctx)
        first = data.as_in_context(self._ctx_list[0])
        self._data_list = [first] + [
            NDArray(first._handle.to(as_torch_device(c), copy=True))
            for c in self._ctx_list[1:]]
        self._grad_list = []
        if self._grad_req != "null":
            self._init_grad()

    def _init_grad(self):
        self._grad_list = [NDArray(torch.zeros_like(d._handle.detach()))
                           for d in self._data_list]
        _ag.mark_variables(self._data_list, self._grad_list,
                           grad_reqs=self._grad_req)

    def initialize(self, init=None, ctx=None, default_init=None,
                   force_reinit=False):
        """Initialize the data on ``ctx`` (default: the current context)
        with ``init``, else the parameter's own initializer, else
        ``default_init``; a parameter of unknown shape waits for the
        first forward."""
        if default_init is None:
            default_init = Uniform()
        if self._data is not None and not force_reinit:
            warnings.warn("Parameter '%s' is already initialized, ignoring. "
                          "Set force_reinit=True to re-initialize."
                          % self.name, stacklevel=2)
            return
        ctx = ctx if ctx is not None else current_context()
        if any(s <= 0 for s in (self.shape or (0,))):
            if self._allow_deferred_init:
                self._deferred_init = (init, ctx, default_init, None)
                return
            raise ValueError("Cannot initialize Parameter '%s' because it "
                             "has invalid shape: %s." % (self.name,
                                                         self.shape))
        self._deferred_init = (init, ctx, default_init, None)
        self._finish_deferred_init()

    def reset_ctx(self, ctx):
        """Re-place the data (and gradient) on ``ctx`` (one context or
        a list), from the first copy."""
        if self._data_list:
            self._init_impl(self._data_list[0], ctx)
        elif self._deferred_init:
            init, _, default_init, data = self._deferred_init
            self._deferred_init = (init, ctx, default_init, data)

    def _load_init(self, data, ctx=None):
        """Take ``data`` (an NDArray or numpy) as the value, initializing
        the parameter if it is not yet (reference ``_load_init``)."""
        if self.shape is not None and len(self.shape) == len(data.shape):
            merged = tuple(s if s else d
                           for s, d in zip(self.shape, data.shape))
            assert merged == tuple(data.shape), \
                "Failed loading Parameter '%s' from saved params: shape " \
                "incompatible expected %s vs saved %s" % (
                    self.name, str(self.shape), str(data.shape))
        self.shape = tuple(data.shape)
        if self._data is None:
            if ctx is None:
                ctx = self._deferred_init[1] if self._deferred_init \
                    else current_context()
            self._deferred_init = ()
            self._init_impl(nd_array(data, ctx=_ctx_list(ctx)[0],
                                     dtype=self.dtype), ctx)
        else:
            self.set_data(data)

    def set_data(self, data):
        """Write ``data`` (an NDArray or numpy of the parameter's shape)
        into the parameter's array."""
        if self._data is None:
            assert self._deferred_init, \
                "Parameter '%s' has not been initialized" % self.name
            self.shape = tuple(data.shape)
            init, ctx, default_init, _ = self._deferred_init
            self._deferred_init = (init, ctx, default_init,
                                   nd_array(data, ctx=_ctx_list(ctx)[0],
                                            dtype=self.dtype))
            self._finish_deferred_init()
            return
        if self.shape is not None and tuple(self.shape) != tuple(data.shape):
            raise AssertionError(
                "Shape mismatch for Parameter %s: %s vs %s"
                % (self.name, self.shape, data.shape))
        src = data._handle if isinstance(data, NDArray) else \
            torch.from_numpy(np.ascontiguousarray(np.asarray(data)))
        for d in self._data_list:
            d._write(src.to(d._handle.device))

    def data(self, ctx=None) -> NDArray:
        """The copy on ``ctx`` (None: the current context's, else the
        first)."""
        self._check_and_get(self._data, ctx)
        return self._data_list[self._index(ctx)]

    def list_data(self):
        self._check_and_get(self._data, None)
        return list(self._data_list)

    def grad(self, ctx=None) -> NDArray:
        if self._data is not None and self._grad is None:
            raise RuntimeError(
                "Cannot get gradient array for Parameter '%s' because "
                "grad_req='null'" % self.name)
        self._check_and_get(self._grad, ctx)
        return self._grad_list[self._index(ctx)]

    def list_grad(self):
        self.grad()
        return list(self._grad_list)

    def list_ctx(self):
        if self._data is None:
            if self._deferred_init:
                return _ctx_list(self._deferred_init[1])
            raise RuntimeError("Parameter '%s' has not been initialized"
                               % self.name)
        return list(self._ctx_list)

    def zero_grad(self):
        for g in self._grad_list:
            g[:] = 0

    def var(self):
        """This parameter as a Symbol variable (shape, dtype and the
        multipliers in its attrs)."""
        if self._var is None:
            self._var = Variable(self.name, shape=self.shape,
                                 dtype=self.dtype, lr_mult=self.lr_mult,
                                 wd_mult=self.wd_mult)
        return self._var

    def cast(self, dtype):
        """Cast the data and gradient to ``dtype`` (the data stays a
        marked variable)."""
        self.dtype = dtype
        if self._data_list:
            self._data_list = [d.astype(dtype) for d in self._data_list]
            if self._grad_req != "null":
                self._init_grad()


class Constant(Parameter):
    """A parameter that is not differentiated, holding ``value``."""

    def __init__(self, name, value):
        if not isinstance(value, NDArray):
            value = nd_array(np.asarray(value, dtype=np.float32), ctx=cpu())
        self.value = value

        class Init(Initializer):
            def __call__(self, desc, arr, generator=None):
                arr = getattr(arr, "_handle", arr)
                arr.copy_(value._handle)

        super().__init__(name, grad_req="null", shape=value.shape,
                         dtype=value.dtype, init=Init(),
                         differentiable=False)


class ParameterDict:
    """Parameters by name, under a prefix; ``shared`` lends its
    parameters to ``get``."""

    def __init__(self, prefix="", shared=None):
        self._prefix = prefix
        self._params = OrderedDict()
        self._shared = shared

    def __repr__(self):
        return "ParameterDict '%s' (\n%s\n)" % (
            self._prefix, "\n".join(str(v) for v in self.values()))

    def __getitem__(self, key):
        return self._params[key]

    def __iter__(self):
        return iter(self._params)

    def __len__(self):
        return len(self._params)

    def items(self):
        return self._params.items()

    def keys(self):
        return self._params.keys()

    def values(self):
        return self._params.values()

    @property
    def prefix(self):
        return self._prefix

    def _get_impl(self, name):
        if name in self._params:
            return self._params[name]
        if self._shared is not None and name in self._shared._params:
            self._params[name] = self._shared._params[name]
            return self._params[name]
        return None

    def get(self, name, **kwargs) -> Parameter:
        """The parameter ``prefix + name``, made with ``kwargs`` if it is
        new; an existing one takes the given attributes (an unknown (0)
        dimension of its shape is filled in)."""
        name = self._prefix + name
        param = self._get_impl(name)
        if param is None:
            param = Parameter(name, **kwargs)
            self._params[name] = param
            return param
        for k, v in kwargs.items():
            existing = getattr(param, k, None)
            if k == "shape" and v is not None and existing is not None:
                v = tuple(v)
                if existing != v:
                    matched = tuple(a if a else b for a, b in
                                    zip(existing, v)) \
                        if len(existing) == len(v) else None
                    if matched is None or 0 in matched:
                        raise AssertionError(
                            "Cannot retrieve Parameter %s because shapes "
                            "mismatch: %s vs %s" % (name, existing, v))
                    param.shape = matched
                continue
            setattr(param, k, v)
        return param

    def get_constant(self, name, value=None):
        name = self._prefix + name
        param = self._get_impl(name)
        if param is None:
            if value is None:
                raise KeyError("No constant named '%s'." % name)
            param = Constant(name, value)
            self._params[name] = param
        return param

    def update(self, other):
        for k, v in other.items():
            if k in self._params and self._params[k] is not v:
                raise ValueError("Cannot update self with other because they "
                                 "have different Parameters with the same "
                                 "name '%s'" % k)
            self._params[k] = v

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False):
        if init is None:
            init = Uniform()
        for _, v in self.items():
            v.initialize(None, ctx, init, force_reinit=force_reinit)

    def zero_grad(self):
        for v in self.values():
            v.zero_grad()

    def reset_ctx(self, ctx):
        for v in self.values():
            v.reset_ctx(ctx)

    def setattr(self, name, value):
        for v in self.values():
            setattr(v, name, value)

    def save(self, filename, strip_prefix=""):
        """Write every parameter's data by name (less ``strip_prefix``) in
        the reference's ``.params`` format."""
        from ..ndarray.ndarray import save as nd_save
        arg_dict = {}
        for param in self.values():
            if not param.name.startswith(strip_prefix):
                raise ValueError(
                    "Prefix '%s' is to be stripped before saving, but "
                    "Parameter's name '%s' does not start with it"
                    % (strip_prefix, param.name))
            arg_dict[param.name[len(strip_prefix):]] = param.list_data()[0]
        nd_save(filename, arg_dict)

    def load(self, filename, ctx=None, allow_missing=False,
             ignore_extra=False, restore_prefix=""):
        """Read a ``.params`` file (either package's; ``arg:``/``aux:``
        prefixes of an exported file are dropped) into the parameters."""
        from ..ndarray.ndarray import load as nd_load
        arg_dict = nd_load(filename, ctx=cpu())
        arg_dict = {restore_prefix + k.split(":", 1)[-1]: v
                    for k, v in arg_dict.items()}
        if not allow_missing:
            for name in self.keys():
                assert name in arg_dict, \
                    "Parameter '%s' is missing in file '%s'" % (
                        name[len(restore_prefix):], filename)
        for name in arg_dict:
            if name not in self._params:
                assert ignore_extra, \
                    "Parameter '%s' loaded from file '%s' is not present " \
                    "in ParameterDict" % (name[len(restore_prefix):],
                                          filename)
                continue
            self[name]._load_init(arg_dict[name], ctx)
