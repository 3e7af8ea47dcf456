"""Gluon ``Block``, ``HybridBlock`` and ``SymbolBlock`` (port of
``mxnet_tpu/gluon/block.py``; reference python/mxnet/gluon/block.py:
Block :122, HybridBlock :375, SymbolBlock :598; CachedOp
src/imperative/cached_op.cc).

A block not hybridized runs ``hybrid_forward`` with ``F = mx.nd``, op by
op, recorded by :mod:`mxnet_tpu_torch.autograd` like any imperative code.
``hybridize()`` traces ``hybrid_forward`` once with Symbols (``F =
mx.sym``) and runs the traced graph as one port
:class:`~mxnet_tpu_torch.executor.GraphProgram`, as the JAX package's
``_build_cache``/``_call_cached_op`` do (``mxnet_tpu/gluon/block.py:
305-348``): under :func:`autograd.record` the program's evaluation is
recorded by torch (the parameters enter as their autograd leaves), so
``backward`` differentiates through it; in train mode every aux array
(BatchNorm's moving statistics) is rebound to the op's new statistic once
per forward (C14); random nodes draw from the port's generator of the
device, and a recording evaluation takes the remat policy of
``mx.set_backward_mirror`` / ``MXNET_TPU_REMAT_POLICY``.

Names: ``_BlockScope`` counts children per class name inside a parent's
scope, and a top-level block takes its name from the Symbol
``NameManager``, as the JAX package does, so the parameter names (and the
``.params`` keys and ``convert`` keys) are the JAX package's.
"""
from __future__ import annotations

import copy
import math
import re
import threading
from collections import OrderedDict

import torch

from .. import autograd as _ag
from .. import rng as _rng
from ..ndarray.ndarray import NDArray, _owned
from ..symbol.symbol import Group, Symbol, Variable
from .parameter import DeferredInitializationError, Parameter, ParameterDict

__all__ = ["Block", "HybridBlock", "SymbolBlock"]


class _BlockScope:
    """A block's name and parameter scope (reference _BlockScope)."""

    _current = threading.local()

    def __init__(self, block):
        self._block = block
        self._counter = {}
        self._old_scope = None
        self._name_scope = None

    @staticmethod
    def create(prefix, params, hint):
        """``(prefix, params)`` for a new block with class hint ``hint``
        in the current scope."""
        current = getattr(_BlockScope._current, "value", None)
        if current is None:
            if prefix is None:
                from ..name import NameManager
                prefix = NameManager.current().get(None, hint) + "_"
            if params is None:
                params = ParameterDict(prefix)
            else:
                params = ParameterDict(params.prefix, params)
            return prefix, params
        if prefix is None:
            count = current._counter.get(hint, 0)
            prefix = "%s%d_" % (hint, count)
            current._counter[hint] = count + 1
        if params is None:
            parent = current._block.params
            params = ParameterDict(parent.prefix + prefix, parent._shared)
        else:
            params = ParameterDict(params.prefix, params)
        return current._block.prefix + prefix, params

    def __enter__(self):
        if self._block._empty_prefix:
            return self
        self._old_scope = getattr(_BlockScope._current, "value", None)
        _BlockScope._current.value = self
        from ..name import Prefix
        self._name_scope = Prefix(self._block.prefix)
        self._name_scope.__enter__()
        return self

    def __exit__(self, ptype, value, trace):
        if self._block._empty_prefix:
            return
        self._name_scope.__exit__(ptype, value, trace)
        self._name_scope = None
        _BlockScope._current.value = self._old_scope


def _flatten(args, inout_str):
    if isinstance(args, NDArray):
        return [args], int(0)
    if isinstance(args, Symbol):
        length = len(args.list_outputs())
        return [args], int(length if length > 1 else 0)
    assert isinstance(args, (list, tuple)), \
        "HybridBlock %s must be (nested) list of Symbol or NDArray, " \
        "but got %s of type %s" % (inout_str, str(args), str(type(args)))
    flat, fmts = [], []
    for i in args:
        arg, fmt = _flatten(i, inout_str)
        flat.extend(arg)
        fmts.append(fmt)
    return flat, fmts


def _regroup(args, fmt):
    if isinstance(fmt, int):
        if fmt == 0:
            return args[0], args[1:]
        return args[:fmt], args[fmt:]
    assert isinstance(args, (list, tuple)), \
        "output must be (nested) list of Symbol or NDArray"
    ret = []
    for i in fmt:
        res, args = _regroup(args, i)
        ret.append(res)
    return ret, args


def _indent(s_, num_spaces):
    lines = s_.split("\n")
    first = lines.pop(0)
    return "\n".join([first] + [(num_spaces * " ") + line
                                for line in lines])


class Block:
    """The base of every layer and model: a name scope, registered
    children and parameters (reference block.py:122)."""

    def __init__(self, prefix=None, params=None):
        self._empty_prefix = prefix == ""
        self._prefix, self._params = _BlockScope.create(prefix, params,
                                                        self._alias())
        self._name = self._prefix[:-1] if self._prefix.endswith("_") \
            else self._prefix
        self._scope = _BlockScope(self)
        self._children = OrderedDict()
        self._reg_params = {}

    def __repr__(self):
        s = "{name}(\n{modstr}\n)"
        modstr = "\n".join("  ({key}): {block}".format(
            key=key, block=_indent(str(block), 2))
            for key, block in self._children.items())
        return s.format(name=self.__class__.__name__, modstr=modstr)

    def __setattr__(self, name, value):
        if hasattr(self, name):
            existing = getattr(self, name)
            if isinstance(existing, (Parameter, Block)) and \
                    not isinstance(value, type(existing)):
                raise TypeError("Changing attribute type for {name} from "
                                "{type1} to {type2} is not allowed.".format(
                                    name=name, type1=type(existing),
                                    type2=type(value)))
        if isinstance(value, Block):
            self.register_child(value, name)
        elif isinstance(value, Parameter):
            assert name not in self._reg_params or \
                self._reg_params[name] is value, \
                "Overriding Parameter attribute %s is not allowed." % name
            self._reg_params[name] = value
        super().__setattr__(name, value)

    def _alias(self):
        return self.__class__.__name__.lower()

    @property
    def prefix(self):
        return self._prefix

    @property
    def name(self):
        return self._name

    def name_scope(self):
        return self._scope

    @property
    def params(self):
        return self._params

    def collect_params(self, select=None) -> ParameterDict:
        """This block's and its children's parameters (those whose name
        matches the regex ``select``)."""
        ret = ParameterDict(self._params.prefix)
        if not select:
            ret.update(self.params)
        else:
            pattern = re.compile(select)
            ret.update({name: value for name, value in self.params.items()
                        if pattern.match(name)})
        for cld in self._children.values():
            ret.update(cld.collect_params(select=select))
        return ret

    def save_params(self, filename):
        self.collect_params().save(filename, strip_prefix=self.prefix)

    def load_params(self, filename, ctx=None, allow_missing=False,
                    ignore_extra=False):
        self.collect_params().load(filename, ctx, allow_missing,
                                   ignore_extra, self.prefix)

    save_parameters = save_params
    load_parameters = load_params

    def register_child(self, block, name=None):
        if name is None:
            name = str(len(self._children))
        self._children[name] = block

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False):
        """Initialize every parameter on ``ctx`` (default: the current
        context, the card) with ``init`` (default ``Uniform()``)."""
        from ..initializer import Uniform
        self.collect_params().initialize(init or Uniform(), ctx, verbose,
                                         force_reinit)

    def hybridize(self, active=True, **kwargs):
        for cld in self._children.values():
            cld.hybridize(active, **kwargs)

    def cast(self, dtype):
        for child in self._children.values():
            child.cast(dtype)
        for _, param in self.params.items():
            param.cast(dtype)

    def __call__(self, *args):
        return self.forward(*args)

    def forward(self, *args):
        raise NotImplementedError

    def apply(self, fn):
        """``fn`` on every child (recursively), then on this block."""
        for cld in self._children.values():
            cld.apply(fn)
        fn(self)
        return self

    def summary(self, *inputs):
        """Run the block on ``inputs``, print each direct child's output
        shape and the parameter count, and return the output."""
        shapes = []

        def hook(block):
            fwd = block.forward

            def wrapped(*a):
                out = fwd(*a)
                shapes.append((block.name, type(block).__name__,
                               getattr(out, "shape", None)))
                return out
            return wrapped

        saved = {}
        for key, child in self._children.items():
            saved[key] = child.forward
            object.__setattr__(child, "forward", hook(child))
        try:
            out = self(*inputs)
        finally:
            for key, child in self._children.items():
                object.__delattr__(child, "forward")
        total = sum(math.prod(p.shape)
                    for p in self.collect_params().values()
                    if p.shape is not None)
        print("%-40s %-24s %s" % ("Layer", "Type", "Output shape"))
        for name, kind, shape in shapes:
            print("%-40s %-24s %s" % (name, kind, shape))
        print("Parameters: %d" % total)
        return out


class HybridBlock(Block):
    """A block that can run as one traced graph (reference block.py:375);
    ``hybridize()`` switches it to that."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._active = False
        self._cached_graph = ()
        self._cached_program = None
        self._flags = {}

    def __setattr__(self, name, value):
        super().__setattr__(name, value)
        if isinstance(value, HybridBlock):
            self._clear_cached_op()

    def _clear_cached_op(self):
        self._cached_graph = ()
        self._cached_program = None

    def register_child(self, block, name=None):
        if not isinstance(block, HybridBlock):
            raise ValueError(
                "Children of HybridBlock must also be HybridBlock, but %s "
                "has type %s." % (str(block), str(type(block))))
        super().register_child(block, name)
        self._clear_cached_op()

    def hybridize(self, active=True, **kwargs):
        self._active = active
        self._flags = kwargs
        self._clear_cached_op()
        super().hybridize(active, **kwargs)

    def cast(self, dtype):
        self._clear_cached_op()
        super().cast(dtype)

    def _get_graph(self, *args):
        if not self._cached_graph:
            flat_args, self._in_format = _flatten(args, "input")
            inputs = [Variable("data%d" % i) if len(flat_args) > 1
                      else Variable("data") for i in range(len(flat_args))]
            grouped, _ = _regroup(inputs, self._in_format)
            params = {i: j.var() for i, j in self._reg_params.items()}
            with self.name_scope():
                if isinstance(grouped, (list, tuple)):
                    out = self.hybrid_forward(_SymModule, *grouped, **params)
                else:
                    out = self.hybrid_forward(_SymModule, grouped, **params)
            flat_out, self._out_format = _flatten(out, "output")
            self._cached_graph = inputs, Group(flat_out)
        return self._cached_graph

    def infer_shape(self, *args):
        """Fill in the parameters' unknown shapes from the inputs' through
        the port's shape inference."""
        inputs, out = self._get_graph(*args)
        flat_args, _ = _flatten(args, "input")
        shapes = {i.name: a.shape for i, a in zip(inputs, flat_args)}
        from ..executor import infer_shapes
        arg_shapes, _, aux_shapes = infer_shapes(out, shapes)
        sdict = dict(zip(out.list_arguments(), arg_shapes))
        sdict.update(zip(out.list_auxiliary_states(), aux_shapes))
        for _, param in self.collect_params().items():
            if sdict.get(param.name) is not None:
                param.shape = tuple(sdict[param.name])

    def _build_cache(self, *args):
        inputs, out = self._get_graph(*args)
        from ..executor import GraphProgram
        self._cached_program = GraphProgram(out)
        self._cached_input_names = [i.name for i in inputs]

    def _call_cached_op(self, *args):
        """Evaluate the traced graph on the inputs and the parameters:
        recorded under :func:`autograd.record`, the aux arrays rebound
        to their new values in train mode."""
        if self._cached_program is None:
            self._build_cache(*args)
        prog = self._cached_program
        flat_args, _ = _flatten(args, "input")
        arg_map = dict(zip(self._cached_input_names, flat_args))
        params = {p.name: p for p in self.collect_params().values()}
        ctx = getattr(getattr(flat_args[0], "_handle", None), "device",
                      None) if flat_args else None
        arg_nds = [arg_map[n] if n in arg_map else params[n].data(ctx)
                   for n in prog.arg_names]
        aux_nds = [params[n].data(ctx) for n in prog.aux_names]
        recording, train = _ag.is_recording(), _ag.is_training()
        if recording:
            tensors = [_ag._leaf_of(a) for a in arg_nds]
            for a in arg_nds:
                a._recorded = True
        else:
            tensors = [a._handle for a in arg_nds]
        aux = [a._handle for a in aux_nds]
        gen = _rng.next_generator(tensors[0].device) if prog.num_rng \
            else None
        from ..executor import backward_mirror_policy
        with torch.set_grad_enabled(recording):
            outs, new_aux = prog.evaluate(
                tensors, aux, train=train, generator=gen,
                remat=backward_mirror_policy() if recording else "none")
        if train:
            for nd_, na in zip(aux_nds, new_aux):
                nd_._handle = na.detach()
        out_nds = [NDArray(_owned(o, tensors)) for o in outs]
        ret, _ = _regroup(out_nds, self._out_format)
        return ret

    def _deferred_forward(self, call, x, *args):
        try:
            return call(x, *args)
        except DeferredInitializationError:
            self._deferred_infer_shape(x, *args)
            for _, p in self.collect_params().items():
                p._finish_deferred_init()
            return call(x, *args)

    def forward(self, x, *args):
        if isinstance(x, NDArray):
            if self._active:
                return self._deferred_forward(self._call_cached_op, x, *args)
            from .. import ndarray as ndm

            def eager(x, *args):
                params = {i: j.data(x._handle.device)
                          for i, j in self._reg_params.items()}
                return self.hybrid_forward(ndm, x, *args, **params)
            return self._deferred_forward(eager, x, *args)
        assert isinstance(x, Symbol), \
            "HybridBlock requires the first argument to forward be either " \
            "Symbol or NDArray, but got %s" % type(x)
        params = {i: j.var() for i, j in self._reg_params.items()}
        with self.name_scope():
            from .. import symbol as symm
            return self.hybrid_forward(symm, x, *args, **params)

    def _deferred_infer_shape(self, *args):
        try:
            self.infer_shape(*args)
        except Exception as e:
            raise ValueError("Deferred initialization failed because shape "
                             "cannot be inferred. %s" % e) from e

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError

    def export(self, path, epoch=0):
        """Write ``path-symbol.json`` and ``path-%04d.params`` (``arg:`` and
        ``aux:`` keys), which the JAX package's ``SymbolBlock`` and
        ``Module`` load."""
        if not self._cached_graph:
            raise RuntimeError(
                "Please first call block.hybridize() and then run forward "
                "with this block at least once before calling export.")
        sym = self._cached_graph[1]
        sym.save("%s-symbol.json" % path)
        aux_names = set(sym.list_auxiliary_states())
        arg_dict = {}
        for name, param in self.collect_params().items():
            kind = "aux:" if name in aux_names else "arg:"
            arg_dict[kind + name] = param.data()
        from ..ndarray.ndarray import save as nd_save
        nd_save("%s-%04d.params" % (path, epoch), arg_dict)


class _SymModuleType:
    """``F`` while tracing ``hybrid_forward``: the port's ``mx.sym``."""

    def __getattr__(self, name):
        from .. import symbol as symm
        return getattr(symm, name)


_SymModule = _SymModuleType()


class SymbolBlock(HybridBlock):
    """A Symbol graph as a block (reference block.py:598): its arguments
    other than ``inputs`` become parameters (initialized, or loaded, by
    name), and it always runs as one graph."""

    def __init__(self, outputs, inputs, params=None):
        super().__init__(prefix=None, params=params)
        self._prefix = ""
        self._params = ParameterDict("", params)
        if isinstance(inputs, Symbol) and len(inputs.list_outputs()) == 1:
            inputs = [inputs]
        if isinstance(outputs, (list, tuple)) and len(outputs) == 1 and \
                isinstance(outputs[0], (list, tuple)):
            outputs = outputs[0]
        if isinstance(outputs, (list, tuple)):
            outputs = Group(outputs)
        syms, self._in_format = _flatten(inputs, "input")
        out, self._out_format = _flatten(outputs, "output")
        out = Group(out) if isinstance(out, list) else out
        input_names = set(i.name for i in syms)
        for name in out.list_arguments():
            if name not in input_names:
                self.params.get(name, allow_deferred_init=True)
        for name in out.list_auxiliary_states():
            self.params.get(name, allow_deferred_init=True,
                            grad_req="null")
        self._cached_graph = syms, out
        prefix = _common_prefix(list(self._params.keys()))
        self._reg_params = {k[len(prefix):]: v
                            for k, v in self._params.items()}

    def forward(self, x, *args):
        if isinstance(x, NDArray):
            return self._deferred_forward(self._call_cached_op, x, *args)
        assert isinstance(x, Symbol)
        return copy.copy(self._cached_graph[1])

    def _clear_cached_op(self):
        # the graph is the block itself: only the program is rebuilt
        self._cached_program = None

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError


def _common_prefix(names):
    if not names:
        return ""
    prefix = names[0]
    for name in names:
        i = 0
        while i < len(prefix) and i < len(name) and prefix[i] == name[i]:
            i += 1
        prefix = prefix[:i]
    return prefix
