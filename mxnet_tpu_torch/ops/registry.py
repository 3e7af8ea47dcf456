"""Operator registry (port of ``mxnet_tpu/ops/registry.py``, the analog of
the reference's NNVM op registry).

An op is a function ``fn(attrs, *tensors) -> tensor | tuple`` on torch
tensors.  There is no per-op gradient: autograd runs over the same
function, and an op whose backward is not the derivative of its forward
(a loss head, a kernel with its own backward) wraps that part in a
``torch.autograd.Function``.  PyTorch runs eagerly, so there is no jit
cache keyed on the attrs.  Op schemas are the typed ``params`` dict
(:class:`~mxnet_tpu_torch.base.Param`), parsed identically from Python
values and from Symbol attr strings.

Stateful concerns are declared, as in the JAX package:

* ``needs_rng`` -- the op receives a ``torch.Generator`` for its output's
  device as an implicit first input, where the JAX op receives a PRNG key
  (:func:`mxnet_tpu_torch.rng.next_generator`);
* ``variadic`` -- the op takes ``num_args`` inputs (``add_n``,
  ``Concat``, ``stack``);
* ``mode_dependent`` -- the op's behaviour differs in training and
  prediction (kept as a flag; no op of the port reads it yet).

An op with no tensor input (the creation and random ops) finds the device
to create its output on with :func:`device_of`.  Eager PyTorch keeps no
compile cache that a per-step attr (a scheduled lr or wd) would have to
bypass, so the JAX package's ``dynamic_params`` has no counterpart.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Union

from ..base import MXNetError, Param, _Null

__all__ = ["Operator", "register", "get_op", "list_ops", "alias",
           "AttrDict", "apply_op", "device_of"]


class AttrDict(dict):
    """Parsed op attributes with attribute access."""

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name)


_REGISTRY: Dict[str, "Operator"] = {}


class Operator:
    """A registered operator."""

    def __init__(self, name: str, fn: Callable,
                 params: Optional[Dict[str, Param]] = None,
                 inputs: Union[Sequence[str], Callable] = ("data",),
                 num_outputs: Union[int, Callable] = 1,
                 num_visible_outputs: Union[int, Callable, None] = None,
                 needs_rng: bool = False,
                 mode_dependent: bool = False,
                 variadic: bool = False,
                 writeback: Optional[Dict[int, int]] = None,
                 aux_inputs: Sequence[int] = (),
                 doc: str = ""):
        self.name = name
        self.fn = fn
        self.params = dict(params or {})
        self._inputs = inputs
        self._num_outputs = num_outputs
        self._num_visible_outputs = num_visible_outputs
        self.needs_rng = needs_rng
        self.mode_dependent = mode_dependent
        self.variadic = variadic
        # {input_index: output_index}: output j is the new value of aux
        # input i (the functional form of the reference's FMutateInputs);
        # a callable(attrs) -> dict for variadic ops (multi_sgd_*)
        self.writeback = writeback if callable(writeback) \
            else dict(writeback or {})
        # input positions that are auxiliary states (ListAuxiliaryStates)
        self.aux_inputs = tuple(aux_inputs)
        self.doc = doc

    def parse_attrs(self, kwargs: Dict[str, Any]) -> AttrDict:
        """Normalise raw kwargs (python values or strings) to typed attrs."""
        out = AttrDict()
        for pname, spec in self.params.items():
            if pname in kwargs:
                out[pname] = spec(kwargs[pname])
            elif spec.required:
                raise MXNetError("Required parameter %s of op %s is missing"
                                 % (pname, self.name))
            elif spec.default is not _Null:
                out[pname] = spec.default
        for k in kwargs:
            if k in self.params:
                continue
            if k in ("name", "dtype_out", "ctx", "ctx_group") \
                    or k.startswith("__"):
                continue
            raise MXNetError("Unknown argument %r for operator %s"
                             % (k, self.name))
        return out

    def list_inputs(self, attrs: Optional[AttrDict] = None,
                    num_args: Optional[int] = None) -> List[str]:
        if callable(self._inputs):
            # a variadic op's names follow its argument count (multi_*)
            return list(self._inputs(attrs, num_args) if self.variadic
                        else self._inputs(attrs))
        if self.variadic:
            if num_args is None and attrs:
                num_args = attrs.get("num_args")
            if num_args is not None:
                return ["arg%d" % i for i in range(num_args)]
        return list(self._inputs)

    def num_outputs(self, attrs: Optional[AttrDict] = None) -> int:
        if callable(self._num_outputs):
            return self._num_outputs(attrs)
        return self._num_outputs

    def writeback_map(self, attrs: Optional[AttrDict] = None) -> Dict[int,
                                                                      int]:
        wb = self.writeback
        return dict(wb(attrs)) if callable(wb) else dict(wb)

    def aux_input_indices(self, attrs: Optional[AttrDict] = None):
        return self.aux_inputs

    def num_visible_outputs(self, attrs: Optional[AttrDict] = None) -> int:
        if self._num_visible_outputs is None:
            return self.num_outputs(attrs)
        if callable(self._num_visible_outputs):
            return self._num_visible_outputs(attrs)
        return self._num_visible_outputs

    def __repr__(self):
        return "<Operator %s>" % self.name


def register(name: str, *, params=None, inputs=("data",), num_outputs=1,
             num_visible_outputs=None, needs_rng=False, mode_dependent=False,
             variadic=False, writeback=None, aux_inputs=(), aliases=()):
    """Decorator registering ``fn(attrs, *tensors)`` as operator ``name``
    (``fn(attrs, generator, *tensors)`` when ``needs_rng``), also under
    each of ``aliases``."""

    def deco(fn):
        op = Operator(name, fn, params=params, inputs=inputs,
                      num_outputs=num_outputs,
                      num_visible_outputs=num_visible_outputs,
                      needs_rng=needs_rng, mode_dependent=mode_dependent,
                      variadic=variadic, writeback=writeback,
                      aux_inputs=aux_inputs, doc=fn.__doc__ or "")
        if name in _REGISTRY:
            raise MXNetError("Operator %s already registered" % name)
        _REGISTRY[name] = op
        for a in aliases:
            _REGISTRY[a] = op
        return fn

    return deco


def alias(existing: str, *new_names: str):
    """Register ``new_names`` for the op already registered as
    ``existing``."""
    op = get_op(existing)
    for n in new_names:
        _REGISTRY[n] = op


def get_op(name: str) -> Operator:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise MXNetError("Operator %s is not registered" % name) from None


def list_ops() -> List[str]:
    return sorted(_REGISTRY)


def apply_op(op: Operator, attrs: AttrDict, *tensors):
    """Apply ``op`` to torch tensors (eager; autograd records it)."""
    return op.fn(attrs, *tensors)


def device_of(attrs: AttrDict):
    """The device an op with no tensor input creates its output on: the
    ``_device`` the imperative layer resolved for it, else the op's
    ``ctx`` attr (``"cpu(0)"``, ``"gpu(1)"``), else the current context
    (the card)."""
    from ..context import as_torch_device
    dev = attrs.get("_device")
    return dev if dev is not None else as_torch_device(attrs.get("ctx"))
