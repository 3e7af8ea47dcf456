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

Only what the ported graphs and optimizers use is here: no op of the
port needs a random key or a variadic input list yet, and eager PyTorch
keeps no compile cache that a per-step attr (a scheduled lr or wd) would
have to bypass, so those declarations of the reference are not accepted.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Union

from ..base import MXNetError, Param, _Null

__all__ = ["Operator", "register", "get_op", "list_ops", "AttrDict",
           "apply_op"]


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
                 num_outputs: int = 1,
                 num_visible_outputs: Optional[int] = None,
                 writeback: Optional[Dict[int, int]] = None,
                 aux_inputs: Sequence[int] = (),
                 doc: str = ""):
        self.name = name
        self.fn = fn
        self.params = dict(params or {})
        self._inputs = inputs
        self._num_outputs = num_outputs
        self._num_visible_outputs = num_visible_outputs
        # {input_index: output_index}: output j is the new value of aux
        # input i (the functional form of the reference's FMutateInputs)
        self.writeback = dict(writeback or {})
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

    def list_inputs(self, attrs: Optional[AttrDict] = None) -> List[str]:
        if callable(self._inputs):
            return list(self._inputs(attrs))
        return list(self._inputs)

    def num_outputs(self, attrs: Optional[AttrDict] = None) -> int:
        return self._num_outputs

    def writeback_map(self, attrs: Optional[AttrDict] = None) -> Dict[int,
                                                                      int]:
        return dict(self.writeback)

    def aux_input_indices(self, attrs: Optional[AttrDict] = None):
        return self.aux_inputs

    def num_visible_outputs(self, attrs: Optional[AttrDict] = None) -> int:
        if self._num_visible_outputs is None:
            return self.num_outputs(attrs)
        return self._num_visible_outputs

    def __repr__(self):
        return "<Operator %s>" % self.name


def register(name: str, *, params=None, inputs=("data",), num_outputs=1,
             num_visible_outputs=None, writeback=None, aux_inputs=(),
             aliases=()):
    """Decorator registering ``fn(attrs, *tensors)`` as operator ``name``."""

    def deco(fn):
        op = Operator(name, fn, params=params, inputs=inputs,
                      num_outputs=num_outputs,
                      num_visible_outputs=num_visible_outputs,
                      writeback=writeback, aux_inputs=aux_inputs,
                      doc=fn.__doc__ or "")
        if name in _REGISTRY:
            raise MXNetError("Operator %s already registered" % name)
        _REGISTRY[name] = op
        for a in aliases:
            _REGISTRY[a] = op
        return fn

    return deco


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
