"""NDArray over a torch tensor (port of the part of
``mxnet_tpu/ndarray/ndarray.py`` that the Module/KVStore path needs;
reference include/mxnet/ndarray.h, python/mxnet/ndarray/ndarray.py).

The JAX package's NDArray holds an immutable ``jax.Array`` and "mutates"
by rebinding its handle.  Here the handle is a torch tensor, mutable in
place, which is what the reference's NDArray is: a write through an
NDArray (an op's writeback, :meth:`NDArray.copyto`, ``arr[:] = x``)
writes into its tensor, so every holder of the same NDArray sees it.
Slicing along axis 0 returns a view sharing memory, as the reference's
does.  Code that must not let an in-place update reach an array its
caller holds copies first (``KVStore.init`` clones, ``pull`` copies).

Ported: :class:`NDArray` (``shape``, ``dtype``, ``context``,
``asnumpy``, ``copyto``, ``as_in_context``, axis-0 indexing),
:func:`array`, :func:`zeros`, :func:`empty` and
:func:`invoke_with_arrays` over :func:`~mxnet_tpu_torch.ops.registry.
apply_op`.  Arithmetic and the other creation and I/O functions raise
:class:`~mxnet_tpu_torch.base.NotPortedYet` (ROADMAP A2).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from ..base import (MXNetError, NotPortedYet, _Null, dtype_name, dtype_np,
                    dtype_torch)
from ..context import Context, as_torch_device, context_of
from ..ops.registry import apply_op, get_op

__all__ = ["NDArray", "array", "zeros", "empty", "invoke_with_arrays"]


def _unported(what):
    def method(self, *args, **kwargs):
        raise NotPortedYet("NDArray.%s: NDArray arithmetic is not ported "
                           "yet (ROADMAP A2)" % what)
    method.__name__ = what
    return method


class NDArray:
    """A torch tensor with the reference NDArray's interface."""

    __slots__ = ("_handle", "__weakref__")

    def __init__(self, handle):
        if not isinstance(handle, torch.Tensor):
            raise TypeError("NDArray wraps a torch.Tensor, got %s"
                            % type(handle).__name__)
        self._handle = handle

    # -- properties -------------------------------------------------------
    @property
    def handle(self) -> torch.Tensor:
        return self._handle

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self._handle.shape)

    @property
    def dtype(self):
        return dtype_np(dtype_name(self._handle.dtype))

    @property
    def context(self) -> Context:
        return context_of(self._handle)

    @property
    def stype(self) -> str:
        return "default"

    def __repr__(self):
        return "%s\n<NDArray %s @%s>" % (
            str(self.asnumpy()), "x".join(map(str, self.shape)), self.context)

    # -- host transfer ----------------------------------------------------
    def asnumpy(self) -> np.ndarray:
        """A fresh host copy (waits for the device)."""
        return self._handle.detach().to("cpu", copy=True).numpy()

    # -- copies -----------------------------------------------------------
    def copyto(self, other):
        """Copy into ``other`` (an NDArray, written in place, cast to its
        dtype) or onto a :class:`Context` (a new NDArray)."""
        if isinstance(other, NDArray):
            if other.shape != self.shape:
                raise MXNetError("copyto: shape %s into %s"
                                 % (self.shape, other.shape))
            other._handle.copy_(self._handle)
            return other
        if isinstance(other, Context):
            return NDArray(self._handle.to(other.torch_device, copy=True))
        raise TypeError("copyto does not support type " + str(type(other)))

    def as_in_context(self, context: Context) -> "NDArray":
        if context == self.context:
            return self
        return self.copyto(context)

    def __getitem__(self, key) -> "NDArray":
        """An integer or a unit-step slice along axis 0: a view sharing
        memory."""
        if isinstance(key, (int, np.integer)) or (
                isinstance(key, slice) and key.step in (None, 1)):
            return NDArray(self._handle[key])
        raise NotPortedYet("NDArray indexing with %r: only integers and "
                           "unit-step slices along axis 0 are ported "
                           "(ROADMAP A2)" % (key,))

    __add__ = __radd__ = __iadd__ = _unported("__add__")
    __sub__ = __rsub__ = __isub__ = _unported("__sub__")
    __mul__ = __rmul__ = __imul__ = _unported("__mul__")
    __truediv__ = __rtruediv__ = __itruediv__ = _unported("__truediv__")
    __neg__ = _unported("__neg__")


def array(source_array, ctx=None, dtype=None) -> NDArray:
    """A new NDArray holding a copy of ``source_array`` (numpy, a list,
    an NDArray or a tensor) on ``ctx`` (default: the current context,
    the card).  The dtype defaults to the source's for arrays, float32
    otherwise."""
    if isinstance(source_array, NDArray):
        src = source_array._handle
    elif isinstance(source_array, torch.Tensor):
        src = source_array
    else:
        host = np.asarray(source_array)
        if dtype is None and not isinstance(source_array, np.ndarray):
            dtype = "float32"
        src = torch.from_numpy(np.ascontiguousarray(host))
    want = dtype_torch(dtype) if dtype is not None else src.dtype
    return NDArray(src.to(as_torch_device(ctx), want, copy=True))


def zeros(shape, ctx=None, dtype=None, **kwargs) -> NDArray:
    if isinstance(shape, (int, np.integer)):
        shape = (int(shape),)
    return NDArray(torch.zeros(tuple(shape),
                               dtype=dtype_torch(dtype or "float32"),
                               device=as_torch_device(ctx)))


def empty(shape, ctx=None, dtype=None) -> NDArray:
    """Uninitialised storage, as the reference's ``empty``."""
    if isinstance(shape, (int, np.integer)):
        shape = (int(shape),)
    return NDArray(torch.empty(tuple(shape),
                               dtype=dtype_torch(dtype or "float32"),
                               device=as_torch_device(ctx)))


def invoke_with_arrays(op_name: str, inputs: Sequence[NDArray], kwargs,
                       out=None):
    """Run registered op ``op_name`` on NDArrays: parse the attrs, apply
    the op to the tensors, write each output that the op declares as the
    new value of an input (``writeback``: optimizer states, weights) into
    that input in place, and return the visible outputs (one NDArray, or
    a list).  ``out`` receives the visible outputs by copy."""
    op = get_op(op_name)
    attrs = op.parse_attrs({k: v for k, v in kwargs.items()
                            if v is not None and v is not _Null})
    with torch.no_grad():
        outputs = apply_op(op, attrs, *[x._handle for x in inputs])
        if not isinstance(outputs, tuple):
            outputs = (outputs,)
        for i_in, i_out in op.writeback_map(attrs).items():
            inputs[i_in]._handle.copy_(outputs[i_out])
    visible = [NDArray(o) for o in outputs[:op.num_visible_outputs(attrs)]]
    if out is not None:
        outs = [out] if isinstance(out, NDArray) else list(out)
        if len(outs) != len(visible):
            raise MXNetError("%s produces %d output(s) but %d out array(s) "
                             "given" % (op.name, len(visible), len(outs)))
        for o, v in zip(outs, visible):
            o._handle.copy_(v._handle)
        return out
    return visible[0] if len(visible) == 1 else visible
