"""NDArray over a torch tensor (port of ``mxnet_tpu/ndarray/ndarray.py``;
reference include/mxnet/ndarray.h, python/mxnet/ndarray/ndarray.py).

The JAX package's NDArray holds an immutable ``jax.Array`` and "mutates"
by rebinding its handle.  Here the handle is a torch tensor, mutable in
place, which is what the reference's NDArray is: a write through an
NDArray (an op's writeback, :meth:`NDArray.copyto`, ``arr[...] = x``,
``arr += x``) writes into its tensor, so every holder of the same
NDArray, and of a view of it, sees it.  Basic indexing (integers and
positive-step slices) returns a view sharing memory, as the reference's
does; every op returns a new contiguous array (an op whose result would
alias its input, ``identity`` or ``Reshape``, is copied).  Code that
must not let an in-place update reach an array its caller holds copies
first (``KVStore.init`` clones, ``pull`` copies).

Ops run through :func:`imperative_invoke`: parse the attrs (a
mode-dependent op takes ``_train`` from :func:`autograd.is_training`),
hand a ``needs_rng`` op its device's generator, apply the op to the
tensors (with grad enabled only while :func:`autograd.record` is on,
where a marked variable enters as its leaf), and write each declared
``writeback`` output into its input in place, never recorded.  An op
with no tensor input creates its output on ``ctx`` (default: the current
context, the card).

Autograd (:mod:`mxnet_tpu_torch.autograd`): ``attach_grad`` marks an
array, ``backward`` writes the gradients into the marked arrays'
``grad`` buffers.  A write into an array that a recording used
(``__setitem__``, ``+=``, ``copyto``) rebinds it to a written copy, so
the recorded graph keeps the values it saw, as the JAX package's
rebinding does.

Sparse storage is :mod:`.sparse` (``tostype``).  Not ported (raising
:class:`~mxnet_tpu_torch.base.NotPortedYet`): the profiler hook of
``imperative_invoke`` (item 9, observability).
"""
from __future__ import annotations

from typing import Any, Dict, Sequence, Tuple

import numpy as np
import torch

from .. import autograd as _ag
from .. import rng as _rng
from ..base import (MXNetError, _Null, dtype_name, dtype_np,
                    dtype_torch)
from ..context import Context, as_torch_device, context_of
from ..ops.registry import Operator, get_op, list_ops

__all__ = ["NDArray", "array", "zeros", "ones", "full", "empty", "arange",
           "eye", "concatenate", "moveaxis", "waitall", "imperative_invoke",
           "invoke_with_arrays", "populate_module", "save", "load",
           "stack_nd"]


class NDArray:
    """A torch tensor with the reference NDArray's interface."""

    # _ag: the autograd record of a marked variable (None if unmarked);
    # _recorded: a recording op has read this array
    __slots__ = ("_handle", "_ag", "_recorded", "__weakref__")

    def __init__(self, handle):
        if not isinstance(handle, torch.Tensor):
            raise TypeError("NDArray wraps a torch.Tensor, got %s"
                            % type(handle).__name__)
        self._handle = handle
        self._ag = None
        self._recorded = False

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
    def size(self) -> int:
        return self._handle.numel()

    @property
    def ndim(self) -> int:
        return self._handle.dim()

    @property
    def context(self) -> Context:
        return context_of(self._handle)

    ctx = context

    @property
    def stype(self) -> str:
        return "default"

    @property
    def T(self) -> "NDArray":
        return self.transpose()

    def __len__(self):
        return self.shape[0]

    def __repr__(self):
        return "%s\n<NDArray %s @%s>" % (
            str(self.asnumpy()), "x".join(map(str, self.shape)), self.context)

    # -- host transfer and sync -------------------------------------------
    def asnumpy(self) -> np.ndarray:
        """A fresh host copy (waits for the device)."""
        return self._handle.detach().to("cpu", copy=True).numpy()

    def asscalar(self):
        if self.size != 1:
            raise ValueError("The current array is not a scalar")
        return self.asnumpy().reshape(())[()]

    def wait_to_read(self):
        if self._handle.is_cuda:
            torch.cuda.synchronize(self._handle.device)

    wait_to_write = wait_to_read

    # -- conversion and copies --------------------------------------------
    def astype(self, dtype, copy=True) -> "NDArray":
        if not copy and self.dtype == dtype_np(dtype):
            return self
        return invoke_with_arrays("Cast", [self],
                                  dict(dtype=dtype_name(dtype)))

    def copy(self) -> "NDArray":
        return invoke_with_arrays("_copy", [self], {})

    def copyto(self, other):
        """Copy into ``other`` (an NDArray, written in place, cast to its
        dtype) or onto a :class:`Context` (a new NDArray)."""
        if isinstance(other, NDArray):
            if other.shape != self.shape:
                raise MXNetError("copyto: shape %s into %s"
                                 % (self.shape, other.shape))
            other._write(self._handle)
            return other
        if isinstance(other, Context):
            return NDArray(self._handle.to(other.torch_device, copy=True))
        raise TypeError("copyto does not support type " + str(type(other)))

    def as_in_context(self, context: Context) -> "NDArray":
        if context == self.context:
            return self
        return self.copyto(context)

    def detach(self) -> "NDArray":
        """The same values outside any recorded graph."""
        return NDArray(self._handle.detach())

    def tostype(self, stype: str):
        """This array (``"default"``) or a row_sparse / CSR array of its
        values (:func:`.sparse.cast_storage`)."""
        if stype == "default":
            return self
        from .sparse import cast_storage
        return cast_storage(self, stype)

    # -- autograd ---------------------------------------------------------
    def attach_grad(self, grad_req: str = "write", stype=None):
        """Mark this array for :func:`autograd.backward`, with a zeroed
        gradient buffer of its shape, dtype and device.  The gradient is
        dense whatever ``stype`` says, as in the JAX package (a
        row_sparse gradient is made at the kvstore boundary)."""
        _ag.mark_variables([self], [NDArray(torch.zeros_like(
            self._handle.detach()))], grad_req)

    def backward(self, out_grad=None, retain_graph=False, train_mode=True):
        _ag.backward([self], [out_grad] if out_grad is not None else None,
                     retain_graph=retain_graph, train_mode=train_mode)

    @property
    def grad(self):
        return self._ag.grad if self._ag is not None else None

    def _in_graph(self) -> bool:
        """A recording read this array, or it is a recorded result."""
        return self._recorded or self._handle.requires_grad

    def _write(self, src):
        """This array's values become ``src``'s (cast to its dtype): in
        place, or, where a recorded graph holds the tensor, by rebinding
        to a written copy."""
        with torch.no_grad():
            if self._in_graph():
                new = torch.empty_like(self._handle.detach())
                new.copy_(src)
                self._handle = new
                self._recorded = False
            else:
                self._handle.copy_(src)

    # -- shape ops (method forms) -----------------------------------------
    def reshape(self, *shape, **kwargs) -> "NDArray":
        if len(shape) == 1 and isinstance(shape[0], (list, tuple)):
            shape = tuple(shape[0])
        return invoke_with_arrays("Reshape", [self],
                                  dict(shape=shape, **kwargs))

    def reshape_like(self, other) -> "NDArray":
        return self.reshape(other.shape)

    def transpose(self, *axes) -> "NDArray":
        if len(axes) == 1 and isinstance(axes[0], (list, tuple)):
            axes = tuple(axes[0])
        return invoke_with_arrays("transpose", [self], dict(axes=axes))

    def flatten(self) -> "NDArray":
        return invoke_with_arrays("Flatten", [self], {})

    def expand_dims(self, axis) -> "NDArray":
        return invoke_with_arrays("expand_dims", [self], dict(axis=axis))

    def swapaxes(self, dim1, dim2) -> "NDArray":
        return invoke_with_arrays("swapaxes", [self],
                                  dict(dim1=dim1, dim2=dim2))

    def flip(self, axis) -> "NDArray":
        return invoke_with_arrays("reverse", [self], dict(axis=axis))

    def broadcast_to(self, shape) -> "NDArray":
        return invoke_with_arrays("broadcast_to", [self], dict(shape=shape))

    def slice(self, begin, end, step=None) -> "NDArray":
        return invoke_with_arrays("slice", [self],
                                  dict(begin=begin, end=end, step=step or ()))

    # -- reductions and elementwise method forms --------------------------
    def sum(self, axis=None, keepdims=False, **kw):
        return invoke_with_arrays("sum", [self],
                                  dict(axis=axis, keepdims=keepdims))

    def mean(self, axis=None, keepdims=False, **kw):
        return invoke_with_arrays("mean", [self],
                                  dict(axis=axis, keepdims=keepdims))

    def max(self, axis=None, keepdims=False, **kw):
        return invoke_with_arrays("max", [self],
                                  dict(axis=axis, keepdims=keepdims))

    def min(self, axis=None, keepdims=False, **kw):
        return invoke_with_arrays("min", [self],
                                  dict(axis=axis, keepdims=keepdims))

    def prod(self, axis=None, keepdims=False, **kw):
        return invoke_with_arrays("prod", [self],
                                  dict(axis=axis, keepdims=keepdims))

    def norm(self, **kw):
        return invoke_with_arrays("norm", [self], kw)

    def argmax(self, axis=None, **kw):
        return invoke_with_arrays("argmax", [self], dict(axis=axis))

    def argmin(self, axis=None, **kw):
        return invoke_with_arrays("argmin", [self], dict(axis=axis))

    def abs(self):
        return invoke_with_arrays("abs", [self], {})

    def sign(self):
        return invoke_with_arrays("sign", [self], {})

    def square(self):
        return invoke_with_arrays("square", [self], {})

    def sqrt(self):
        return invoke_with_arrays("sqrt", [self], {})

    def exp(self):
        return invoke_with_arrays("exp", [self], {})

    def log(self):
        return invoke_with_arrays("log", [self], {})

    def clip(self, a_min, a_max):
        return invoke_with_arrays("clip", [self],
                                  dict(a_min=a_min, a_max=a_max))

    def one_hot(self, depth, **kw):
        return invoke_with_arrays("one_hot", [self], dict(depth=depth, **kw))

    def astype_like(self, other):
        return self.astype(other.dtype)

    # -- arithmetic -------------------------------------------------------
    def _binary(self, other, op_nd, op_sc, rev=False):
        if isinstance(other, NDArray):
            name = op_nd if self.shape == other.shape \
                else _BROADCAST_MAP[op_nd]
            a, b = (other, self) if rev else (self, other)
            return invoke_with_arrays(name, [a, b], {})
        if rev and op_sc in _RSCALAR_MAP:
            return invoke_with_arrays(_RSCALAR_MAP[op_sc], [self],
                                      dict(scalar=float(other)))
        return invoke_with_arrays(op_sc, [self], dict(scalar=float(other)))

    def __add__(self, o):
        return self._binary(o, "elemwise_add", "_plus_scalar")

    __radd__ = __add__

    def __sub__(self, o):
        return self._binary(o, "elemwise_sub", "_minus_scalar")

    def __rsub__(self, o):
        return self._binary(o, "elemwise_sub", "_minus_scalar", rev=True)

    def __mul__(self, o):
        return self._binary(o, "elemwise_mul", "_mul_scalar")

    __rmul__ = __mul__

    def __truediv__(self, o):
        return self._binary(o, "elemwise_div", "_div_scalar")

    def __rtruediv__(self, o):
        return self._binary(o, "elemwise_div", "_div_scalar", rev=True)

    def __mod__(self, o):
        return self._binary(o, "_mod", "_mod_scalar")

    def __rmod__(self, o):
        return self._binary(o, "_mod", "_mod_scalar", rev=True)

    def __pow__(self, o):
        return self._binary(o, "_power", "_power_scalar")

    def __rpow__(self, o):
        return self._binary(o, "_power", "_power_scalar", rev=True)

    def __neg__(self):
        return invoke_with_arrays("negative", [self], {})

    def __abs__(self):
        return invoke_with_arrays("abs", [self], {})

    def __eq__(self, o):
        if o is None:
            return False
        return self._binary(o, "_equal", "_equal_scalar")

    def __ne__(self, o):
        if o is None:
            return True
        return self._binary(o, "_not_equal", "_not_equal_scalar")

    def __gt__(self, o):
        return self._binary(o, "_greater", "_greater_scalar")

    def __ge__(self, o):
        return self._binary(o, "_greater_equal", "_greater_equal_scalar")

    def __lt__(self, o):
        return self._binary(o, "_lesser", "_lesser_scalar")

    def __le__(self, o):
        return self._binary(o, "_lesser_equal", "_lesser_equal_scalar")

    def __hash__(self):
        return id(self)

    def __bool__(self):
        if self.size == 1:
            return bool(self.asscalar())
        raise ValueError("The truth value of an NDArray with multiple "
                         "elements is ambiguous.")

    def _inplace(self, out: "NDArray") -> "NDArray":
        """``self op= x``: the result written into this array's tensor;
        a result of another shape (a broadcast) or dtype (an integer
        array plus a float: float64), a recorded result, or an array a
        recorded graph holds rebinds the handle, as the reference rebinds
        it."""
        if out.shape == self.shape and out.dtype == self.dtype \
                and not out._handle.requires_grad and not self._in_graph():
            with torch.no_grad():
                self._handle.copy_(out._handle)
        else:
            self._handle = out._handle
            self._recorded = out._recorded
        return self

    def __iadd__(self, o):
        return self._inplace(self.__add__(o))

    def __isub__(self, o):
        return self._inplace(self.__sub__(o))

    def __imul__(self, o):
        return self._inplace(self.__mul__(o))

    def __itruediv__(self, o):
        return self._inplace(self.__truediv__(o))

    # -- indexing ---------------------------------------------------------
    def __getitem__(self, key):
        """An NDArray key takes rows (``take``); a key of integers and
        slices with a negative step goes through the ``slice`` op; any
        other key is torch indexing (a view for integers and
        positive-step slices)."""
        if isinstance(key, NDArray):
            return invoke_with_arrays("take", [self, key], dict(axis=0))
        neg = _negative_step_key(key, self.ndim)
        if neg is not None:
            begin, end, step, ints = neg
            out = invoke_with_arrays("slice", [self], dict(
                begin=begin, end=end, step=step))
            return NDArray(out._handle.squeeze(ints)) if ints else out
        if _ag.is_recording():
            self._recorded = True
            return NDArray(_ag._leaf_of(self)[
                _torch_key(key, self._handle.device)])
        with torch.no_grad():
            return NDArray(self._handle[_torch_key(key,
                                                   self._handle.device)])

    def __setitem__(self, key, value):
        """Writes into this array's tensor in place (into a written copy
        that the array is rebound to, where a recorded graph holds the
        tensor).  A key of integers and slices with a negative step goes
        through ``_slice_assign`` / ``_slice_assign_scalar``."""
        if self._in_graph():
            with torch.no_grad():
                self._handle = self._handle.detach().clone()
            self._recorded = False
        t = self._handle
        if isinstance(value, NDArray):
            value = value._handle.detach().to(t.device)
        elif not isinstance(value, (int, float, bool, np.number)):
            value = torch.as_tensor(np.asarray(value), dtype=t.dtype,
                                    device=t.device)
        neg = _negative_step_key(key, self.ndim)
        if neg is not None:
            begin, end, step, ints = neg
            attrs = dict(begin=begin, end=end, step=step)
            with torch.no_grad():
                if torch.is_tensor(value):
                    if value.dim() == self.ndim - len(ints):
                        for ax in ints:     # the integer axes, as size 1
                            value = value.unsqueeze(ax)
                    op = get_op("_slice_assign")
                    new = op.fn(op.parse_attrs(attrs), t, value.to(t.dtype))
                else:
                    op = get_op("_slice_assign_scalar")
                    new = op.fn(op.parse_attrs(dict(attrs,
                                                    scalar=float(value))), t)
                t.copy_(new)
            return
        if isinstance(key, NDArray):
            key = key._handle.long()
        with torch.no_grad():
            t[_torch_key(key, t.device)] = value

    def __iter__(self):
        for i in range(self.shape[0]):
            yield self[i]

    def __array__(self, dtype=None, copy=None):
        a = self.asnumpy()
        return a.astype(dtype) if dtype is not None else a


_BROADCAST_MAP = {
    "elemwise_add": "broadcast_add", "elemwise_sub": "broadcast_sub",
    "elemwise_mul": "broadcast_mul", "elemwise_div": "broadcast_div",
    "_mod": "broadcast_mod", "_power": "broadcast_power",
    "_maximum": "broadcast_maximum", "_minimum": "broadcast_minimum",
    "_equal": "broadcast_equal", "_not_equal": "broadcast_not_equal",
    "_greater": "broadcast_greater",
    "_greater_equal": "broadcast_greater_equal",
    "_lesser": "broadcast_lesser", "_lesser_equal": "broadcast_lesser_equal",
}
_RSCALAR_MAP = {
    "_minus_scalar": "_rminus_scalar", "_div_scalar": "_rdiv_scalar",
    "_mod_scalar": "_rmod_scalar", "_power_scalar": "_rpower_scalar",
}


def _negative_step_key(key, ndim):
    """``(begin, end, step, int_axes)`` for a key of integers and slices
    with at least one negative step (which torch indexing refuses), else
    None.  An integer ``i`` becomes the slice ``i:i+1`` whose axis is
    squeezed afterwards; open ends become integers that mean the same for
    any length."""
    parts = key if isinstance(key, tuple) else (key,)
    if len(parts) > ndim:
        return None
    begin, end, step, ints = [], [], [], []
    for ax, k in enumerate(parts):
        if isinstance(k, (bool, np.bool_)):
            return None
        if isinstance(k, (int, np.integer)):
            k = int(k)
            begin.append(k)
            end.append(k + 1 if k != -1 else _FAR)
            step.append(1)
            ints.append(ax)
        elif isinstance(k, slice):
            st = 1 if k.step is None else int(k.step)
            begin.append(k.start if k.start is not None
                         else (-1 if st < 0 else 0))
            end.append(k.stop if k.stop is not None
                       else (-_FAR if st < 0 else _FAR))
            step.append(st)
        else:
            return None
    if not any(st < 0 for st in step):
        return None
    return tuple(begin), tuple(end), tuple(step), ints


_FAR = 1 << 62     # an open slice end, for any axis length


def _torch_key(key, device):
    """numpy arrays and NDArrays in an indexing key as torch tensors."""
    def conv(k):
        if isinstance(k, NDArray):
            return k._handle.long().to(device)
        if isinstance(k, np.ndarray):
            return torch.from_numpy(k).to(device)
        return k
    if isinstance(key, tuple):
        return tuple(conv(k) for k in key)
    return conv(key)


# ---------------------------------------------------------------------------
# Imperative invoke
# ---------------------------------------------------------------------------

def _storage_ptr(t):
    return t.untyped_storage().data_ptr()


def _owned(out, inputs):
    """``out`` as a contiguous tensor sharing no memory with ``inputs``:
    an op's result is a new array, even where torch returns a view."""
    ptr = _storage_ptr(out)
    if ptr and any(_storage_ptr(x) == ptr for x in inputs):
        return out.clone(memory_format=torch.contiguous_format)
    return out.contiguous()


def imperative_invoke(op: Operator, inputs: Sequence[NDArray],
                      kwargs: Dict[str, Any], out=None):
    """Run ``op`` on NDArrays: parse the attrs (``_train`` from the
    autograd training flag), hand a ``needs_rng`` op its device's
    generator (the first input's device, else ``ctx``), apply the op
    (recorded while :func:`autograd.record` is on, unless it has
    writebacks), write each output the op declares as the new value of an
    input (``writeback``: optimizer states, weights) into that input in
    place, and return the visible outputs (one NDArray, or a list).
    ``out`` receives the visible outputs by copy (by rebinding, for a
    recorded result)."""
    attrs = op.parse_attrs(kwargs)
    if op.mode_dependent:
        attrs["_train"] = _ag.is_training()
    wb = op.writeback_map(attrs)
    # an op that writes back its aux states (BatchNorm) is recorded; one
    # that writes back its other inputs (the optimizer updates) is not
    recording = _ag.is_recording() and \
        set(wb) <= set(op.aux_input_indices(attrs))
    if recording:
        tensors = [_ag._leaf_of(x) for x in inputs]
        for x in inputs:
            x._recorded = True
    else:
        tensors = [x._handle for x in inputs]
    if tensors:
        device = tensors[0].device
    else:
        device = as_torch_device(kwargs.get("ctx"))
        attrs["_device"] = device
    with torch.set_grad_enabled(recording):
        if op.needs_rng:
            outputs = op.fn(attrs, _rng.next_generator(device), *tensors)
        else:
            outputs = op.fn(attrs, *tensors)
        if not isinstance(outputs, tuple):
            outputs = (outputs,)
    with torch.no_grad():
        for i_in, i_out in wb.items():
            if recording:
                # the aux array takes the new value itself (C14), so a
                # recorded graph keeps the one it read
                inputs[i_in]._handle = outputs[i_out].detach()
                inputs[i_in]._recorded = False
            else:
                inputs[i_in]._handle.copy_(outputs[i_out])
    n_vis = op.num_visible_outputs(attrs)
    visible = [NDArray(_owned(o, tensors)) for o in outputs[:n_vis]]
    if out is not None:
        outs = [out] if isinstance(out, NDArray) else list(out)
        if len(outs) != len(visible):
            raise MXNetError("%s produces %d output(s) but %d out array(s) "
                             "given" % (op.name, len(visible), len(outs)))
        for o, v in zip(outs, visible):
            if v._handle.requires_grad:
                o._handle, o._recorded = v._handle, True
            else:
                o._write(v._handle)
        return out
    return visible[0] if n_vis == 1 else visible


def invoke_with_arrays(op_name: str, inputs: Sequence[NDArray], kwargs,
                       out=None):
    """:func:`imperative_invoke` by op name, with None and ``_Null`` attrs
    dropped."""
    kwargs = {k: v for k, v in kwargs.items()
              if v is not None and v is not _Null}
    return imperative_invoke(get_op(op_name), inputs, kwargs, out)


def _make_wrapper(op: Operator):
    def wrapper(*args, out=None, name=None, **kwargs):
        inputs = [a for a in args if isinstance(a, NDArray)]
        extra = [a for a in args if not isinstance(a, NDArray)]
        if extra:
            # positional attrs map onto the schema in declaration order
            free = [p for p in op.params if p not in kwargs]
            if len(extra) > len(free):
                raise MXNetError("op %s: too many positional arguments %r"
                                 % (op.name, extra))
            kwargs.update(zip(free, extra))
        if op.variadic and "num_args" not in kwargs:
            kwargs["num_args"] = len(inputs)
        if not inputs:   # inputs given as keywords (data=..., weight=...)
            inputs = [kwargs.pop(n) for n in op.list_inputs(None)
                      if isinstance(kwargs.get(n), NDArray)]
        kwargs = {k: v for k, v in kwargs.items()
                  if v is not None and v is not _Null}
        return imperative_invoke(op, inputs, kwargs, out)

    wrapper.__name__ = op.name
    wrapper.__doc__ = op.doc
    return wrapper


def populate_module(mod):
    """Expose every registered op as a function of ``mod`` (the reference
    generates these from the C op registry, ndarray/register.py)."""
    for name in list_ops():
        setattr(mod, name, _make_wrapper(get_op(name)))


# ---------------------------------------------------------------------------
# creation and I/O
# ---------------------------------------------------------------------------

def _shape(shape):
    if isinstance(shape, (int, np.integer)):
        return (int(shape),)
    return tuple(shape)


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
    return NDArray(torch.zeros(_shape(shape),
                               dtype=dtype_torch(dtype or "float32"),
                               device=as_torch_device(ctx)))


def ones(shape, ctx=None, dtype=None, **kwargs) -> NDArray:
    return NDArray(torch.ones(_shape(shape),
                              dtype=dtype_torch(dtype or "float32"),
                              device=as_torch_device(ctx)))


def full(shape, val, ctx=None, dtype=None, out=None) -> NDArray:
    nd = NDArray(torch.full(_shape(shape), val,
                            dtype=dtype_torch(dtype or "float32"),
                            device=as_torch_device(ctx)))
    if out is not None:
        out._write(nd._handle)
        return out
    return nd


def empty(shape, ctx=None, dtype=None) -> NDArray:
    """Uninitialised storage, as the reference's ``empty``."""
    return NDArray(torch.empty(_shape(shape),
                               dtype=dtype_torch(dtype or "float32"),
                               device=as_torch_device(ctx)))


def arange(start, stop=None, step=1.0, repeat=1, ctx=None,
           dtype="float32") -> NDArray:
    """The values of ``np.arange(start, stop, step)`` (float64) cast to
    ``dtype``, as the JAX package computes them, each repeated."""
    out = np.arange(start, stop, step).astype(dtype_np(dtype))
    if repeat != 1:
        out = np.repeat(out, repeat)
    return array(out, ctx=ctx)


def eye(N, M=0, k=0, ctx=None, dtype="float32") -> NDArray:
    return array(np.eye(N, M if M > 0 else N, k).astype(dtype_np(dtype)),
                 ctx=ctx)


def moveaxis(tensor, source, destination) -> NDArray:
    return NDArray(torch.movedim(tensor._handle, source, destination)
                   .clone(memory_format=torch.contiguous_format))


def concatenate(arrays, axis=0, always_copy=True) -> NDArray:
    return invoke_with_arrays("Concat", list(arrays),
                              dict(num_args=len(arrays), dim=axis))


def stack_nd(arrays, axis=0) -> NDArray:
    return invoke_with_arrays("stack", list(arrays),
                              dict(num_args=len(arrays), axis=axis))


def waitall():
    """Wait until every card of the process has finished its queued work
    (``mx.nd.waitall``)."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)


def save(fname: str, data):
    """Save NDArrays (one, a list, or a str -> NDArray dict) in the
    reference's binary container (MXNDArraySave; the format is in
    :mod:`.serialization`)."""
    from .serialization import save as _save
    _save(fname, data)


def load(fname: str, ctx=None):
    """Load a reference binary NDArray container (MXNDArrayLoad) onto
    ``ctx`` (default: the current context, the card)."""
    from .serialization import load as _load
    return _load(fname, ctx)
