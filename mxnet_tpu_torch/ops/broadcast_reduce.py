"""Broadcasting binary ops and reductions (port of
``mxnet_tpu/ops/broadcast_reduce.py``; reference
src/operator/tensor/elemwise_binary_broadcast_op*.cc and
broadcast_reduce_op*.{cc,h}).  ``Symbol.__add__`` makes
``broadcast_add``.

Reduction attrs (broadcast_reduce_op.h ReduceAxesParam): ``axis`` None
reduces every axis, an int or a tuple those; ``keepdims`` keeps them as
size 1; ``exclude`` reduces the axes *not* listed.  An empty set of
axes returns the input unchanged, as ``jnp.sum(x, axis=())`` does.
"""
from __future__ import annotations

import torch

from ..base import Param, attr_bool, attr_float, attr_shape, attr_str
from .elemwise import _int_to_f64, _mod
from .registry import register

_BROADCAST = {
    "broadcast_add": (torch.add, ("_broadcast_plus",)),
    "broadcast_sub": (torch.sub, ("_broadcast_minus",)),
    "broadcast_mul": (torch.mul, ()),
    "broadcast_div": (torch.div, ()),
    "broadcast_mod": (_mod, ()),
    "broadcast_power": (torch.pow, ()),
    "broadcast_maximum": (torch.maximum, ()),
    "broadcast_minimum": (torch.minimum, ()),
    "broadcast_hypot": (lambda a, b: torch.hypot(
        *torch.broadcast_tensors(a, b)), ()),
    "broadcast_equal": (torch.eq, ()),
    "broadcast_not_equal": (torch.ne, ()),
    "broadcast_greater": (torch.gt, ()),
    "broadcast_greater_equal": (torch.ge, ()),
    "broadcast_lesser": (torch.lt, ()),
    "broadcast_lesser_equal": (torch.le, ()),
    "broadcast_logical_and": (lambda a, b: (a != 0) & (b != 0), ()),
    "broadcast_logical_or": (lambda a, b: (a != 0) | (b != 0), ()),
    "broadcast_logical_xor": (lambda a, b: (a != 0) ^ (b != 0), ()),
}


def _make_bcast(name, f):
    cmp = any(t in name for t in ("equal", "greater", "lesser", "logical"))

    def fn(attrs, a, b):
        out = f(a, b)
        return out.to(a.dtype) if cmp else out

    return fn


for _name, (_f, _aliases) in _BROADCAST.items():
    register(_name, inputs=("lhs", "rhs"), aliases=_aliases)(
        _make_bcast(_name, _f))


@register("broadcast_to", inputs=("data",),
          params=dict(shape=attr_shape(required=True)))
def _broadcast_to(attrs, x):
    """0 in the target keeps that dim (reference)."""
    tgt = tuple(s if t == 0 else t for s, t in zip(x.shape, attrs.shape))
    return torch.broadcast_to(x, tgt)


@register("broadcast_axis", inputs=("data",),
          params=dict(axis=attr_shape(()), size=attr_shape(())),
          aliases=("broadcast_axes",))
def _broadcast_axis(attrs, x):
    tgt = list(x.shape)
    for ax, sz in zip(attrs.axis, attrs.size):
        tgt[ax] = sz
    return torch.broadcast_to(x, tuple(tgt))


@register("broadcast_like", inputs=("lhs", "rhs"))
def _broadcast_like(attrs, a, b):
    return torch.broadcast_to(a, b.shape)


# ---------------------------------------------------------------------------
# Reductions
# ---------------------------------------------------------------------------

def _norm_axes(attrs, ndim):
    axis = attrs.get("axis", None)
    if axis is None or axis == ():
        axes = tuple(range(ndim))
    elif isinstance(axis, int):
        axes = (axis % ndim,)
    else:
        axes = tuple(a % ndim for a in axis)
    if attrs.get("exclude", False):
        axes = tuple(i for i in range(ndim) if i not in axes)
    return axes


def _as_float(x):
    return x if x.is_floating_point() else x.to(torch.get_default_dtype())


def _prod(x, axes, keepdims):
    for a in sorted(axes, reverse=True):
        x = torch.prod(x, a, keepdim=keepdims)
    return x


_RED_PARAMS = dict(axis=attr_shape(None), keepdims=attr_bool(False),
                   exclude=attr_bool(False))

_REDUCE = {
    "sum": lambda x, a, k: torch.sum(x, a, keepdim=k),
    "mean": lambda x, a, k: torch.mean(_as_float(x), a, keepdim=k),
    "prod": _prod,
    "nansum": lambda x, a, k: torch.nansum(x, a, keepdim=k),
    "nanprod": lambda x, a, k: _prod(
        torch.where(torch.isnan(x), torch.ones_like(x), x), a, k),
    "max": lambda x, a, k: torch.amax(x, a, keepdim=k),
    "min": lambda x, a, k: torch.amin(x, a, keepdim=k),
}

_RED_ALIASES = {"sum": ("sum_axis",), "max": ("max_axis",),
                "min": ("min_axis",)}


def _make_reduce(f):
    def fn(attrs, x):
        axes = _norm_axes(attrs, x.dim())
        if not axes:
            return x
        return f(x, axes, attrs.get("keepdims", False))

    return fn


for _name, _f in _REDUCE.items():
    register(_name, inputs=("data",), params=dict(_RED_PARAMS),
             aliases=_RED_ALIASES.get(_name, ()))(_make_reduce(_f))


@register("norm", inputs=("data",),
          params=dict(ord=Param(int, 2), axis=attr_shape(None),
                      keepdims=attr_bool(False)))
def _norm(attrs, x):
    """Without an axis the 2-norm of every element, in f32, as shape (1,)
    (``(1,)*ndim`` with keepdims); with one, the ``ord`` 1 or 2 norm."""
    if attrs.axis is None:
        out = torch.sqrt(torch.sum(x.to(torch.float32) ** 2)).to(x.dtype)
        return out.reshape((1,) if not attrs.keepdims else (1,) * x.dim())
    axes = tuple(a % x.dim() for a in attrs.axis)
    if attrs.ord == 1:
        return torch.sum(torch.abs(x), axes, keepdim=attrs.keepdims)
    return torch.sqrt(torch.sum(x * x, axes, keepdim=attrs.keepdims))


def _arg(f):
    def fn(attrs, x):
        if attrs.axis is None:
            out = f(x.reshape(-1), 0)
            out = out.reshape((1,) * x.dim()) if attrs.keepdims else out
        else:
            out = f(x, attrs.axis, keepdim=attrs.keepdims)
        return out.to(x.dtype)  # the reference returns the input's dtype
    return fn


_ARG_PARAMS = dict(axis=Param(int, None), keepdims=attr_bool(False))
register("argmax", inputs=("data",), params=dict(_ARG_PARAMS))(
    _arg(torch.argmax))
register("argmin", inputs=("data",), params=dict(_ARG_PARAMS))(
    _arg(torch.argmin))


@register("argmax_channel", inputs=("data",))
def _argmax_channel(attrs, x):
    return torch.argmax(x, 1).to(x.dtype)


@register("square_sum", inputs=("data",), params=dict(_RED_PARAMS))
def _square_sum(attrs, x):
    """reference src/operator/tensor/square_sum-inl.h"""
    axes = _norm_axes(attrs, x.dim())
    if not axes:
        return x * x
    return torch.sum(x * x, axes, keepdim=attrs.get("keepdims", False))


@register("L2Normalization", inputs=("data",),
          params=dict(eps=attr_float(1e-10), mode=attr_str("instance")))
def _l2_normalization(attrs, x):
    """reference src/operator/l2_normalization-inl.h"""
    if attrs.mode == "instance":
        axes = tuple(range(1, x.dim()))
    elif attrs.mode == "channel":
        axes = (1,)
    else:  # spatial
        axes = tuple(range(2, x.dim()))
    x = _int_to_f64(x)         # the JAX package's float64 for integers
    norm = torch.sqrt(torch.sum(x * x, axes, keepdim=True) + attrs.eps)
    return x / norm
