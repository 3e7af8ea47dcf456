"""Elementwise operator families (port of ``mxnet_tpu/ops/elemwise.py``;
reference src/operator/tensor/elemwise_unary_op.cc,
elemwise_binary_op*.cc, elemwise_binary_scalar_op*.cc and the functor zoo
of src/operator/mshadow_op.h).

Each op is one PyTorch expression registered from a table, as the JAX
package registers one ``jnp`` expression.  Parity notes:

* ``elemwise_*`` binaries take identical shapes; broadcasting is the
  ``broadcast_*`` family (:mod:`.broadcast_reduce`);
* ``*_scalar`` ops take the scalar as an attr;
* comparison and logical ops return 0/1 in the lhs dtype, not bool;
* ``_mod`` is the JAX package's ``jnp.mod``: ``fmod``, then the divisor
  added where the remainder's sign differs from the divisor's, so the
  bits equal XLA's; an integer remainder by zero is 0;
* dtypes follow the JAX package, which runs with x64 enabled: an integer
  tensor combined with a scalar (every scalar attr is a float), and
  ``clip``, ``round``, ``rint``, ``reciprocal`` and ``smooth_l1`` of
  one, give float64;
* ``Cast`` from a float to an integer type saturates as XLA's convert
  does (NaN to 0, out-of-range values to the type's least or largest
  value), where ``Tensor.to`` wraps;
* ``sign(NaN)`` is NaN, where ``torch.sign`` gives 0.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..base import attr_float, attr_int, attr_str, dtype_torch
from .registry import register


def _mod(a, b):
    if a.is_floating_point() or b.is_floating_point():
        r = torch.fmod(a, b)
        return torch.where((r != 0) & ((r < 0) != (b < 0)), r + b, r)
    # integers: XLA's remainder by zero is 0, where torch raises (CPU) or
    # leaves it undefined (CUDA); divide by 1 there and put 0 back
    zero = b == 0
    b = torch.where(zero, 1, b)
    r = torch.fmod(a, b)
    r = torch.where((r != 0) & ((r < 0) != (b < 0)), r + b, r)
    return torch.where(zero, 0, r)


def _int_to_f64(x):
    """``x``, or float64 for an integer or boolean tensor: what a float
    scalar promotes an integer array to in the JAX package (x64)."""
    return x if x.is_floating_point() or x.is_complex() else \
        x.to(torch.float64)


def _sign(x):
    """``jnp.sign``: NaN stays NaN."""
    out = torch.sign(x)
    return out.masked_fill(torch.isnan(x), float("nan")) \
        if x.is_floating_point() else out


def _saturating_cast(x, dtype):
    """``x.to(dtype)``, except that a float cast to an integer type
    saturates: NaN gives 0 and a value past the type's range its least or
    largest value.  The thresholds are powers of two, exact in every
    float type."""
    if not x.is_floating_point() or dtype == torch.bool \
            or dtype.is_floating_point or dtype.is_complex:
        return x.to(dtype)
    info = torch.iinfo(dtype)
    t = torch.trunc(x)
    hi = t >= float(info.max) + 1.0
    lo = t < float(info.min)
    out = torch.where(hi | lo | torch.isnan(t), 0, t).to(dtype)
    return torch.where(hi, info.max, torch.where(lo, info.min, out))


def _cbrt(x):
    return torch.sign(x) * torch.abs(x).pow(1.0 / 3.0)


def _scalar_like(x, s):
    """``s`` as a 0-d tensor of the dtype ``x op s`` promotes to."""
    return torch.tensor(s, dtype=torch.result_type(x, s), device=x.device)


# ---------------------------------------------------------------------------
# Unary math
# ---------------------------------------------------------------------------
_UNARY = {
    "abs": torch.abs,
    "sign": _sign,
    "rint": lambda x: torch.round(_int_to_f64(x)),   # half to even
    "ceil": torch.ceil,
    "floor": torch.floor,
    "trunc": torch.trunc,
    "fix": torch.trunc,           # the reference's fix rounds toward zero
    "square": torch.square,
    "sqrt": torch.sqrt,
    "rsqrt": torch.rsqrt,
    "cbrt": _cbrt,
    "rcbrt": lambda x: 1.0 / _cbrt(x),
    "exp": torch.exp,
    "log": torch.log,
    "log10": torch.log10,
    "log2": torch.log2,
    "log1p": torch.log1p,
    "expm1": torch.expm1,
    "sin": torch.sin,
    "cos": torch.cos,
    "tan": torch.tan,
    "arcsin": torch.asin,
    "arccos": torch.acos,
    "arctan": torch.atan,
    "sinh": torch.sinh,
    "cosh": torch.cosh,
    "tanh": torch.tanh,
    "arcsinh": torch.asinh,
    "arccosh": torch.acosh,
    "arctanh": torch.atanh,
    "degrees": torch.rad2deg,
    "radians": torch.deg2rad,
    "gamma": lambda x: torch.exp(torch.lgamma(x)),
    "gammaln": torch.lgamma,
    "reciprocal": lambda x: 1.0 / _int_to_f64(x),
    "negative": torch.neg,
    "relu": torch.relu,
    "sigmoid": torch.sigmoid,
    "softsign": F.softsign,
    "erf": torch.erf,
    "erfinv": torch.erfinv,
    "logical_not": lambda x: (x == 0).to(x.dtype),
}

for _name, _f in _UNARY.items():
    register(_name, inputs=("data",))(
        (lambda f: lambda attrs, x: f(x))(_f))


@register("identity", inputs=("data",), aliases=("_copy",))
def _identity(attrs, x):
    return x


@register("BlockGrad", inputs=("data",), aliases=("stop_gradient",))
def _block_grad(attrs, x):
    """reference: src/operator/tensor/elemwise_unary_op.cc BlockGrad"""
    return x.detach()


@register("make_loss", inputs=("data",))
def _make_loss_op(attrs, x):
    return x


@register("zeros_like", inputs=("data",))
def _zeros_like(attrs, x):
    return torch.zeros_like(x)


@register("ones_like", inputs=("data",))
def _ones_like(attrs, x):
    return torch.ones_like(x)


# ---------------------------------------------------------------------------
# Binary elementwise (same shape)
# ---------------------------------------------------------------------------
_BINARY = {
    "elemwise_add": torch.add,
    "elemwise_sub": torch.sub,
    "elemwise_mul": torch.mul,
    "elemwise_div": torch.div,
    "_maximum": torch.maximum,
    "_minimum": torch.minimum,
    "_hypot": torch.hypot,
    "_power": torch.pow,
    "_mod": _mod,
    "_equal": torch.eq,
    "_not_equal": torch.ne,
    "_greater": torch.gt,
    "_greater_equal": torch.ge,
    "_lesser": torch.lt,
    "_lesser_equal": torch.le,
    "_logical_and": lambda a, b: (a != 0) & (b != 0),
    "_logical_or": lambda a, b: (a != 0) | (b != 0),
    "_logical_xor": lambda a, b: (a != 0) ^ (b != 0),
}

_BINARY_ALIASES = {
    "elemwise_add": ("_plus", "_add"),
    "elemwise_sub": ("_minus", "_sub"),
    "elemwise_mul": ("_mul",),
    "elemwise_div": ("_div",),
}

_CMP = ("equal", "greater", "lesser", "logical")


def _make_binary(name, f):
    cast = any(t in name for t in _CMP)

    def fn(attrs, a, b):
        out = f(a, b)
        return out.to(a.dtype) if cast else out

    return fn


for _name, _f in _BINARY.items():
    register(_name, inputs=("lhs", "rhs"),
             aliases=_BINARY_ALIASES.get(_name, ()))(_make_binary(_name, _f))


@register("smooth_l1", inputs=("data",), params=dict(scalar=attr_float(1.0)))
def _smooth_l1(attrs, x):
    """reference: mshadow_op.h smooth_l1_loss; sigma = attrs.scalar"""
    x = _int_to_f64(x)
    s2 = attrs.scalar * attrs.scalar
    absx = torch.abs(x)
    return torch.where(absx < 1.0 / s2, 0.5 * s2 * x * x, absx - 0.5 / s2)


# ---------------------------------------------------------------------------
# Scalar ops; the scalar is an attr
# ---------------------------------------------------------------------------
_SCALAR = {
    "_plus_scalar": lambda x, s: x + s,
    "_minus_scalar": lambda x, s: x - s,
    "_rminus_scalar": lambda x, s: s - x,
    "_mul_scalar": lambda x, s: x * s,
    "_div_scalar": lambda x, s: x / s,
    "_rdiv_scalar": lambda x, s: s / x,
    "_mod_scalar": lambda x, s: _mod(x, _scalar_like(x, s)),
    "_rmod_scalar": lambda x, s: _mod(_scalar_like(x, s), x),
    "_power_scalar": lambda x, s: torch.pow(x, s),
    "_rpower_scalar": lambda x, s: torch.pow(s, x),
    "_maximum_scalar": lambda x, s: torch.maximum(x, _scalar_like(x, s)),
    "_minimum_scalar": lambda x, s: torch.minimum(x, _scalar_like(x, s)),
    "_hypot_scalar": lambda x, s: torch.hypot(
        x, _scalar_like(x, s).expand_as(x)),
    "_equal_scalar": lambda x, s: x == s,
    "_not_equal_scalar": lambda x, s: x != s,
    "_greater_scalar": lambda x, s: x > s,
    "_greater_equal_scalar": lambda x, s: x >= s,
    "_lesser_scalar": lambda x, s: x < s,
    "_lesser_equal_scalar": lambda x, s: x <= s,
    "_logical_and_scalar": lambda x, s: (x != 0) & bool(s != 0),
    "_logical_or_scalar": lambda x, s: (x != 0) | bool(s != 0),
    "_logical_xor_scalar": lambda x, s: (x != 0) ^ bool(s != 0),
}

for _name, _f in _SCALAR.items():
    register(_name, inputs=("data",),
             params=dict(scalar=attr_float(required=True)))(
        (lambda f, cast: lambda attrs, x: (
            f(x, attrs.scalar).to(x.dtype) if cast
            else f(_int_to_f64(x), attrs.scalar)))(
            _f, any(t in _name for t in _CMP)))


@register("_scatter_elemwise_div", inputs=("lhs", "rhs"))
def _scatter_div(attrs, a, b):
    return a / b


@register("clip", inputs=("data",),
          params=dict(a_min=attr_float(required=True),
                      a_max=attr_float(required=True)))
def _clip(attrs, x):
    """reference tensor/matrix_op.cc Clip"""
    return torch.clamp(_int_to_f64(x), attrs.a_min, attrs.a_max)


@register("Cast", inputs=("data",),
          params=dict(dtype=attr_str(required=True)), aliases=("cast",))
def _cast(attrs, x):
    return _saturating_cast(x, dtype_torch(attrs.dtype))


@register("where", inputs=("condition", "x", "y"))
def _where(attrs, cond, x, y):
    """reference src/operator/tensor/control_flow_op.cc (where); a 1-D
    condition selects rows"""
    if cond.shape != x.shape:
        cond = cond.reshape((-1,) + (1,) * (x.dim() - 1))
    return torch.where(cond != 0, x, y)


@register("round", inputs=("data",))
def _round(attrs, x):
    """reference mshadow_op.h round: ties away from zero (not the
    half-to-even of ``rint``)."""
    x = _int_to_f64(x)
    return torch.sign(x) * torch.floor(torch.abs(x) + 0.5)


@register("add_n", variadic=True, inputs=("args",),
          params=dict(num_args=attr_int(required=True)),
          aliases=("ElementWiseSum", "_sum_n"))
def _add_n(attrs, *xs):
    """reference elemwise_sum.cc: the sum of N arrays, left to right."""
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    return out
