"""Optimizer update ops (port of ``mxnet_tpu/ops/optimizer_ops.py``
whole; reference src/operator/optimizer_op.cc): ``sgd_update`` /
``sgd_mom_update``, the mixed-precision ``mp_sgd_update`` /
``mp_sgd_mom_update``, the many-parameter ``multi_sgd_update``,
``multi_sgd_mom_update``, ``multi_mp_sgd_update`` and
``multi_mp_sgd_mom_update``, and the other optimizers' ``adam_update``,
``rmsprop_update``, ``rmspropalex_update``, ``ftrl_update``,
``signsgd_update``, ``signum_update`` and ``ftml_update``.  The JAX
package computes them in XLA, not Pallas, so they are plain PyTorch.

Each op returns ``(new_weight, new_states...)`` and declares
``writeback``; :func:`~mxnet_tpu_torch.ndarray.ndarray.invoke_with_arrays`
copies those into the weight and state NDArrays in place, as the
reference's FMutateInputs does.  The formulas are the JAX package's:
``g = clip(grad * rescale_grad)``, then ``w - lr (g + wd w)`` (SGD) or
``m' = momentum m - lr (g + wd w)``, ``w + m'`` (SGD with momentum).
The ``mp_`` ops keep an f32 master copy ``weight32`` of a low-precision
weight: the gradient is cast to f32 before ``rescale_grad`` and the clip,
the update runs on ``weight32`` (and an f32 momentum), and the weight is
written as the rounding of the new master to its dtype.  The ``multi_``
ops take ``num_weights`` groups of inputs (weight, grad[, mom][,
weight32]) with per-group ``lrs`` / ``wds`` and apply the same formulas
to each (their ``wd`` term is added after the clip, as in the JAX
package).  The JAX package's ``dynamic_params`` have no counterpart: an
eager op keeps no compile cache for a per-step lr or wd to bypass.  The
other optimizers' ops wait (ROADMAP queue A item 2).
"""
from __future__ import annotations

import torch

from ..base import attr_bool, attr_float, attr_float_tuple, attr_int
from .registry import register

__all__ = []

_COMMON = dict(lr=attr_float(required=True), wd=attr_float(0.0),
               rescale_grad=attr_float(1.0), clip_gradient=attr_float(-1.0))


def _prep_grad(attrs, grad):
    g = grad * attrs.rescale_grad
    if attrs.clip_gradient > 0:
        g = torch.clamp(g, -attrs.clip_gradient, attrs.clip_gradient)
    return g


def _prep_grad_wd(attrs, grad, weight):
    """``wd * weight`` added BEFORE the clip (the adam / rmsprop
    families; reference optimizer_op-inl.h:773)."""
    g = grad * attrs.rescale_grad + attrs.wd * weight
    if attrs.clip_gradient > 0:
        g = torch.clamp(g, -attrs.clip_gradient, attrs.clip_gradient)
    return g


@register("sgd_update", inputs=("weight", "grad"),
          params=dict(_COMMON, lazy_update=attr_bool(True)),
          writeback={0: 0})
def _sgd_update(attrs, weight, grad):
    g = _prep_grad(attrs, grad)
    return weight - attrs.lr * (g + attrs.wd * weight)


@register("sgd_mom_update", inputs=("weight", "grad", "mom"),
          params=dict(_COMMON, momentum=attr_float(0.0),
                      lazy_update=attr_bool(True)),
          num_outputs=2, num_visible_outputs=1, writeback={0: 0, 2: 1})
def _sgd_mom_update(attrs, weight, grad, mom):
    g = _prep_grad(attrs, grad)
    new_mom = attrs.momentum * mom - attrs.lr * (g + attrs.wd * weight)
    return weight + new_mom, new_mom


@register("mp_sgd_update", inputs=("weight", "grad", "weight32"),
          params=dict(_COMMON, lazy_update=attr_bool(True)),
          num_outputs=2, num_visible_outputs=1, writeback={0: 0, 2: 1})
def _mp_sgd_update(attrs, weight, grad, weight32):
    g = _prep_grad(attrs, grad.float())
    new_w32 = weight32 - attrs.lr * (g + attrs.wd * weight32)
    return new_w32.to(weight.dtype), new_w32


@register("mp_sgd_mom_update", inputs=("weight", "grad", "mom", "weight32"),
          params=dict(_COMMON, momentum=attr_float(0.0),
                      lazy_update=attr_bool(True)),
          num_outputs=3, num_visible_outputs=1,
          writeback={0: 0, 2: 1, 3: 2})
def _mp_sgd_mom_update(attrs, weight, grad, mom, weight32):
    g = _prep_grad(attrs, grad.float())
    new_mom = attrs.momentum * mom - attrs.lr * (g + attrs.wd * weight32)
    new_w32 = weight32 + new_mom
    return new_w32.to(weight.dtype), new_mom, new_w32


# ---------------------------------------------------------------------------
# many parameters in one op (variadic inputs, per-group lrs / wds); the
# writeback maps follow num_weights
# ---------------------------------------------------------------------------

def _multi_attrs():
    return dict(lrs=attr_float_tuple(required=True),
                wds=attr_float_tuple(required=True),
                rescale_grad=attr_float(1.0),
                clip_gradient=attr_float(-1.0),
                num_weights=attr_int(-1),   # -1: from the argument count
                num_args=attr_int(0),
                momentum=attr_float(0.0))


def _nw(attrs, stride):
    """num_weights, derived from the argument count if not given."""
    n = attrs.num_weights
    if n is None or n < 0:
        n = (attrs.num_args or stride) // stride
    return n


def _multi_prep(attrs, grad, weight, i):
    g = grad * attrs.rescale_grad
    if attrs.clip_gradient > 0:
        g = torch.clamp(g, -attrs.clip_gradient, attrs.clip_gradient)
    return g + attrs.wds[i] * weight


def _multi_inputs(stride, names):
    def inputs(attrs, num_args=None):
        n = attrs.get("num_weights", -1) if attrs else -1
        if n is None or n < 0:
            n = (num_args if num_args else
                 (attrs.get("num_args") if attrs else 0) or stride) // stride
        return ["%s_%d" % (nm, i) for i in range(n) for nm in names]
    return inputs


def _multi_writeback(stride, states):
    """Input 0 of each group -> its new weight (output i), and the
    group's ``states`` (input offsets) -> the outputs after the weights,
    one block of num_weights each."""
    def writeback(attrs):
        n = _nw(attrs, stride)
        wb = {stride * i: i for i in range(n)}
        for j, off in enumerate(states):
            wb.update({stride * i + off: (j + 1) * n + i for i in range(n)})
        return wb
    return writeback


@register("multi_sgd_update", inputs=_multi_inputs(2, ("weight", "grad")),
          params=_multi_attrs(), variadic=True,
          num_outputs=lambda a: _nw(a, 2),
          writeback=_multi_writeback(2, ()))
def _multi_sgd_update(attrs, *args):
    out = []
    for i in range(_nw(attrs, 2)):
        w, g = args[2 * i], args[2 * i + 1]
        out.append(w - attrs.lrs[i] * _multi_prep(attrs, g, w, i))
    return tuple(out)


@register("multi_sgd_mom_update",
          inputs=_multi_inputs(3, ("weight", "grad", "mom")),
          params=_multi_attrs(), variadic=True,
          num_outputs=lambda a: 2 * _nw(a, 3),
          num_visible_outputs=lambda a: _nw(a, 3),
          writeback=_multi_writeback(3, (2,)))
def _multi_sgd_mom_update(attrs, *args):
    ws, ms = [], []
    for i in range(_nw(attrs, 3)):
        w, g, m = args[3 * i], args[3 * i + 1], args[3 * i + 2]
        m2 = attrs.momentum * m - attrs.lrs[i] * _multi_prep(attrs, g, w, i)
        ws.append(w + m2)
        ms.append(m2)
    return tuple(ws + ms)


@register("multi_mp_sgd_update",
          inputs=_multi_inputs(3, ("weight", "grad", "weight32")),
          params=_multi_attrs(), variadic=True,
          num_outputs=lambda a: 2 * _nw(a, 3),
          num_visible_outputs=lambda a: _nw(a, 3),
          writeback=_multi_writeback(3, (2,)))
def _multi_mp_sgd_update(attrs, *args):
    ws, w32s = [], []
    for i in range(_nw(attrs, 3)):
        w, g, w32 = args[3 * i], args[3 * i + 1], args[3 * i + 2]
        new32 = w32 - attrs.lrs[i] * _multi_prep(attrs, g.float(), w32, i)
        ws.append(new32.to(w.dtype))
        w32s.append(new32)
    return tuple(ws + w32s)


@register("multi_mp_sgd_mom_update",
          inputs=_multi_inputs(4, ("weight", "grad", "mom", "weight32")),
          params=_multi_attrs(), variadic=True,
          num_outputs=lambda a: 3 * _nw(a, 4),
          num_visible_outputs=lambda a: _nw(a, 4),
          writeback=_multi_writeback(4, (2, 3)))
def _multi_mp_sgd_mom_update(attrs, *args):
    ws, ms, w32s = [], [], []
    for i in range(_nw(attrs, 4)):
        w, g, m, w32 = args[4 * i:4 * i + 4]
        m2 = attrs.momentum * m - attrs.lrs[i] * _multi_prep(
            attrs, g.float(), w32, i)
        new32 = w32 + m2
        ws.append(new32.to(w.dtype))
        ms.append(m2)
        w32s.append(new32)
    return tuple(ws + ms + w32s)


# ---------------------------------------------------------------------------
# the other optimizers' updates
# ---------------------------------------------------------------------------

@register("adam_update", inputs=("weight", "grad", "mean", "var"),
          params=dict(_COMMON, beta1=attr_float(0.9), beta2=attr_float(0.999),
                      epsilon=attr_float(1e-8), lazy_update=attr_bool(True)),
          num_outputs=3, num_visible_outputs=1,
          writeback={0: 0, 2: 1, 3: 2})
def _adam_update(attrs, weight, grad, mean, var):
    g = _prep_grad_wd(attrs, grad, weight)
    new_mean = attrs.beta1 * mean + (1 - attrs.beta1) * g
    new_var = attrs.beta2 * var + (1 - attrs.beta2) * g * g
    new_w = weight - attrs.lr * new_mean / (torch.sqrt(new_var)
                                            + attrs.epsilon)
    return new_w, new_mean, new_var


@register("rmsprop_update", inputs=("weight", "grad", "n"),
          params=dict(_COMMON, gamma1=attr_float(0.95),
                      epsilon=attr_float(1e-8),
                      clip_weights=attr_float(-1.0)),
          num_outputs=2, num_visible_outputs=1, writeback={0: 0, 2: 1})
def _rmsprop_update(attrs, weight, grad, n):
    g = _prep_grad_wd(attrs, grad, weight)
    new_n = (1 - attrs.gamma1) * g * g + attrs.gamma1 * n
    new_w = weight - attrs.lr * g / torch.sqrt(new_n + attrs.epsilon)
    if attrs.clip_weights > 0:
        new_w = torch.clamp(new_w, -attrs.clip_weights, attrs.clip_weights)
    return new_w, new_n


@register("rmspropalex_update", inputs=("weight", "grad", "n", "g", "delta"),
          params=dict(_COMMON, gamma1=attr_float(0.95),
                      gamma2=attr_float(0.9), epsilon=attr_float(1e-8),
                      clip_weights=attr_float(-1.0)),
          num_outputs=4, num_visible_outputs=1,
          writeback={0: 0, 2: 1, 3: 2, 4: 3})
def _rmspropalex_update(attrs, weight, grad, n, g_state, delta):
    g = _prep_grad_wd(attrs, grad, weight)
    new_n = (1 - attrs.gamma1) * g * g + attrs.gamma1 * n
    new_g = (1 - attrs.gamma1) * g + attrs.gamma1 * g_state
    new_delta = attrs.gamma2 * delta - attrs.lr * g / torch.sqrt(
        new_n - new_g * new_g + attrs.epsilon)
    new_w = weight + new_delta
    if attrs.clip_weights > 0:
        new_w = torch.clamp(new_w, -attrs.clip_weights, attrs.clip_weights)
    return new_w, new_n, new_g, new_delta


@register("ftrl_update", inputs=("weight", "grad", "z", "n"),
          params=dict(_COMMON, lamda1=attr_float(0.01), beta=attr_float(1.0)),
          num_outputs=3, num_visible_outputs=1,
          writeback={0: 0, 2: 1, 3: 2})
def _ftrl_update(attrs, weight, grad, z, n):
    g = _prep_grad(attrs, grad)
    new_n = n + g * g
    sigma = (torch.sqrt(new_n) - torch.sqrt(n)) / attrs.lr
    new_z = z + g - sigma * weight
    new_w = torch.where(
        torch.abs(new_z) <= attrs.lamda1,
        torch.zeros((), dtype=new_z.dtype, device=new_z.device),
        -(new_z - torch.sign(new_z) * attrs.lamda1) /
        ((attrs.beta + torch.sqrt(new_n)) / attrs.lr + attrs.wd))
    return new_w.to(weight.dtype), new_z, new_n


@register("signsgd_update", inputs=("weight", "grad"), params=dict(_COMMON),
          writeback={0: 0})
def _signsgd_update(attrs, weight, grad):
    g = _prep_grad(attrs, grad)
    return weight - attrs.lr * (torch.sign(g) + attrs.wd * weight)


@register("signum_update", inputs=("weight", "grad", "mom"),
          params=dict(_COMMON, momentum=attr_float(0.0),
                      wd_lh=attr_float(0.0)),
          num_outputs=2, num_visible_outputs=1, writeback={0: 0, 2: 1})
def _signum_update(attrs, weight, grad, mom):
    g = _prep_grad(attrs, grad)
    new_mom = attrs.momentum * mom - (1 - attrs.momentum) * (
        g + attrs.wd * weight)
    new_w = (1 - attrs.lr * attrs.wd_lh) * weight + \
        attrs.lr * torch.sign(new_mom)
    return new_w, new_mom


@register("ftml_update", inputs=("weight", "grad", "d", "v", "z"),
          params=dict(lr=attr_float(required=True), beta1=attr_float(0.6),
                      beta2=attr_float(0.999), epsilon=attr_float(1e-8),
                      t=attr_int(required=True), wd=attr_float(0.0),
                      rescale_grad=attr_float(1.0),
                      clip_grad=attr_float(-1.0)),
          num_outputs=4, num_visible_outputs=1,
          writeback={0: 0, 2: 1, 3: 2, 4: 3})
def _ftml_update(attrs, weight, grad, d, v, z):
    """FTML (reference optimizer_op-inl.h:633 FTMLKernel); ``clip_grad``
    applies from 0 up, as the JAX package's."""
    g = attrs.rescale_grad * grad + attrs.wd * weight
    if attrs.clip_grad >= 0:
        g = torch.clamp(g, -attrs.clip_grad, attrs.clip_grad)
    b1, b2, t = attrs.beta1, attrs.beta2, float(attrs.t)
    v_new = b2 * v + (1 - b2) * torch.square(g)
    d_t = (1 - b1 ** t) / attrs.lr * (
        torch.sqrt(v_new / (1 - b2 ** t)) + attrs.epsilon)
    z_new = b1 * z + (1 - b1) * g - (d_t - b1 * d) * weight
    w_new = -z_new / d_t
    return w_new, d_t, v_new, z_new
