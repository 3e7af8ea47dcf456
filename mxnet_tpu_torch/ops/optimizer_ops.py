"""Optimizer update ops (port of ``sgd_update`` / ``sgd_mom_update`` from
``mxnet_tpu/ops/optimizer_ops.py:39,47``; reference
src/operator/optimizer_op.cc).

Each op returns ``(new_weight, new_states...)`` and declares
``writeback``; :func:`~mxnet_tpu_torch.ndarray.ndarray.invoke_with_arrays`
copies those into the weight and state NDArrays in place, as the
reference's FMutateInputs does.  The formulas are the JAX package's:
``g = clip(grad * rescale_grad)``, then ``w - lr (g + wd w)`` (SGD) or
``m' = momentum m - lr (g + wd w)``, ``w + m'`` (SGD with momentum).
The other optimizers' ops wait (ROADMAP A3).
"""
from __future__ import annotations

import torch

from ..base import attr_bool, attr_float
from .registry import register

__all__ = []

_COMMON = dict(lr=attr_float(required=True), wd=attr_float(0.0),
               rescale_grad=attr_float(1.0), clip_gradient=attr_float(-1.0))


def _prep_grad(attrs, grad):
    g = grad * attrs.rescale_grad
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
