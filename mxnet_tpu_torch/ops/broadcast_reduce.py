"""Broadcasting binary ops (port of ``broadcast_add`` from
``mxnet_tpu/ops/broadcast_reduce.py``; reference
src/operator/tensor/elemwise_binary_broadcast_op*).  ``Symbol.__add__``
makes it."""
from __future__ import annotations

from .registry import register


@register("broadcast_add", inputs=("lhs", "rhs"),
          aliases=("_broadcast_plus",))
def _broadcast_add(attrs, a, b):
    return a + b
