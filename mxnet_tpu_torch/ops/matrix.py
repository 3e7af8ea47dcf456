"""Shape-manipulation and indexing ops of the LM graph (port of the
``Reshape``, ``expand_dims`` and ``Embedding`` ops of
``mxnet_tpu/ops/matrix.py``; reference src/operator/tensor/matrix_op*,
indexing_op.h)."""
from __future__ import annotations

import numpy as np

from ..base import attr_bool, attr_dtype, attr_int, attr_shape
from .registry import register

__all__ = ["infer_reshape"]


# ---------------------------------------------------------------------------
# Reshape with MXNet's special codes (matrix_op-inl.h ReshapeParam):
#  0 -> copy input dim; -1 -> infer; -2 -> copy all remaining dims;
# -3 -> merge next two input dims; -4 -> split one input dim into next two
# ---------------------------------------------------------------------------

def infer_reshape(ishape, target, reverse=False):
    """Pure-python resolution of the target shape; shared with the Symbol
    layer."""
    if reverse:
        ishape = tuple(reversed(ishape))
        target = tuple(reversed(target))
    out = []
    src = list(ishape)
    i = 0  # position in src
    t = 0
    while t < len(target):
        code = target[t]
        if code == 0:
            out.append(src[i])
            i += 1
        elif code == -1:
            out.append(-1)
            i += 1
        elif code == -2:
            out.extend(src[i:])
            i = len(src)
        elif code == -3:
            out.append(src[i] * src[i + 1])
            i += 2
        elif code == -4:
            d1, d2 = target[t + 1], target[t + 2]
            if d1 == -1:
                d1 = src[i] // d2
            if d2 == -1:
                d2 = src[i] // d1
            out.extend([d1, d2])
            i += 1
            t += 2
        else:
            out.append(code)
            if i < len(src):
                i += 1
        t += 1
    if -1 in out:
        known = int(np.prod([d for d in out if d != -1])) or 1
        total = int(np.prod(ishape)) if ishape else 1
        out[out.index(-1)] = total // known
    if reverse:
        out = list(reversed(out))
    return tuple(out)


@register("Reshape", inputs=("data",),
          params=dict(shape=attr_shape(()), reverse=attr_bool(False),
                      target_shape=attr_shape(None),
                      keep_highest=attr_bool(False)),
          aliases=("reshape",))
def _reshape(attrs, x):
    if attrs.shape:
        tgt = infer_reshape(tuple(x.shape), attrs.shape, attrs.reverse)
    elif attrs.target_shape is not None:  # legacy
        tgt = attrs.target_shape
        if attrs.keep_highest:
            tgt = (x.shape[0],) + tuple(tgt)[1:]
    else:
        tgt = (-1,)
    return x.reshape(tgt)


@register("expand_dims", inputs=("data",),
          params=dict(axis=attr_int(required=True)))
def _expand_dims(attrs, x):
    axis = attrs.axis if attrs.axis >= 0 else attrs.axis + x.dim() + 1
    return x.unsqueeze(axis)


@register("Embedding", inputs=("data", "weight"),
          params=dict(input_dim=attr_int(required=True),
                      output_dim=attr_int(required=True),
                      dtype=attr_dtype("float32"),
                      sparse_grad=attr_bool(False)))
def _embedding(attrs, idx, weight):
    """``weight[idx]``; ids arrive as floats and truncate to integers, as
    the reference's ``astype(int32)``."""
    import torch.nn.functional as F
    return F.embedding(idx.long(), weight)
