"""Parameter-shape inference hooks (port of the hooks of
``mxnet_tpu/ops/shape_hints.py`` that the LM graph needs).

Output shapes come from running each op on ``meta`` tensors; this module
supplies only the missing direction: for ops with learnable inputs, a hook
computing the parameter shapes from the known input shapes and attrs.

Hook signature: ``fn(attrs, in_shapes: list[tuple|None]) -> {input_idx:
shape}``.
"""
from __future__ import annotations

import numpy as np

from .registry import get_op


def _fc(attrs, shapes):
    data = shapes[0]
    if attrs.get("flatten", True):
        in_dim = int(np.prod(data[1:]))
    else:
        in_dim = data[-1]
    out = {1: (attrs["num_hidden"], in_dim)}
    if not attrs.get("no_bias", False):
        out[2] = (attrs["num_hidden"],)
    return out


def _layer_norm(attrs, shapes):
    c = shapes[0][attrs.get("axis", -1)]
    return {1: (c,), 2: (c,)}


def _embedding(attrs, shapes):
    return {1: (attrs["input_dim"], attrs["output_dim"])}


def _softmax_output_label(attrs, shapes):
    data = shapes[0]
    if attrs.get("multi_output", False):
        return {1: (data[0],) + tuple(data[2:])}
    if attrs.get("preserve_shape", False):
        return {1: tuple(data[:-1])}
    return {1: (data[0],)}


def install():
    get_op("SoftmaxOutput").infer_params = _softmax_output_label
    get_op("FullyConnected").infer_params = _fc
    get_op("LayerNorm").infer_params = _layer_norm
    get_op("Embedding").infer_params = _embedding


install()
