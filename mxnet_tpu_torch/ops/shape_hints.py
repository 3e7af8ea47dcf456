"""Parameter-shape inference hooks (port of
``mxnet_tpu/ops/shape_hints.py``: the LM graph's, the conv nets' and
loss heads' of ``ops/nn.py``, and the ``RNN`` op's packed blob and
states).

Output shapes come from running each op on ``meta`` tensors; this module
supplies only the missing direction: for ops with learnable inputs, a hook
computing the parameter shapes from the known input shapes and attrs.

Hook signature: ``fn(attrs, in_shapes: list[tuple|None]) -> {input_idx:
shape}``.
"""
from __future__ import annotations

import numpy as np

from .registry import get_op
from .rnn import rnn_param_size


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


def _conv(attrs, shapes):
    data = shapes[0]
    g = attrs.get("num_group", 1)
    if attrs.get("layout") == "NHWC":
        out = {1: (attrs["num_filter"],) + tuple(attrs["kernel"])
               + (data[-1] // g,)}
    else:
        out = {1: (attrs["num_filter"], data[1] // g)
               + tuple(attrs["kernel"])}
    if not attrs.get("no_bias", False):
        out[2] = (attrs["num_filter"],)
    return out


def _deconv(attrs, shapes):
    data = shapes[0]
    g = attrs.get("num_group", 1)
    out = {1: (data[1], attrs["num_filter"] // g) + tuple(attrs["kernel"])}
    if not attrs.get("no_bias", False):
        out[2] = (attrs["num_filter"],)
    return out


def _bn(attrs, shapes):
    c = shapes[0][attrs.get("axis", 1)]
    return {1: (c,), 2: (c,), 3: (c,), 4: (c,)}


def _in_norm(attrs, shapes):
    c = shapes[0][1]
    return {1: (c,), 2: (c,)}


def _layer_norm(attrs, shapes):
    c = shapes[0][attrs.get("axis", -1)]
    return {1: (c,), 2: (c,)}


def _embedding(attrs, shapes):
    return {1: (attrs["input_dim"], attrs["output_dim"])}


def _rnn(attrs, shapes):
    data = shapes[0]
    L = attrs["num_layers"]
    d = 2 if attrs.get("bidirectional", False) else 1
    h = attrs["state_size"]
    n = rnn_param_size(L, data[2], h, attrs.get("bidirectional", False),
                       attrs["mode"])
    out = {1: (n,), 2: (L * d, data[1], h)}
    if attrs["mode"] == "lstm":
        out[3] = (L * d, data[1], h)
    return out


def _prelu(attrs, shapes):
    if attrs.get("act_type") == "prelu":
        data = shapes[0]
        return {1: (data[1] if len(data) > 1 else 1,)}
    return {}


def _softmax_output_label(attrs, shapes):
    data = shapes[0]
    if attrs.get("multi_output", False):
        return {1: (data[0],) + tuple(data[2:])}
    if attrs.get("preserve_shape", False):
        return {1: tuple(data[:-1])}
    return {1: (data[0],)}


def _label_like_data(attrs, shapes):
    return {1: tuple(shapes[0])}


def _svm_label(attrs, shapes):
    return {1: (shapes[0][0],)}


def install():
    get_op("SoftmaxOutput").infer_params = _softmax_output_label
    get_op("LinearRegressionOutput").infer_params = _label_like_data
    get_op("MAERegressionOutput").infer_params = _label_like_data
    get_op("LogisticRegressionOutput").infer_params = _label_like_data
    get_op("SVMOutput").infer_params = _svm_label
    get_op("FullyConnected").infer_params = _fc
    get_op("Convolution").infer_params = _conv
    get_op("Deconvolution").infer_params = _deconv
    get_op("BatchNorm").infer_params = _bn
    get_op("InstanceNorm").infer_params = _in_norm
    get_op("LayerNorm").infer_params = _layer_norm
    get_op("Embedding").infer_params = _embedding
    get_op("_contrib_SparseEmbedding").infer_params = _embedding
    get_op("RNN").infer_params = _rnn
    get_op("LeakyReLU").infer_params = _prelu


install()
