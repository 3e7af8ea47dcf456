"""Shared pieces for the symbolic model builders (port of
``mxnet_tpu/models/_common.py``)."""
from .. import symbol as sym


def conv_bn(x, channels, kernel, stride, pad, name, groups=1, relu=True):
    """conv (no bias) -> BatchNorm [-> relu]."""
    x = sym.Convolution(x, num_filter=channels, kernel=kernel,
                        stride=stride, pad=pad, num_group=groups,
                        no_bias=True, name=name)
    x = sym.BatchNorm(x, fix_gamma=False, name=name + "_bn")
    return sym.Activation(x, act_type="relu", name=name + "_relu") \
        if relu else x


def classifier_head(x, num_classes, dtype, dropout=0.0):
    """global avg pool -> flatten [-> dropout] -> FC -> f32 -> softmax."""
    x = sym.Pooling(x, global_pool=True, kernel=(7, 7), pool_type="avg")
    x = sym.Flatten(x)
    if dropout > 0:
        x = sym.Dropout(x, p=dropout)
    x = sym.FullyConnected(x, num_hidden=num_classes, name="fc")
    if dtype != "float32":
        x = sym.Cast(x, dtype="float32")
    return sym.SoftmaxOutput(x, name="softmax")


def data_input(dtype):
    x = sym.Variable("data")
    if dtype != "float32":
        x = sym.Cast(x, dtype=dtype)
    return x
