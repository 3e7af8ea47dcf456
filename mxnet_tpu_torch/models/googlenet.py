"""GoogLeNet / Inception-BN symbol (port of
``mxnet_tpu/models/googlenet.py``: the same graph and ``tojson()``;
reference
example/image-classification/symbols/{googlenet,inception-bn}.py role):
inception modules with BN after every conv, built from a branch table
like the Gluon Inception3."""
from .. import symbol as sym
from ._common import classifier_head, conv_bn, data_input


def _cbr(x, channels, kernel, stride, pad, name):
    return conv_bn(x, channels, kernel, stride, pad, name)


def _inception(x, c1, c3r, c3, c5r, c5, pool_proj, name):
    """Classic 4-branch module: 1x1 | 1x1-3x3 | 1x1-5x5 | pool-1x1."""
    b1 = _cbr(x, c1, (1, 1), (1, 1), (0, 0), name + "_1x1")
    b3 = _cbr(x, c3r, (1, 1), (1, 1), (0, 0), name + "_3x3r")
    b3 = _cbr(b3, c3, (3, 3), (1, 1), (1, 1), name + "_3x3")
    b5 = _cbr(x, c5r, (1, 1), (1, 1), (0, 0), name + "_5x5r")
    b5 = _cbr(b5, c5, (5, 5), (1, 1), (2, 2), name + "_5x5")
    bp = sym.Pooling(x, kernel=(3, 3), stride=(1, 1), pad=(1, 1),
                     pool_type="max")
    bp = _cbr(bp, pool_proj, (1, 1), (1, 1), (0, 0), name + "_proj")
    return sym.Concat(b1, b3, b5, bp, dim=1, name=name + "_out")


# (c1, c3r, c3, c5r, c5, pool_proj) per module; "P" = 3x2 maxpool
_MODULES = [
    (64, 96, 128, 16, 32, 32), (128, 128, 192, 32, 96, 64), "P",
    (192, 96, 208, 16, 48, 64), (160, 112, 224, 24, 64, 64),
    (128, 128, 256, 24, 64, 64), (112, 144, 288, 32, 64, 64),
    (256, 160, 320, 32, 128, 128), "P",
    (256, 160, 320, 32, 128, 128), (384, 192, 384, 48, 128, 128),
]


def get_symbol(num_classes=1000, dtype="float32", **kwargs):
    x = data_input(dtype)
    x = _cbr(x, 64, (7, 7), (2, 2), (3, 3), "conv1")
    x = sym.Pooling(x, kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                    pool_type="max")
    x = _cbr(x, 64, (1, 1), (1, 1), (0, 0), "conv2r")
    x = _cbr(x, 192, (3, 3), (1, 1), (1, 1), "conv2")
    x = sym.Pooling(x, kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                    pool_type="max")
    for i, spec in enumerate(_MODULES):
        if spec == "P":
            x = sym.Pooling(x, kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                            pool_type="max")
        else:
            x = _inception(x, *spec, name="mix%d" % i)
    return classifier_head(x, num_classes, dtype, dropout=0.4)
