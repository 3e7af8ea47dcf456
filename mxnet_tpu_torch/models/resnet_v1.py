"""ResNet v1 (post-activation) symbol (port of
``mxnet_tpu/models/resnet_v1.py``: the same graph and ``tojson()``;
reference example/image-classification/symbols/resnet-v1.py role):
conv-BN-relu units with the relu AFTER the residual add — the original
He et al. 1512.03385 form, vs models/resnet.py's v2 pre-activation."""
from .. import symbol as sym
from ._common import classifier_head, conv_bn, data_input

_DEPTHS = {
    18: ([2, 2, 2, 2], False), 34: ([3, 4, 6, 3], False),
    50: ([3, 4, 6, 3], True), 101: ([3, 4, 23, 3], True),
    152: ([3, 8, 36, 3], True),
}
_WIDTHS_BOTTLE = [256, 512, 1024, 2048]
_WIDTHS_BASIC = [64, 128, 256, 512]


def _cb(x, channels, kernel, stride, pad, name):
    return conv_bn(x, channels, kernel, stride, pad, name, relu=False)


def _unit(x, width, stride, dim_match, bottleneck, name):
    if bottleneck:
        mid = width // 4
        y = sym.Activation(_cb(x, mid, (1, 1), (stride, stride), (0, 0),
                               name + "_c1"), act_type="relu")
        y = sym.Activation(_cb(y, mid, (3, 3), (1, 1), (1, 1),
                               name + "_c2"), act_type="relu")
        y = _cb(y, width, (1, 1), (1, 1), (0, 0), name + "_c3")
    else:
        y = sym.Activation(_cb(x, width, (3, 3), (stride, stride), (1, 1),
                               name + "_c1"), act_type="relu")
        y = _cb(y, width, (3, 3), (1, 1), (1, 1), name + "_c2")
    shortcut = x if dim_match else _cb(x, width, (1, 1),
                                       (stride, stride), (0, 0),
                                       name + "_sc")
    return sym.Activation(y + shortcut, act_type="relu")


def get_symbol(num_classes=1000, num_layers=50, dtype="float32", **kwargs):
    if num_layers not in _DEPTHS:
        raise ValueError("resnet-v1 depth must be one of %s"
                         % sorted(_DEPTHS))
    units, bottleneck = _DEPTHS[num_layers]
    widths = _WIDTHS_BOTTLE if bottleneck else _WIDTHS_BASIC
    x = data_input(dtype)
    x = sym.Activation(_cb(x, 64, (7, 7), (2, 2), (3, 3), "conv0"),
                       act_type="relu")
    x = sym.Pooling(x, kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                    pool_type="max")
    for stage, (n, width) in enumerate(zip(units, widths)):
        for u in range(n):
            x = _unit(x, width, 2 if (u == 0 and stage > 0) else 1,
                      u != 0, bottleneck,
                      "stage%d_unit%d" % (stage + 1, u + 1))
    return classifier_head(x, num_classes, dtype)
