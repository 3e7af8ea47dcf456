"""MobileNet v1 symbol (port of ``mxnet_tpu/models/mobilenet.py``: the same
graph and ``tojson()``; reference
example/image-classification/symbols/mobilenet.py role): depthwise-
separable convolutions — a 3x3 grouped conv at full group count followed
by a 1x1 pointwise mix, each BN+relu."""
from ._common import classifier_head, conv_bn, data_input

# (pointwise output channels, depthwise stride); the depthwise width is
# the previous row's output
_ROWS = [(64, 1), (128, 2), (128, 1), (256, 2), (256, 1), (512, 2),
         (512, 1), (512, 1), (512, 1), (512, 1), (512, 1), (1024, 2),
         (1024, 1)]


def get_symbol(num_classes=1000, multiplier=1.0, dtype="float32", **kwargs):
    s = lambda c: max(int(c * multiplier), 8)   # noqa: E731
    x = data_input(dtype)
    x = conv_bn(x, s(32), (3, 3), (2, 2), (1, 1), "conv0")
    width = 32
    for i, (out, stride) in enumerate(_ROWS):
        x = conv_bn(x, s(width), (3, 3), (stride, stride), (1, 1),
                    "dw%d" % i, groups=s(width))
        x = conv_bn(x, s(out), (1, 1), (1, 1), (0, 0), "pw%d" % i)
        width = out
    return classifier_head(x, num_classes, dtype)
