"""ResNeXt symbol (port of ``mxnet_tpu/models/resnext.py``: the same graph
and ``tojson()``; reference
example/image-classification/symbols/resnext.py role): the aggregated-
transformations bottleneck — a grouped 3x3 between two 1x1s, post-
activation residual units (Xie et al. 1611.05431)."""
from .. import symbol as sym
from ._common import classifier_head, conv_bn, data_input

_DEPTHS = {50: [3, 4, 6, 3], 101: [3, 4, 23, 3], 152: [3, 8, 36, 3]}
_WIDTHS = [256, 512, 1024, 2048]


def _unit(x, width, stride, dim_match, cardinality, bottleneck_width,
          name):
    group_width = cardinality * bottleneck_width * (width // 256)
    y = conv_bn(x, group_width, (1, 1), (1, 1), (0, 0), name + "_conv1")
    y = conv_bn(y, group_width, (3, 3), (stride, stride), (1, 1),
                name + "_conv2", groups=cardinality)
    y = conv_bn(y, width, (1, 1), (1, 1), (0, 0), name + "_conv3",
                relu=False)
    shortcut = x if dim_match else conv_bn(
        x, width, (1, 1), (stride, stride), (0, 0), name + "_sc",
        relu=False)
    return sym.Activation(y + shortcut, act_type="relu")


def get_symbol(num_classes=1000, num_layers=50, cardinality=32,
               bottleneck_width=4, dtype="float32", **kwargs):
    if num_layers not in _DEPTHS:
        raise ValueError("resnext depth must be one of %s"
                         % sorted(_DEPTHS))
    x = data_input(dtype)
    x = conv_bn(x, 64, (7, 7), (2, 2), (3, 3), "conv0")
    x = sym.Pooling(x, kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                    pool_type="max")
    for stage, (n, width) in enumerate(zip(_DEPTHS[num_layers], _WIDTHS)):
        for u in range(n):
            x = _unit(x, width, 2 if (u == 0 and stage > 0) else 1,
                      u != 0, cardinality, bottleneck_width,
                      "stage%d_unit%d" % (stage + 1, u + 1))
    return classifier_head(x, num_classes, dtype)
