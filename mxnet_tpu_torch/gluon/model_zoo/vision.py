"""Gluon vision model zoo (port of ``mxnet_tpu/gluon/model_zoo/vision.py``,
unchanged over the port's layers).

Reference analog: python/mxnet/gluon/model_zoo/vision/{resnet,vgg,
alexnet,squeezenet,densenet,mobilenet,inception}.py.  Rebuilt here in a
single declarative style: every family is a data table (stage widths,
repeat counts, fire/branch specs) consumed by a handful of builders —
``_cba`` (conv[+BN][+act]), ``_stack``, residual units, and the
Inception branch DSL.  No pretrained weights ship in this environment;
``pretrained=True`` raises.
"""
from __future__ import annotations

from .. import nn
from ..block import HybridBlock
from ..contrib.nn import HybridConcurrent

__all__ = ["get_model", "resnet18_v1", "resnet34_v1", "resnet50_v1",
           "resnet101_v1", "resnet152_v1", "resnet18_v2", "resnet34_v2",
           "resnet50_v2", "resnet101_v2", "resnet152_v2", "vgg11", "vgg13",
           "vgg16", "vgg19", "vgg11_bn", "vgg13_bn", "vgg16_bn", "vgg19_bn",
           "alexnet", "squeezenet1_0", "squeezenet1_1", "densenet121",
           "densenet161", "densenet169", "densenet201", "mobilenet1_0",
           "mobilenet0_75", "mobilenet0_5", "mobilenet0_25", "get_resnet",
           "get_vgg", "get_mobilenet", "AlexNet", "SqueezeNet", "DenseNet",
           "MobileNet", "ResNetV1", "ResNetV2", "VGG", "Inception3",
           "inception_v3", "HybridConcurrent"]


# -- shared builders --------------------------------------------------------

def _stack(*parts):
    seq = nn.HybridSequential(prefix="")
    for p in parts:
        seq.add(p)
    return seq


def _cba(channels, kernel=1, stride=1, pad=0, groups=1, act="relu",
         bn=True, bias=None, bn_eps=1e-5):
    """conv [+ BatchNorm] [+ activation]; bias defaults to not-bn."""
    seq = nn.HybridSequential(prefix="")
    seq.add(nn.Conv2D(channels, kernel_size=kernel, strides=stride,
                      padding=pad, groups=groups,
                      use_bias=not bn if bias is None else bias))
    if bn:
        seq.add(nn.BatchNorm(epsilon=bn_eps))
    if act:
        seq.add(nn.Activation(act))
    return seq


def _no_pretrained(flag):
    if flag:
        raise RuntimeError("pretrained weights are unavailable in this "
                           "environment (no network); initialize instead")


# -- ResNet -----------------------------------------------------------------
#
# Depth table: repeats per stage, stage output widths, bottleneck?.
# The unit plans are (channels, kernel, stride, pad) conv steps; v1 units
# are post-activation (conv-bn-relu body, relu after the add), v2 units
# are pre-activation (bn-relu before every conv, clean add).

_RESNET_DEPTHS = {
    18:  ([2, 2, 2, 2],  [64, 64, 128, 256, 512],     False),
    34:  ([3, 4, 6, 3],  [64, 64, 128, 256, 512],     False),
    50:  ([3, 4, 6, 3],  [64, 256, 512, 1024, 2048],  True),
    101: ([3, 4, 23, 3], [64, 256, 512, 1024, 2048],  True),
    152: ([3, 8, 36, 3], [64, 256, 512, 1024, 2048],  True),
}


def _unit_plan(width, stride, bottleneck, preact):
    if not bottleneck:
        return [(width, 3, stride, 1), (width, 3, 1, 1)]
    mid = width // 4
    if preact:     # v2 strides on the middle 3x3
        return [(mid, 1, 1, 0), (mid, 3, stride, 1), (width, 1, 1, 0)]
    return [(mid, 1, stride, 0), (mid, 3, 1, 1), (width, 1, 1, 0)]


class _UnitV1(HybridBlock):
    """Post-activation residual unit (He et al. 2015)."""

    def __init__(self, width, stride, bottleneck, rewire, in_width,
                 **kwargs):
        super().__init__(**kwargs)
        plan = _unit_plan(width, stride, bottleneck, preact=False)
        self.body = _stack(*[
            _cba(c, k, s, p, act="relu" if i + 1 < len(plan) else None)
            for i, (c, k, s, p) in enumerate(plan)])
        self.skip = _cba(width, 1, stride, act=None) if rewire else None

    def hybrid_forward(self, F, x):
        route = x if self.skip is None else self.skip(x)
        return F.Activation(self.body(x) + route, act_type="relu")


class _UnitV2(HybridBlock):
    """Pre-activation residual unit (He et al. 2016): bn-relu precedes
    each conv, and the first pre-activation also feeds the shortcut."""

    def __init__(self, width, stride, bottleneck, rewire, in_width,
                 **kwargs):
        super().__init__(**kwargs)
        plan = _unit_plan(width, stride, bottleneck, preact=True)
        self._n = len(plan)
        for i, (c, k, s, p) in enumerate(plan):
            setattr(self, "norm%d" % i, nn.BatchNorm())
            setattr(self, "conv%d" % i,
                    nn.Conv2D(c, kernel_size=k, strides=s, padding=p,
                              use_bias=False))
        self.skip = (nn.Conv2D(width, 1, stride, use_bias=False)
                     if rewire else None)

    def hybrid_forward(self, F, x):
        pre = F.Activation(self.norm0(x), act_type="relu")
        route = x if self.skip is None else self.skip(pre)
        y = self.conv0(pre)
        for i in range(1, self._n):
            y = F.Activation(getattr(self, "norm%d" % i)(y),
                             act_type="relu")
            y = getattr(self, "conv%d" % i)(y)
        return y + route


class _ResNetBase(HybridBlock):
    _unit = None       # set by subclass
    _preact_stem = False

    def __init__(self, depth_spec, classes=1000, thumbnail=False, **kwargs):
        super().__init__(**kwargs)
        repeats, widths, bottleneck = depth_spec
        with self.name_scope():
            feats = nn.HybridSequential(prefix="")
            if self._preact_stem:
                feats.add(nn.BatchNorm(scale=False, center=False))
            if thumbnail:
                feats.add(_cba(widths[0], 3, 1, 1, act=None, bn=False,
                               bias=False))
            else:
                feats.add(_cba(widths[0], 7, 2, 3, bias=False,
                               act=None if self._preact_stem else "relu",
                               bn=not self._preact_stem))
                if self._preact_stem:
                    # v2 stem still normalizes before pooling
                    feats.add(nn.BatchNorm())
                    feats.add(nn.Activation("relu"))
                feats.add(nn.MaxPool2D(3, 2, 1))
            carry = widths[0]
            for stage, (n, width) in enumerate(zip(repeats, widths[1:]), 1):
                block = nn.HybridSequential(prefix="stage%d_" % stage)
                with block.name_scope():
                    block.add(self._unit(width, 1 if stage == 1 else 2,
                                         bottleneck, rewire=width != carry,
                                         in_width=carry, prefix=""))
                    for _ in range(n - 1):
                        block.add(self._unit(width, 1, bottleneck,
                                             rewire=False, in_width=width,
                                             prefix=""))
                feats.add(block)
                carry = width
            if self._preact_stem:
                feats.add(nn.BatchNorm())
                feats.add(nn.Activation("relu"))
            feats.add(nn.GlobalAvgPool2D())
            if self._preact_stem:
                feats.add(nn.Flatten())
            self.features = feats
            self.output = nn.Dense(classes, in_units=carry)

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


def _is_bottleneck(block, channels):
    """Honor a legacy block argument when its name tells us the unit
    kind; otherwise infer from the stage-width table."""
    name = getattr(block, "__name__", "").lower()
    if "bottle" in name:
        return True
    if "basic" in name:
        return False
    return channels[1] != channels[0]


class ResNetV1(_ResNetBase):
    _unit = _UnitV1

    def __init__(self, block, layers, channels, classes=1000,
                 thumbnail=False, **kwargs):
        # legacy (block, layers, channels) signature kept for parity
        super().__init__((layers, channels, _is_bottleneck(block, channels)),
                         classes=classes, thumbnail=thumbnail, **kwargs)


class ResNetV2(_ResNetBase):
    _unit = _UnitV2
    _preact_stem = True

    def __init__(self, block, layers, channels, classes=1000,
                 thumbnail=False, **kwargs):
        super().__init__((layers, channels, _is_bottleneck(block, channels)),
                         classes=classes, thumbnail=thumbnail, **kwargs)


def get_resnet(version, num_layers, pretrained=False, ctx=None, **kwargs):
    if num_layers not in _RESNET_DEPTHS:
        raise ValueError("no resnet-%s; depths: %s"
                         % (num_layers, sorted(_RESNET_DEPTHS)))
    if version not in (1, 2):
        raise ValueError("resnet version must be 1 or 2")
    _no_pretrained(pretrained)
    repeats, widths, _ = _RESNET_DEPTHS[num_layers]
    cls = ResNetV1 if version == 1 else ResNetV2
    return cls(None, repeats, widths, **kwargs)


def _resnet_factory(version, depth):
    def build(**kwargs):
        return get_resnet(version, depth, **kwargs)
    build.__name__ = "resnet%d_v%d" % (depth, version)
    return build


resnet18_v1 = _resnet_factory(1, 18)
resnet34_v1 = _resnet_factory(1, 34)
resnet50_v1 = _resnet_factory(1, 50)
resnet101_v1 = _resnet_factory(1, 101)
resnet152_v1 = _resnet_factory(1, 152)
resnet18_v2 = _resnet_factory(2, 18)
resnet34_v2 = _resnet_factory(2, 34)
resnet50_v2 = _resnet_factory(2, 50)
resnet101_v2 = _resnet_factory(2, 101)
resnet152_v2 = _resnet_factory(2, 152)


# -- VGG --------------------------------------------------------------------
# Stage widths are fixed; depth only changes per-stage conv counts.

_VGG_WIDTHS = [64, 128, 256, 512, 512]
_VGG_COUNTS = {11: [1, 1, 2, 2, 2], 13: [2, 2, 2, 2, 2],
               16: [2, 2, 3, 3, 3], 19: [2, 2, 4, 4, 4]}


class VGG(HybridBlock):
    def __init__(self, layers, filters, classes=1000, batch_norm=False,
                 **kwargs):
        super().__init__(**kwargs)
        assert len(layers) == len(filters)
        with self.name_scope():
            feats = nn.HybridSequential(prefix="")
            for count, width in zip(layers, filters):
                for _ in range(count):
                    feats.add(_cba(width, 3, 1, 1, bn=batch_norm, bias=True))
                feats.add(nn.MaxPool2D(strides=2))
            for _ in range(2):
                feats.add(nn.Dense(4096, activation="relu",
                                   weight_initializer="normal"))
                feats.add(nn.Dropout(rate=0.5))
            self.features = feats
            self.output = nn.Dense(classes, weight_initializer="normal")

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


def get_vgg(num_layers, pretrained=False, **kwargs):
    _no_pretrained(pretrained)
    return VGG(_VGG_COUNTS[num_layers], _VGG_WIDTHS, **kwargs)


def _vgg_factory(depth, bn):
    def build(**kwargs):
        if bn:
            kwargs["batch_norm"] = True
        return get_vgg(depth, **kwargs)
    build.__name__ = "vgg%d%s" % (depth, "_bn" if bn else "")
    return build


vgg11, vgg13, vgg16, vgg19 = (_vgg_factory(d, False)
                              for d in (11, 13, 16, 19))
vgg11_bn, vgg13_bn, vgg16_bn, vgg19_bn = (_vgg_factory(d, True)
                                          for d in (11, 13, 16, 19))


# -- AlexNet ----------------------------------------------------------------

_ALEX_CONVS = [(64, 11, 4, 2, True), (192, 5, 1, 2, True),
               (384, 3, 1, 1, False), (256, 3, 1, 1, False),
               (256, 3, 1, 1, True)]


class AlexNet(HybridBlock):
    def __init__(self, classes=1000, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            feats = nn.HybridSequential(prefix="")
            with feats.name_scope():
                for width, k, s, p, pool in _ALEX_CONVS:
                    feats.add(_cba(width, k, s, p, bn=False, bias=True))
                    if pool:
                        feats.add(nn.MaxPool2D(pool_size=3, strides=2))
                feats.add(nn.Flatten())
                for _ in range(2):
                    feats.add(nn.Dense(4096, activation="relu"))
                    feats.add(nn.Dropout(0.5))
            self.features = feats
            self.output = nn.Dense(classes)

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


def alexnet(pretrained=False, **kwargs):
    _no_pretrained(pretrained)
    return AlexNet(**kwargs)


# -- SqueezeNet -------------------------------------------------------------
# Layout tables: "P" = 3x2 ceil maxpool, tuples are fire modules
# (squeeze, expand1x1, expand3x3).

_SQUEEZE_LAYOUTS = {
    "1.0": [(96, 7, 2), "P", (16, 64, 64), (16, 64, 64), (32, 128, 128),
            "P", (32, 128, 128), (48, 192, 192), (48, 192, 192),
            (64, 256, 256), "P", (64, 256, 256)],
    "1.1": [(64, 3, 2), "P", (16, 64, 64), (16, 64, 64), "P",
            (32, 128, 128), (32, 128, 128), "P", (48, 192, 192),
            (48, 192, 192), (64, 256, 256), (64, 256, 256)],
}


def _fire(squeeze, e1, e3):
    expand = HybridConcurrent(axis=1)
    expand.add(_cba(e1, 1, bn=False, bias=True))
    expand.add(_cba(e3, 3, pad=1, bn=False, bias=True))
    return _stack(_cba(squeeze, 1, bn=False, bias=True), expand)


class SqueezeNet(HybridBlock):
    def __init__(self, version, classes=1000, **kwargs):
        super().__init__(**kwargs)
        if version not in _SQUEEZE_LAYOUTS:
            raise ValueError("squeezenet version must be '1.0' or '1.1'")
        with self.name_scope():
            feats = nn.HybridSequential(prefix="")
            for i, part in enumerate(_SQUEEZE_LAYOUTS[version]):
                if part == "P":
                    feats.add(nn.MaxPool2D(3, 2, ceil_mode=True))
                elif i == 0:     # the stem conv: (channels, kernel, stride)
                    feats.add(_cba(part[0], part[1], part[2],
                                   bn=False, bias=True))
                else:
                    feats.add(_fire(*part))
            feats.add(nn.Dropout(0.5))
            self.features = feats
            self.output = _stack(
                _cba(classes, 1, bn=False, bias=True),
                nn.GlobalAvgPool2D(), nn.Flatten())

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


def squeezenet1_0(pretrained=False, **kwargs):
    _no_pretrained(pretrained)
    return SqueezeNet("1.0", **kwargs)


def squeezenet1_1(pretrained=False, **kwargs):
    _no_pretrained(pretrained)
    return SqueezeNet("1.1", **kwargs)


# -- DenseNet ---------------------------------------------------------------

_DENSE_CONFIGS = {121: (64, 32, [6, 12, 24, 16]),
                  161: (96, 48, [6, 12, 36, 24]),
                  169: (64, 32, [6, 12, 32, 32]),
                  201: (64, 32, [6, 12, 48, 32])}


class _DenseUnit(HybridBlock):
    """BN-relu-1x1 then BN-relu-3x3, concatenated onto the input."""

    def __init__(self, growth, bn_size, dropout, **kwargs):
        super().__init__(**kwargs)
        tail = [nn.Dropout(dropout)] if dropout else []
        self.body = _stack(
            nn.BatchNorm(), nn.Activation("relu"),
            nn.Conv2D(bn_size * growth, kernel_size=1, use_bias=False),
            nn.BatchNorm(), nn.Activation("relu"),
            nn.Conv2D(growth, kernel_size=3, padding=1, use_bias=False),
            *tail)

    def hybrid_forward(self, F, x):
        return F.Concat(x, self.body(x), dim=1)


class DenseNet(HybridBlock):
    def __init__(self, num_init_features, growth_rate, block_config,
                 bn_size=4, dropout=0, classes=1000, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            feats = _stack(
                nn.Conv2D(num_init_features, kernel_size=7, strides=2,
                          padding=3, use_bias=False),
                nn.BatchNorm(), nn.Activation("relu"),
                nn.MaxPool2D(pool_size=3, strides=2, padding=1))
            width = num_init_features
            for stage, n in enumerate(block_config, 1):
                block = nn.HybridSequential(prefix="stage%d_" % stage)
                with block.name_scope():
                    for _ in range(n):
                        block.add(_DenseUnit(growth_rate, bn_size, dropout))
                feats.add(block)
                width += n * growth_rate
                if stage < len(block_config):
                    width //= 2     # transition halves channels + spatial
                    feats.add(_stack(
                        nn.BatchNorm(), nn.Activation("relu"),
                        nn.Conv2D(width, kernel_size=1, use_bias=False),
                        nn.AvgPool2D(pool_size=2, strides=2)))
            feats.add(nn.BatchNorm())
            feats.add(nn.Activation("relu"))
            feats.add(nn.GlobalAvgPool2D())
            feats.add(nn.Flatten())
            self.features = feats
            self.output = nn.Dense(classes)

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


def _densenet_factory(depth):
    def build(pretrained=False, **kwargs):
        _no_pretrained(pretrained)
        return DenseNet(*_DENSE_CONFIGS[depth], **kwargs)
    build.__name__ = "densenet%d" % depth
    return build


densenet121 = _densenet_factory(121)
densenet161 = _densenet_factory(161)
densenet169 = _densenet_factory(169)
densenet201 = _densenet_factory(201)


# -- MobileNet (v1) ---------------------------------------------------------
# Each row: (separable-out-channels, stride); depthwise width = previous
# row's output.

_MOBILENET_ROWS = [(64, 1), (128, 2), (128, 1), (256, 2), (256, 1),
                   (512, 2), (512, 1), (512, 1), (512, 1), (512, 1),
                   (512, 1), (1024, 2), (1024, 1)]


class MobileNet(HybridBlock):
    def __init__(self, multiplier=1.0, classes=1000, **kwargs):
        super().__init__(**kwargs)
        scale = lambda c: int(c * multiplier)   # noqa: E731
        with self.name_scope():
            feats = nn.HybridSequential(prefix="")
            with feats.name_scope():
                feats.add(_cba(scale(32), 3, 2, 1))
                carry = 32
                for out, stride in _MOBILENET_ROWS:
                    # depthwise 3x3 at the incoming width...
                    feats.add(_cba(scale(carry), 3, stride, 1,
                                   groups=scale(carry)))
                    # ...then pointwise up to the row width
                    feats.add(_cba(scale(out)))
                    carry = out
                feats.add(nn.GlobalAvgPool2D())
                feats.add(nn.Flatten())
            self.features = feats
            self.output = nn.Dense(classes)

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


def get_mobilenet(multiplier, pretrained=False, **kwargs):
    _no_pretrained(pretrained)
    return MobileNet(multiplier, **kwargs)


def _mobilenet_factory(multiplier, tag):
    def build(**kwargs):
        return get_mobilenet(multiplier, **kwargs)
    build.__name__ = "mobilenet" + tag
    return build


mobilenet1_0 = _mobilenet_factory(1.0, "1_0")
mobilenet0_75 = _mobilenet_factory(0.75, "0_75")
mobilenet0_5 = _mobilenet_factory(0.5, "0_5")
mobilenet0_25 = _mobilenet_factory(0.25, "0_25")


# -- Inception v3 -----------------------------------------------------------
# Built from a declarative branch table: each mixing block is a list of
# branches; a branch is an optional pool marker followed by
# (channels, kernel, stride, pad) conv steps.

def _bn_conv(channels, kernel, stride=1, pad=0):
    return _cba(channels, kernel, stride, pad, bn_eps=0.001)


def _inc_branch(steps):
    seq = nn.HybridSequential(prefix="")
    for step in steps:
        if step == "avg":
            seq.add(nn.AvgPool2D(pool_size=3, strides=1, padding=1))
        elif step == "max":
            seq.add(nn.MaxPool2D(pool_size=3, strides=2))
        else:
            seq.add(_bn_conv(*step))
    return seq


def _inc_mix(branches, axis=1):
    cat = HybridConcurrent(axis=axis)
    for steps in branches:
        cat.add(steps if isinstance(steps, HybridBlock)
                else _inc_branch(steps))
    return cat


def _mix_a(pool_features):
    return _inc_mix([
        [(64, 1)],
        [(48, 1), (64, 5, 1, 2)],
        [(64, 1), (96, 3, 1, 1), (96, 3, 1, 1)],
        ["avg", (pool_features, 1)],
    ])


def _mix_b():
    return _inc_mix([
        [(384, 3, 2)],
        [(64, 1), (96, 3, 1, 1), (96, 3, 2)],
        ["max"],
    ])


def _mix_c(c7):
    return _inc_mix([
        [(192, 1)],
        [(c7, 1), (c7, (1, 7), 1, (0, 3)), (192, (7, 1), 1, (3, 0))],
        [(c7, 1), (c7, (7, 1), 1, (3, 0)), (c7, (1, 7), 1, (0, 3)),
         (c7, (7, 1), 1, (3, 0)), (192, (1, 7), 1, (0, 3))],
        ["avg", (192, 1)],
    ])


def _mix_d():
    return _inc_mix([
        [(192, 1), (320, 3, 2)],
        [(192, 1), (192, (1, 7), 1, (0, 3)), (192, (7, 1), 1, (3, 0)),
         (192, 3, 2)],
        ["max"],
    ])


def _split_conv(channels):
    """The E-block 1x3/3x1 fan-out pair."""
    return _inc_mix([
        [(channels, (1, 3), 1, (0, 1))],
        [(channels, (3, 1), 1, (1, 0))],
    ])


def _mix_e():
    b3 = _stack(_bn_conv(384, 1), _split_conv(384))
    b3d = _stack(_bn_conv(448, 1), _bn_conv(384, 3, 1, 1),
                 _split_conv(384))
    return _inc_mix([
        [(320, 1)],
        b3,
        b3d,
        ["avg", (192, 1)],
    ])


class Inception3(HybridBlock):
    """Inception v3 ("Rethinking the Inception Architecture", 1512.00567;
    reference inception.py Inception3)."""

    def __init__(self, classes=1000, **kwargs):
        super().__init__(**kwargs)
        stem = [
            _bn_conv(32, 3, 2), _bn_conv(32, 3), _bn_conv(64, 3, 1, 1),
            nn.MaxPool2D(pool_size=3, strides=2),
            _bn_conv(80, 1), _bn_conv(192, 3),
            nn.MaxPool2D(pool_size=3, strides=2),
        ]
        mixes = [
            _mix_a(32), _mix_a(64), _mix_a(64),
            _mix_b(),
            _mix_c(128), _mix_c(160), _mix_c(160), _mix_c(192),
            _mix_d(),
            _mix_e(), _mix_e(),
        ]
        self.features = _stack(*(stem + mixes))
        self.features.add(nn.AvgPool2D(pool_size=8))
        self.features.add(nn.Dropout(0.5))
        self.output = nn.Dense(classes)

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


def inception_v3(pretrained=False, ctx=None, **kwargs):
    _no_pretrained(pretrained)
    return Inception3(**kwargs)


# -- registry ---------------------------------------------------------------

_models = {}
for _fn in (resnet18_v1, resnet34_v1, resnet50_v1, resnet101_v1,
            resnet152_v1, resnet18_v2, resnet34_v2, resnet50_v2,
            resnet101_v2, resnet152_v2, vgg11, vgg13, vgg16, vgg19,
            vgg11_bn, vgg13_bn, vgg16_bn, vgg19_bn, alexnet,
            densenet121, densenet161, densenet169, densenet201,
            inception_v3):
    _models[_fn.__name__] = _models[_fn.__name__.replace("_v3", "v3")] = _fn
for _tag, _fn in (("1.0", squeezenet1_0), ("1.1", squeezenet1_1)):
    _models["squeezenet" + _tag] = _fn
for _tag, _fn in (("1.0", mobilenet1_0), ("0.75", mobilenet0_75),
                  ("0.5", mobilenet0_5), ("0.25", mobilenet0_25)):
    _models["mobilenet" + _tag] = _fn


def get_model(name, **kwargs):
    """Look a model builder up by zoo name (reference
    model_zoo/__init__.py get_model)."""
    key = name.lower()
    if key not in _models:
        raise ValueError("Model %s is not supported. Available options "
                         "are\n\t%s" % (name, "\n\t".join(sorted(_models))))
    return _models[key](**kwargs)
