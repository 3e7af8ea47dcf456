"""Inception-v4 symbol (port of ``mxnet_tpu/models/inception_v4.py``: the
same graph and ``tojson()``; reference
example/image-classification/symbols/inception-v4.py role, Szegedy et
al. 1602.07261), expressed as branch tables over the shared conv_bn
builder: each module is a list of branches; a branch is a pool marker or
a sequence of (channels, kernel, stride, pad) conv steps."""
from .. import symbol as sym
from ._common import classifier_head, conv_bn, data_input


def _branch(x, steps, name):
    for j, step in enumerate(steps):
        if step == "avg":
            x = sym.Pooling(x, kernel=(3, 3), stride=(1, 1), pad=(1, 1),
                            pool_type="avg")
        elif step == "max":
            x = sym.Pooling(x, kernel=(3, 3), stride=(2, 2),
                            pool_type="max")
        else:
            c, k, s, p = step
            x = conv_bn(x, c, k, (s, s) if isinstance(s, int) else s,
                        p, "%s_%d" % (name, j))
    return x


def _mix(x, branches, name):
    outs = [_branch(x, steps, "%s_b%d" % (name, i))
            for i, steps in enumerate(branches)]
    return sym.Concat(*outs, dim=1, name=name)


_K1 = lambda c: (c, (1, 1), 1, (0, 0))            # noqa: E731
_K3 = lambda c, s=1, p=(1, 1): (c, (3, 3), s, p)  # noqa: E731
_H17 = lambda c: (c, (1, 7), 1, (0, 3))           # noqa: E731
_V17 = lambda c: (c, (7, 1), 1, (3, 0))           # noqa: E731


def _inception_a(x, name):
    return _mix(x, [
        [_K1(96)],
        [_K1(64), _K3(96)],
        [_K1(64), _K3(96), _K3(96)],
        ["avg", _K1(96)],
    ], name)


def _reduction_a(x, name):
    return _mix(x, [
        [(384, (3, 3), 2, (0, 0))],
        [_K1(192), _K3(224), (256, (3, 3), 2, (0, 0))],
        ["max"],
    ], name)


def _inception_b(x, name):
    return _mix(x, [
        [_K1(384)],
        [_K1(192), _H17(224), _V17(256)],
        [_K1(192), _V17(192), _H17(224), _V17(224), _H17(256)],
        ["avg", _K1(128)],
    ], name)


def _reduction_b(x, name):
    return _mix(x, [
        [_K1(192), (192, (3, 3), 2, (0, 0))],
        [_K1(256), _H17(256), _V17(320), (320, (3, 3), 2, (0, 0))],
        ["max"],
    ], name)


def _inception_c(x, name):
    b2 = _branch(x, [_K1(384)], name + "_b2s")
    b2a = _branch(b2, [(256, (1, 3), 1, (0, 1))], name + "_b2a")
    b2b = _branch(b2, [(256, (3, 1), 1, (1, 0))], name + "_b2b")
    b3 = _branch(x, [_K1(384), (448, (3, 1), 1, (1, 0)),
                     (512, (1, 3), 1, (0, 1))], name + "_b3s")
    b3a = _branch(b3, [(256, (1, 3), 1, (0, 1))], name + "_b3a")
    b3b = _branch(b3, [(256, (3, 1), 1, (1, 0))], name + "_b3b")
    b1 = _branch(x, [_K1(256)], name + "_b1")
    bp = _branch(x, ["avg", _K1(256)], name + "_bp")
    return sym.Concat(b1, b2a, b2b, b3a, b3b, bp, dim=1, name=name)


def get_symbol(num_classes=1000, dtype="float32", **kwargs):
    x = data_input(dtype)
    # stem (299x299 canonical input)
    x = _branch(x, [(32, (3, 3), 2, (0, 0)), (32, (3, 3), 1, (0, 0)),
                    (64, (3, 3), 1, (1, 1))], "stem1")
    x = _mix(x, [["max"], [(96, (3, 3), 2, (0, 0))]], "stem2")
    x = _mix(x, [
        [_K1(64), (96, (3, 3), 1, (0, 0))],
        [_K1(64), _H17(64), _V17(64), (96, (3, 3), 1, (0, 0))],
    ], "stem3")
    x = _mix(x, [[(192, (3, 3), 2, (0, 0))], ["max"]], "stem4")
    for i in range(4):
        x = _inception_a(x, "incA%d" % i)
    x = _reduction_a(x, "redA")
    for i in range(7):
        x = _inception_b(x, "incB%d" % i)
    x = _reduction_b(x, "redB")
    for i in range(3):
        x = _inception_c(x, "incC%d" % i)
    return classifier_head(x, num_classes, dtype, dropout=0.2)
