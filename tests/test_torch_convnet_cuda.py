"""The conv-net slice on the card: the convolutions stay float32 when the
caller allows cuDNN's TF32, pooling and BatchNorm at ResNet's shapes
match the CPU, and a ResNet training step on the card matches the same
step on the CPU.

Every test here is marked ``cuda`` and skips without a CUDA device.  The
file imports neither ``jax`` nor ``mxnet_tpu`` (the card's host has only
PyTorch), so it runs there without the repository's conftest::

    python -m pytest tests/test_torch_convnet_cuda.py --noconftest -q
"""
import os
import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from mxnet_tpu_torch import convert  # noqa: E402
from mxnet_tpu_torch.models import resnet  # noqa: E402
from mxnet_tpu_torch.ops.registry import get_op  # noqa: E402
from mxnet_tpu_torch.parallel import ShardedTrainer  # noqa: E402

pytestmark = pytest.mark.cuda

# an f32 convolution's error against a float64 one, relative to the
# largest output: f32 accumulation over C*k*k = 2304 products stays near
# 1e-6; TF32 operands (10-bit mantissas) give about 1e-3
F32_TOL = 2e-5


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _tf32(t):
    """``t`` rounded to TF32 (10 explicit mantissa bits), as a tensor
    core takes an f32 operand."""
    bits = t.float().contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


def _rel(got, want):
    got, want = got.double().cpu(), want.double().cpu()
    return ((got - want).abs().max() / want.abs().max()).item()


@pytest.mark.parametrize("name,attrs,wshape", [
    ("Convolution", dict(kernel=(3, 3), pad=(1, 1), num_filter=128,
                         no_bias=True), (128, 256, 3, 3)),
    ("Deconvolution", dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                           num_filter=128, no_bias=True),
     (256, 128, 3, 3)),
])
def test_conv_stays_f32_when_the_caller_allows_tf32(dev, name, attrs,
                                                    wshape):
    rs = np.random.RandomState(0)
    x = torch.from_numpy(rs.randn(8, 256, 14, 14).astype(np.float32))
    w = torch.from_numpy((rs.randn(*wshape) * 0.05).astype(np.float32))
    op = get_op(name)
    parsed = op.parse_attrs(attrs)
    want = op.fn(parsed, x.double(), w.double())
    saved = torch.backends.cudnn.allow_tf32
    try:
        torch.backends.cudnn.allow_tf32 = True
        got = op.fn(parsed, x.to(dev), w.to(dev))
        torch.cuda.synchronize()
        assert torch.backends.cudnn.allow_tf32 is False
        # the same op over TF32-rounded operands: what a 1xTF32 run
        # computes, whatever algorithm cuDNN would pick
        tf32 = op.fn(parsed, _tf32(x).double(), _tf32(w).double())
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    err, err_tf32 = _rel(got, want), _rel(tf32, want)
    print("%s: card %.3g, 1xTF32 %.3g (tolerance %g)"
          % (name, err, err_tf32, F32_TOL))
    assert err <= F32_TOL
    assert err_tf32 > F32_TOL


@pytest.mark.parametrize("attrs,shape", [
    (dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1)), (32, 64, 112, 112)),
    (dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), layout="NHWC"),
     (32, 112, 112, 64)),
    (dict(kernel=(3, 3), pad=(2, 2)), (4, 16, 15, 15)),
    (dict(kernel=(2, 2), stride=(2, 2), pool_type="avg",
          pooling_convention="full"), (4, 16, 15, 15)),
    (dict(kernel=(7, 7), global_pool=True, pool_type="avg"),
     (32, 2048, 7, 7)),
], ids=["stem-max", "stem-max-nhwc", "pad-past-half", "avg-full",
        "global-avg"])
def test_pooling_on_card_matches_cpu(dev, attrs, shape):
    op = get_op("Pooling")
    parsed = op.parse_attrs(attrs)
    x = torch.from_numpy(np.random.RandomState(1).randn(*shape)
                         .astype(np.float32))
    xc = x.clone().requires_grad_()
    xd = x.to(dev).requires_grad_()
    yd, yc = op.fn(parsed, xd), op.fn(parsed, xc)
    g = torch.from_numpy(np.random.RandomState(2).randn(*yc.shape)
                         .astype(np.float32))
    yd.backward(g.to(dev))
    yc.backward(g)
    assert _rel(yd, yc) <= 1e-6
    assert _rel(xd.grad, xc.grad) <= 1e-6


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
def test_batchnorm_on_card_matches_cpu(dev, layout):
    op = get_op("BatchNorm")
    axis = 1 if layout == "NCHW" else 3
    rs = np.random.RandomState(3)
    shape = (32, 256, 14, 14) if layout == "NCHW" else (32, 14, 14, 256)
    ins = [rs.randn(*shape) * 2 + 0.5, rs.rand(256) + 0.5, rs.randn(256),
           rs.randn(256) * 0.1, rs.rand(256) + 0.5]
    ins = [torch.from_numpy(a.astype(np.float32)) for a in ins]
    g = torch.from_numpy(rs.randn(*shape).astype(np.float32))
    for train in (True, False):
        parsed = op.parse_attrs(dict(fix_gamma=False, eps=2e-5, axis=axis))
        parsed["_train"] = train
        outs = []
        for device in (dev, "cpu"):
            leaves = [t.to(device, copy=True).requires_grad_()
                      for t in ins[:3]]
            res = op.fn(parsed, *leaves, *(t.to(device) for t in ins[3:]))
            res[0].backward(g.to(device))
            outs.append([r.detach() for r in res]
                        + [t.grad for t in leaves])
        for a, b in zip(*outs):
            assert _rel(a, b) <= 1e-5


def test_resnet_step_on_card_matches_cpu(dev):
    """One step of the cifar ResNet-20 at 12x12, batch 8, from one state:
    params, moms and aux within 1e-3 of each tensor's largest change,
    the loss within 1e-4."""
    kw = dict(num_classes=10, num_layers=20, image_shape="3,12,12")
    shapes = {"data": (8, 3, 12, 12), "softmax_label": (8,)}
    cpu = ShardedTrainer(resnet.get_symbol(**kw), device="cpu", lr=0.1)
    card = ShardedTrainer(resnet.get_symbol(**kw), device=dev, lr=0.1)
    start = convert.trainer_state_to_numpy(cpu.init_state(shapes, seed=0))
    names = (cpu.param_names, cpu.prog.aux_names)
    rs = np.random.RandomState(0)
    batch = {"data": rs.randn(8, 3, 12, 12).astype(np.float32),
             "softmax_label": rs.randint(0, 10, 8).astype(np.float32)}
    after = []
    for tr, device in ((cpu, "cpu"), (card, dev)):
        state = convert.trainer_state_from_numpy(names, start, device)
        *state, loss = tr.step(*state, batch)
        after.append((convert.trainer_state_to_numpy(state), float(loss)))
    (c_state, c_loss), (d_state, d_loss) = after
    assert abs(c_loss - d_loss) <= 1e-4 * abs(c_loss)
    for s0, sc, sd in zip(start, c_state, d_state):
        for a0, ac, ad in zip(s0, sc, sd):
            change = max(np.abs(ac - a0).max(), 1e-12)
            assert np.abs(ad - ac).max() <= 1e-3 * change
