"""bench.py's training configuration in the port against the JAX package:
bf16 parameters (``ShardedTrainer(param_dtype="bfloat16")``), the raw step
(``sgd_step_fn``) and the auto-layout step (``build_step_auto_layout``),
with the weights carried across by ``convert`` bit for bit
(mxnet_tpu_torch/parallel/trainer.py vs mxnet_tpu/parallel/trainer.py).

Models: the tiny LM of tests/test_torch_train.py (vocab 12, T 16, L1,
hidden 16, heads 2) on the einsum path and on the flash path
(``flash_min_seq`` 1: the JAX package's Pallas kernels in interpret mode,
the port's plain versions of B9), and the cifar ResNet-20 at 12x12 built
with ``dtype="bfloat16"`` (its data is cast to bf16, so inference gives
every convolution and batch norm parameter bf16).

Tolerances, and why:

* The update rule is the reference's ``_tree_sgd`` rounding for
  rounding: bit-equal to it run op by op.  Inside ``jit`` XLA:CPU fuses
  the same expressions and contracts ``momentum*m - lr*g`` (and the
  ``wd*p`` sum) into fused multiply-adds, so the compiled reference
  differs from its own op-by-op form in the last bits; the port follows
  the op-by-op form.
* Two bf16 steps cannot agree bit for bit: XLA rounds bf16 chains at
  other places than PyTorch's CPU kernels, which compute each op in f32
  and round once (gelu, softmax, a bias add after a matmul, the einsum
  attention, avg pooling and the convolution's bias gradient differ by
  up to 4 bf16 steps at an output's largest magnitude:
  ``test_bf16_ops_match_jax`` states them).  So each trained tensor is held norm-wise to the
  reference's OWN bf16 rounding gap: ``|port - jax| / |jax - start|``
  at most 3x ``|jax_bf16 - jax_f32| / |jax_f32 - start|`` (the same
  weights and batches trained in f32 by the JAX package), and at least
  one bf16 step (2^-8).  Two independent roundings of one size stand
  about sqrt(2) of it apart.
* The f32 raw and auto-layout steps are bit-equal to
  ``ShardedTrainer.step`` (the step calls the raw step), except that a
  conv net's channels-last weights take other convolution algorithms:
  rtol 2e-4 / atol 2e-5 there, test_torch_convnet.py's f32 bar.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import ml_dtypes
from mxnet_tpu.models import resnet as jax_resnet
from mxnet_tpu.models.transformer import get_symbol as jax_get_symbol
from mxnet_tpu.parallel.mesh import MeshSpec as JaxMeshSpec
from mxnet_tpu.parallel.mesh import make_mesh as jax_make_mesh
from mxnet_tpu.parallel.trainer import ShardedTrainer as JaxTrainer
from mxnet_tpu.parallel.trainer import _tree_sgd as jax_tree_sgd
from mxnet_tpu_torch import convert
from mxnet_tpu_torch.base import DeviceUnavailable, MXNetError
from mxnet_tpu_torch.models import resnet
from mxnet_tpu_torch.models.transformer import get_symbol
from mxnet_tpu_torch.parallel import ShardedTrainer
from mxnet_tpu_torch.parallel.trainer import _tree_sgd, sgd_step_fn

TINY = dict(vocab_size=12, seq_len=16, num_layers=1, hidden=16, heads=2)
LM_SHAPES = {"data": (8, 16), "softmax_label": (8, 16)}
RESNET = dict(num_classes=10, num_layers=20, image_shape="3,12,12")
RESNET_SHAPES = {"data": (4, 3, 12, 12), "softmax_label": (4,)}
HP = dict(lr=0.1, momentum=0.9, wd=1e-4)
GAP_FACTOR = 3.0
BF16_STEP = 2.0 ** -8


def _lm_batches(n=2, seed=11):
    rs = np.random.RandomState(seed)
    return [{"data": rs.randint(0, 12, (8, 16)).astype(np.float32),
             "softmax_label": rs.randint(0, 12, (8, 16)).astype(np.float32)}
            for _ in range(n)]


def _resnet_batches(n=2, seed=0):
    rs = np.random.RandomState(seed)
    return [{"data": rs.randn(4, 3, 12, 12).astype(np.float32),
             "softmax_label": rs.randint(0, 10, 4).astype(np.float32)}
            for _ in range(n)]


def _bits(a):
    """A host array (ml_dtypes bf16 or f32) as a tensor of the same
    bits."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).view(np.int16).copy()) \
            .view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _jax_trainer(symbol, param_dtype, shapes, seed):
    jt = JaxTrainer(symbol, JaxMeshSpec(jax_make_mesh((1,), ("dp",))),
                    param_dtype=param_dtype, **HP)
    return jt, jt.init_state(shapes, seed=seed)


def _train(trainer, state, batches):
    loss = None
    for b in batches:
        *state, loss = trainer.step(*state, b)
    return tuple(state), float(loss)


def _host(state):
    return tuple(tuple(np.asarray(a) for a in part) for part in state)


def _gap_check(names, start, port, jax_bf16, jax_f32):
    """Every tensor of the three parts within GAP_FACTOR of the
    reference's own bf16 gap (module docstring); returns the worst
    ratio of the two gaps."""
    worst = 0.0
    for part, part_names in zip(range(3), names):
        for n, s0, p, j, f in zip(part_names, start[part], port[part],
                                  jax_bf16[part], jax_f32[part]):
            s0, f = s0.astype(np.float64), np.asarray(f, np.float64)
            j = np.asarray(j).astype(np.float64)
            p = np.asarray(p, np.float64)
            gap = np.linalg.norm(p - j) / max(np.linalg.norm(j - s0), 1e-30)
            own = np.linalg.norm(j - f) / max(np.linalg.norm(f - s0), 1e-30)
            bound = GAP_FACTOR * max(own, BF16_STEP)
            assert gap <= bound, (n, gap, own)
            worst = max(worst, gap / max(own, BF16_STEP))
    return worst


def _state_dtypes(state):
    return [str(t.dtype).replace("torch.", "") for t in state[0]]


# ---------------------------------------------------------------------------
# the update rule and the weights carried across
# ---------------------------------------------------------------------------

def test_tree_sgd_is_the_references_rounding_for_rounding():
    """bf16 and f32 parameters, f32 momentum, wd != 0 and a rescale that
    is no power of two: params and momentum bit-equal to the reference's
    ``_tree_sgd`` op by op, whether the verdict is a device tensor or a
    bool read on the host; a False verdict leaves every tensor as it
    was, NaN included."""
    rs = np.random.RandomState(0)
    shapes = [(64, 32), (32,), (7, 5, 3), (300,)]
    dts = [ml_dtypes.bfloat16, np.float32, ml_dtypes.bfloat16, np.float32]
    P = [rs.randn(*s).astype(d) for s, d in zip(shapes, dts)]
    G = [(rs.randn(*s) * 3).astype(d) for s, d in zip(shapes, dts)]
    M = [(rs.randn(*s) * 0.1).astype(np.float32) for s in shapes]
    lr, momentum, wd, scale = 0.37, 0.9, 1e-2, 3.0
    jp, jm = jax_tree_sgd(tuple(map(jnp.asarray, P)),
                          tuple(map(jnp.asarray, G)),
                          tuple(map(jnp.asarray, M)), lr, momentum, wd,
                          1.0 / jnp.float32(scale))
    tp, tm = [_bits(a) for a in P], [_bits(a) for a in M]
    _tree_sgd(tp, [_bits(a) for a in G], tm, lr, momentum, wd,
              1.0 / torch.tensor(scale), torch.tensor(True))
    # a verdict the caller read on the host: in place, the same bits
    hp, hm = [_bits(a) for a in P], [_bits(a) for a in M]
    _tree_sgd(hp, [_bits(a) for a in G], hm, lr, momentum, wd,
              1.0 / torch.tensor(scale), True)
    for a, b in zip(tp + tm, hp + hm):
        assert a.dtype == b.dtype and torch.equal(a, b)
    for t, j, d in zip(tp, jp, dts):
        assert t.dtype == (torch.bfloat16 if d is ml_dtypes.bfloat16
                           else torch.float32)
        np.testing.assert_array_equal(t.float().numpy(),
                                      np.asarray(j).astype(np.float32))
    for t, j in zip(tm, jm):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    # a bad step: nothing moves
    before = [t.clone() for t in tp + tm]
    tp[0][0, 0] = float("nan")
    before[0][0, 0] = float("nan")
    _tree_sgd(tp, [_bits(a) for a in G], tm, lr, momentum, wd,
              1.0 / torch.tensor(scale), torch.tensor(False))
    for a, b in zip(tp + tm, before):
        assert torch.equal(a, b) or (torch.isnan(a) == torch.isnan(b)).all()


def test_convert_carries_bf16_weights_bit_for_bit():
    """A JAX bf16 trainer state (ml_dtypes arrays) crosses into the port
    as bf16 tensors with the same bits, and back as exact f32 arrays
    whose bf16 cast gives those bits again."""
    jt, jstate = _jax_trainer(jax_get_symbol(**TINY), "bfloat16",
                              LM_SHAPES, seed=5)
    host = _host(jstate)
    names = (jt.param_names, jt.prog.aux_names)
    tstate = convert.trainer_state_from_numpy(names, host, "cpu")
    back = convert.trainer_state_to_numpy(tstate)
    for part, t_part, b_part in zip(host, tstate, back):
        for a, t, b in zip(part, t_part, b_part):
            if a.dtype.name == "bfloat16":
                assert t.dtype == torch.bfloat16 and b.dtype == np.float32
                np.testing.assert_array_equal(
                    t.view(torch.int16).numpy().view(np.uint16),
                    a.view(np.uint16))
                np.testing.assert_array_equal(
                    b.astype(ml_dtypes.bfloat16).view(np.uint16),
                    a.view(np.uint16))
            else:
                assert t.dtype == torch.float32
                np.testing.assert_array_equal(b, a)
    with pytest.raises(MXNetError):
        convert.trainer_state_from_numpy(
            names, (host[0], tuple(m.astype(np.float16) for m in host[1]),
                    host[2]), "cpu")


# ---------------------------------------------------------------------------
# init_state's dtypes (C13)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("model,param_dtype", [
    ("lm", "bfloat16"), ("resnet-bf16-graph", None),
    ("resnet-bf16-graph", "bfloat16")])
def test_init_state_dtypes_match_jax(model, param_dtype):
    """Each parameter takes its inferred dtype (a ResNet built with
    ``dtype="bfloat16"`` casts its data, so its convolution weights and
    its BatchNorm gamma and beta are bf16), then ``param_dtype``'s cast
    of every name but gamma/beta (the LM's LayerNorm gamma and beta stay
    f32); momentum and aux are f32: as in the JAX package, whose own
    state's bf16 draws are the port's f32 draws rounded."""
    if model == "lm":
        jsym, tsym, shapes = (jax_get_symbol(**TINY), get_symbol(**TINY),
                              LM_SHAPES)
    else:
        jsym = jax_resnet.get_symbol(dtype="bfloat16", **RESNET)
        tsym = resnet.get_symbol(dtype="bfloat16", **RESNET)
        shapes = RESNET_SHAPES
    jt, jstate = _jax_trainer(jsym, param_dtype, shapes, seed=0)
    tt = ShardedTrainer(tsym, device="cpu", param_dtype=param_dtype, **HP)
    p, m, x = tt.init_state(shapes, seed=0)
    assert tt.param_names == jt.param_names
    assert _state_dtypes((p,)) == [str(np.asarray(a).dtype)
                                   for a in jstate[0]]
    assert all(t.dtype == torch.float32 for t in m + x)
    want = {n: ("float32" if model == "lm" and n.endswith(("gamma", "beta"))
                else "bfloat16") for n in tt.param_names}
    assert dict(zip(tt.param_names, _state_dtypes((p,)))) == want
    # the bf16 values are the f32 draws rounded to nearest even
    f32 = ShardedTrainer(tsym, device="cpu", **HP).init_state(shapes,
                                                               seed=0)[0]
    f32 = [t.float() for t in f32]
    for a, b in zip(p, f32):
        assert torch.equal(a, b.to(a.dtype))


def test_bf16_trainer_needs_a_device_or_the_card():
    """Without a card and without ``device="cpu"`` the bf16 trainer
    raises DeviceUnavailable, as every entry point of the port does."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(DeviceUnavailable):
        ShardedTrainer(get_symbol(**TINY), param_dtype="bfloat16")


# ---------------------------------------------------------------------------
# two bf16 steps against the JAX package
# ---------------------------------------------------------------------------

def _bf16_pair(jsym, tsym, jsym_f32, shapes, batches, seed):
    """Two steps of the JAX bf16 trainer, of the JAX f32 trainer from the
    same weights (upcast), and of the port's bf16 trainer from the bf16
    weights carried across; returns (names, start, port, jax, jax_f32,
    losses)."""
    jt, jstate = _jax_trainer(jsym, "bfloat16", shapes, seed)
    jf, _ = _jax_trainer(jsym_f32, None, shapes, seed)
    tt = ShardedTrainer(tsym, device="cpu", param_dtype="bfloat16", **HP)
    host = _host(jstate)
    names = (jt.param_names, jt.param_names, jt.prog.aux_names)
    tstate = convert.trainer_state_from_numpy(
        (jt.param_names, jt.prog.aux_names), host, "cpu",
        order=(tt.param_names, tt.prog.aux_names))
    assert tt.param_names == jt.param_names
    assert _state_dtypes(tstate) == [str(a.dtype) for a in host[0]]
    start = tuple(tuple(a.astype(np.float32) for a in part)
                  for part in host)
    fstate = tuple(tuple(jnp.asarray(a) for a in part) for part in start)
    jstate, jloss = _train(jt, jstate, batches)
    fstate, _ = _train(jf, fstate, batches)
    tstate, tloss = _train(tt, tstate, batches)
    assert _state_dtypes(tstate) == [str(np.asarray(a).dtype)
                                     for a in jstate[0]]
    return (names, start, convert.trainer_state_to_numpy(tstate),
            _host(jstate), _host(fstate), (tloss, jloss))


@pytest.mark.parametrize("flash_min_seq", [10000, 1],
                         ids=["einsum-path", "flash-path"])
def test_bf16_lm_steps_match_jax(flash_min_seq):
    net = dict(TINY, flash_min_seq=flash_min_seq)
    names, start, port, jax_bf16, jax_f32, (tloss, jloss) = _bf16_pair(
        jax_get_symbol(**net), get_symbol(**net), jax_get_symbol(**net),
        LM_SHAPES, _lm_batches(), seed=5)
    _gap_check(names, start, port, jax_bf16, jax_f32)
    # the summed SoftmaxOutput "loss": N*T probabilities of one, each
    # rounded to bf16 before the f32 sum
    assert tloss == pytest.approx(jloss, rel=1e-2)
    assert tloss == pytest.approx(8 * 16, rel=1e-2)


def test_bf16_resnet20_steps_match_jax():
    names, start, port, jax_bf16, jax_f32, (tloss, jloss) = _bf16_pair(
        jax_resnet.get_symbol(dtype="bfloat16", **RESNET),
        resnet.get_symbol(dtype="bfloat16", **RESNET),
        jax_resnet.get_symbol(**RESNET), RESNET_SHAPES, _resnet_batches(),
        seed=3)
    _gap_check(names, start, port, jax_bf16, jax_f32)
    assert tloss == pytest.approx(jloss, rel=1e-2)


# ---------------------------------------------------------------------------
# the raw step and the auto-layout step
# ---------------------------------------------------------------------------

def _run(mode, trainer, shapes, batches, seed=3):
    p, m, x = trainer.init_state(shapes, seed=seed)
    if mode == "step":
        for b in batches:
            p, m, x, loss = trainer.step(p, m, x, b)
        return p, m, x
    if mode == "raw":
        step = sgd_step_fn(trainer)
    else:
        step, p, m, x = trainer.build_step_auto_layout(p, m, x, shapes)
    keys, guard = trainer._keys(), trainer._guard_arrays()
    for b in batches:
        b = {n: torch.from_numpy(v) for n, v in b.items()}
        p, m, x, loss, ok, guard = step(p, m, x, b, keys, guard)
        assert ok.dtype == torch.bool and bool(ok)
    assert guard[0].dtype == torch.float32 and guard[1].dtype == torch.int32
    assert int(guard[1]) == len(batches)
    return p, m, x


@pytest.mark.parametrize("param_dtype", [None, "bfloat16", "float16"],
                         ids=["f32", "bf16", "f16"])
def test_raw_and_auto_layout_lm_steps_equal_the_step(param_dtype):
    """The LM (no convolution, so the auto layout re-lays nothing): the
    raw and auto-layout steps give the step's state bit for bit."""
    net = dict(TINY, flash_min_seq=1)
    got = {mode: _run(mode, ShardedTrainer(get_symbol(**net), device="cpu",
                                           param_dtype=param_dtype, **HP),
                      LM_SHAPES, _lm_batches())
           for mode in ("step", "raw", "auto")}
    for mode in ("raw", "auto"):
        for a, b in zip(sum(got[mode], ()), sum(got["step"], ())):
            assert a.dtype == b.dtype and torch.equal(a, b)


def test_auto_layout_resnet_is_channels_last_and_matches_the_step():
    """Every convolution weight and its momentum come back channels-last
    and stay so through the steps; the f32 state equals the step's
    within test_torch_convnet.py's f32 bar (other convolution
    algorithms), the raw step's bit for bit."""
    sym = resnet.get_symbol(**RESNET)
    got = {mode: _run(mode, ShardedTrainer(sym, device="cpu", **HP),
                      RESNET_SHAPES, _resnet_batches())
           for mode in ("step", "raw", "auto")}
    tr = ShardedTrainer(sym, device="cpu", **HP)
    conv = tr._conv_weights()
    assert len(conv) == 22            # 19 3x3 and three 1x1 shortcuts
    p, m, _ = got["auto"]
    for i, (a, b) in enumerate(zip(p, m)):
        for t in (a, b):
            assert t.is_contiguous(memory_format=torch.channels_last) \
                if i in conv else t.is_contiguous()
            if i in conv and t.shape[-1] > 1:
                assert not t.is_contiguous()
    for a, b in zip(sum(got["raw"], ()), sum(got["step"], ())):
        assert torch.equal(a, b)
    for a, b in zip(sum(got["auto"], ()), sum(got["step"], ())):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-4,
                                   atol=2e-5)


def test_auto_layout_step_takes_the_shapes_and_dtypes_it_was_built_for():
    """As the reference's compiled step: ``input_dtypes`` (the bench's
    IO path feeds uint8) and ``batch_shapes`` are what it accepts."""
    sym = resnet.get_symbol(dtype="bfloat16", **RESNET)
    tr = ShardedTrainer(sym, device="cpu", param_dtype="bfloat16", **HP)
    state = tr.init_state(RESNET_SHAPES, seed=0)
    step, p, m, x = tr.build_step_auto_layout(
        *state, RESNET_SHAPES, input_dtypes={"data": np.uint8})
    rs = np.random.RandomState(1)
    data = torch.from_numpy(rs.randint(0, 256, (4, 3, 12, 12))
                            .astype(np.uint8))
    label = torch.from_numpy(rs.randint(0, 10, 4).astype(np.float32))
    keys, guard = tr._keys(), tr._guard_arrays()
    p, m, x, loss, ok, guard = step(p, m, x, {"data": data,
                                              "softmax_label": label},
                                    keys, guard)
    assert bool(ok) and torch.isfinite(loss)
    with pytest.raises(MXNetError):
        step(p, m, x, {"data": data.float(), "softmax_label": label}, keys,
             guard)
    with pytest.raises(MXNetError):
        step(p, m, x, {"data": data[:2], "softmax_label": label[:2]}, keys,
             guard)


def test_raw_step_skips_a_nonfinite_update_on_the_device():
    """A NaN weight: ``ok`` is False, params, momentum and aux come back
    unchanged (the NaN where it was), and the dynamic loss scale halves,
    all as tensors the step never read on the host."""
    sym = resnet.get_symbol(dtype="bfloat16", **RESNET)
    tr = ShardedTrainer(sym, device="cpu", param_dtype="bfloat16",
                        dynamic_loss_scale=True, loss_scale=8.0, **HP)
    p, m, x = tr.init_state(RESNET_SHAPES, seed=0)
    p[tr.param_names.index("conv0_weight")][0, 0, 0, 0] = float("nan")
    before = [t.clone() for t in p + m + x]
    step = sgd_step_fn(tr)
    b = {n: torch.from_numpy(v) for n, v in _resnet_batches(1)[0].items()}
    p, m, x, loss, ok, guard = step(p, m, x, b, tr._keys(),
                                    tr._guard_arrays())
    assert not bool(ok)
    for a, c in zip(p + m + x, before):
        assert torch.equal(torch.nan_to_num(a), torch.nan_to_num(c))
    assert float(guard[0]) == 4.0 and int(guard[1]) == 0


# ---------------------------------------------------------------------------
# the ops of the bf16 path against the JAX ops in bf16
# ---------------------------------------------------------------------------

def _bf16_steps(got, want):
    """Largest difference in bf16 steps at the reference's largest
    magnitude (one step = 2^-7 of its power of two)."""
    got, want = got.astype(np.float64), want.astype(np.float64)
    top = max(float(np.abs(want).max()), 2.0 ** -126)
    return float(np.abs(got - want).max()) / 2.0 ** (np.floor(np.log2(top))
                                                     - 7)


# name, inputs (numpy f32), kinds ("b": bf16, "f": f32), attrs, the inputs
# to differentiate, and the bound of the output's and of each gradient's
# difference, in bf16 steps at the reference's largest magnitude: 0 where
# both packages round at the same places; where they do not, the largest
# difference found rounded up to a whole step, and its cause
def _bf16_op_cases():
    rs = np.random.RandomState(0)
    ids = rs.randint(0, 10, (4, 6)).astype(np.float32)
    return [
        ("FullyConnected:no-bias", [rs.randn(4, 32), rs.randn(8, 32) * 0.2],
         "bb", dict(num_hidden=8, no_bias=True), [0, 1], [0, 0, 0]),
        # PyTorch adds the bias inside the matmul before its one rounding,
        # XLA rounds the product and then the sum
        ("FullyConnected", [rs.randn(4, 32), rs.randn(8, 32) * 0.2,
                            rs.randn(8)], "bbb", dict(num_hidden=8),
         [0, 1, 2], [1, 0, 0, 1]),
        ("Embedding", [ids, rs.randn(10, 8)], "fb",
         dict(input_dim=10, output_dim=8), [1], [0, 0]),
        ("LayerNorm", [rs.randn(4, 16) * 2 + 1, rs.rand(16) + 0.5,
                       rs.randn(16)], "bff", {}, [0, 1, 2], [0, 0, 0.01, 0.01]),
        # F.gelu computes erf in f32 and rounds once; the reference's
        # jax.nn.gelu rounds 0.5*x, -x*sqrt(0.5), erfc and the product
        ("Activation:gelu", [rs.randn(4, 16) * 2], "b",
         dict(act_type="gelu"), [0], [1, 1]),
        ("broadcast_add", [rs.randn(4, 16), rs.randn(1, 16)], "bb", {},
         [0, 1], [0, 0, 1]),
        ("Cast", [rs.randn(4, 16)], "f", dict(dtype="bfloat16"), [0],
         [0, 0]),
        # torch.softmax in f32 with one rounding; jax.nn.softmax rounds
        # exp, the sum and the quotient
        ("SoftmaxOutput", [rs.randn(8, 10) * 3,
                           rs.randint(0, 10, 8).astype(np.float32)], "bf",
         {}, [0], [1, 1]),
        ("BatchNorm", [rs.randn(2, 4, 5, 5) * 1.5 + 0.5, rs.rand(4) + 0.5,
                       rs.randn(4), np.zeros(4), np.ones(4)], "bbbff",
         dict(fix_gamma=False, eps=2e-5), [0, 1, 2], [0, 0, 0, 0]),
        ("Pooling:max", [rs.randn(2, 4, 6, 6)], "b",
         dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1)), [0], [0, 0]),
        # the reference sums the window in bf16, ATen in f32
        ("Pooling:global-avg", [rs.randn(2, 4, 6, 6)], "b",
         dict(kernel=(6, 6), global_pool=True, pool_type="avg"), [0],
         [2, 0]),
        # the convolution's bias: added after the product's rounding, and
        # its gradient summed in bf16, by XLA
        ("Convolution", [rs.randn(2, 3, 8, 8), rs.randn(4, 3, 3, 3) * 0.3,
                         rs.randn(4)], "bbb",
         dict(kernel=(3, 3), pad=(1, 1), num_filter=4), [0, 1, 2],
         [1, 0, 0, 4]),
        # the flash path: the plain versions of B9 against the Pallas
        # kernels in interpret mode, f32 inside both
        ("_contrib_fused_attention:flash",
         [rs.randn(2, 16, 2, 8), rs.randn(2, 16, 2, 8),
          rs.randn(2, 16, 2, 8)], "bbb", dict(causal=True, flash_min_seq=1),
         [0, 1, 2], [0, 0, 0, 0]),
        # the einsum path (T < flash_min_seq): the scores and the softmax
        # rounded at other places
        ("_contrib_fused_attention:einsum",
         [rs.randn(2, 16, 2, 8), rs.randn(2, 16, 2, 8),
          rs.randn(2, 16, 2, 8)], "bbb", dict(causal=True), [0, 1, 2],
         [2, 2, 2, 1]),
    ]


BF16_OP_CASES = _bf16_op_cases()


@pytest.mark.parametrize("case", BF16_OP_CASES,
                         ids=[c[0] for c in BF16_OP_CASES])
def test_bf16_ops_match_jax(case):
    """Each op of the bf16 path, forward and gradient, in bf16 on both
    sides from the same bf16 inputs: the port's result has the
    reference's dtype, and stands from it at most the stated number of
    bf16 steps (0 where both round at the same places)."""
    import jax
    from mxnet_tpu.ops.registry import get_op as jax_get_op
    from mxnet_tpu_torch.ops.registry import get_op
    key, ins, kinds, attrs, diff, bounds = case
    name = key.split(":")[0]
    jins = [jnp.asarray(np.asarray(x, np.float32),
                        jnp.bfloat16 if k == "b" else jnp.float32)
            for x, k in zip(ins, kinds)]
    tins = [torch.from_numpy(np.asarray(x, np.float32)).to(
        torch.bfloat16 if k == "b" else torch.float32)
        for x, k in zip(ins, kinds)]
    jop, top = jax_get_op(name), get_op(name)
    jattrs, tattrs = jop.parse_attrs(dict(attrs)), top.parse_attrs(
        dict(attrs))

    def first(*xs):
        full = list(jins)
        for i, x in zip(diff, xs):
            full[i] = x
        out = jop.fn(jattrs, *full)
        return out[0] if isinstance(out, tuple) else out

    y, vjp = jax.vjp(first, *[jins[i] for i in diff])
    g = np.random.RandomState(1).randn(*y.shape).astype(np.float32)
    jgrads = vjp(jnp.asarray(g, y.dtype))
    leaves = list(tins)
    for i in diff:
        leaves[i] = leaves[i].clone().requires_grad_()
    out = top.fn(tattrs, *leaves)
    out = out[0] if isinstance(out, tuple) else out
    out.backward(torch.from_numpy(g).to(out.dtype))
    got = [out.detach()] + [leaves[i].grad for i in diff]
    want = [y] + list(jgrads)
    for t, j, bound in zip(got, want, bounds):
        j = np.asarray(j)
        assert str(t.dtype).replace("torch.", "") == str(j.dtype)
        steps = _bf16_steps(t.float().numpy(), j.astype(np.float32))
        assert steps <= bound, (key, steps, bound)


def test_importing_the_ops_sets_the_low_precision_matmul_policy():
    """ATen lets cuBLAS reduce bf16/f16 products in their own precision;
    importing the port's ops turns that off once, before any op runs,
    so every low-precision product accumulates in f32 to the end as the
    reference's do, whichever op ran first (a fresh interpreter: this
    one has imported the ops already)."""
    code = ("import torch\n"
            "import mxnet_tpu_torch.ops\n"
            "m = torch.backends.cuda.matmul\n"
            "print(m.allow_bf16_reduced_precision_reduction,"
            " m.allow_fp16_reduced_precision_reduction)\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=root, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["False", "False"]
