"""Training in float16 with the port against the JAX package, on the CPU:
the f16 flash-attention plain versions (B9 f16's oracles) against the JAX
Pallas kernels in interpret mode, ``Module.fit`` of a float16 ResNet
through multi-precision SGD and a two-bit ``KVStore("device")`` (B10's
path), and ``ShardedTrainer(param_dtype="float16")`` steps of the LM on
the flash path with a dynamic loss scale.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances, and why:

* flash plain versions: both compute in f32 from the same f16 inputs and
  round to f16, so an element may land one f16 step apart (2^-10 of its
  magnitude) on top of the f32 kernels' tolerances (1e-5 for out and
  lse, 1e-4 for the gradients, x max(1, max|ref|)):
  ``chip_smoke.lowp_close``, as the card holds the kernels;
* training: f16 chains round at other places in XLA and in PyTorch's CPU
  kernels, so each trained tensor is held norm-wise to the reference's
  OWN f16 rounding gap: ``|port - jax| / |jax - start|`` at most 3x
  ``|jax_f16 - jax_f32| / |jax_f32 - start|`` (the same weights and
  batches trained by the JAX package in f32), and at least one f16 step
  (2^-11), as tests/test_torch_train_bf16.py holds bf16.
"""
import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import mxnet_tpu as jmx
from mxnet_tpu import kvstore as jkv
from mxnet_tpu import lr_scheduler as jls
from mxnet_tpu.models import resnet as jax_resnet
from mxnet_tpu.models.transformer import get_symbol as jax_get_symbol
from mxnet_tpu.ops import pallas_kernels as pk
from mxnet_tpu.parallel.mesh import MeshSpec as JaxMeshSpec
from mxnet_tpu.parallel.mesh import make_mesh as jax_make_mesh
from mxnet_tpu.parallel.trainer import ShardedTrainer as JaxTrainer
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import convert
from mxnet_tpu_torch import kvstore as tkv
from mxnet_tpu_torch.models import resnet
from mxnet_tpu_torch.models.transformer import get_symbol
from mxnet_tpu_torch.ops import kernels
from mxnet_tpu_torch.parallel import ShardedTrainer

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from chip_smoke import lowp_close  # noqa: E402

GAP_FACTOR = 3.0
F16_STEP = 2.0 ** -11


def _gap(start, port, jax_f16, jax_f32):
    """``|port - jax| / |jax - start|`` and the reference's own gap
    ``|jax_f16 - jax_f32| / |jax_f32 - start|``, norm-wise in f64."""
    s0, p, j, f = (np.asarray(a, np.float64) for a in (start, port,
                                                       jax_f16, jax_f32))
    gap = np.linalg.norm(p - j) / max(np.linalg.norm(j - s0), 1e-30)
    own = np.linalg.norm(j - f) / max(np.linalg.norm(f - s0), 1e-30)
    return gap, own


def _gap_check(named):
    """``named``: name -> (start, port, jax_f16, jax_f32); every tensor
    within GAP_FACTOR of the reference's own f16 gap."""
    worst = 0.0
    for n, (s0, p, j, f) in named.items():
        gap, own = _gap(s0, p, j, f)
        assert gap <= GAP_FACTOR * max(own, F16_STEP), (n, gap, own)
        worst = max(worst, gap / max(own, F16_STEP))
    return worst


# ---------------------------------------------------------------------------
# the f16 flash plain versions against the JAX Pallas kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("shape", [(2, 48, 2, 64), (1, 37, 2, 128)],
                         ids=["t48-d64", "t37-d128"])
def test_f16_flash_plain_versions_match_jax_pallas(shape, causal):
    rs = np.random.RandomState(sum(shape))
    q, k, v, do = (rs.randn(*shape).astype(np.float16) for _ in range(4))
    out, lse = pk.fused_attention_fwd(q, k, v, causal=causal)
    jdq, jdk, jdv = pk.fused_attention_bwd(q, k, v, out, lse, do,
                                           causal=causal)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    t_out, t_lse = kernels.flash_attention_fwd(tq, tk, tv, causal=causal)
    assert t_out.dtype == torch.float16 and t_lse.dtype == torch.float32
    assert lowp_close(torch, t_out, torch.from_numpy(np.asarray(out)),
                      1e-5)[0] <= 1.0
    np.testing.assert_allclose(t_lse.numpy(), np.asarray(lse)[..., 0],
                               rtol=1e-5, atol=1e-5)
    delta = kernels.flash_delta(t_out, tdo)
    dq = kernels.flash_attention_bwd_dq(tq, tk, tv, tdo, t_lse, delta,
                                        causal)
    dk, dv = kernels.flash_attention_bwd_dkv(tq, tk, tv, tdo, t_lse, delta,
                                             causal)
    for got, want in zip((dq, dk, dv), (jdq, jdk, jdv)):
        assert got.dtype == torch.float16
        assert lowp_close(torch, got, torch.from_numpy(np.asarray(want)),
                          1e-4)[0] <= 1.0


def test_f16_flash_attention_op_takes_the_flash_path_above_the_threshold():
    """``_contrib_fused_attention`` in f16 at T >= flash_min_seq goes
    through ``kernels.flash_attention`` (here its plain versions), below
    it through the einsum; both in f16, both differentiable."""
    from mxnet_tpu_torch.ops.registry import get_op
    op = get_op("_contrib_fused_attention")
    rs = np.random.RandomState(0)
    q, k, v = (torch.from_numpy(rs.randn(2, 32, 2, 16).astype(np.float16))
               .requires_grad_() for _ in range(3))
    calls = []
    orig = kernels.flash_attention

    def spy(*a, **kw):
        calls.append(a[0].dtype)
        return orig(*a, **kw)

    kernels.flash_attention = spy
    try:
        for fms, want in ((16, 1), (64, 0)):
            calls.clear()
            out = op.fn(op.parse_attrs(dict(causal=True, flash_min_seq=fms)),
                        q, k, v)
            out.float().sum().backward()
            assert out.dtype == torch.float16 and len(calls) == want
    finally:
        kernels.flash_attention = orig


# ---------------------------------------------------------------------------
# Module.fit of a float16 ResNet: multi-precision SGD, 2-bit store
# ---------------------------------------------------------------------------

RESNET = dict(num_classes=10, num_layers=20, image_shape="3,28,28")


def _module_fit(pkg, kv_mod, kv_kw, net, args, auxs, X, y, ls_mod,
                multi_precision=True):
    mod = pkg.mod.Module(net, context=pkg.cpu(), compression_params={
        "type": "2bit", "threshold": 0.5})
    sched = ls_mod.MultiFactorScheduler([1], 0.1)
    mod.fit(pkg.io.NDArrayIter(X, y, batch_size=4),
            kvstore=kv_mod.create("device", **kv_kw), optimizer="sgd",
            optimizer_params={"learning_rate": 0.1, "momentum": 0.9,
                              "wd": 1e-4, "multi_precision": multi_precision,
                              "lr_scheduler": sched},
            arg_params=args, aux_params=auxs,
            eval_metric=[pkg.metric.Accuracy(), pkg.metric.CrossEntropy(),
                         pkg.metric.TopKAccuracy(top_k=5)],
            num_epoch=1)
    return mod


def test_module_fit_f16_resnet_multi_precision_two_bit_matches_jax(
        monkeypatch):
    """Two batches of the cifar ResNet-20 (12x12) built with
    ``dtype="float16"``: the JAX Module's Xavier start carried across by
    ``convert`` bit for bit (f16 weights, gamma and beta; the moving
    statistics f16 at the start and f32 after a training forward, C14),
    then ``Module.fit`` with multi-precision SGD, a MultiFactorScheduler
    and a 2-bit ``KVStore("device")`` in both packages; the JAX package
    again on the f32 net from the same weights for its own gap.

    Every push is recorded (in the f32 run too).  The reference's own f16
    gradients stand ~8% (norm-wise) from its f32 ones at the first push,
    whose weights are the same on all three sides (f16 BatchNorm
    statistics over a batch of 4 and an f16 softmax): the port's first
    gradients are held to 3x that gap.  ``q`` is equal except where the
    two packages' ``g + r`` differ by enough to carry it across +-t (the
    difference of their gradients and residuals), ``q + new_r`` equals
    ``g + r`` on each side within one f16 step, and the residuals are
    f16.  The weights: each tensor within 3x the reference's own f16 gap
    on the elements whose ``q`` agreed at every push, the others within
    the updates a flip can move them by.  The store's states are
    (weight32, mom) in f32 for every f16 weight."""
    from test_torch_module import _record_pushes
    rs = np.random.RandomState(3)
    X = rs.randn(8, 3, 28, 28).astype(np.float32)
    y = rs.randint(0, 10, 8).astype(np.float32)
    jnet = jax_resnet.get_symbol(dtype="float16", **RESNET)
    jnet32 = jax_resnet.get_symbol(**RESNET)
    jmod = jmx.mod.Module(jnet, context=jmx.cpu())
    it = jmx.io.NDArrayIter(X, y, batch_size=4)
    jmod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    jmx.random.seed(0)
    jmod.init_params(initializer=jmx.init.Xavier(
        rnd_type="gaussian", factor_type="in", magnitude=2))
    a0, x0 = jmod.get_params()
    args = {k: v.asnumpy() for k, v in a0.items()}
    auxs = {k: v.asnumpy() for k, v in x0.items()}
    assert args["conv0_weight"].dtype == np.float16
    t_args, t_auxs = convert.module_params_from_numpy(args, auxs)
    for k, v in args.items():
        np.testing.assert_array_equal(t_args[k].asnumpy(), v)
    f_log = _record_pushes(monkeypatch, jkv._TwoBitCompressor,
                           lambda a: np.asarray(a, np.float32))
    jmod32 = _module_fit(jmx, jkv, {}, jnet32,
                         {k: jmx.nd.array(v.astype(np.float32))
                          for k, v in args.items()},
                         {k: jmx.nd.array(v) for k, v in auxs.items()}, X,
                         y, jls, multi_precision=False)
    monkeypatch.undo()
    t_log = _record_pushes(monkeypatch, tkv._TwoBitCompressor,
                           lambda a: a.detach().float().numpy(), many=True)
    j_log = _record_pushes(monkeypatch, jkv._TwoBitCompressor,
                           lambda a: np.asarray(a, np.float32))
    tmod = _module_fit(tmx, tkv, {"device": "cpu"}, resnet.get_symbol(
        dtype="float16", **RESNET), t_args, t_auxs, X, y, tmx.lr_scheduler)
    jmod = _module_fit(jmx, jkv, {}, jnet,
                       {k: jmx.nd.array(v) for k, v in args.items()},
                       {k: jmx.nd.array(v) for k, v in auxs.items()}, X, y,
                       jls)
    n = len(args)
    assert len(t_log) == len(j_log) == len(f_log) == 2 * n
    flipped = {}
    for i, ((tk, tg, tr, tq, tnr), (jk, jg, jr, jq, jnr)) in enumerate(
            zip(t_log, j_log)):
        assert tk == jk == f_log[i][0]
        if i < n:       # the first push: the same weights everywhere
            gap, own = _gap(np.zeros_like(jg), tg, jg, f_log[i][1])
            assert gap <= GAP_FACTOR * max(own, F16_STEP), (tk, gap, own)
        t_comp, j_comp = tg + tr, jg + jr
        differ = tq != jq
        spread = np.abs(t_comp - j_comp) + np.abs(j_comp) * 2.0 ** -10
        across = np.abs(np.abs(j_comp) - 0.5) <= spread
        assert not (differ & ~across).any(), tk
        assert set(np.unique(tq)) <= {-0.5, 0.0, 0.5}
        for q, nr, comp in ((tq, tnr, t_comp), (jq, jnr, j_comp)):
            assert np.all(np.abs(q + nr - comp) <= 2.0 ** -10 * np.maximum(
                np.abs(comp), 2.0 ** -14)), tk
        flipped[tk] = flipped.get(tk, np.zeros(tq.shape, bool)) | differ
    ta, tx = tmod.get_params()
    ja, jx = jmod.get_params()
    fa, fx = jmod32.get_params()
    # a flipped q moves its weight by lr * rescale * t per push and then
    # by the momentum it left: two steps at lr 0.1 (then 0.01), batch 4
    bound = 0.1 * 0.25 * 0.5 * 4
    named = {}
    for k in args:
        t_w, j_w = ta[k].asnumpy(), ja[k].asnumpy()
        assert t_w.dtype == np.float16, k
        mask = flipped.get(k, np.zeros(t_w.shape, bool))
        assert (np.abs(t_w.astype(np.float32) - j_w)[mask] <= bound).all()
        named[k] = (args[k], np.where(mask, j_w, t_w), j_w,
                    fa[k].asnumpy())
    for k in auxs:
        assert tx[k].asnumpy().dtype == np.float32, k
        named[k] = (auxs[k], tx[k].asnumpy(), jx[k].asnumpy(),
                    fx[k].asnumpy())
    _gap_check(named)
    state = convert.kvstore_state_to_numpy(tmod._kvstore)
    assert state["residual"] and all(
        r.dtype == np.float16 for r in state["residual"].values())
    for s in state["states"].values():
        assert isinstance(s, tuple) and s[0].dtype == np.float32 \
            and s[1].dtype == np.float32
    assert tmod._optimizer.num_update == jmod._optimizer.num_update == 2
    assert tmod._optimizer._get_lr(0) == pytest.approx(0.01)


# ---------------------------------------------------------------------------
# ShardedTrainer(param_dtype="float16"): the LM on the flash path
# ---------------------------------------------------------------------------

LM = dict(vocab_size=100, seq_len=64, num_layers=2, hidden=64, heads=2,
          flash_min_seq=32)
LM_SHAPES = {"data": (4, 64), "softmax_label": (4, 64)}
HP = dict(lr=0.1, momentum=0.9, wd=1e-4)


def _lm_batches(n=2, seed=11):
    rs = np.random.RandomState(seed)
    return [{"data": rs.randint(0, 100, (4, 64)).astype(np.float32),
             "softmax_label": rs.randint(0, 100, (4, 64)).astype(
                 np.float32)} for _ in range(n)]


def _jax_trainer(symbol, param_dtype, **kw):
    jt = JaxTrainer(symbol, JaxMeshSpec(jax_make_mesh((1,), ("dp",))),
                    param_dtype=param_dtype, **dict(HP, **kw))
    return jt


def _train(trainer, state, batches):
    for b in batches:
        *state, _loss = trainer.step(*state, b)
    return tuple(state)


def _host(state):
    return tuple(tuple(np.asarray(a) for a in part) for part in state)


def test_f16_lm_steps_match_jax():
    """Two steps of ``ShardedTrainer(param_dtype="float16")`` with a
    dynamic loss scale of 1024, which divides the update in both
    packages (the flash path at T 64: flash_min_seq
    32), from the JAX trainer's f16 state carried across bit for bit:
    every name but gamma/beta f16, as in the reference; each tensor
    within 3x the reference's own f16 gap; no step skipped, the scale
    as the reference leaves it."""
    ls = dict(loss_scale=1024.0, dynamic_loss_scale=True)
    jt = _jax_trainer(jax_get_symbol(**LM), "float16", **ls)
    jf = _jax_trainer(jax_get_symbol(**LM), None, **ls)
    tt = ShardedTrainer(get_symbol(**LM), device="cpu",
                        param_dtype="float16", **dict(HP, **ls))
    jstate = jt.init_state(LM_SHAPES, seed=5)
    jf.init_state(LM_SHAPES, seed=5)      # its state: jt's, upcast below
    host = _host(jstate)
    assert tt.param_names == jt.param_names
    want = {n: ("float32" if n.endswith(("gamma", "beta")) else "float16")
            for n in jt.param_names}
    assert {n: str(a.dtype) for n, a in zip(jt.param_names,
                                            host[0])} == want
    tstate = convert.trainer_state_from_numpy(
        (jt.param_names, jt.prog.aux_names), host, "cpu",
        order=(tt.param_names, tt.prog.aux_names))
    assert [str(t.dtype)[6:] for t in tstate[0]] == [want[n] for n in
                                                      tt.param_names]
    start = tuple(tuple(a.astype(np.float32) for a in part) for part in host)
    fstate = tuple(tuple(jnp.asarray(a) for a in part) for part in start)
    batches = _lm_batches()
    kernels.reset_launches()
    tstate = _train(tt, tstate, batches)
    jstate = _train(jt, jstate, batches)
    fstate = _train(jf, fstate, batches)
    assert [str(t.dtype)[6:] for t in tstate[0]] == [want[n] for n in
                                                      tt.param_names]
    port = convert.trainer_state_to_numpy(tstate)
    jh, fh = _host(jstate), _host(fstate)
    named = {}
    for part, names in ((0, tt.param_names), (1, tt.param_names)):
        for n, s0, p, j, f in zip(names, start[part], port[part], jh[part],
                                  fh[part]):
            named["%s[%d]" % (n, part)] = (s0, p, np.asarray(j, np.float32),
                                           f)
    _gap_check(named)
    assert tt.skipped_steps == 0
    assert tt.loss_scale == pytest.approx(float(np.asarray(
        jt.loss_scale if not callable(jt.loss_scale) else jt.loss_scale())))


def test_f16_trainer_skips_a_step_that_overflows():
    """An f16 weight at f16's largest values overflows the forward: the
    guard skips the step (weights and momentum unchanged) and halves the
    dynamic loss scale, as the reference's automaton does.  (The loss
    scale itself never reaches the gradients here: SoftmaxOutput's
    gradient ignores the incoming one, in both packages.)"""
    ls = dict(loss_scale=2.0 ** 10, dynamic_loss_scale=True)
    tt = ShardedTrainer(get_symbol(**LM), device="cpu",
                        param_dtype="float16", **dict(HP, **ls))
    p, m, x = tt.init_state(LM_SHAPES, seed=2)
    i = tt.param_names.index("tok_embed_weight")
    p[i].fill_(60000.0)
    before = [t.clone() for t in p + m]
    p, m, x, _loss = tt.step(p, m, x, _lm_batches(1)[0])
    assert tt.skipped_steps == 1
    assert tt.loss_scale == 2.0 ** 9
    assert int(tt._guard_state[1]) == 0     # the device's good streak
    assert all(torch.equal(a, b) for a, b in zip(p + m, before))
