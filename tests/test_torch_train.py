"""The port's training slice against the JAX package's: the tiny LM of
tests/test_flash_vjp.py (vocab 12, T 16, L1, hidden 16, heads 2) trained
by the port's ``ShardedTrainer`` on the CPU and by the JAX package's on
its CPU, from the JAX trainer's initial state carried across by
``convert`` (mxnet_tpu_torch/parallel/trainer.py vs
mxnet_tpu/parallel/trainer.py).

The JAX side runs its Pallas flash kernels in interpret mode above the
dispatch threshold; the port's attention op takes the kernels' plain
versions on CPU tensors.  Tolerance for the trained state: rtol 2e-4 /
atol 2e-5 (f32 on both sides, two momentum steps, the bar of
test_flash_vjp.py's einsum-vs-flash parity).
"""
import numpy as np
import pytest
import torch

from mxnet_tpu.models.transformer import get_symbol as jax_get_symbol
from mxnet_tpu.parallel.mesh import MeshSpec as JaxMeshSpec
from mxnet_tpu.parallel.mesh import make_mesh as jax_make_mesh
from mxnet_tpu.parallel.trainer import ShardedTrainer as JaxTrainer
from mxnet_tpu_torch import convert
from mxnet_tpu_torch.base import NotPortedYet
from mxnet_tpu_torch.models.transformer import get_decode_step, get_symbol
from mxnet_tpu_torch.parallel import MeshSpec, ShardedTrainer, make_mesh

TINY = dict(vocab_size=12, seq_len=16, num_layers=1, hidden=16, heads=2)
SHAPES = {"data": (8, 16), "softmax_label": (8, 16)}
RTOL, ATOL = 2e-4, 2e-5


def _batches(n=2, seed=11):
    rs = np.random.RandomState(seed)
    return [{"data": rs.randint(0, 12, (8, 16)).astype(np.float32),
             "softmax_label": rs.randint(0, 12, (8, 16)).astype(np.float32)}
            for _ in range(n)]


def _pair(flash_min_seq=10000, seed=5, **kw):
    """A JAX trainer with its initial state, and a port trainer on the
    CPU with the same state carried across."""
    net = dict(TINY, flash_min_seq=flash_min_seq)
    jt = JaxTrainer(jax_get_symbol(**net),
                    JaxMeshSpec(jax_make_mesh((1,), ("dp",))), lr=0.1,
                    momentum=0.9, wd=0.0, **kw)
    jstate = jt.init_state(SHAPES, seed=seed)
    tt = ShardedTrainer(get_symbol(**net),
                        MeshSpec(make_mesh((1,), ("dp",), device="cpu")),
                        lr=0.1, momentum=0.9, wd=0.0, **kw)
    host = tuple(tuple(np.asarray(a) for a in part) for part in jstate)
    tstate = convert.trainer_state_from_numpy(
        (jt.param_names, jt.prog.aux_names), host, "cpu",
        order=(tt.param_names, tt.prog.aux_names))
    assert tt.param_names == jt.param_names
    return jt, jstate, tt, tstate


def _train(trainer, state, batches):
    p, m, x = state
    loss = None
    for b in batches:
        p, m, x, loss = trainer.step(p, m, x, b)
    return (p, m, x), float(loss)


def _assert_state_close(tstate, jstate):
    host = convert.trainer_state_to_numpy(tstate)
    for tpart, jpart in zip(host, jstate):
        assert len(tpart) == len(jpart)
        for a, b in zip(tpart, jpart):
            np.testing.assert_allclose(a, np.asarray(b), rtol=RTOL,
                                       atol=ATOL)


@pytest.mark.parametrize("flash_min_seq", [10000, 1],
                         ids=["einsum-path", "flash-path"])
def test_two_steps_match_jax(flash_min_seq):
    jt, jstate, tt, tstate = _pair(flash_min_seq)
    batches = _batches()
    jstate, jloss = _train(jt, jstate, batches)
    tstate, tloss = _train(tt, tstate, batches)
    _assert_state_close(tstate, jstate)
    # the summed SoftmaxOutput "loss" is the constant N*T
    assert tloss == pytest.approx(jloss, rel=1e-5)
    assert tloss == pytest.approx(8 * 16, rel=1e-5)


@pytest.mark.parametrize("flash_min_seq", [10000, 1],
                         ids=["einsum-path", "flash-path"])
def test_grad_accum_matches_jax(flash_min_seq):
    jt, jstate, tt, tstate = _pair(flash_min_seq, grad_accum=2)
    batches = _batches()
    jstate, _ = _train(jt, jstate, batches)
    tstate, _ = _train(tt, tstate, batches)
    _assert_state_close(tstate, jstate)


@pytest.mark.parametrize("rows", [(8, 6), (7, 7)],
                         ids=["mismatched", "indivisible"])
def test_grad_accum_rejects_a_batch_of_two_sizes(rows):
    """With grad_accum > 1 every input must have one leading size that
    divides by it; anything else is refused at the step, before the
    forward runs."""
    tt = ShardedTrainer(get_symbol(**TINY), device="cpu", lr=0.1,
                        momentum=0.9, wd=0.0, grad_accum=2)
    state = tt.init_state(SHAPES, seed=0)
    rs = np.random.RandomState(0)
    batch = {"data": rs.randint(0, 12, (rows[0], 16)).astype(np.float32),
             "softmax_label": rs.randint(0, 12, (rows[1], 16)).astype(
                 np.float32)}
    with pytest.raises(ValueError, match="not one size divisible"):
        tt.step(*state, batch)


def test_step_hands_the_loss_scale_automaton_the_device_verdict(
        monkeypatch):
    """``step`` reads the verdict on the host once, to choose the
    in-place update; the loss-scale automaton gets the 0-d device
    tensor, so no host scalar is copied to the card after the update."""
    from mxnet_tpu_torch.resilience import guards
    seen = []
    real = guards.scale_update

    def spy(scale, good, ok, *args, **kw):
        seen.append(ok)
        return real(scale, good, ok, *args, **kw)

    monkeypatch.setattr(guards, "scale_update", spy)
    _, _, tt, tstate = _pair(dynamic_loss_scale=True, loss_scale=8.0)
    _train(tt, tstate, _batches(1))
    assert len(seen) == 1
    assert isinstance(seen[0], torch.Tensor) and seen[0].dim() == 0
    assert seen[0].dtype == torch.bool and bool(seen[0])


def test_loss_scale_matches_jax():
    """The head ignores the cotangent, so a static scale only divides
    the gradients: the update is the unscaled one, as in JAX."""
    jt, jstate, tt, tstate = _pair(loss_scale=4.0)
    batches = _batches()
    jstate, _ = _train(jt, jstate, batches)
    tstate, _ = _train(tt, tstate, batches)
    _assert_state_close(tstate, jstate)
    assert tt.loss_scale == jt.loss_scale == 4.0


def test_nonfinite_step_is_skipped_and_the_scale_halves():
    """A NaN in one carried weight makes the loss and the gradients
    non-finite: both packages apply no update and halve the dynamic
    scale; the next finite step trains again."""
    jt, jstate, tt, tstate = _pair(dynamic_loss_scale=True,
                                   loss_scale=8.0)
    i = tt.param_names.index("l0_ff1_weight")
    jp = list(jstate[0])
    poisoned = np.array(jp[i])
    poisoned[0, 0] = np.nan
    jp[i] = poisoned
    jstate = (tuple(jp),) + tuple(jstate[1:])
    tp = list(tstate[0])
    tp[i] = tp[i].clone()
    tp[i][0, 0] = float("nan")
    tstate = (tuple(tp),) + tuple(tstate[1:])
    before = convert.trainer_state_to_numpy(tstate)
    batch = _batches(1)
    jstate, jloss = _train(jt, jstate, batch)
    tstate, tloss = _train(tt, tstate, batch)
    assert np.isnan(jloss) and np.isnan(tloss)
    after = convert.trainer_state_to_numpy(tstate)
    for b_part, a_part, j_part in zip(before, after, jstate):
        for b, a, j in zip(b_part, a_part, j_part):
            np.testing.assert_array_equal(a, b)     # NaN where it was
            np.testing.assert_array_equal(a, np.asarray(j))
    assert tt.loss_scale == jt.loss_scale == 4.0
    assert tt.skipped_steps == jt.skipped_steps == 1


def test_nonfinite_budget_aborts():
    from mxnet_tpu_torch.resilience.guards import NonFiniteError
    _, _, tt, tstate = _pair(nonfinite_budget=0)
    p = list(tstate[0])
    p[0] = torch.full_like(p[0], float("nan"))
    with pytest.raises(NonFiniteError):
        tt.step(tuple(p), tstate[1], tstate[2], _batches(1)[0])


def test_loss_scale_automaton_matches_jax():
    import jax.numpy as jnp
    from mxnet_tpu.resilience import guards as jg
    from mxnet_tpu_torch.resilience import guards as tg
    scale, good = 8.0, 0
    js, jgood = jnp.float32(8.0), jnp.int32(0)
    for ok in (True, True, False, True, True, True, False, False):
        scale, good = tg.scale_update(scale, good, ok, 2)
        js, jgood = jg.scale_update(js, jgood, jnp.bool_(ok), 2)
        assert (scale, good) == (float(js), int(jgood))


def test_init_state_names_shapes_and_statistics():
    """The port's init draws from a torch.Generator, the JAX package's
    from its key stream: names, shapes and fixed fills are equal and the
    Xavier (gaussian, fan-in, magnitude 2) draws agree in distribution."""
    net = dict(vocab_size=200, seq_len=32, num_layers=2, hidden=64, heads=4)
    shapes = {"data": (2, 32), "softmax_label": (2, 32)}
    jt = JaxTrainer(jax_get_symbol(**net),
                    JaxMeshSpec(jax_make_mesh((1,), ("dp",))))
    tt = ShardedTrainer(get_symbol(**net), device="cpu")
    jp, jm, jx = jt.init_state(shapes, seed=0)
    tp, tm, tx = tt.init_state(shapes, seed=0)
    assert tt.param_names == jt.param_names and tx == jx == ()
    again = tt.init_state(shapes, seed=0)[0]
    for name, a, b, c, m in zip(tt.param_names, tp, jp, again, tm):
        a, b = a.numpy(), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, c.numpy())     # seeded
        assert not m.any()                              # zero momentum
        if name.endswith(("bias", "beta")):
            assert not a.any() and not b.any()
        elif name.endswith("gamma"):
            assert (a == 1).all() and (b == 1).all()
        else:
            want = np.sqrt(2.0 / a.shape[1])
            # sample std of >= 2048 draws: within 6% of sqrt(2/fan_in)
            assert abs(a.std() / want - 1) < 0.06, name
            assert abs(b.std() / want - 1) < 0.06, name
            assert abs(a.mean()) < 0.1 * want, name
    assert not np.array_equal(tt.init_state(shapes, seed=1)[0][0].numpy(),
                              tp[0].numpy())


def test_port_trained_state_serves_through_get_decode_step():
    """A state trained by the port feeds the port's decode program under
    the same names: teacher-forced decode logits give the training
    graph's probabilities at every position."""
    from mxnet_tpu_torch.executor import GraphProgram
    _, _, tt, tstate = _pair(flash_min_seq=1)
    (p, m, x), _ = _train(tt, tstate, _batches())
    params = dict(zip(tt.param_names, p))
    toks = _batches(1, seed=3)[0]["data"][:2]
    prog = GraphProgram(tt.symbol)
    args = [None] * len(prog.arg_names)
    for n, t in params.items():
        args[prog.arg_names.index(n)] = t
    args[prog.arg_names.index("data")] = torch.from_numpy(toks)
    args[prog.arg_names.index("softmax_label")] = torch.zeros(2, 16)
    with torch.no_grad():
        probs = prog.evaluate(args, [], train=False)[0][0].reshape(2, 16, 12)
    dec = get_decode_step(params, page_size=4, max_seqs=2, device="cpu",
                          **TINY)
    c = dec.config
    table = (1 + np.arange(2)[:, None] * c.pages_per_seq
             + np.arange(c.pages_per_seq)).astype(np.int32)
    kv = dec.fresh_cache()
    for t in range(16):
        pos = np.full(2, t, np.int32)
        _nxt, logits, kv = dec.step(kv, toks[:, t].astype(np.int32), pos,
                                    pos + 1, table[:, t // 4],
                                    pos % 4, table)
        np.testing.assert_allclose(torch.softmax(logits, -1).numpy(),
                                   probs[:, t].numpy(), rtol=1e-4,
                                   atol=1e-6)


def test_unported_features_raise():
    """ZeRO and local batches are ported (at dp 1 they are the plain
    step; over dp 2 tests/test_torch_dist.py holds them to the JAX
    package); a mesh axis other than dp over more than one device is
    still to port, and a dp mesh of 2 needs a gang of 2."""
    net = get_symbol(**TINY)
    tt = ShardedTrainer(net, device="cpu")
    ShardedTrainer(net, device="cpu", param_dtype="float32")
    want = tt.step(*tt.init_state(SHAPES), _batches(1)[0])[0]
    for kw in (dict(zero=True), dict(shard_optimizer_state=True)):
        tz = ShardedTrainer(net, device="cpu", **kw)
        got = tz.step(*tz.init_state(SHAPES), _batches(1)[0],
                      local_batch=True)[0]
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    # a tp, dp x tp or ep mesh over two devices is ported: like dp it
    # needs a gang of two (tests/test_torch_dist.py)
    for shape, names in (((2,), ("tp",)), ((1, 2), ("dp", "tp")),
                         ((2,), ("ep",))):
        with pytest.raises(ValueError, match="gang has 1"):
            make_mesh(shape, names, device="cpu")
    with pytest.raises(ValueError, match="gang has 1"):
        make_mesh((2,), ("dp",), device="cpu")


@pytest.mark.parametrize("var,value", [
    ("MXNET_TPU_REMAT_POLICY", "dots"),
    ("MXNET_BACKWARD_DO_MIRROR", "1"),
    ("MXNET_BACKWARD_DO_MIRROR", "false"),
    ("MXNET_TPU_COMPILE_CACHE", "1"),
    ("MXNET_TPU_PREFLIGHT", "1"),
    ("MXNET_TPU_PREFLIGHT", "no"),
    ("MXNET_TPU_ATTRIBUTION", "1"),
    ("MXNET_TPU_CHAOS", "nan_grad@2"),
])
def test_armed_env_features_of_the_jax_step_raise(monkeypatch, var, value):
    from mxnet_tpu_torch.resilience import chaos
    net = get_symbol(**TINY)
    tt = ShardedTrainer(net, device="cpu")
    state = tt.init_state(SHAPES)
    monkeypatch.setenv(var, value)
    chaos.reset()
    if var in ("MXNET_TPU_REMAT_POLICY", "MXNET_BACKWARD_DO_MIRROR"):
        # remat is ported: these rows now hold a step under the policy
        # to the step without it, and the policy to the JAX package's
        from mxnet_tpu import executor as jexec
        from mxnet_tpu_torch import executor as texec
        assert texec.backward_mirror_policy() == \
            jexec.backward_mirror_policy() == "dots"
        tr = ShardedTrainer(net, device="cpu")
        assert tr._built_remat == "dots"
        start = tr.init_state(SHAPES)
        got = tr.step(*start, _batches(1)[0])[0]
        monkeypatch.delenv(var)
        ref = ShardedTrainer(net, device="cpu")
        want = ref.step(*ref.init_state(SHAPES), _batches(1)[0])[0]
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                       atol=1e-6)
        return
    if var == "MXNET_TPU_CHAOS":
        # the nan_grad drill is ported: the step it fires on poisons its
        # batch, is skipped (the state stays) and counted
        try:
            tr = ShardedTrainer(net, device="cpu")
            start = tr.init_state(SHAPES)
            b = _batches(2)
            after1 = [p.clone() for p in tr.step(*start, b[0])[0]]
            params, mom, aux, loss = tr.step(*start, b[1])
            assert not np.isfinite(float(loss))
            assert tr.skipped_steps == 1
            for a, p in zip(after1, params):
                assert torch.equal(a, p)
        finally:
            monkeypatch.delenv(var)
            chaos.reset()
        return
    try:
        with pytest.raises(NotPortedYet):
            ShardedTrainer(net, device="cpu")
        with pytest.raises(NotPortedYet):
            tt.step(*state, _batches(1)[0])
    finally:
        monkeypatch.delenv(var)
        chaos.reset()
