"""MXNet's float16 recipe in the port against the JAX package, on the CPU:
the mixed-precision and many-parameter SGD ops
(mxnet_tpu_torch/ops/optimizer_ops.py vs mxnet_tpu/ops/optimizer_ops.py),
``SGD(multi_precision=True)`` through the ``Updater``
(mxnet_tpu_torch/optimizer.py), every learning-rate schedule
(mxnet_tpu_torch/lr_scheduler.py), ``TopKAccuracy``
(mxnet_tpu_torch/metric.py) and the two-bit compression's plain version
over f16, bf16, f64 and strided gradients (B10's oracle,
mxnet_tpu_torch/ops/kernels.py vs the JAX kernel through XLA and through
Pallas in interpret mode).

Inputs are made with numpy from a seed and handed to both packages.
Tolerances, and why:

* optimizer ops: the f32 master and the momentum within 2 f32 ulps of
  the tensor's largest term (XLA:CPU contracts ``momentum*m - lr*(g +
  wd*w)`` into FMAs where PyTorch rounds each product, so each sum may
  land an ulp or two apart), the f16 weight exact or 1 f16 ulp of its
  own magnitude (the rounding of a master that may sit that close to a
  midpoint); over five steps of the Updater 8 f32 ulps (the differences
  carry from step to step) and the same 1 f16 ulp;
* schedules: exact (the same float expressions);
* TopKAccuracy: exact (no ties in the seeded scores);
* two-bit: ``q`` exact except where ``g + r`` lies within one f32 ulp of
  +-t (one package may round the sum across it), ``q + new_r`` within
  one ulp of the gradient's dtype of ``g + r`` everywhere.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
import ml_dtypes
from mxnet_tpu import lr_scheduler as jls
from mxnet_tpu import metric as jmetric
from mxnet_tpu import optimizer as jopt
from mxnet_tpu.ndarray import ndarray as jnd
from mxnet_tpu.ops import pallas_kernels as jpk
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import lr_scheduler as tls
from mxnet_tpu_torch import optimizer as topt
from mxnet_tpu_torch.ndarray import ndarray as tnd
from mxnet_tpu_torch.ops import kernels
from mxnet_tpu_torch.ops.registry import list_ops


def _ulps(port, ref, dtype, terms=()):
    """The largest distance in units of ``dtype``'s last place.  f16 (a
    rounded weight): at each element's own magnitude (the larger of the
    two sides), so that 1 is one rounding apart.  f32 (the master and
    the momentum, sums of several rounded terms): at the tensor's largest
    magnitude among ``ref`` and the ``terms`` summed to make it."""
    port = np.asarray(port, np.float64)
    ref = np.asarray(ref, np.float64)
    if dtype is np.float16:
        mag = np.maximum(np.abs(port), np.abs(ref)).astype(np.float16)
        ulp = np.maximum(np.spacing(mag).astype(np.float64), 2.0 ** -24)
    else:
        mag = max([float(np.abs(ref).max())] + [
            float(np.abs(np.asarray(t, np.float64)).max()) for t in terms])
        ulp = float(np.spacing(np.float32(mag)))
    return float((np.abs(port - ref) / ulp).max())


def _port_array(a):
    """A host array (f16, f32 or ml_dtypes bf16) as a port NDArray on the
    CPU with the same bits."""
    return tnd.NDArray(_to_torch(a))


def _t(a, dtype=None):
    return tnd.array(np.asarray(a), ctx="cpu",
                     dtype=dtype or np.asarray(a).dtype)


def _j(a):
    return jnd.array(np.asarray(a), dtype=np.asarray(a).dtype)


def _inputs(wdtype, n=4, seed=0, shape=(33, 7)):
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        w32 = rs.randn(*shape).astype(np.float32)
        out.append(dict(w=w32.astype(wdtype), w32=w32,
                        g=(rs.randn(*shape) * 3).astype(wdtype),
                        m=(rs.randn(*shape) * 0.1).astype(np.float32)))
    return out


KW = dict(lr=0.37, wd=1e-2, rescale_grad=1.0 / 3.0)


@pytest.mark.parametrize("wdtype", [np.float16, np.float32],
                         ids=["f16-weight", "f32-weight"])
@pytest.mark.parametrize("clip", [-1.0, 2.0], ids=["no-clip", "clip2"])
@pytest.mark.parametrize("op,arrays,extra", [
    ("mp_sgd_update", ("w", "g", "w32"), {}),
    ("mp_sgd_mom_update", ("w", "g", "m", "w32"), {"momentum": 0.9})])
def test_mp_sgd_ops_match_jax(op, arrays, extra, wdtype, clip):
    c = _inputs(wdtype, 1)[0]
    kw = dict(KW, clip_gradient=clip, **extra)
    t = [_t(c[a]) for a in arrays]
    j = [_j(c[a]) for a in arrays]
    tout = tnd.invoke_with_arrays(op, t, kw)
    jout = jnd.invoke_with_arrays(op, j, kw)
    # the terms of the f32 sums: the old master and momentum, lr g
    terms = (c["w32"], c["m"] * 0.9, KW["lr"] * np.clip(
        c["g"].astype(np.float32) * KW["rescale_grad"], -abs(clip) if clip
        > 0 else -np.inf, abs(clip) if clip > 0 else np.inf))
    for a, tt, jj in zip(arrays, t, j):
        want = jj.asnumpy()
        got = tt.asnumpy()
        assert got.dtype == want.dtype, a
        dt = np.float16 if got.dtype == np.float16 else np.float32
        assert _ulps(got, want, dt, terms) <= (1.0 if dt is np.float16
                                               else 2.0), a
    np.testing.assert_array_equal(np.asarray(tout.asnumpy()),
                                  t[0].asnumpy())
    assert jout.asnumpy().dtype == tout.asnumpy().dtype


MULTI = [("multi_sgd_update", ("w", "g"), False),
         ("multi_sgd_mom_update", ("w", "g", "m"), False),
         ("multi_mp_sgd_update", ("w", "g", "w32"), True),
         ("multi_mp_sgd_mom_update", ("w", "g", "m", "w32"), True)]


@pytest.mark.parametrize("op,arrays,mp", MULTI, ids=[m[0] for m in MULTI])
def test_multi_sgd_ops_match_jax(op, arrays, mp):
    """Three parameters in one call (per-parameter lrs and wds, a clip),
    weights f16 for the mp ops and f32 for the others: every written
    input as the JAX op writes it."""
    cases = _inputs(np.float16 if mp else np.float32, 3, seed=4)
    kw = dict(lrs=(0.1, 0.37, 0.05), wds=(0.0, 1e-2, 1e-3),
              rescale_grad=0.5, clip_gradient=2.5, momentum=0.9)
    t = [_t(c[a]) for c in cases for a in arrays]
    j = [_j(c[a]) for c in cases for a in arrays]
    tnd.invoke_with_arrays(op, t, dict(kw, num_weights=3))
    jnd.invoke_with_arrays(op, j, dict(kw, num_weights=3))
    for i, (tt, jj) in enumerate(zip(t, j)):
        c = cases[i // len(arrays)]
        lr = kw["lrs"][i // len(arrays)]
        terms = (c["w32"], c["m"] * 0.9, lr * np.clip(
            c["g"].astype(np.float32) * 0.5, -2.5, 2.5))
        got, want = tt.asnumpy(), jj.asnumpy()
        assert got.dtype == want.dtype
        dt = np.float16 if got.dtype == np.float16 else np.float32
        assert _ulps(got, want, dt, terms) <= (
            1.0 if dt is np.float16 else 2.0), (i, arrays[i % len(arrays)])


SGD_OPS = ("sgd_update", "sgd_mom_update", "mp_sgd_update",
           "mp_sgd_mom_update", "multi_sgd_update", "multi_sgd_mom_update",
           "multi_mp_sgd_update", "multi_mp_sgd_mom_update")


@pytest.mark.parametrize("name", SGD_OPS)
def test_each_sgd_op_has_the_jax_schema(name):
    """Inputs, output counts, writeback maps (at two and three weights
    for the multi ops) and params keys as the JAX op declares them."""
    from mxnet_tpu.ops.registry import get_op as jax_get_op
    from mxnet_tpu_torch.ops.registry import get_op
    op, jop = get_op(name), jax_get_op(name)
    assert op.variadic == jop.variadic
    assert sorted(op.params) == sorted(jop.params)
    for n in ((2, 3) if op.variadic else (None,)):
        kw = dict(lrs=(0.1,) * (n or 1), wds=(0.0,) * (n or 1),
                  num_weights=n) if n else dict(lr=0.1)
        a, ja = op.parse_attrs(kw), jop.parse_attrs(kw)
        assert op.list_inputs(a) == jop.list_inputs(ja)
        assert op.num_outputs(a) == jop.num_outputs(ja)
        assert op.num_visible_outputs(a) == jop.num_visible_outputs(ja)
        assert op.writeback_map(a) == jop.writeback_map(ja)


def test_the_registry_holds_the_six_new_ops():
    names = set(list_ops())
    for op in ("mp_sgd_update", "mp_sgd_mom_update", "multi_sgd_update",
               "multi_sgd_mom_update", "multi_mp_sgd_update",
               "multi_mp_sgd_mom_update"):
        assert op in names and hasattr(tmx.nd, op)
    assert len(names) == 368   # with the other optimizers' seven ops, Custom, linalg, spatial, RNN, contrib and sparse storage


@pytest.mark.parametrize("momentum", [0.9, 0.0], ids=["momentum", "plain"])
@pytest.mark.parametrize("wdtype", [np.float16, np.float32, "bfloat16"],
                         ids=["f16", "f32", "bf16"])
def test_sgd_multi_precision_through_the_updater_matches_jax(wdtype,
                                                            momentum):
    """tests/test_optimizer.py::test_multi_precision over five steps of
    the Updater, two keys: a float16 weight gets the state (weight32,
    mom) in f32 and stays float16; f32 and bf16 weights take the plain
    path (no master copy), as in the reference.  A MultiFactorScheduler
    moves the lr after step 2 (the lr is read before the update count
    moves)."""
    rs = np.random.RandomState(3)
    dt = ml_dtypes.bfloat16 if wdtype == "bfloat16" else wdtype
    w0 = {k: rs.rand(*s).astype(np.float32).astype(dt)
          for k, s in ((0, (4, 5)), (1, (9,)))}
    gs = [{k: (rs.randn(*w.shape) * 2).astype(np.float32).astype(dt)
           for k, w in w0.items()} for _ in range(5)]
    ups, ws = [], []
    for mod, ls in ((topt, tls), (jopt, jls)):
        o = mod.SGD(learning_rate=0.1, momentum=momentum, wd=1e-3,
                    multi_precision=True, rescale_grad=0.25,
                    lr_scheduler=ls.MultiFactorScheduler([2], 0.5))
        ups.append(mod.get_updater(o))
    ws.append({k: _port_array(w) for k, w in w0.items()})
    ws.append({k: jnd.array(w) for k, w in w0.items()})
    for g in gs:
        for k in w0:
            ups[0](k, _port_array(g[k]), ws[0][k])
            ups[1](k, jnd.array(g[k]), ws[1][k])
    mixed = wdtype is np.float16
    for k in w0:
        tw = ws[0][k]._handle.double().numpy()
        jw = np.asarray(ws[1][k].asnumpy()).astype(np.float64)
        assert str(ws[0][k]._handle.dtype) == "torch." + np.dtype(dt).name
        st_t, st_j = ups[0].states[k], ups[1].states[k]
        if mixed:
            assert isinstance(st_t, tuple) and st_t[0].dtype == np.float32
            assert (st_t[1] is None) == (momentum == 0.0)
            assert _ulps(st_t[0].asnumpy(), st_j[0].asnumpy(),
                         np.float32) <= 8
            if momentum:
                assert st_t[1].dtype == np.float32
                assert _ulps(st_t[1].asnumpy(), st_j[1].asnumpy(),
                             np.float32) <= 8
            assert _ulps(tw, jw, np.float16) <= 1
        else:
            assert not isinstance(st_t, tuple)
            scale = float(np.abs(jw).max())
            tol = 1e-6 if wdtype is np.float32 else 2.0 ** -7
            np.testing.assert_allclose(tw, jw, atol=tol * scale, rtol=0)
    assert ups[0].optimizer.num_update == ups[1].optimizer.num_update == 5


def test_updater_get_states_holds_the_f32_masters():
    o = topt.SGD(learning_rate=0.1, momentum=0.9, multi_precision=True)
    up = topt.get_updater(o)
    w = tnd.array(np.ones(6, np.float16), ctx="cpu", dtype="float16")
    up(0, tnd.array(np.full(6, 0.5, np.float16), ctx="cpu",
                    dtype="float16"), w)
    import pickle
    host = pickle.loads(up.get_states())
    assert host[0][0].dtype == np.float32 and host[0][1].dtype == np.float32
    assert w.dtype == np.float16


SCHEDULES = [
    ("FactorScheduler", dict(step=7, factor=0.5, stop_factor_lr=1e-3), 0.3),
    ("MultiFactorScheduler", dict(step=[10, 50, 120], factor=0.1), 0.1),
    ("PolyScheduler", dict(max_update=200, base_lr=0.2, pwr=2), None),
    ("CosineScheduler", dict(max_update=150, base_lr=0.2, final_lr=1e-3),
     None)]


@pytest.mark.parametrize("name,kw,base", SCHEDULES,
                         ids=[s[0] for s in SCHEDULES])
def test_lr_schedulers_match_jax(name, kw, base):
    t, j = getattr(tls, name)(**kw), getattr(jls, name)(**kw)
    if base is not None:
        t.base_lr = j.base_lr = base
    for n in range(0, 300):
        assert t(n) == j(n), (name, n)


def test_warmup_scheduler_matches_jax():
    t = tls.WarmupScheduler(20, tls.FactorScheduler(step=5, factor=0.7))
    j = jls.WarmupScheduler(20, jls.FactorScheduler(step=5, factor=0.7))
    t.scheduler.base_lr = j.scheduler.base_lr = 0.4
    for n in range(300):
        assert t(n) == j(n), n
    assert tmx.lr_scheduler.MultiFactorScheduler is tls.MultiFactorScheduler
    with pytest.raises(ValueError):
        tls.MultiFactorScheduler([5, 5], 0.1)
    with pytest.raises(ValueError):
        tls.FactorScheduler(step=0)


def test_optimizer_reads_its_schedule_like_jax():
    """An Optimizer with an lr_scheduler: the scheduler's base_lr becomes
    the optimizer's learning_rate, and ``_get_lr`` follows num_update."""
    lrs = []
    for mod, ls in ((topt, tls), (jopt, jls)):
        o = mod.SGD(learning_rate=0.2,
                    lr_scheduler=ls.MultiFactorScheduler([3, 6], 0.1))
        seq = []
        for _ in range(9):
            o._update_count(0)
            seq.append(o._get_lr(0))
        lrs.append(seq)
    assert lrs[0] == lrs[1]


@pytest.mark.parametrize("k", [2, 5])
def test_top_k_accuracy_matches_jax(k):
    rs = np.random.RandomState(k)
    probs = rs.rand(64, 10).astype(np.float32)
    labels = rs.randint(0, 10, 64).astype(np.float32)
    t = tmx.metric.create("top_k_accuracy", top_k=k)
    j = jmetric.create("top_k_accuracy", top_k=k)
    for i in range(2):
        sl = slice(32 * i, 32 * (i + 1))
        t.update([tnd.array(labels[sl], ctx="cpu")],
                 [tnd.array(probs[sl], ctx="cpu")])
        j.update([jnd.array(labels[sl])], [jnd.array(probs[sl])])
    assert t.get() == j.get()
    assert t.get()[0] == "top_k_accuracy_%d" % k
    assert isinstance(tmx.metric.TopKAccuracy(top_k=5), tmx.metric.EvalMetric)
    with pytest.raises(ValueError):
        tmx.metric.TopKAccuracy(top_k=1)


# ---------------------------------------------------------------------------
# two-bit compression's plain version in every dtype (B10's oracle)
# ---------------------------------------------------------------------------

def _two_bit_host(dtype, shape, seed):
    rs = np.random.RandomState(seed)
    g = (rs.randn(*shape) * 0.5).astype(np.float32)
    r = (rs.randn(*shape) * 0.2).astype(np.float32)
    flat = r.reshape(-1)
    flat[:6] = [0.5, np.nextafter(np.float32(0.5), np.float32(1)), -0.5,
                np.nan, np.inf, -np.inf]
    g.reshape(-1)[:6] = 0
    return g.astype(dtype), r.astype(dtype)


def _to_torch(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).view(np.int16).copy()) \
            .view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _to_f64(x):
    if isinstance(x, torch.Tensor):
        return x.double().numpy()
    return np.asarray(x).astype(np.float64)


@pytest.mark.parametrize("use_pallas", [False, True], ids=["xla", "pallas"])
@pytest.mark.parametrize("dtype", [np.float16, ml_dtypes.bfloat16,
                                   np.float64], ids=["f16", "bf16", "f64"])
def test_two_bit_plain_in_every_dtype_matches_jax(dtype, use_pallas):
    g, r = _two_bit_host(dtype, (37, 29), 5)
    jq, jr = jpk.two_bit_compress(jnp.asarray(g), jnp.asarray(r), 0.5,
                                  use_pallas=use_pallas)
    tq, tr = kernels.two_bit_compress_plain(_to_torch(g), _to_torch(r), 0.5)
    assert str(tq.dtype).replace("torch.", "") == np.dtype(dtype).name
    assert tr.dtype == tq.dtype and tq.shape == g.shape
    comp = g.astype(np.float32) + r.astype(np.float32)
    near = np.abs(np.abs(comp) - np.float32(0.5)) <= np.spacing(
        np.float32(0.5))
    tq, tr, jq, jr = map(_to_f64, (tq, tr, jq, jr))
    np.testing.assert_array_equal(tq[~near], jq[~near])
    fin = np.isfinite(jr)
    np.testing.assert_array_equal(np.isnan(tr), np.isnan(jr))
    step = float(np.finfo(np.float16 if dtype is np.float16 else
                          np.float32).eps) if dtype is not \
        ml_dtypes.bfloat16 else 2.0 ** -7
    both = (tq + tr)[fin]
    ref = (jq + jr)[fin]
    assert np.all(np.abs(both - ref) <= step * np.maximum(np.abs(ref), 1.0))


def test_two_bit_on_a_transposed_gradient_matches_jax():
    """A transposed f16 gradient through the compressor's many-key entry
    on the CPU: ``q`` of the gradient's shape, the residual updated in
    place, both as the JAX kernel gives them for the same (transposed)
    values, over three pushes."""
    rs = np.random.RandomState(2)
    base = (rs.randn(24, 40) * 0.4).astype(np.float16)
    r_t = torch.zeros(40, 24, dtype=torch.float16)
    r_j = jnp.zeros((40, 24), jnp.float16)
    for i in range(3):
        g = torch.from_numpy(base * np.float16(i + 1)).t()
        assert not g.is_contiguous()
        q, = kernels.two_bit_compress_many([g], [r_t], 0.5)
        jq, r_j = jpk.two_bit_compress(jnp.asarray(g.numpy()), r_j, 0.5,
                                       use_pallas=True)
        assert q.shape == (40, 24)
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(r_t.numpy(), np.asarray(r_j))
