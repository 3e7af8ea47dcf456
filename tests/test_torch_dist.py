"""The port's data parallelism across processes against the JAX package
on 2 (or 4) of its 8 virtual CPU devices.

One gang of 2 ranks (``tools/launch.py -n 2 --dist-device cpu`` running
``tests/torch_dist_workers.py``, gloo on the CPU) runs every 2-rank case
once for the module; the inputs come from numpy seeds and the JAX
package's initial states, written to the gang's directory.  The gang of
4 is tests/test_torch_dist4.py's.

Tolerances:

* the dp ``ShardedTrainer`` (plain, ``local_batch``, ZeRO, ZeRO with
  ``grad_accum``), BatchNorm under dp (its loss head normalised by the
  valid labels, and by the batch), and the one-rank ``nan_grad`` skip:
  the trained state within rtol 2e-4 / atol 2e-5 of the JAX trainer's on
  a 2-device mesh (the bar of tests/test_torch_train.py: f32, a few
  momentum steps, the gradient summed in another order), and the ranks'
  parameters bit-equal to each other;
* ``Module.fit`` through ``dist_sync`` against the JAX package's Module
  over ``[cpu(0), cpu(1)]`` with ``KVStore("device")`` (the same sum):
  rtol 1e-5 / atol 1e-6, at 2 ranks and at 4 (against 4 contexts);
  with two-bit compression, bit-equal to one
  process that sums the two ranks' compressed gradients (their sum of
  values in {-t, 0, t} is exact);
* ``gluon.Trainer(kvstore="dist_sync")`` over two ranks against the JAX
  package's Trainer on the whole batch in one process: rtol 1e-5 / atol
  1e-6; joining the gang initialises no CUDA;
* ``dist_async``'s averaging (a dense key and a row_sparse one) and
  ``allreduce_row_sparse``: exact against numpy (sums of two f32
  values);
* the recommender at S 2 and 4 against the JAX package's XLA backend on
  the same mesh: within 1e-6 of each tensor's largest magnitude, as
  tests/test_torch_sparse_plane.py, and every untouched row bit-equal;
* tensor parallelism: the tp-2 ``ShardedTrainer`` (here; dp2 x tp2 plain
  and ZeRO, and the annotated MLP, in tests/test_torch_dist4.py) against
  the JAX trainer on the same mesh of virtual devices: the whole state
  and rank r's blocks (against the JAX array's shard on device r) within
  rtol 2e-4 / atol 2e-5, the losses within rtol 1e-5, the ranks' whole
  parameters bit-equal, no collective on the default group; tp-2 decode
  against the JAX package's tp-2 ``DecodeProgram`` at vocab 29 (the head
  whole) and 32 (the head split), teacher-forced: tokens equal, logits
  within 1e-4 (f32, int8, int4: the bar of tests/test_torch_decode.py),
  rank r's KV pool within 1e-5 of the JAX pool's heads on device r, one
  step's audit trail equal to ``decode_tp_model_bytes``; the tp-2
  engine's tokens equal to the JAX one-process engine's, and its swap and
  kill drill (tests/test_decode.py:345).
"""
import os

import numpy as np
import pytest

import jax.numpy as jnp
import mxnet_tpu as jmx
import mxnet_tpu.serving.decode as jdec
from mxnet_tpu import sparse as jsp
from mxnet_tpu.models.transformer import get_symbol as jax_lm
from mxnet_tpu.parallel.mesh import MeshSpec as JaxMeshSpec
from mxnet_tpu.parallel.mesh import make_mesh as jax_make_mesh
from mxnet_tpu.parallel.trainer import ShardedTrainer as JaxTrainer

import torch_dist_workers as W
from mxnet_tpu_torch.parallel.placement import zero_shard_dim

RTOL, ATOL = 2e-4, 2e-5
CASES2 = ("cuda_untouched", "lm_dp", "lm_local", "lm_zero",
          "lm_sharded_state", "lm_zero_accum", "lm_nan", "bn_dp",
          "bn_dp_batch",
          "module_sync", "module_sync_2bit", "gluon_sync", "async_avg",
          "async_avg_rsp", "rsp_allreduce", "rec", "lm_tp2", "decode_tp",
          "decode_tp_engine")


result = W.result


def _jax_mesh(n):
    return JaxMeshSpec(jax_make_mesh((n,), ("dp",)))


# -- inputs and JAX references -------------------------------------------
#
# Each ``_*_inputs`` writes the gang's inputs and returns a function that
# computes the JAX package's references, so that the fixture runs the
# references while the gang trains.

def _host(x):
    return np.asarray(x)


def _lm_inputs(outdir):
    T = W.LM["seq_len"]
    shapes = {"data": (W.LM_BATCH, T), "softmax_label": (W.LM_BATCH, T)}
    jt = JaxTrainer(jax_lm(**W.LM), _jax_mesh(2), **W.LM_HYPER)
    params, mom, aux = jt.init_state(shapes, seed=5)
    rs = np.random.RandomState(23)
    batches = [{k: rs.randint(0, W.LM["vocab_size"], (W.LM_BATCH, T))
                .astype(np.float32) for k in shapes}
               for _ in range(W.LM_STEPS)]
    inp = {"p_" + n: _host(p) for n, p in zip(jt.param_names, params)}
    inp.update({"a_" + n: _host(a) for n, a in zip(jt.prog.aux_names, aux)})
    for i, b in enumerate(batches):
        inp.update({"b%d_%s" % (i, k): v for k, v in b.items()})
    np.savez(os.path.join(outdir, "lm.in.npz"), **inp)

    def train(t, steps):
        p, m, a = t.init_state(shapes, seed=5)
        losses = []
        for b in steps:
            p, m, a, loss = t.step(p, m, a, b)
            losses.append(float(loss))
        return {"p": dict(zip(t.param_names, map(_host, p))),
                "m": dict(zip(t.param_names, map(_host, m))),
                "loss": losses}

    def refs():
        accum = JaxTrainer(jax_lm(**W.LM), _jax_mesh(2),
                           **dict(W.LM_HYPER, grad_accum=2))
        return {"plain": train(jt, batches), "accum": train(accum, batches),
                "nan": train(jt, [batches[0], batches[2]])}
    return refs


def _bn_inputs(outdir):
    shapes = {"data": W.BN_SHAPE, "softmax_label": W.BN_SHAPE[:1]}
    jts = {n: JaxTrainer(W.bn_symbol(jmx.sym, n), _jax_mesh(2), **W.BN_HYPER)
           for n in ("valid", "batch")}
    p, m, a = jts["valid"].init_state(shapes, seed=3)
    names, aux_names = jts["valid"].param_names, jts["valid"].prog.aux_names
    rs = np.random.RandomState(31)
    batches = [{"data": rs.randn(*W.BN_SHAPE).astype(np.float32),
                "softmax_label": rs.randint(0, 5, W.BN_SHAPE[:1])
                .astype(np.float32)} for _ in range(W.BN_STEPS)]
    inp = {"p_" + n: _host(x) for n, x in zip(names, p)}
    inp.update({"a_" + n: _host(x) for n, x in zip(aux_names, a)})
    for i, b in enumerate(batches):
        inp.update({"b%d_%s" % (i, k): v for k, v in b.items()})
    np.savez(os.path.join(outdir, "bn.in.npz"), **inp)

    def refs():
        out = {}
        for n, jt in jts.items():
            pn, mn, an = jt.init_state(shapes, seed=3)
            for b in batches:
                pn, mn, an, _ = jt.step(pn, mn, an, b)
            out[n] = {"p": dict(zip(names, map(_host, pn))),
                      "a": dict(zip(aux_names, map(_host, an)))}
        return out
    return refs


def _module_inputs(outdir, world=2):
    rs = np.random.RandomState(41)
    rows = W.MLP_BATCH * W.MLP_BATCHES
    X = rs.randn(rows, W.MLP_DIM).astype(np.float32)
    y = rs.randint(0, W.MLP_CLASSES, rows).astype(np.float32)
    args = {"fc1_weight": rs.normal(0, 0.3, (16, W.MLP_DIM)),
            "fc1_bias": rs.normal(0, 0.1, (16,)),
            "fc2_weight": rs.normal(0, 0.3, (W.MLP_CLASSES, 16)),
            "fc2_bias": rs.normal(0, 0.1, (W.MLP_CLASSES,))}
    args = {k: v.astype(np.float32) for k, v in args.items()}
    inp = dict(X=X, y=y, **{"p_" + k: v for k, v in args.items()})
    np.savez(os.path.join(outdir, "module.in.npz"), **inp)

    def refs():
        mod = jmx.mod.Module(W.mlp_symbol(jmx.sym),
                             context=[jmx.cpu(i) for i in range(world)])
        mod.fit(jmx.io.NDArrayIter(X, y, batch_size=W.MLP_BATCH),
                num_epoch=1, kvstore=jmx.kv.create("device"),
                optimizer="sgd",
                optimizer_params=dict(learning_rate=0.1, momentum=0.9),
                arg_params={k: jmx.nd.array(v) for k, v in args.items()},
                initializer=None)
        got, _ = mod.get_params()
        return {"X": X, "y": y, "args": args,
                "jax": {k: v.asnumpy() for k, v in got.items()}}
    return refs


def _rec_inputs(outdir, S):
    jembs = [jsp.ShardedEmbedding(W.REC["V"], W.REC["D"], _jax_mesh(S),
                                  name="t%d" % f) for f in range(W.REC["F"])]
    state = jsp.recommender_state(jembs, dense_dim=W.REC["dense"],
                                  hidden=W.REC["hidden"], seed=0)
    rs = np.random.RandomState(51)
    inp = {"table%d" % f: _host(t)[:W.REC["V"]]
           for f, t in enumerate(state["tables"])}
    inp.update({"mlp_" + k: _host(v) for k, v in state["mlp"].items()})
    touched = [set() for _ in range(W.REC["F"])]
    batches = []
    for i in range(W.REC["steps"]):
        B = W.REC["B"]
        ids = rs.randint(0, W.REC["V"] // 2, (W.REC["F"], B)).astype(
            np.int32)
        ids[:, :4] = ids[:, :1]           # duplicates across ranks' parts
        batch = {"ids": ids, "dense": rs.rand(B, W.REC["dense"])
                 .astype(np.float32),
                 "label": (rs.rand(B) > 0.5).astype(np.float32)}
        inp.update({k + str(i): v for k, v in batch.items()})
        for f in range(W.REC["F"]):
            touched[f].update(ids[f].tolist())
        batches.append(batch)
    np.savez(os.path.join(outdir, "rec.in.npz"), **inp)

    def refs():
        st = state
        step = jsp.make_recommender_step(jembs, lr=0.05, momentum=0.9)
        losses = []
        for batch in batches:
            st, loss = step(st, {k: jnp.asarray(v) for k, v in batch.items()})
            losses.append(float(loss))
        return {"inp": inp, "loss": losses, "touched": touched,
                "tables": [_host(t)[:W.REC["V"]] for t in st["tables"]],
                "moms": [_host(m)[:W.REC["V"]] for m in st["moms"]],
                "mlp": {k: _host(v) for k, v in st["mlp"].items()}}
    return refs


def _device_shards(x, n):
    """The blocks of a JAX array on devices 0..n-1, by device index."""
    import jax
    devs = jax.devices()[:n]
    by = {sh.device: np.asarray(sh.data) for sh in x.addressable_shards}
    return [by[d] for d in devs]


def _jax_tp_train(symbol, axes, kw, hyper, shapes, batches, seed,
                  init=None):
    """The JAX trainer over ``axes`` from ``init`` (whole host arrays by
    name; else its own ``init_state(seed)``): the whole state, each
    device's blocks and the losses."""
    import jax
    spec = JaxMeshSpec.build(axes)
    jt = JaxTrainer(symbol, spec, **dict(hyper, **kw))
    p, m, a = jt.init_state(shapes, seed=seed)
    if init is not None:
        p = tuple(jax.device_put(init[n].astype(np.asarray(x).dtype),
                                 x.sharding)
                  for n, x in zip(jt.param_names, p))
    losses = []
    for b in batches:
        p, m, a, loss = jt.step(p, m, a, b)
        losses.append(float(loss))
    n = spec.mesh.size
    return {"p": dict(zip(jt.param_names, map(_host, p))),
            "m": dict(zip(jt.param_names, map(_host, m))),
            "sp": {k: _device_shards(x, n) for k, x in
                   zip(jt.param_names, p)},
            "sm": {k: _device_shards(x, n) for k, x in
                   zip(jt.param_names, m)}, "loss": losses}


def _tp_lm_inputs(outdir, names):
    """The lm inputs (those of :func:`_lm_inputs`) and the JAX trainer's
    runs over the meshes of ``names`` (``W.TP_LM``)."""
    T = W.LM["seq_len"]
    shapes = {"data": (W.LM_BATCH, T), "softmax_label": (W.LM_BATCH, T)}
    if not os.path.exists(os.path.join(outdir, "lm.in.npz")):
        _lm_inputs(outdir)
    with np.load(os.path.join(outdir, "lm.in.npz")) as f:
        inp = {k: f[k] for k in f.files}
    batches = [{k: inp["b%d_%s" % (i, k)] for k in shapes}
               for i in range(W.LM_STEPS)]
    init = {k[2:]: v for k, v in inp.items() if k.startswith("p_")}

    def refs():
        return {n: _jax_tp_train(jax_lm(**W.LM), W.TP_LM[n][0],
                                 W.TP_LM[n][1], W.LM_HYPER, shapes,
                                 batches, 5, init) for n in names}
    return refs


def _tp_mlp_inputs(outdir):
    M = W.TP_MLP
    shapes = {"data": (M["batch"], M["dim"]),
              "softmax_label": (M["batch"],)}
    rs = np.random.RandomState(61)
    inp = {"p_fc1_weight": rs.normal(0, .3, (M["hidden"], M["dim"])),
           "p_fc1_bias": rs.normal(0, .1, (M["hidden"],)),
           "p_fc2_weight": rs.normal(0, .3, (M["classes"], M["hidden"])),
           "p_fc2_bias": rs.normal(0, .1, (M["classes"],))}
    for i in range(M["steps"]):
        inp["x%d" % i] = rs.rand(M["batch"], M["dim"])
        inp["y%d" % i] = rs.randint(0, M["classes"], M["batch"])
    inp = {k: v.astype(np.float32) for k, v in inp.items()}
    np.savez(os.path.join(outdir, "tpmlp.in.npz"), **inp)
    batches = [{"data": inp["x%d" % i], "softmax_label": inp["y%d" % i]}
               for i in range(M["steps"])]
    init = {k[2:]: v for k, v in inp.items() if k.startswith("p_")}

    def refs():
        return _jax_tp_train(W.tp_mlp_symbol(jmx.sym), M["mesh"], {},
                             M["hyper"], shapes, batches, 0, init)
    return refs


def _dec_inputs(outdir):
    """The decode toy's parameters at both vocabs, and the JAX package's
    tp-2 programs teacher-forced over them, plus its one-process engine's
    tokens for the engine case's requests."""
    inp = {}
    for vocab in W.TP_DEC["vocabs"]:
        params = jdec.init_decode_params(W.tp_decode_config(jdec, vocab),
                                         seed=3)
        inp.update({"v%d_%s" % (vocab, k): v for k, v in params.items()})
    np.savez(os.path.join(outdir, "dec.in.npz"), **inp)

    def refs():
        out = {}
        for vocab in W.TP_DEC["vocabs"]:
            params = {k[len("v%d_" % vocab):]: v for k, v in inp.items()
                      if k.startswith("v%d_" % vocab)}
            for qz in ((None, "int8", "int4") if vocab == 29 else (None,)):
                prog = jdec.DecodeProgram(params, W.tp_decode_config(
                    jdec, vocab), quantize=qz, mesh={"tp": 2})
                out["v%d_%s" % (vocab, qz or "f32")] = W.tp_teacher_forced(
                    prog, prog.fresh_cache(), W.tp_decode_tokens(vocab), 2,
                    np.asarray)
        params = {k[4:]: v for k, v in inp.items() if k.startswith("v29_")}
        with jdec.DecodeEngine(jdec.DecodeProgram(params, W.tp_decode_config(
                jdec, 29)), default_deadline=60.0) as eng:
            futs = [eng.submit(p, max_new_tokens=m)
                    for p, m in W.tp_requests(29)]
            out["engine"] = [f.result(timeout=60)[0] for f in futs]
        return out
    return refs


def gang_with_refs(outdir, n, cases, inputs):
    """Write every input (``inputs``: name -> an ``_*_inputs`` result's
    maker), start the gang, compute the JAX references while it runs,
    and wait for it."""
    makers = {k: f() for k, f in inputs.items()}
    proc = W.start_gang(outdir, n, cases)
    try:
        refs = {k: f() for k, f in makers.items()}
    except BaseException:
        proc.kill()
        proc.communicate()
        raise
    W.wait_gang(proc)
    return outdir, refs


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    outdir = str(tmp_path_factory.mktemp("gang2"))
    return gang_with_refs(outdir, 2, CASES2, {
        "lm": lambda: _lm_inputs(outdir), "bn": lambda: _bn_inputs(outdir),
        "module": lambda: _module_inputs(outdir),
        "rec": lambda: _rec_inputs(outdir, 2),
        "tplm": lambda: _tp_lm_inputs(outdir, ("lm_tp2",)),
        "dec": lambda: _dec_inputs(outdir)})


# -- the dp trainer --------------------------------------------------------

def _close(got, want, rtol=RTOL, atol=ATOL, what=""):
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                               err_msg=what)


def _ranks_equal(outdir, name, keys=("p_",)):
    a, b = result(outdir, name, 0), result(outdir, name, 1)
    for k in a:
        if k.startswith(keys):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    return a, b


@pytest.mark.parametrize("name,ref", [("lm_dp", "plain"),
                                      ("lm_local", "plain"),
                                      ("lm_zero", "plain"),
                                      ("lm_sharded_state", "plain"),
                                      ("lm_zero_accum", "accum")])
def test_dp_trainer_matches_jax(gang, name, ref):
    """Global batch 4 over dp 2, three momentum steps: the port's ranks
    (each its half, by slicing or ``local_batch``; with ZeRO each rank
    updates its half of each shardable parameter and momentum) against
    the JAX trainer on a 2-device mesh.  ZeRO keeps half the momentum
    bytes on each rank, and its audit trail records the reduce-scatter
    and all-gather payloads of ``zero_update_model_bytes``."""
    outdir, refs = gang
    want = refs["lm"][ref]
    a, b = _ranks_equal(outdir, name)
    for n, v in want["p"].items():
        _close(a["p_" + n], v, what=n)
    np.testing.assert_allclose(a["loss"], want["loss"], rtol=1e-5)
    full = sum(v.nbytes for v in want["m"].values())
    if name != "lm_dp" and name != "lm_local":
        for n, v in want["m"].items():
            d = zero_shard_dim(v.shape, [None] * v.ndim, 2)
            got = v if d is None else np.concatenate(
                [a["m_" + n], b["m_" + n]], axis=d)
            _close(got, v, what="mom " + n)
        assert a["mom_bytes"] < 0.52 * full and b["mom_bytes"] < 0.52 * full
        if name == "lm_sharded_state":
            # storage only: the gradients all-reduced whole, the
            # updated slices all-gathered
            assert a["audit_reduce-scatter"] == 0
            assert a["audit_all-gather"] > 0
            return
        rs_b, ag_b, ar_b = a["zero_model"]
        assert a["audit_reduce-scatter"] == rs_b
        assert a["audit_all-gather"] == ag_b
        # the residual all-reduce, plus the loss-and-verdict pair
        assert a["audit_all-reduce"] == ar_b + 8
    else:
        assert a["mom_bytes"] == full
        for n, v in want["m"].items():
            _close(a["m_" + n], v, what="mom " + n)


def test_batchnorm_under_dp_uses_the_global_batch(gang):
    """A conv net with a training BatchNorm over dp 2: the statistics,
    and so the moving averages and the trained weights, are the global
    batch's, as the JAX package's partitioned step computes."""
    outdir, refs = gang
    _check_bn(outdir, "bn_dp", refs["bn"]["valid"])


def test_batch_normalised_loss_head_under_dp_counts_the_global_batch(gang):
    """The same net with ``SoftmaxOutput(normalization="batch")``: under
    dp 2 each rank's head divides by the global batch's count, as the
    JAX package's partitioned step does."""
    outdir, refs = gang
    _check_bn(outdir, "bn_dp_batch", refs["bn"]["batch"])


def _check_bn(outdir, name, want):
    a, _b = _ranks_equal(outdir, name, keys=("p_", "a_"))
    for n, v in want["p"].items():
        _close(a["p_" + n], v, what=n)
    for n, v in want["a"].items():
        _close(a["a_" + n], v, what=n)


def test_nan_grad_on_one_rank_skips_the_step_on_every_rank(gang):
    """``nan_grad`` fires at step 2 on rank 1 only: both ranks count one
    skipped step and end where the JAX trainer ends after steps 1 and
    3."""
    outdir, refs = gang
    a, b = _ranks_equal(outdir, "lm_nan")
    assert int(a["skipped"]) == int(b["skipped"]) == 1
    assert not np.isfinite(a["loss"][1])
    for n, v in refs["lm"]["nan"]["p"].items():
        _close(a["p_" + n], v, what=n)


# -- Module.fit through dist_sync -----------------------------------------

def test_dist_sync_module_fit_matches_jax_two_contexts(gang):
    outdir, refs = gang
    a, _b = _ranks_equal(outdir, "module_sync")
    for n, v in refs["module"]["jax"].items():
        _close(a["p_" + n], v, rtol=1e-5, atol=1e-6, what=n)


def test_dist_sync_two_bit_equals_the_one_process_sum(gang):
    outdir, refs = gang
    a, _b = _ranks_equal(outdir, "module_sync_2bit")
    m = refs["module"]
    want = W.two_bit_reference(m["X"], m["y"], m["args"], 2, 0.05)
    for n, v in want.items():
        np.testing.assert_array_equal(a["p_" + n], v, err_msg=n)


def test_gluon_dist_sync_matches_jax_one_process(gang):
    """``gluon.Trainer(kvstore="dist_sync")`` over two ranks, each on its
    half of the batch, against the JAX package's Trainer on the whole
    batch in one process (the store's sum is the whole batch's
    gradient): rtol 1e-5 / atol 1e-6."""
    outdir, _refs = gang
    a, _b = _ranks_equal(outdir, "gluon_sync")
    X, y, w = W.gluon_data()
    want = W.gluon_fit(jmx, X, y, w, "device", jmx.cpu())
    for k, v in want.items():
        _close(a["p_" + k], v, rtol=1e-5, atol=1e-6, what=k)


def test_joining_the_gang_initialises_no_cuda(gang):
    outdir, _refs = gang
    for r in (0, 1):
        got = result(outdir, "cuda_untouched", r)
        assert not bool(got["initialized"])
        assert str(got["device"]) == "cpu"


# -- the stores ------------------------------------------------------------

def test_dist_async_averages_every_interval(gang):
    """Interval 2, SGD lr 0.1: rank r pushes (r+1)*step; its own value
    moves alone for two pushes, then the ranks' values are averaged;
    ``sync_weights`` averages once more."""
    outdir, _refs = gang
    got = [result(outdir, "async_avg", r) for r in (0, 1)]
    vals = [np.ones(4, np.float32) for _ in range(2)]
    want = [[], []]
    for step in range(1, 4):
        for r in (0, 1):
            vals[r] = vals[r] - np.float32(0.1) * np.float32((r + 1) * step)
        if step % 2 == 0:
            avg = (vals[0] + vals[1]) / np.float32(2)
            vals = [avg.copy(), avg.copy()]
        for r in (0, 1):
            want[r].append(vals[r].copy())
    avg = (vals[0] + vals[1]) / np.float32(2)
    for r in (0, 1):
        want[r].append(avg)
        np.testing.assert_array_equal(got[r]["seen"], np.stack(want[r]))
        assert int(got[r]["rank"]) == r and int(got[r]["workers"]) == 2
        assert int(got[r]["dead"]) == 0


def test_dist_async_averages_a_row_sparse_key_by_its_holders(gang):
    """Each row is averaged over the ranks that hold it (a row on one
    rank keeps its value), as the JAX package's ``_average_key``."""
    outdir, _refs = gang
    total = np.zeros((6, 2), np.float32)
    count = np.zeros(6, np.float32)
    for r in (0, 1):
        ids, vals = W.async_rsp_push(r, 2)
        total[ids] += vals
        count[ids] += 1
    want = total / np.maximum(count, 1)[:, None]
    for r in (0, 1):
        np.testing.assert_array_equal(
            result(outdir, "async_avg_rsp", r)["dense"], want)


def test_allreduce_row_sparse_is_the_union_sum(gang):
    outdir, _refs = gang
    dense = np.zeros((8, 3), np.float32)
    for r in (0, 1):
        ids, vals = W.rsp_rows(r)
        dense[ids] += vals
    for r in (0, 1):
        got = result(outdir, "rsp_allreduce", r)
        assert got["ids"].tolist() == sorted(np.flatnonzero(
            np.abs(dense).sum(1)).tolist())
        np.testing.assert_array_equal(got["data"], dense[got["ids"]])
        np.testing.assert_array_equal(got["pushed"], dense)


# -- the recommender over a dp mesh -----------------------------------------

def _check_rec(outdir, ref, n):
    REL = 1e-6
    got = [result(outdir, "rec", r) for r in range(n)]
    for r in range(1, n):
        for k in got[0]:
            if k != "loss" and not k.startswith("mom"):
                np.testing.assert_array_equal(got[r][k], got[0][k], err_msg=k)
    g = got[0]
    np.testing.assert_allclose(g["loss"], ref["loss"], atol=1e-6)
    for f in range(W.REC["F"]):
        for key, want in (("table", ref["tables"][f]),
                          ("mom", ref["moms"][f])):
            have = g["%s%d" % (key, f)]
            err = np.abs(have - want).max()
            assert err <= REL * np.abs(want).max(), (key, f, err)
        untouched = sorted(set(range(W.REC["V"])) - ref["touched"][f])
        assert untouched
        np.testing.assert_array_equal(g["table%d" % f][untouched],
                                      ref["inp"]["table%d" % f][untouched])
    for k, want in ref["mlp"].items():
        err = np.abs(g["mlp_" + k] - want).max()
        assert err <= REL * np.abs(want).max(), (k, err)


def test_recommender_dp2_matches_jax_xla_backend(gang):
    outdir, refs = gang
    _check_rec(outdir, refs["rec"], 2)


# -- tensor parallelism -----------------------------------------------------

def check_tp(outdir, name, ref, n, axes):
    """A tp trainer case against the JAX trainer's run over the same mesh
    (module docstring); ``axes``: the mesh axes that must carry
    collectives."""
    got = [result(outdir, name, r) for r in range(n)]
    for g in got[1:]:
        for k in g:
            if k.startswith(("w_", "wm_", "loss")):
                np.testing.assert_array_equal(g[k], got[0][k], err_msg=k)
    np.testing.assert_allclose(got[0]["loss"], ref["loss"], rtol=1e-5)
    for k, v in ref["p"].items():
        _close(got[0]["w_" + k], v, what=k)
        _close(got[0]["wm_" + k], ref["m"][k], what="mom " + k)
        for r in range(n):
            _close(got[r]["s_" + k], ref["sp"][k][r], what="%s r%d" % (k, r))
            _close(got[r]["sm_" + k], ref["sm"][k][r],
                   what="mom %s r%d" % (k, r))
    for g in got:
        seen = {k.split("_")[1] for k in g if k.startswith("audit_")}
        assert seen == set(axes), seen


def test_tp2_trainer_matches_jax(gang):
    """The LM at tp 2 (every FC and the embedding split over tp, the
    flash-free einsum path), three momentum steps, against the JAX
    trainer on a tp-2 mesh: rank r holds the JAX array's shard on device
    r; every collective ran on the tp group."""
    outdir, refs = gang
    check_tp(outdir, "lm_tp2", refs["tplm"]["lm_tp2"], 2, ("tp",))
    a = result(outdir, "lm_tp2", 0)
    assert a["s_l0_ff1_weight"].shape[0] * 2 == a["w_l0_ff1_weight"].shape[0]
    assert a["s_tok_embed_weight"].shape[0] * 2 == \
        a["w_tok_embed_weight"].shape[0]
    assert a["audit_tp_all-gather"] > 0 and a["audit_tp_all-reduce"] > 0


@pytest.mark.parametrize("vocab,qz", [(29, None), (29, "int8"),
                                      (29, "int4"), (32, None)])
def test_tp2_decode_matches_jax_tp2(gang, vocab, qz):
    """Teacher-forced tp-2 decode against the JAX package's tp-2 program:
    tokens equal, logits within 1e-4, each rank's KV heads within 1e-5 of
    the JAX pool's on its device, the ranks' outputs equal, and one
    step's collectives exactly ``decode_tp_model_bytes`` on the tp axis
    (vocab 29 keeps a whole head and gathers nothing)."""
    from mxnet_tpu_torch.serving import decode as tdec
    outdir, refs = gang
    tag = "v%d_%s" % (vocab, qz or "f32")
    jn, jl, jkv = refs["dec"][tag]
    got = [result(outdir, "decode_tp", r) for r in (0, 1)]
    np.testing.assert_array_equal(got[0]["next_" + tag],
                                  got[1]["next_" + tag])
    np.testing.assert_array_equal(got[0]["logits_" + tag],
                                  got[1]["logits_" + tag])
    assert np.array_equal(got[0]["next_" + tag], jn), tag
    assert np.abs(got[0]["logits_" + tag] - jl).max() < 1e-4, tag
    h = jkv.shape[3] // 2
    for r, g in enumerate(got):
        kv = g["kv_" + tag]
        assert kv.shape[3] == h
        assert np.abs(kv[:, :, 1:] - jkv[:, :, 1:, r * h:(r + 1) * h]
                      ).max() < 1e-5, (tag, r)
        cfg = W.tp_decode_config(tdec, vocab)
        want = tdec.decode_tp_model_bytes(cfg, 2)
        assert want == jdec.decode_tp_model_bytes(
            W.tp_decode_config(jdec, vocab), 2)
        have = {k[len("audit_%s_" % tag):]: int(v) for k, v in g.items()
                if k.startswith("audit_%s_" % tag)}
        assert have == want, (tag, have, want)
        assert g["axes_" + tag].tolist() == ["tp"]
    if tag == "v32_f32":
        for g in got:
            assert int(g["loaded_tp"]) == 2
            np.testing.assert_array_equal(g["next_loaded"], jn)
            np.testing.assert_array_equal(g["logits_loaded"],
                                          got[0]["logits_" + tag])


def test_tp2_engine_matches_jax_and_survives_the_drill(gang):
    """The tp-2 engine (rank 0 leads, rank 1 follows): its tokens equal
    the JAX one-process engine's; then a swap mid-generation completes
    all six requests in time, an exec_error burst sheds typed on every
    rank (the follower counts the failed steps), the pool drains clean
    and a geometry mismatch is refused with the swapped model serving."""
    outdir, refs = gang
    a, b = (result(outdir, "decode_tp_engine", r) for r in (0, 1))
    for i, want in enumerate(refs["dec"]["engine"]):
        np.testing.assert_array_equal(a["parity%d" % i], want)
    assert bool(a["swapped"]) and int(a["ok"]) == 6
    assert set(a["doomed"].tolist()) <= {"ExecFailed", "DeadlineExceeded",
                                         "CircuitOpen"}
    assert a["pages"][0] == a["pages"][1]
    assert str(a["mismatch"]) == "SwapFailed" and bool(a["still_b"])
    assert int(b["parity_steps"]) > 0 and int(b["parity_swaps"]) == 1
    assert int(b["drill_swaps"]) == 2
    assert int(b["drill_exec_failures"]) >= 1
