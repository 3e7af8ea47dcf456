"""The port's sparse plane (``mxnet_tpu_torch/sparse``) against the JAX
package's (``mxnet_tpu/sparse``) on a one-device mesh,
``make_mesh((1,), ("dp",))``, the port on the CPU.

The JAX package draws its tables from ``jax.random``, so every case
carries the JAX state across (``ShardedEmbedding.load_array``,
``convert.recommender_state_from_numpy``) and feeds both sides the same
numpy ids and gradients.  The JAX side runs its XLA backend.

Tolerances: a lookup is a copy and must be exact.  An update rounds each
PyTorch op on its own, where XLA:CPU fuses the update and contracts
``a*b + c`` into one rounding, so updated tensors agree to about 1 ulp
per op: within 1e-6 of each tensor's largest magnitude (ROADMAP queue C,
"Bit parity in the sparse optimizer").  Three recommender steps add the
MLP's matmuls, summed in another order: the same 1e-6 bar, and losses
within 1e-6.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from mxnet_tpu.parallel.mesh import MeshSpec as JaxMeshSpec
from mxnet_tpu.parallel.mesh import make_mesh as jax_make_mesh
from mxnet_tpu import sparse as jsp
from mxnet_tpu_torch import convert
from mxnet_tpu_torch import sparse as tsp
from mxnet_tpu_torch.base import MXNetError, NotPortedYet
from mxnet_tpu_torch.ops.kernels import LAUNCHES
from mxnet_tpu_torch.parallel import MeshSpec, make_mesh
from mxnet_tpu_torch.parallel import audit
from mxnet_tpu_torch.sparse import embedding as tembedding

REL = 1e-6


@pytest.fixture(scope="module")
def specs():
    return (JaxMeshSpec(jax_make_mesh((1,), ("dp",))),
            MeshSpec(make_mesh((1,), ("dp",), device="cpu")))


def _pair(specs, V, D, seed, name, **kw):
    """A JAX table and the port's plane with the same table carried
    across."""
    jspec, tspec = specs
    je = jsp.ShardedEmbedding(V, D, jspec, name=name, **kw)
    te = tsp.ShardedEmbedding(V, D, tspec, name=name, **kw)
    jt = je.init_state(seed=seed)
    return je, jt, te, te.load_array(np.asarray(jt))


def _close(got, want, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    err = np.abs(got - want).max()
    assert err <= REL * max(np.abs(want).max(), 1e-30), (what, err)


def _exact_grads(rs, b, d):
    return (rs.randint(-8, 8, (b, d)) / 1024.0).astype(np.float32)


# ---------------------------------------------------------------------------
# routed lookup
# ---------------------------------------------------------------------------

def test_lookup_matches_jax_with_duplicates_and_edges(specs):
    V, D, B = 100, 8, 32
    je, jt, te, tt = _pair(specs, V, D, 0, "lk")
    rs = np.random.RandomState(0)
    ids = rs.randint(0, V, B).astype(np.int64)
    ids[5:9] = ids[0]
    ids[10:12] = (0, V - 1)
    want = np.asarray(je.lookup(jt, jnp.asarray(ids)))
    got = te.lookup(tt, torch.from_numpy(ids))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, np.asarray(jt)[ids])


@pytest.mark.parametrize("factor", [None, 0.25], ids=["full", "starved"])
def test_lookup_stats_and_capacity_drops_match_jax(specs, factor):
    V, D, B = 96, 4, 64
    je, jt, te, tt = _pair(specs, V, D, 2, "lk3", capacity_factor=factor)
    ids = np.random.RandomState(3).randint(0, V, B).astype(np.int64)
    j_out, j_rec, j_drop = je.lookup(jt, jnp.asarray(ids), stats=True)
    t_out, t_rec, t_drop = te.lookup(tt, torch.from_numpy(ids), stats=True)
    np.testing.assert_array_equal(t_out.numpy(), np.asarray(j_out))
    np.testing.assert_array_equal(t_rec.numpy(), np.asarray(j_rec))
    np.testing.assert_array_equal(t_drop.numpy(), np.asarray(j_drop))
    assert (int(t_drop.sum()) > 0) == (factor is not None)
    assert te.capacity(B) == je.capacity(B)
    assert te.wire_model(B) == je.wire_model(B)


# ---------------------------------------------------------------------------
# lazy updates
# ---------------------------------------------------------------------------

SGD_CASES = [
    dict(momentum=0.5, wd=0.0078125, lr=0.5),
    dict(momentum=0.9, wd=0.01, lr=0.5, random=True),
    dict(momentum=None, wd=0.0078125, lr=0.25, rescale_grad=0.5,
         clip_gradient=0.001953125),
    dict(momentum=0.9, lr=0.05, rescale_grad=2.0, clip_gradient=0.003,
         random=True),
]


@pytest.mark.parametrize("case", SGD_CASES,
                         ids=["pow2", "arbitrary", "no-mom-clip-rescale",
                              "mom-clip-rescale"])
def test_apply_sgd_matches_jax(specs, case):
    case = dict(case)
    random = case.pop("random", False)
    momentum = case.pop("momentum")
    V, D, B = 96, 8, 32
    je, jt, te, tt = _pair(specs, V, D, 5, "sgd")
    rs = np.random.RandomState(9)
    ids = rs.randint(0, V, B).astype(np.int64)
    ids[:B // 4] = ids[0]                        # heavy duplication
    grads = rs.randn(B, D).astype(np.float32) * 0.01 if random \
        else _exact_grads(rs, B, D)
    if momentum is None:
        jmom = tmom = None
    else:
        jmom = je.zeros_slot()
        tmom = te.zeros_slot()
        case["momentum"] = momentum
    jt2, jm2 = je.apply_sgd(jt, jmom, jnp.asarray(ids), jnp.asarray(grads),
                            **case)
    before = tt.clone()
    tt2, tm2 = te.apply_sgd(tt, tmom, torch.from_numpy(ids),
                            torch.from_numpy(grads), **case)
    assert tt2 is tt and tm2 is tmom             # in place
    _close(tt2.numpy(), jt2, "table")
    if momentum is not None:
        _close(tm2.numpy(), jm2, "momentum")
    else:
        assert jm2 is None and tm2 is None
    # untouched rows are bit-identical, touched rows moved
    untouched = np.setdiff1d(np.arange(V), ids)
    assert torch.equal(tt[untouched], before[untouched])
    assert (tt[np.unique(ids)] != before[np.unique(ids)]).any(dim=1).all()
    if momentum is not None:
        assert (tm2[untouched] == 0).all()


def test_apply_adam_matches_jax(specs):
    V, D, B = 96, 8, 32
    je, jt, te, tt = _pair(specs, V, D, 6, "adam")
    rs = np.random.RandomState(11)
    ids = rs.randint(0, V, B).astype(np.int64)
    ids[3:7] = ids[2]
    grads = _exact_grads(rs, B, D)
    kw = dict(lr=0.01, wd=0.001, beta1=0.9, beta2=0.999,
              clip_gradient=0.005)
    jout = je.apply_adam(jt, je.zeros_slot(), je.zeros_slot(),
                         jnp.asarray(ids), jnp.asarray(grads), **kw)
    mean, var = te.zeros_slot(), te.zeros_slot()
    before = tt.clone()
    tout = te.apply_adam(tt, mean, var, torch.from_numpy(ids),
                         torch.from_numpy(grads), **kw)
    assert tout[0] is tt and tout[1] is mean and tout[2] is var
    for name, a, b in zip(("table", "mean", "var"), tout, jout):
        _close(a.numpy(), b, name)
    untouched = np.setdiff1d(np.arange(V), ids)
    assert torch.equal(tt[untouched], before[untouched])
    assert (var[untouched] == 0).all()


# ---------------------------------------------------------------------------
# state: snapshot, restore, reshard
# ---------------------------------------------------------------------------

def test_state_dict_load_array_round_trip(specs):
    jspec, tspec = specs
    te = tsp.ShardedEmbedding(50, 4, tspec, name="ckpt")
    table = te.init_state(seed=3)
    mom = te.zeros_slot()
    snap = te.state_dict(table, mom=mom, var=None)
    assert sorted(snap) == ["mom", "table"]
    ids = torch.arange(8)
    te.apply_sgd(table, mom, ids, torch.ones(8, 4), lr=0.5, momentum=0.9)
    # the snapshot is a copy: the in-place update did not reach it
    assert not np.array_equal(snap["table"], table.numpy())
    other = te.reshard(MeshSpec(make_mesh((1,), ("dp",), device="cpu")))
    assert (other.num_rows, other.dim, other.name) == (50, 4, "ckpt")
    back = other.load_array(snap["table"])
    np.testing.assert_array_equal(back.numpy(), snap["table"])
    with pytest.raises(ValueError):
        other.load_array(snap["table"][:10])
    # the same seed gives the same table; the JAX plane's sizing agrees
    np.testing.assert_array_equal(te.init_state(seed=3).numpy(),
                                  te.init_state(seed=3).numpy())
    je = jsp.ShardedEmbedding(50, 4, jspec, name="ckpt")
    assert te.table_bytes == je.table_bytes
    assert ("ckpt", te.table_bytes) in tsp.live_tables()
    for args in ((4096, 16, 1), (64, 8, 4, 5)):
        assert tsp.lookup_wire_bytes(*args) == jsp.lookup_wire_bytes(*args)
        assert tsp.step_alltoall_model_bytes(*args) == \
            jsp.step_alltoall_model_bytes(*args)


# ---------------------------------------------------------------------------
# the recommender step
# ---------------------------------------------------------------------------

def _host_state(state):
    return {"tables": tuple(np.asarray(t) for t in state["tables"]),
            "moms": tuple(None if m is None else np.asarray(m)
                          for m in state["moms"]),
            "mlp": {k: np.asarray(v) for k, v in state["mlp"].items()},
            "mlp_mom": {k: np.asarray(v)
                        for k, v in state["mlp_mom"].items()}}


def test_recommender_three_steps_match_jax(specs):
    jspec, tspec = specs
    F, V, D, Dd, B = 3, 200, 8, 5, 64
    jembs = [jsp.ShardedEmbedding(V, D, jspec, name="rec%d" % f)
             for f in range(F)]
    tembs = [tsp.ShardedEmbedding(V, D, tspec, name="rec%d" % f)
             for f in range(F)]
    jstate = jsp.recommender_state(jembs, dense_dim=Dd, hidden=(16, 8),
                                   seed=0)
    tstate = convert.recommender_state_from_numpy(_host_state(jstate), "cpu")
    # the MLP is drawn from numpy on both sides: the same bytes
    own = tsp.recommender_state(tembs, dense_dim=Dd, hidden=(16, 8), seed=0)
    for k, v in own["mlp"].items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(jstate["mlp"][k]))
    jstep = jsp.make_recommender_step(jembs, lr=0.05, momentum=0.9, wd=1e-4)
    tstep = tsp.make_recommender_step(tembs, lr=0.05, momentum=0.9, wd=1e-4)
    rs = np.random.RandomState(4)
    before = dict(LAUNCHES)
    n_audit = len(audit.collective_log())
    for _ in range(3):
        batch = {"ids": rs.randint(0, V, (F, B)).astype(np.int32),
                 "dense": rs.rand(B, Dd).astype(np.float32),
                 "label": (rs.rand(B) > 0.5).astype(np.float32)}
        batch["ids"][:, :8] = batch["ids"][:, :1]
        jstate, jloss = jstep(jstate, {k: jnp.asarray(v)
                                       for k, v in batch.items()})
        same = tstate
        tstate, tloss = tstep(tstate, batch)
        assert tstate is same
        assert abs(float(tloss) - float(jloss)) <= 1e-6
    assert dict(LAUNCHES) == before              # the CPU launches nothing
    # one lookup and one update per table per step on the audit trail
    assert len(audit.collective_log()) - n_audit == min(128, 2 * F * 3)
    got = convert.recommender_state_to_numpy(tstate)
    want = _host_state(jstate)
    for part in ("tables", "moms"):
        for i, (a, b) in enumerate(zip(got[part], want[part])):
            _close(a, b, "%s[%d]" % (part, i))
    for part in ("mlp", "mlp_mom"):
        for k in want[part]:
            _close(got[part][k], want[part][k], "%s.%s" % (part, k))


def _count_gathers(monkeypatch):
    """Record the segment count of every grouped gather call."""
    from mxnet_tpu_torch.sparse import kernels as tkernels
    calls = []
    orig = tkernels.embedding_gather_many

    def counted(tables, ids_list, backend=None):
        calls.append(len(tables))
        return orig(tables, ids_list, backend)

    monkeypatch.setattr(tkernels, "embedding_gather_many", counted)
    return calls


@pytest.mark.parametrize("momentum", [True, False],
                         ids=["momentum", "no-momentum"])
def test_grouped_step_bit_equals_per_table_step(specs, monkeypatch,
                                                momentum):
    """The recommender step gathers every table's lookup rows in one
    grouped call and every table's weight and momentum rows in another;
    from the same state and batches it is bit-equal to the same step
    made of one ``lookup`` and one ``apply_sgd`` per table, over tables
    of mixed width (D 8, 16 and 7)."""
    from mxnet_tpu_torch.sparse import step as tstep
    _jspec, tspec = specs
    dims, V, Dd, B = (8, 16, 7), 150, 5, 64
    embs = [tsp.ShardedEmbedding(V, D, tspec, name="g%d" % f)
            for f, D in enumerate(dims)]
    F = len(embs)
    start = convert.recommender_state_to_numpy(tsp.recommender_state(
        embs, dense_dim=Dd, hidden=(16, 8), seed=2, momentum=momentum))
    rs = np.random.RandomState(8)
    batches = []
    for _ in range(3):
        b = {"ids": rs.randint(0, V, (F, B)).astype(np.int32),
             "dense": rs.rand(B, Dd).astype(np.float32),
             "label": (rs.rand(B) > 0.5).astype(np.float32)}
        b["ids"][:, :6] = b["ids"][:, :1]                 # duplicates
        batches.append(b)

    def per_table_lookup(embs_, tables, ids):
        return [e.lookup(t, ids[f]) for f, (e, t) in enumerate(zip(embs_,
                                                                    tables))]

    def per_table_sgd(embs_, tables, moms, ids, g_rows, lr, mom, wd):
        for f, (e, t, m) in enumerate(zip(embs_, tables, moms)):
            e.apply_sgd(t, m, ids[f], g_rows[f], lr=lr, momentum=mom, wd=wd)

    results = {}
    for mode in ("grouped", "per-table"):
        with monkeypatch.context() as mp:
            if mode == "per-table":
                mp.setattr(tstep, "_lookup_all", per_table_lookup)
                mp.setattr(tstep, "_sgd_all", per_table_sgd)
            calls = _count_gathers(mp)
            state = convert.recommender_state_from_numpy(start, "cpu")
            step = tsp.make_recommender_step(embs, lr=0.05, momentum=0.9,
                                             wd=1e-4)
            losses = [float(step(state, b)[1]) for b in batches]
            results[mode] = (convert.recommender_state_to_numpy(state),
                             losses)
        per_update = 2 * F if momentum else F
        if mode == "grouped":
            assert calls == [F, per_update] * 3      # 2 gathers per step
        else:
            assert calls == ([1] * F + [2 if momentum else 1] * F) * 3
    (a, la), (b, lb) = results["grouped"], results["per-table"]
    assert la == lb
    for part in ("tables", "moms"):
        for x, y in zip(a[part], b[part]):
            if x is None:
                assert y is None and not momentum
            else:
                np.testing.assert_array_equal(x, y)
    for part in ("mlp", "mlp_mom"):
        for k in a[part]:
            np.testing.assert_array_equal(a[part][k], b[part][k])


def test_lookup_and_updates_make_one_grouped_gather(specs, monkeypatch):
    """``lookup``, ``apply_sgd`` (with and without momentum) and
    ``apply_adam`` each read their rows in one grouped gather of 1, 2, 1
    and 3 segments."""
    _jspec, tspec = specs
    e = tsp.ShardedEmbedding(60, 8, tspec, name="one")
    t, m, v = e.init_state(seed=1), e.zeros_slot(), e.zeros_slot()
    rs = np.random.RandomState(3)
    ids = rs.randint(0, 60, 16).astype(np.int32)
    g = _exact_grads(rs, 16, 8)
    calls = _count_gathers(monkeypatch)
    e.lookup(t, ids)
    e.apply_sgd(t, m, ids, g, lr=0.1, momentum=0.9)
    e.apply_sgd(t, None, ids, g, lr=0.1)
    e.apply_adam(t, m, v, ids, g, lr=0.01)
    assert calls == [1, 2, 1, 3]


# ---------------------------------------------------------------------------
# what this slice leaves
# ---------------------------------------------------------------------------

def test_unported_paths_raise(specs, monkeypatch):
    _jspec, tspec = specs
    # a dp mesh of 2 and its all-to-all are ported (they need a gang of
    # 2: tests/test_torch_dist.py); so is a mesh with an ep axis over 2
    # devices (MoE dispatch over it is item 7's second half, step 2)
    with pytest.raises(ValueError, match="gang has 1"):
        make_mesh((2,), ("dp",), device="cpu")
    with pytest.raises(ValueError, match="gang has 1"):
        make_mesh((2,), ("ep",), device="cpu")
    x = torch.zeros(1, 3)
    assert tembedding._a2a(x, "dp", 1) is x
    with pytest.raises(NotPortedYet):
        tsp.tune_embedding(100, 8, 32)
    with pytest.raises(MXNetError):       # bf16/f16/f64 tables: ported
        tsp.ShardedEmbedding(10, 4, tspec, dtype="int32")
    embs = [tsp.ShardedEmbedding(10, 4, tspec, name="np")]
    state = tsp.recommender_state(embs, dense_dim=2, hidden=(4,), seed=0)
    step = tsp.make_recommender_step(embs)
    batch = {"ids": np.zeros((1, 4), np.int32),
             "dense": np.zeros((4, 2), np.float32),
             "label": np.zeros(4, np.float32)}
    with pytest.raises(NotPortedYet):
        tsp.lower_step(step, state, batch)
    monkeypatch.setenv("MXNET_TPU_PREFLIGHT", "1")
    with pytest.raises(NotPortedYet):
        step(state, batch)
    monkeypatch.setenv("MXNET_TPU_PREFLIGHT", "0")
    _state, loss = step(state, batch)
    assert np.isfinite(float(loss))
