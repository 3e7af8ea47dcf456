"""The embedding plane on bfloat16, float16 and float64 tables: the port's
embedding gather and scatter at the table's dtype (``mxnet_tpu_torch/
sparse/kernels.py``, the plain versions that the CUDA kernels are held to
on the card) and its ``ShardedEmbedding`` / recommender step over such
tables, against the JAX package's (``mxnet_tpu/sparse``) on the CPU.

* The kernels: the JAX package's Pallas kernels, called standalone in
  interpret mode (inside ``shard_map`` they raise ``check_vma`` under this
  jax), and its XLA path.  bf16 and f16 are held to Pallas bit for bit:
  the gather and the set scatter are copies (first write wins), and the
  add folds each run of equal sorted ids in order, ``((t + r0) + r1) +
  ...`` rounded to the table's dtype after every add, which inexact
  payloads make visible.  float64 is held to the XLA path bit for bit
  (the Pallas scatter refuses f64: it runs with x64 off).
* The plane: ``lookup``, ``apply_sgd`` and ``apply_adam`` on bf16 and f16
  tables, and two bf16 recommender steps, against the JAX plane's XLA
  backend on a one-device mesh from the same state.  A lookup is a copy
  and must be exact.  An update computes its new rows in float32 and
  rounds them once to the table's dtype; XLA:CPU contracts ``a*b + c``
  into one rounding where PyTorch rounds each op, so the float32 rows may
  differ by an ulp and their roundings by one step of the table's dtype:
  tables within one step of their dtype per element, float32 slots and
  the MLP within 1e-6 of each tensor's largest magnitude.
* Snapshots: a bf16 table's ``state_dict`` crosses to the other package
  and back bit for bit (the JAX package's are ``ml_dtypes`` arrays, the
  port's float32 arrays of the same values).
"""
import ml_dtypes
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from mxnet_tpu import sparse as jsp
from mxnet_tpu.parallel.mesh import MeshSpec as JaxMeshSpec
from mxnet_tpu.parallel.mesh import make_mesh as jax_make_mesh
from mxnet_tpu.sparse import embedding_gather as jax_gather
from mxnet_tpu.sparse import embedding_scatter as jax_scatter
from mxnet_tpu_torch import convert
from mxnet_tpu_torch import sparse as tsp
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops.kernels import LAUNCHES
from mxnet_tpu_torch.parallel import MeshSpec, make_mesh
from mxnet_tpu_torch.sparse import kernels as K

REL = 1e-6
LOWP = {"bfloat16": jnp.bfloat16, "float16": jnp.float16}
# fraction bits of each dtype's significand: one step (ulp) of a value
# in [2^e, 2^(e+1)) is 2^(e - bits)
_FRAC = {"bfloat16": 7, "float16": 10, "float32": 23, "float64": 52}
_TINY = {"bfloat16": 2.0 ** -133, "float16": 2.0 ** -24}


def _jax_table(rs, rows, D, dtype, scale=10.0):
    """An inexact table in ``dtype`` (a JAX array) and the port's tensor
    of the same bits."""
    jt = jnp.asarray((rs.randn(rows, D) * scale).astype(np.float32)) \
        .astype(dtype)
    return jt, convert.tensor_from_host(np.asarray(jt))


def _bits(x):
    """A value's bits as an integer array, whatever its dtype."""
    if isinstance(x, torch.Tensor) and x.dtype == torch.bfloat16:
        return x.detach().cpu().view(torch.int16).numpy()
    a = np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)
    if a.dtype.name == "bfloat16":
        return a.view(np.int16)
    return a.view({2: np.int16, 4: np.int32, 8: np.int64}[a.itemsize])


def _assert_bits(got, want, what=""):
    np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=what)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x).astype(np.float32)


def _within_one_step(got, want, dtype, what=""):
    """|got - want| <= one step of ``dtype`` at ``want``, per element."""
    g, w = _f32(got).astype(np.float64), _f32(want).astype(np.float64)
    assert g.shape == w.shape, what
    _m, e = np.frexp(np.abs(w))
    step = np.maximum(np.ldexp(1.0, e - 1 - _FRAC[dtype]), _TINY[dtype])
    bad = np.abs(g - w) > step
    assert not bad.any(), (what, int(bad.sum()), np.abs(g - w).max())


def _close(got, want, what=""):
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape, what
    err = np.abs(got - want).max()
    assert err <= REL * max(np.abs(want).max(), 1e-30), (what, err)


def _runs(rs, rows, lengths, pads, pad_alone):
    """Sorted ids in runs of ``lengths`` (distinct rows), then ``pads``
    ids >= rows after a real run of the last row or (``pad_alone``) in a
    run of their own."""
    top = rows - 2 if pad_alone else rows - 1
    heads = np.append(np.sort(rs.choice(top, len(lengths) - 1,
                                        replace=False)), top)
    return np.concatenate([np.full(k, r) for r, k in zip(heads, lengths)]
                          + [rows + np.arange(pads)]).astype(np.int32)


# ---------------------------------------------------------------------------
# the kernels' plain versions
# ---------------------------------------------------------------------------

GATHER_CASES = [(40, 1, 12), (40, 13, 16), (97, 16, 24), (33, 64, 9),
                (20, 16, 1)]
GATHER_IDS = ["d1", "d13", "d16", "d64", "n1"]


@pytest.mark.parametrize("rows,D,n", GATHER_CASES, ids=GATHER_IDS)
@pytest.mark.parametrize("dtype", list(LOWP))
def test_gather_plain_bit_equals_pallas(dtype, rows, D, n):
    rs = np.random.RandomState(rows * D + n)
    jt, tt = _jax_table(rs, rows, D, LOWP[dtype])
    ids = rs.randint(0, rows, n).astype(np.int32)
    ids[0] = rows - 1
    if n > 2:
        ids[1] = 0
    want = jax_gather(jt, jnp.asarray(ids), backend="pallas")
    got = K.embedding_gather(tt, torch.from_numpy(ids))
    assert got.dtype == tt.dtype
    _assert_bits(got, want)
    # the grouped gather over tables of several dtypes keeps each one's
    many = K.embedding_gather_many([tt, tt.float(), tt.double()],
                                   [torch.from_numpy(ids)] * 3)
    assert [m.dtype for m in many] == [tt.dtype, torch.float32,
                                       torch.float64]
    _assert_bits(many[0], want)
    np.testing.assert_array_equal(many[1].numpy(), _f32(want))


@pytest.mark.parametrize("rows,D,n", GATHER_CASES, ids=GATHER_IDS)
@pytest.mark.parametrize("dtype", list(LOWP))
def test_scatter_set_plain_bit_equals_pallas(dtype, rows, D, n):
    """First write wins over duplicates; float32 payloads are rounded to
    the table's dtype first; pads carry the current last row."""
    rs = np.random.RandomState(rows + D * n)
    jt, tt = _jax_table(rs, rows, D, LOWP[dtype])
    ids = np.sort(rs.randint(0, rows, n))
    if n > 3:
        ids[1:3] = ids[0]
    ids = np.concatenate([ids, [rows, rows + 1]]).astype(np.int32)
    src = (rs.randn(len(ids), D) * 10).astype(np.float32)
    src[-2:] = _f32(jt[rows - 1])
    want = jax_scatter(jt, jnp.asarray(ids), jnp.asarray(src), mode="set",
                       backend="pallas")
    got = K.embedding_scatter(tt, torch.from_numpy(ids),
                              torch.from_numpy(src), "set")
    assert got is tt and got.dtype == tt.dtype
    _assert_bits(got, want)


INEXACT_RUNS = {"ones-twos": [1] * 12 + [2] * 6,
                "run33": [3, 33, 1, 2],
                "run200": [1, 2, 200, 1]}


@pytest.mark.parametrize("pad_alone", [False, True],
                         ids=["pads-after-run", "pads-alone"])
@pytest.mark.parametrize("D", [1, 7, 16])
@pytest.mark.parametrize("runs", list(INEXACT_RUNS))
@pytest.mark.parametrize("dtype", list(LOWP))
def test_scatter_add_plain_bit_equals_pallas_order(dtype, runs, D,
                                                   pad_alone):
    """Inexact payloads: each add rounds to the table's dtype, so only the
    in-order fold of each run, rounded after every add, gives the Pallas
    kernel's bits (a float32 accumulator rounded once at the end does
    not, as the check below shows on these inputs)."""
    rs = np.random.RandomState(len(INEXACT_RUNS[runs]) * D + pad_alone)
    rows = 200
    ids = _runs(rs, rows, INEXACT_RUNS[runs], 3, pad_alone)
    jt, tt = _jax_table(rs, rows, D, LOWP[dtype])
    src = rs.randn(len(ids), D).astype(np.float32)
    src[-3:] = 0.0
    want = jax_scatter(jt, jnp.asarray(ids), jnp.asarray(src), mode="add",
                       backend="pallas")
    got = K.embedding_scatter_plain(tt.clone(), torch.from_numpy(ids),
                                    torch.from_numpy(src), "add")
    _assert_bits(got, want)
    # the wrapper on a CPU table is the plain version
    again = K.embedding_scatter(tt.clone(), torch.from_numpy(ids),
                                torch.from_numpy(src), "add")
    _assert_bits(again, want)
    # one rounding at the end is another result where runs are long
    if max(INEXACT_RUNS[runs]) > 8 and D > 1:
        acc = tt.float().clone()
        keep = ids < rows
        acc.index_add_(0, torch.from_numpy(ids[keep]).long(),
                       torch.from_numpy(src[keep]).to(tt.dtype).float())
        assert not torch.equal(acc.to(tt.dtype), got)


@pytest.mark.parametrize("mode", ["gather", "add", "set"])
def test_float64_plain_bit_equals_xla(mode):
    """float64 tables against the XLA path (the Pallas kernels run with
    x64 off and refuse f64 payloads); set mode without duplicates (XLA
    leaves the winner among them unspecified)."""
    rs = np.random.RandomState(3)
    rows, D, n = 50, 13, 40
    table = rs.randn(rows, D) * 10
    dups = mode != "set"
    ids = np.sort(rs.choice(rows, n, replace=dups)).astype(np.int32)
    src = rs.randn(n, D)
    tt = torch.from_numpy(table.copy())
    if mode == "gather":
        want = jax_gather(jnp.asarray(table), jnp.asarray(ids),
                          backend="xla")
        got = K.embedding_gather(tt, torch.from_numpy(ids))
    else:
        want = jax_scatter(jnp.asarray(table), jnp.asarray(ids),
                           jnp.asarray(src), mode=mode, backend="xla")
        got = K.embedding_scatter(tt, torch.from_numpy(ids),
                                  torch.from_numpy(src), mode)
    assert got.dtype == torch.float64
    _assert_bits(got, want)


def test_other_dtypes_and_rows_are_refused():
    for dt in (torch.int32, torch.complex64):
        table = torch.zeros(4, 2, dtype=dt)
        with pytest.raises(MXNetError):
            K._check_table("embedding_gather", table)
    spec = MeshSpec(make_mesh((1,), ("dp",), device="cpu"))
    with pytest.raises(MXNetError):
        tsp.ShardedEmbedding(10, 4, spec, dtype="int32")
    for dt in ("bfloat16", "float16", "float64"):
        emb = tsp.ShardedEmbedding(10, 4, spec, dtype=dt)
        assert emb.init_state(seed=0).dtype == getattr(torch, dt)
        assert emb.zeros_slot().dtype == torch.float32
        assert emb.table_bytes == 10 * 4 * getattr(torch, dt).itemsize


# ---------------------------------------------------------------------------
# the plane
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def specs():
    return (JaxMeshSpec(jax_make_mesh((1,), ("dp",))),
            MeshSpec(make_mesh((1,), ("dp",), device="cpu")))


def _pair(specs, V, D, seed, name, dtype):
    jspec, tspec = specs
    je = jsp.ShardedEmbedding(V, D, jspec, name=name, dtype=dtype,
                              backend="xla")
    te = tsp.ShardedEmbedding(V, D, tspec, name=name, dtype=dtype)
    jt = je.init_state(seed=seed)
    tt = te.load_array(np.asarray(jt))
    assert tt.dtype == te.dtype
    _assert_bits(tt, jt)
    return je, jt, te, tt


def _ids(rs, V, B):
    ids = rs.randint(0, V, B).astype(np.int64)
    ids[:B // 4] = ids[0]                        # heavy duplication
    return ids


@pytest.mark.parametrize("dtype", list(LOWP))
def test_lookup_matches_jax(specs, dtype):
    je, jt, te, tt = _pair(specs, 96, 8, 1, "lk", dtype)
    rs = np.random.RandomState(2)
    ids = _ids(rs, 96, 32)
    ids[-1], ids[-2] = 0, 95
    want = je.lookup(jt, jnp.asarray(ids))
    got = te.lookup(tt, torch.from_numpy(ids))
    assert got.dtype == te.dtype
    _assert_bits(got, want)


@pytest.mark.parametrize("momentum", [0.9, None], ids=["mom", "no-mom"])
@pytest.mark.parametrize("dtype", list(LOWP))
def test_apply_sgd_matches_jax(specs, dtype, momentum):
    V, D, B = 96, 8, 32
    je, jt, te, tt = _pair(specs, V, D, 5, "sgd", dtype)
    rs = np.random.RandomState(9)
    ids = _ids(rs, V, B)
    grads = (rs.randn(B, D) * 0.1).astype(np.float32)
    kw = dict(lr=0.5, wd=0.01, rescale_grad=0.5)
    jmom = None if momentum is None else je.zeros_slot()
    tmom = None if momentum is None else te.zeros_slot()
    if momentum is not None:
        kw["momentum"] = momentum
    jt2, jm2 = je.apply_sgd(jt, jmom, jnp.asarray(ids), jnp.asarray(grads),
                            **kw)
    before = tt.clone()
    tt2, tm2 = te.apply_sgd(tt, tmom, torch.from_numpy(ids),
                            torch.from_numpy(grads), **kw)
    assert tt2 is tt and tt2.dtype == te.dtype
    _within_one_step(tt2, jt2, dtype, "table")
    if momentum is not None:
        assert tm2.dtype == torch.float32
        _close(tm2, jm2, "momentum")
    untouched = np.setdiff1d(np.arange(V), ids)
    assert torch.equal(tt[untouched], before[untouched])


@pytest.mark.parametrize("dtype", list(LOWP))
def test_apply_adam_matches_jax(specs, dtype):
    V, D, B = 96, 8, 32
    je, jt, te, tt = _pair(specs, V, D, 6, "adam", dtype)
    rs = np.random.RandomState(11)
    ids = _ids(rs, V, B)
    grads = (rs.randn(B, D) * 0.01).astype(np.float32)
    kw = dict(lr=0.01, wd=0.001, beta1=0.9, beta2=0.999,
              clip_gradient=0.005)
    jout = je.apply_adam(jt, je.zeros_slot(), je.zeros_slot(),
                         jnp.asarray(ids), jnp.asarray(grads), **kw)
    tout = te.apply_adam(tt, te.zeros_slot(), te.zeros_slot(),
                         torch.from_numpy(ids), torch.from_numpy(grads), **kw)
    assert tout[0] is tt
    _within_one_step(tout[0], jout[0], dtype, "table")
    for name, a, b in zip(("mean", "var"), tout[1:], jout[1:]):
        assert a.dtype == torch.float32
        _close(a, b, name)


def test_bf16_recommender_two_steps_match_jax(specs):
    """Two steps of the recommender over three bf16 tables: the lookup's
    bf16 rows meet the f32 dense input in the concatenation (promoted to
    f32), each row's gradient comes back in bf16, the lazy SGD updates
    the bf16 tables and their f32 momentum."""
    jspec, tspec = specs
    F, V, D, Dd, B = 3, 200, 8, 5, 64
    jembs = [jsp.ShardedEmbedding(V, D, jspec, name="rb%d" % f,
                                  dtype="bfloat16", backend="xla")
             for f in range(F)]
    tembs = [tsp.ShardedEmbedding(V, D, tspec, name="rb%d" % f,
                                  dtype="bfloat16") for f in range(F)]
    jstate = jsp.recommender_state(jembs, dense_dim=Dd, hidden=(16, 8),
                                   seed=0)
    host = {"tables": tuple(np.asarray(t) for t in jstate["tables"]),
            "moms": tuple(np.asarray(m) for m in jstate["moms"]),
            "mlp": {k: np.asarray(v) for k, v in jstate["mlp"].items()},
            "mlp_mom": {k: np.asarray(v)
                        for k, v in jstate["mlp_mom"].items()}}
    tstate = convert.recommender_state_from_numpy(host, "cpu")
    assert all(t.dtype == torch.bfloat16 for t in tstate["tables"])
    jstep = jsp.make_recommender_step(jembs, lr=0.05, momentum=0.9, wd=1e-4)
    tstep = tsp.make_recommender_step(tembs, lr=0.05, momentum=0.9, wd=1e-4)
    rs = np.random.RandomState(4)
    before = dict(LAUNCHES)
    for _ in range(2):
        batch = {"ids": rs.randint(0, V, (F, B)).astype(np.int32),
                 "dense": rs.rand(B, Dd).astype(np.float32),
                 "label": (rs.rand(B) > 0.5).astype(np.float32)}
        batch["ids"][:, :8] = batch["ids"][:, :1]
        jstate, jloss = jstep(jstate, {k: jnp.asarray(v)
                                       for k, v in batch.items()})
        tstate, tloss = tstep(tstate, batch)
        assert abs(float(tloss) - float(jloss)) <= 1e-6
    assert dict(LAUNCHES) == before              # the CPU launches nothing
    for i, (a, b) in enumerate(zip(tstate["tables"], jstate["tables"])):
        assert a.dtype == torch.bfloat16
        _within_one_step(a, b, "bfloat16", "tables[%d]" % i)
    for i, (a, b) in enumerate(zip(tstate["moms"], jstate["moms"])):
        _close(a, b, "moms[%d]" % i)
    for part in ("mlp", "mlp_mom"):
        for k in jstate[part]:
            _close(tstate[part][k], jstate[part][k], "%s.%s" % (part, k))


def test_bf16_snapshots_cross_both_ways(specs):
    """``state_dict`` / ``load_array`` of a bf16 table, bit for bit: in the
    port (its float32 snapshot back to bf16 with ``dtype=``), from the JAX
    package (``ml_dtypes`` bf16 through a uint16 view) and to it."""
    jspec, tspec = specs
    V, D = 37, 6
    je = jsp.ShardedEmbedding(V, D, jspec, name="snap", dtype="bfloat16")
    te = tsp.ShardedEmbedding(V, D, tspec, name="snap", dtype="bfloat16")
    jt = je.init_state(seed=7)
    jsnap = je.state_dict(jt, mom=je.zeros_slot())
    assert jsnap["table"].dtype.name == "bfloat16"
    # the JAX package's snapshot into the port
    tt = te.load_array(jsnap["table"])
    mom = te.load_array(jsnap["mom"])
    assert tt.dtype == torch.bfloat16 and mom.dtype == torch.float32
    _assert_bits(tt, jsnap["table"])
    # the port's snapshot: float32 of the same values, back bit for bit
    tsnap = te.state_dict(tt, mom=mom)
    assert tsnap["table"].dtype == np.float32
    again = te.load_array(tsnap["table"], dtype="bfloat16")
    _assert_bits(again, tt)
    with pytest.raises(MXNetError):       # not exact in bf16
        te.load_array(tsnap["table"] + np.float32(1e-6), dtype="bfloat16")
    # and into the JAX package
    back = je.load_array(tsnap["table"].astype(ml_dtypes.bfloat16))
    _assert_bits(back, jt)
    # float16 keeps its own dtype on both sides
    te16 = tsp.ShardedEmbedding(V, D, tspec, name="s16", dtype="float16")
    t16 = te16.init_state(seed=1)
    snap16 = te16.state_dict(t16)
    assert snap16["table"].dtype == np.float16
    _assert_bits(te16.load_array(snap16["table"]), t16)
