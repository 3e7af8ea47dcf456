"""The port's sparse storage against the JAX package's on the CPU
(``mxnet_tpu_torch/ndarray/sparse.py`` and its users vs
``mxnet_tpu/ndarray/sparse.py``): row_sparse and CSR arrays, their
functions, the writes into them, storage-type inference, the kvstore's
sparse push and ``row_sparse_pull``, lazy SGD and Adam, ``Module.fit``
with ``sparse_row_id_fn`` and the wide-embedding loop of
``example/sparse/linear_classification.py``.

Inputs come from numpy with a seed and go to both packages.  Tolerances:
component indices, shapes, dtypes and data movement exactly; the
segment sums (merge, ``embedding_grad``, ``sparse_dot``) and the lazy
updates, which both packages run op by op in float32, bit for bit (the
JAX functions run eagerly here, so XLA fuses nothing); ``Module.fit``
and the loop within 1e-6 of each tensor's largest magnitude (matrix
products and the loss head reduce in their own orders).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
import mxnet_tpu as jmx
import mxnet_tpu.ndarray.sparse as jsp
import mxnet_tpu_torch as tmx
import mxnet_tpu_torch.ndarray.sparse as tsp
from mxnet_tpu.base import MXNetError as JaxMXNetError
from mxnet_tpu_torch.base import MXNetError

CPU = tmx.cpu()


def _rsp(data, idx, shape):
    """The same RowSparseNDArray in both packages (constructor form)."""
    t = tsp.RowSparseNDArray(torch.from_numpy(np.array(data)),
                             torch.from_numpy(np.array(idx, np.int64)),
                             shape)
    j = jsp.RowSparseNDArray(jnp.asarray(data),
                             jnp.asarray(np.array(idx, np.int64)), shape)
    return t, j


def _same_rsp(t, j):
    assert t.stype == "row_sparse" and t.shape == tuple(j.shape)
    np.testing.assert_array_equal(t.indices.asnumpy(), np.asarray(j._indices))
    td, jd = t.data.asnumpy(), np.asarray(j._data)
    assert td.dtype == jd.dtype and td.shape == jd.shape
    np.testing.assert_array_equal(td, jd)
    np.testing.assert_array_equal(t.asnumpy(), j.asnumpy())


def _same_csr(t, j):
    assert t.stype == "csr" and t.shape == tuple(j.shape)
    for a in ("_data", "_indices", "_indptr"):
        np.testing.assert_array_equal(getattr(t, a).numpy(),
                                      np.asarray(getattr(j, a)), a)
    np.testing.assert_array_equal(t.asnumpy(), j.asnumpy())


def _close(got, want, rel=1e-6):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= rel * scale


# ---------------------------------------------------------------------------
# the arrays
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("idx", [[7, 2, 2, 9, 0], [0, 3, 3, 3, 8], [],
                                 [5]], ids=["unsorted-dups", "sorted-dups",
                                            "empty", "one"])
def test_constructor_sorts_stably_and_keeps_duplicates(idx):
    rs = np.random.RandomState(len(idx))
    data = rs.randn(len(idx), 3).astype(np.float32)
    t, j = _rsp(data, idx, (10, 3))
    _same_rsp(t, j)
    assert t.dtype == np.float32 and t.context == CPU


@pytest.mark.parametrize("dtype", ["float32", "float64", "int32"])
def test_row_sparse_array_and_csr_matrix_match(dtype):
    rs = np.random.RandomState(1)
    idx = np.array([6, 1, 6, 3, 1, 0, 6])
    data = (rs.randn(7, 2) * 4).astype(dtype)
    with CPU:
        t = tsp.row_sparse_array((data, idx), shape=(8, 2))
        dense = np.where(rs.rand(5, 4) > 0.6, rs.randn(5, 4), 0)
        t2 = tsp.row_sparse_array(dense.astype(dtype))
        c1 = tsp.csr_matrix(dense.astype(dtype))
        c2 = tsp.csr_matrix((np.array([1., 2, 0, 3]), [0, 2, 1, 3],
                             [0, 2, 2, 4]), shape=(3, 4), dtype=dtype)
    _same_rsp(t, jsp.row_sparse_array((data, idx), shape=(8, 2)))
    _same_rsp(t2, jsp.row_sparse_array(dense.astype(dtype)))
    _same_csr(c1, jsp.csr_matrix(dense.astype(dtype)))
    _same_csr(c2, jsp.csr_matrix((np.array([1., 2, 0, 3]), [0, 2, 1, 3],
                                  [0, 2, 2, 4]), shape=(3, 4), dtype=dtype))


def test_retain_and_gather_rows():
    rs = np.random.RandomState(2)
    data = rs.randn(6, 2, 3).astype(np.float32)
    t, j = _rsp(data, [9, 4, 4, 0, 12, 7], (13, 2, 3))
    for req in ([4, 12, 5, 4, 0], [], [1, 2], [12, 9, 7, 4, 0]):
        _same_rsp(t.retain(np.array(req)), j.retain(np.array(req)))
        _same_rsp(t.gather_rows(req), j.gather_rows(req))
    with CPU:
        _same_rsp(t.retain(tmx.nd.array([7., 0.])),
                  j.retain(jmx.nd.array([7., 0.])))
    te, je = _rsp(np.zeros((0, 2, 3), np.float32), [], (13, 2, 3))
    _same_rsp(te.retain([1, 3]), je.retain(np.array([1, 3])))
    _same_rsp(te.gather_rows([3, 1, 3]), je.gather_rows([3, 1, 3]))


def test_copyto_and_conversions():
    rs = np.random.RandomState(3)
    t, j = _rsp(rs.randn(3, 4).astype(np.float32), [5, 1, 2], (6, 4))
    t2, j2 = _rsp(np.zeros((0, 4), np.float32), [], (6, 4))
    t.copyto(t2)
    j.copyto(j2)
    _same_rsp(t2, j2)
    t2._data.zero_()                  # a copy: the source keeps its rows
    assert t.data.asnumpy().any()
    with CPU:
        dense = tmx.nd.array(rs.randn(6, 4).astype(np.float32))
    jdense = jmx.nd.array(dense.asnumpy())
    for st in ("row_sparse", "csr"):
        got, want = tmx.nd.cast_storage(dense, st), \
            jmx.nd.cast_storage(jdense, st)
        (_same_rsp if st == "row_sparse" else _same_csr)(got, want)
        back = got.tostype("default")
        assert back.stype == "default"
        np.testing.assert_array_equal(back.asnumpy(), dense.asnumpy())
        assert got.tostype(st) is got
    _same_csr(tmx.nd.cast_storage(t, "csr"), jmx.nd.cast_storage(j, "csr"))
    _same_rsp(dense.tostype("row_sparse"), jdense.tostype("row_sparse"))
    z = tsp.zeros_sparse("csr", (3, 5), ctx=CPU)
    _same_csr(z, jsp.zeros_sparse("csr", (3, 5)))
    _same_rsp(tsp.zeros_sparse("row_sparse", (4, 2), ctx=CPU),
              jsp.zeros_sparse("row_sparse", (4, 2)))


def test_csr_row_slices_match_the_densified_slice():
    """The JAX package slices a densified CSR; the port reads indptr:
    stored zeros dropped, a later duplicate column kept, columns sorted,
    as the dense slice gives them."""
    data = np.array([1., 0., 2., 5., 7., 3.], np.float32)
    cols = np.array([3, 1, 0, 2, 2, 4])
    indptr = np.array([0, 3, 3, 5, 6])
    with CPU:
        t = tsp.csr_matrix((data, cols, indptr), shape=(4, 5))
    j = jsp.csr_matrix((data, cols, indptr), shape=(4, 5))
    for key in (slice(0, 4), slice(1, 3), slice(2, None), slice(None, None,
                                                                 2)):
        _same_csr(t[key], j[key])


def test_writes_rebind_the_components():
    """The port's choice for a write into a sparse array: it rebinds the
    components (to the written dense value's nonzero rows), on every
    path; none vanishes.  ``copyto`` of a dense array agrees with the JAX
    package, which keeps the written value as the dense form."""
    rs = np.random.RandomState(4)
    data = rs.randn(2, 3).astype(np.float32)
    t, j = _rsp(data, [1, 4], (5, 3))
    with CPU:
        src = tmx.nd.array(rs.randn(5, 3).astype(np.float32))
    src.copyto(t)
    jmx.nd.array(src.asnumpy()).copyto(j)
    np.testing.assert_array_equal(t.asnumpy(), j.asnumpy())
    assert t.indices.asnumpy().tolist() == [0, 1, 2, 3, 4]
    t, _ = _rsp(data, [1, 4], (5, 3))
    t[3] = 2.0                                  # __setitem__
    assert t.indices.asnumpy().tolist() == [1, 3, 4]
    np.testing.assert_array_equal(t.data.asnumpy()[1], [2.0] * 3)
    t._handle[0, 1] = -1.0                      # in place into the dense form
    assert t.indices.asnumpy().tolist() == [0, 1, 3, 4]
    t += 1.0                                    # every row nonzero now
    assert t.stype == "row_sparse" and len(t.indices.asnumpy()) == 5
    t, _ = _rsp(data, [1, 4], (5, 3))
    t.data._handle[0] = 9.0                     # a component written in place
    np.testing.assert_array_equal(t.asnumpy()[1], [9.0] * 3)
    t._data = torch.zeros(2, 3)                 # a component rebound
    assert not t.asnumpy().any()
    c = tsp.csr_matrix(np.eye(3, dtype=np.float32), ctx=CPU)
    c[1, 2] = 4.0
    assert c.indices.asnumpy().tolist() == [0, 1, 2, 2]


def test_merge_row_sparse():
    rs = np.random.RandomState(5)
    pairs = []
    for k in (4, 0, 6, 1):
        idx = rs.randint(0, 8, k)
        pairs.append(_rsp(rs.randn(k, 3).astype(np.float32), idx, (8, 3)))
    _same_rsp(tsp.merge_row_sparse([p[0] for p in pairs]),
              jsp.merge_row_sparse([p[1] for p in pairs]))
    one = _rsp(np.ones((3, 3), np.float32), [2, 2, 5], (8, 3))
    _same_rsp(tsp.merge_row_sparse([one[0]]),
              jsp.merge_row_sparse([one[1]]))
    empty = _rsp(np.zeros((0, 3), np.float32), [], (8, 3))
    _same_rsp(tsp.merge_row_sparse([empty[0], empty[0]]),
              jsp.merge_row_sparse([empty[1], empty[1]]))
    for mod, err in ((tsp, MXNetError), (jsp, JaxMXNetError)):
        with pytest.raises(err):
            mod.merge_row_sparse([])


def test_embedding_grad_and_sparse_dot():
    rs = np.random.RandomState(6)
    ids = rs.randint(0, 30, (5, 3))
    rows = rs.randn(5, 3, 4).astype(np.float32)
    with CPU:
        got = tsp.embedding_grad(ids, tmx.nd.array(rows), 30)
    _same_rsp(got, jsp.embedding_grad(ids, jmx.nd.array(rows), 30))
    dense = np.where(rs.rand(6, 9) > 0.7, rs.randn(6, 9), 0).astype(
        np.float32)
    with CPU:
        c = tsp.csr_matrix(dense)
        z = tsp.zeros_sparse("csr", (6, 9))
    jc = jsp.csr_matrix(dense)
    for ta, k in ((False, 9), (True, 6)):
        r = rs.randn(k, 2).astype(np.float32)
        with CPU:
            got = tsp.sparse_dot(c, tmx.nd.array(r), transpose_a=ta)
            got0 = tsp.sparse_dot(z, tmx.nd.array(r), transpose_a=ta)
        want = jsp.sparse_dot(jc, jmx.nd.array(r), transpose_a=ta)
        np.testing.assert_array_equal(got.asnumpy(), want.asnumpy())
        assert not got0.asnumpy().any() and got0.shape == want.shape
    r = rs.randn(9, 2).astype(np.float32)
    with CPU:
        dd = tsp.sparse_dot(tmx.nd.array(dense), tmx.nd.array(r))
    _close(dd.asnumpy(), dense @ r)


# ---------------------------------------------------------------------------
# lazy updates
# ---------------------------------------------------------------------------

def _states(shape, rs, n):
    vals = [rs.randn(*shape).astype(np.float32) for _ in range(n)]
    with CPU:
        return [tmx.nd.array(v) for v in vals], [jmx.nd.array(v)
                                                 for v in vals]


@pytest.mark.parametrize("weight", ["dense", "row_sparse"])
@pytest.mark.parametrize("case", [
    dict(momentum=0.9, wd=1e-3, rescale_grad=0.5, clip_gradient=None),
    dict(momentum=0.0, wd=0.0, rescale_grad=1.0, clip_gradient=0.3),
    dict(momentum=0.9, wd=0.01, rescale_grad=2.0, clip_gradient=0.5)],
    ids=["momentum-wd", "plain-clip", "momentum-wd-clip"])
def test_lazy_sgd_matches_jax(weight, case):
    rs = np.random.RandomState(7)
    shape = (12, 4)
    gt, gj = _rsp(rs.randn(4, 4).astype(np.float32), [9, 2, 5, 11], shape)
    (wt, mt), (wj, mj) = _states(shape, rs, 2)
    if weight == "row_sparse":
        wt, wj = _rsp(rs.randn(6, 4).astype(np.float32),
                      [0, 2, 5, 7, 9, 11], shape)
    before = wt.asnumpy()
    kw = dict(case)
    mom = kw.pop("momentum")
    for _ in range(2):
        tsp.sgd_row_sparse_update(wt, gt, mt if mom else None, lr=0.1,
                                  momentum=mom, **kw)
        jsp.sgd_row_sparse_update(wj, gj, mj if mom else None, lr=0.1,
                                  momentum=mom, **kw)
    np.testing.assert_array_equal(wt.asnumpy(), wj.asnumpy())
    np.testing.assert_array_equal(mt.asnumpy(), mj.asnumpy())
    untouched = np.setdiff1d(np.arange(12), [9, 2, 5, 11])
    np.testing.assert_array_equal(wt.asnumpy()[untouched],
                                  before[untouched])


@pytest.mark.parametrize("weight", ["dense", "row_sparse", "wide"])
@pytest.mark.parametrize("clip", [None, 0.05])
def test_lazy_adam_matches_jax(weight, clip):
    """Bit for bit; "wide" touches 3000 rows, enough square roots that a
    float32 ``sqrt`` that is not correctly rounded (torch's on an AVX-512
    CPU) shows."""
    rs = np.random.RandomState(8)
    shape, ids = (10, 3), [8, 1, 4]
    if weight == "wide":
        shape, ids = (4000, 16), np.sort(rs.choice(4000, 3000, False))
    gt, gj = _rsp(rs.randn(len(ids), shape[1]).astype(np.float32), ids,
                  shape)
    (wt, mt, vt), (wj, mj, vj) = _states(shape, rs, 3)
    vt._handle.abs_()
    vj._handle = jnp.abs(vj._handle)
    if weight == "row_sparse":
        wt, wj = _rsp(rs.randn(4, 3).astype(np.float32), [1, 4, 6, 8], shape)
    for _ in range(2):
        for fn, w, g, m, v in ((tsp.adam_row_sparse_update, wt, gt, mt, vt),
                               (jsp.adam_row_sparse_update, wj, gj, mj, vj)):
            fn(w, g, m, v, lr=0.01, wd=0.02, rescale_grad=0.5,
               clip_gradient=clip)
    for a, b in ((wt, wj), (mt, mj), (vt, vj)):
        np.testing.assert_array_equal(a.asnumpy(), b.asnumpy())


def test_lazy_update_of_a_weight_missing_a_row_raises():
    rs = np.random.RandomState(9)
    gt, gj = _rsp(rs.randn(2, 3).astype(np.float32), [1, 5], (8, 3))
    wt, wj = _rsp(rs.randn(2, 3).astype(np.float32), [1, 4], (8, 3))
    with pytest.raises(MXNetError, match="missing rows"):
        tsp.sgd_row_sparse_update(wt, gt, None, lr=0.1)
    with pytest.raises(JaxMXNetError, match="missing rows"):
        jsp.sgd_row_sparse_update(wj, gj, None, lr=0.1)
    te, _ = _rsp(np.zeros((0, 3), np.float32), [], (8, 3))
    with pytest.raises(MXNetError, match="missing rows"):
        tsp.sgd_row_sparse_update(te, gt, None, lr=0.1)


@pytest.mark.parametrize("name", ["sgd", "adam", "rmsprop", "adagrad"])
def test_optimizers_take_a_row_sparse_gradient(name):
    """SGD and Adam update lazily; the others (and SGD without
    lazy_update) take the gradient's dense form, as in the JAX package."""
    rs = np.random.RandomState(10)
    kw = dict(learning_rate=0.1, wd=0.01)
    if name == "sgd":
        kw["momentum"] = 0.9
    gt, gj = _rsp(rs.randn(2, 3).astype(np.float32), [3, 0], (5, 3))
    (wt,), (wj,) = _states((5, 3), rs, 1)
    ut = tmx.optimizer.get_updater(tmx.optimizer.create(name, **kw))
    uj = jmx.optimizer.get_updater(jmx.optimizer.create(name, **kw))
    for _ in range(2):
        ut(0, gt, wt)
        uj(0, gj, wj)
    _close(wt.asnumpy(), wj.asnumpy())
    if name == "sgd":
        (w2,), (j2,) = _states((5, 3), rs, 1)
        ut = tmx.optimizer.get_updater(tmx.optimizer.SGD(lazy_update=False,
                                                         **kw))
        uj = jmx.optimizer.get_updater(jmx.optimizer.SGD(lazy_update=False,
                                                         **kw))
        ut(0, gt, w2)
        uj(0, gj, j2)
        _close(w2.asnumpy(), j2.asnumpy())


# ---------------------------------------------------------------------------
# storage types in a graph
# ---------------------------------------------------------------------------

def _sparse_lr(sym, vocab=50, dim=8, classes=2):
    ids = sym.Variable("data")
    table = sym.Variable("embed_weight")
    emb = sym.contrib.SparseEmbedding(data=ids, weight=table,
                                      input_dim=vocab, output_dim=dim,
                                      name="wide_embedding")
    pooled = sym.mean(emb, axis=1)
    logits = sym.FullyConnected(pooled, num_hidden=classes, name="fc")
    return sym.SoftmaxOutput(logits, name="softmax")


def test_infer_storage_type_matches_jax():
    """example/sparse/symbolic_sparse_lr.py's graph and the
    test_sparse.py chains, in both packages."""
    t, j = _sparse_lr(tmx.sym), _sparse_lr(jmx.sym)
    for kw in ({}, {"embed_weight": "row_sparse"}, {"data": "csr"}):
        assert t.infer_storage_type(**kw) == j.infer_storage_type(**kw)
    for pkg in (tmx.sym, jmx.sym):
        x = pkg.Variable("x", stype="row_sparse")
        kept = pkg.sparse_retain(pkg.cast_storage(x, stype="row_sparse"),
                                 pkg.Variable("i"))
        outs = [g.infer_storage_type()[1] for g in
                (kept, pkg.square_sum(kept, axis=(1,)),
                 pkg.dot(pkg.Variable("c"), pkg.Variable("w")),
                 pkg.cast_storage(pkg.Variable("d"), stype="csr"))]
        assert outs == [["row_sparse"], ["default"], ["default"], ["csr"]]
    assert t.infer_storage_type("csr", "row_sparse") == \
        j.infer_storage_type("csr", "row_sparse")


# ---------------------------------------------------------------------------
# the kvstore
# ---------------------------------------------------------------------------

def _stores(optimizer=None):
    tk = tmx.kv.create("device", device="cpu")
    jk = jmx.kv.create("device")
    if optimizer:
        kw = dict(learning_rate=0.1, wd=0.01)
        if optimizer == "sgd":
            kw["momentum"] = 0.9
        tk.set_optimizer(tmx.optimizer.create(optimizer, **kw))
        jk.set_optimizer(jmx.optimizer.create(optimizer, **kw))
    return tk, jk


@pytest.mark.parametrize("store", ["dense", "row_sparse"])
@pytest.mark.parametrize("form", ["one-per-out", "one-per-key",
                                  "one-for-all"])
def test_row_sparse_pull_matches_jax(store, form):
    rs = np.random.RandomState(11)
    tk, jk = _stores()
    shape = (9, 3)
    for k in ("a", "b"):
        val = rs.randn(*shape).astype(np.float32)
        if store == "dense":
            with CPU:
                tk.init(k, tmx.nd.array(val))
            jk.init(k, jmx.nd.array(val))
        else:
            t, j = _rsp(val[[0, 2, 3, 7]], [7, 0, 3, 2], shape)
            tk.init(k, t)
            jk.init(k, j)
    ids = [np.array([3, 1, 3, 8]), np.array([0, 7]), np.array([5, 5, 2]),
           np.array([2])]
    with CPU:
        touts = [tsp.zeros_sparse("row_sparse", shape), tmx.nd.zeros(shape),
                 tsp.zeros_sparse("row_sparse", shape), tmx.nd.ones(shape)]
    jouts = [jsp.zeros_sparse("row_sparse", shape), jmx.nd.zeros(shape),
             jsp.zeros_sparse("row_sparse", shape), jmx.nd.ones(shape)]
    rids = {"one-per-out": ids, "one-per-key": ids[:2],
            "one-for-all": ids[:1]}[form]
    with CPU:
        tk.row_sparse_pull(["a", "b"], out=[touts[:2], touts[2:]],
                           row_ids=[tmx.nd.array(r) for r in rids])
    jk.row_sparse_pull(["a", "b"], out=[jouts[:2], jouts[2:]],
                       row_ids=[jmx.nd.array(r) for r in rids])
    for t, j in zip(touts, jouts):
        np.testing.assert_array_equal(t.asnumpy(), j.asnumpy())
        if isinstance(t, tsp.RowSparseNDArray):
            _same_rsp(t, j)
    with pytest.raises(MXNetError):
        tk.row_sparse_pull(["a", "b"], out=[touts[:2], touts[2:]],
                           row_ids=[ids[0]] * 3)


@pytest.mark.parametrize("optimizer", [None, "sgd", "adam"])
def test_sparse_push_matches_jax(optimizer):
    """init of a row_sparse and a dense value, pushes of row_sparse
    values from two devices (merged, duplicates summed), replacing or
    lazily updating the store, then pulls."""
    rs = np.random.RandomState(12)
    tk, jk = _stores(optimizer)
    shape = (10, 2)
    dense = rs.randn(*shape).astype(np.float32)
    with CPU:
        tk.init("w", tmx.nd.array(dense))
    jk.init("w", jmx.nd.array(dense))
    t, j = _rsp(rs.randn(10, 2).astype(np.float32), np.arange(10), shape)
    tk.init("r", t)
    jk.init("r", j)
    for step in range(3):
        gs = [_rsp(rs.randn(3, 2).astype(np.float32),
                   rs.choice(10, 3, replace=False), shape) for _ in range(2)]
        for k in ("w", "r"):
            tk.push(k, [g[0] for g in gs])
            jk.push(k, [g[1] for g in gs])
    for k in ("w", "r"):
        with CPU:
            to = tmx.nd.zeros(shape)
        jo = jmx.nd.zeros(shape)
        tk.pull(k, out=to)
        jk.pull(k, out=jo)
        _close(to.asnumpy(), jo.asnumpy())
    t._data.zero_()      # the store holds its own copy
    with CPU:
        to = tmx.nd.zeros(shape)
    tk.pull("r", out=to)
    assert to.asnumpy().any()


# ---------------------------------------------------------------------------
# Module.fit and the wide-embedding loop
# ---------------------------------------------------------------------------

def _fit_two_steps(pkg, feats, y, table, proj, row_fn):
    pkg.random.seed(7)
    net = _sparse_lr(pkg.sym, vocab=table.shape[0], dim=table.shape[1])
    ctx = pkg.cpu()
    mod = pkg.mod.Module(net, context=ctx)
    it = pkg.io.NDArrayIter(feats, y, batch_size=16,
                            label_name="softmax_label")
    mod.bind(it.provide_data, it.provide_label)
    arr = (lambda v: pkg.nd.array(v, ctx=ctx)) if pkg is tmx else \
        pkg.nd.array
    mod.init_params(arg_params={"embed_weight": arr(table),
                                "fc_weight": arr(proj),
                                "fc_bias": arr(np.zeros(2, np.float32))})
    kv = pkg.kv.create("device", device="cpu") if pkg is tmx else \
        pkg.kv.create("device")
    mod.init_optimizer(kvstore=kv, optimizer="sgd",
                       optimizer_params={"learning_rate": 0.5,
                                         "momentum": 0.9})
    for batch in list(it)[:2]:
        mod.prepare(batch, sparse_row_id_fn=row_fn)
        mod.forward_backward(batch)
        mod.update()
    return {k: v.asnumpy() for k, v in mod.get_params()[0].items()}


def test_module_fit_steps_with_sparse_row_id_fn_match_jax():
    """Two steps of test_sparse.py's SparseEmbedding classifier through a
    "device" store that updates, each batch's rows pulled first by
    ``sparse_row_id_fn`` (the other rows of the bound weight zeroed)."""
    V, D, N, A = 50, 8, 64, 4
    rs = np.random.RandomState(1)
    table = rs.normal(0, 1, (V, D)).astype(np.float32)
    proj = rs.normal(0, 1, (2, D)).astype(np.float32)
    feats = rs.randint(0, V, (N, A)).astype(np.float32)
    y = (table[feats.astype(int)].mean(1) @ proj[0] > 0).astype(np.float32)

    def row_fn(batch):
        return {"embed_weight": batch.data[0].asnumpy().astype(np.int64)
                .ravel()}
    got = _fit_two_steps(tmx, feats, y, table, proj, row_fn)
    want = _fit_two_steps(jmx, feats, y, table, proj, row_fn)
    assert sorted(got) == sorted(want)
    for k in want:
        _close(got[k], want[k])
    with pytest.warns(UserWarning, match="sparse_row_id_fn"):
        mod = tmx.mod.Module(_sparse_lr(tmx.sym, V, D), context=CPU)
        mod.bind([("data", (16, A))], [("softmax_label", (16,))])
        mod.init_params()
        mod.init_optimizer(kvstore=None)
        mod.prepare(None, sparse_row_id_fn=row_fn)


def _linear_classification(pkg, sp, steps, vocab=1000, dim=8, fields=3,
                           batch=32):
    """example/sparse/linear_classification.py's loop, ``fields`` keys:
    pull each key's rows, mean-pool, logistic regression, embedding_grad,
    one list push (lazy momentum SGD on the store)."""
    rs = np.random.RandomState(0)
    keys = ["emb%d" % f for f in range(fields)]
    kv = pkg.kv.create("device", device="cpu") if pkg is tmx else \
        pkg.kv.create("device")
    mk = (lambda v: pkg.nd.array(v, ctx=pkg.cpu())) if pkg is tmx else \
        pkg.nd.array
    for k in keys:
        kv.init(k, mk(rs.normal(0, 0.1, (vocab, dim)).astype(np.float32)))
    kv.set_optimizer(pkg.optimizer.SGD(learning_rate=2.0, momentum=0.9,
                                       lazy_update=True))
    w = rs.normal(0, 1.0, (dim,)).astype(np.float32)
    losses = []
    for _ in range(steps):
        ids = rs.zipf(1.3, (batch, fields)) % vocab
        y = (rs.rand(batch) > 0.5).astype(np.float32)
        outs = [sp.zeros_sparse("row_sparse", (vocab, dim),
                                **({"ctx": pkg.cpu()} if pkg is tmx
                                   else {})) for _ in keys]
        kv.row_sparse_pull(keys, out=outs,
                           row_ids=[ids[:, f] for f in range(fields)])
        e = np.zeros((batch, dim), np.float32)
        for f, o in enumerate(outs):
            pos = np.searchsorted(o.indices.asnumpy(), ids[:, f])
            e += o.data.asnumpy()[pos]
        e /= fields
        p = 1.0 / (1.0 + np.exp(-(e @ w)))
        err = ((p - y) / batch).astype(np.float32)
        losses.append(float(-np.mean(y * np.log(p + 1e-8) +
                                     (1 - y) * np.log(1 - p + 1e-8))))
        ge = (err[:, None] * w[None, :] / fields).astype(np.float32)
        grads = [sp.embedding_grad(ids[:, f], mk(ge), vocab)
                 for f in range(fields)]
        kv.push(keys, grads)
        w = w - 0.5 * (e.T @ err)
    tables = []
    for k in keys:
        o = mk(np.zeros((vocab, dim), np.float32))
        kv.pull(k, out=o)
        tables.append(o.asnumpy())
    return losses, tables


def test_linear_classification_loop_matches_jax():
    """Three steps at vocab 1000 through both packages: every table equal
    (each touched row moved), the losses within 1e-6."""
    got = _linear_classification(tmx, tsp, 3)
    want = _linear_classification(jmx, jsp, 3)
    _close(got[0], want[0])
    for a, b in zip(got[1], want[1]):
        np.testing.assert_array_equal(a, b)


def test_allreduce_row_sparse_in_one_process_is_the_array_itself():
    import mxnet_tpu.parallel as jpar
    from mxnet_tpu_torch import parallel as tpar
    t, j = _rsp(np.ones((2, 3), np.float32), [4, 1], (6, 3))
    assert tpar.allreduce_row_sparse(t) is t
    assert jpar.allreduce_row_sparse(j) is j
