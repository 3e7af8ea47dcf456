"""Sparse storage at the port's file and data boundaries against the JAX
package's, on the CPU: ``LibSVMIter`` (the same CSR batches, padding and
labels, parsed without a dense array), ``.params`` files with row_sparse
and CSR records (bit-equal both ways), the JAX package's legacy npz
container, and ``test_utils.rand_sparse_ndarray`` (the same draws from
the same seed).  Everything is compared exactly."""
import io

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import mxnet_tpu as jmx
import mxnet_tpu.ndarray.sparse as jsp
import mxnet_tpu.test_utils as jtu
import mxnet_tpu_torch as tmx
import mxnet_tpu_torch.ndarray.sparse as tsp
import mxnet_tpu_torch.test_utils as ttu

CPU = tmx.cpu()


def _write_libsvm(path, rows, dim, seed):
    """A libsvm file with duplicate indices, explicit zeros, negative
    indices and empty rows."""
    rs = np.random.RandomState(seed)
    with open(path, "w") as f:
        for i in range(rows):
            toks = []
            for _ in range(rs.randint(0, 6)):
                k = int(rs.randint(-dim, dim))
                v = float(rs.choice([0.0, 1.0, -2.5, rs.randn()]))
                toks.append("%d:%r" % (k, v))
            f.write("%d %s\n" % (rs.randint(0, 2), " ".join(toks)))


@pytest.mark.parametrize("rows,batch", [(11, 4), (8, 4), (3, 5)],
                         ids=["pad-1", "no-pad", "pad-past-end"])
def test_libsvm_iter_batches_match_jax(tmp_path, rows, batch):
    path = str(tmp_path / "d.libsvm")
    _write_libsvm(path, rows, 20, rows)
    its = [pkg.io.LibSVMIter(path, data_shape=(20,), batch_size=batch)
           for pkg in (tmx, jmx)]
    assert its[0].provide_data[0].shape == its[1].provide_data[0].shape
    assert its[0].provide_label[0].shape == its[1].provide_label[0].shape
    for epoch in range(2):
        got, want = list(its[0]), list(its[1])
        assert len(got) == len(want) > 0
        for t, j in zip(got, want):
            assert t.pad == j.pad
            td, jd = t.data[0], j.data[0]
            assert td.stype == "csr" and td.shape == tuple(jd.shape)
            for a in ("_data", "_indices", "_indptr"):
                np.testing.assert_array_equal(getattr(td, a).numpy(),
                                              np.asarray(getattr(jd, a)))
            np.testing.assert_array_equal(t.label[0].asnumpy(),
                                          j.label[0].asnumpy())
        for it in its:
            it.reset()


def test_libsvm_iter_refuses_an_index_out_of_range(tmp_path):
    path = str(tmp_path / "bad.libsvm")
    with open(path, "w") as f:
        f.write("1 0:1.0 4:2.0\n")
    for pkg in (tmx, jmx):
        with pytest.raises(IndexError):
            pkg.io.LibSVMIter(path, data_shape=(4,), batch_size=1)


def _arrays(rs):
    """The same dict of dense, row_sparse (with a zero-nnz one) and CSR
    arrays in both packages."""
    dense = rs.randn(3, 4).astype(np.float32)
    rsp = (rs.randn(3, 2).astype(np.float64), np.array([7, 1, 4]))
    csr = np.where(rs.rand(4, 6) > 0.6, rs.randn(4, 6), 0).astype(np.float32)
    with CPU:
        t = {"dense": tmx.nd.array(dense),
             "rsp": tsp.row_sparse_array(rsp, shape=(9, 2)),
             "empty": tsp.zeros_sparse("row_sparse", (5, 3)),
             "csr": tsp.csr_matrix(csr),
             "csr0": tsp.zeros_sparse("csr", (2, 3)),
             "i": tmx.nd.array(np.arange(4, dtype=np.int32))}
    j = {"dense": jmx.nd.array(dense),
         "rsp": jsp.row_sparse_array(rsp, shape=(9, 2)),
         "empty": jsp.zeros_sparse("row_sparse", (5, 3)),
         "csr": jsp.csr_matrix(csr),
         "csr0": jsp.zeros_sparse("csr", (2, 3)),
         "i": jmx.nd.array(np.arange(4, dtype=np.int32))}
    return t, j


def _same(t, j):
    assert t.stype == j.stype and t.shape == tuple(j.shape)
    np.testing.assert_array_equal(t.asnumpy(), np.asarray(j.asnumpy()))
    if t.stype != "default":
        for a in ("_data", "_indices") + (("_indptr",) if t.stype == "csr"
                                          else ()):
            np.testing.assert_array_equal(getattr(t, a).numpy(),
                                          np.asarray(getattr(j, a)))


@pytest.mark.parametrize("form", ["dict", "list"])
def test_params_files_are_bit_equal_both_ways(tmp_path, form):
    t, j = _arrays(np.random.RandomState(0))
    if form == "list":
        t, j = list(t.values()), list(j.values())
    ft, fj = str(tmp_path / "t.params"), str(tmp_path / "j.params")
    tmx.nd.save(ft, t)
    jmx.nd.save(fj, j)
    assert open(ft, "rb").read() == open(fj, "rb").read()
    back_t = tmx.nd.load(fj, ctx=CPU)
    back_j = jmx.nd.load(ft)
    pairs = zip(back_t.values(), back_j.values()) if form == "dict" \
        else zip(back_t, back_j)
    for a, b in pairs:
        _same(a, b)
    tmx.nd.save(str(tmp_path / "again.params"), back_t)
    assert open(str(tmp_path / "again.params"), "rb").read() == \
        open(ft, "rb").read()


def test_unsorted_row_sparse_record_loads_sorted(tmp_path):
    """A record whose indices are unsorted (another writer's) loads
    through the constructor's stable sort in both packages."""
    data = np.arange(6, dtype=np.float32).reshape(3, 2)
    j = jsp.RowSparseNDArray(jnp.asarray(data), jnp.asarray([5, 1, 3]),
                             (6, 2))
    j._indices, j._data = jnp.asarray([5, 1, 3]), jnp.asarray(data)
    f = str(tmp_path / "u.params")
    jmx.nd.save(f, [j])
    (t,), (jb,) = tmx.nd.load(f, ctx=CPU), jmx.nd.load(f)
    _same(t, jb)


@pytest.mark.parametrize("form", ["dict", "list"])
def test_legacy_npz_container_loads(tmp_path, form):
    rs = np.random.RandomState(1)
    vals = [rs.randn(2, 3).astype(np.float32), np.arange(5, dtype=np.int64)]
    buf = io.BytesIO()
    if form == "dict":
        np.savez(buf, **{"dict:w": vals[0], "dict:b": vals[1]})
    else:
        np.savez(buf, **{"arr:1": vals[1], "arr:0": vals[0]})
    f = str(tmp_path / "legacy.params")
    with open(f, "wb") as fh:
        fh.write(buf.getvalue())
    got, want = tmx.nd.load(f, ctx=CPU), jmx.nd.load(f)
    assert type(got) is type(want)
    pairs = [(got[k], want[k]) for k in want] if form == "dict" \
        else list(zip(got, want))
    assert len(pairs) == 2
    for a, b in pairs:
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a.asnumpy(), b.asnumpy())


@pytest.mark.parametrize("stype,density", [("row_sparse", 0.4),
                                           ("row_sparse", 0.0),
                                           ("csr", 0.3), ("csr", None)])
def test_rand_sparse_ndarray_draws_the_same(stype, density):
    jtu._rng.seed(5)
    ttu._rng.seed(5)
    shape = (7, 4)
    with CPU:
        t, tparts = ttu.rand_sparse_ndarray(shape, stype, density=density)
    j, jparts = jtu.rand_sparse_ndarray(shape, stype, density=density)
    _same(t, j)
    assert len(tparts) == len(jparts)
    for a, b in zip(tparts, jparts):
        np.testing.assert_array_equal(a, b)
    with CPU:
        t2 = ttu.rand_ndarray(shape, stype, density=0.5)
    _same(t2, jtu.rand_ndarray(shape, stype, density=0.5))


def test_row_sparse_bf16_record_round_trips(tmp_path):
    """bfloat16 row_sparse data (type flag 7) round-trips bit for bit."""
    with CPU:
        a = tsp.row_sparse_array((np.array([[1.5, -2.25]], np.float32),
                                  np.array([3])), shape=(4, 2),
                                 dtype="bfloat16")
    f = str(tmp_path / "b.params")
    tmx.nd.save(f, {"a": a})
    back = tmx.nd.load(f, ctx=CPU)["a"]
    assert back._data.dtype == torch.bfloat16
    assert torch.equal(back._data, a._data)
    assert back.indices.asnumpy().tolist() == [3]
    j = jmx.nd.load(f)["a"]
    np.testing.assert_array_equal(np.asarray(j._data).astype(np.float32),
                                  a._data.float().numpy())
    np.testing.assert_array_equal(np.asarray(j._indices), [3])
