"""The port's ``mx.nd`` against the JAX package's, on the CPU: the
counterparts of ``tests/test_ndarray.py``'s 16 tests.  Each runs the same
script of NDArray calls in both packages (the port inside ``with
mx.cpu():``) on the same numpy inputs and compares every result: values
exactly for creation, data movement, indexing, comparisons and ordering,
within 1e-6 of the largest magnitude for f32 arithmetic and reductions;
dtypes and shapes equal.  Plus what is particular to the port: in-place
writes through views, ``nd.load`` onto the given context, and the
``NotPortedYet`` parts (sparse, the unported contrib ops).
"""
import struct

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import MXNetError, NotPortedYet

from torch_cases import compare


def _both(script, tol=0.0):
    """Run ``script(mx)`` in both packages; it returns a list of NDArrays
    (or numpy values); compare them pairwise."""
    ref = script(jmx)
    with tmx.cpu():
        got = script(tmx)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        g = g.asnumpy() if hasattr(g, "asnumpy") else np.asarray(g)
        r = r.asnumpy() if hasattr(r, "asnumpy") else np.asarray(r)
        compare(g, r, tol)


def test_creation():
    def script(mx):
        nd = mx.nd
        return [nd.zeros((3, 4)), nd.ones((2,), dtype="int32"),
                nd.full((2, 2), 7.5), nd.array([[1, 2], [3, 4]]),
                nd.array(np.arange(4, dtype=np.float64)),
                nd.arange(0, 10, 2), nd.arange(0.5, 3.2, 0.7, repeat=2),
                nd.eye(3), nd.eye(3, 4, 1), nd.empty((2, 3)).shape,
                nd.zeros(5, dtype="int64")]
    _both(script)


def test_arithmetic():
    def script(mx):
        a = mx.nd.array([[1.0, 2], [3, 4]])
        b = mx.nd.array([[5.0, 6], [7, 8]])
        return [a + b, a - b, a * 2 + 1, 1 / a, b % a, a ** 2, -a, 2 - a,
                2 ** a, a / b, 3 % a, abs(-a), a * b, 7 - a * 0.5]
    _both(script, 1e-6)


def test_broadcast_arith():
    def script(mx):
        a = mx.nd.ones((3, 4))
        b = mx.nd.arange(0, 4).reshape((1, 4))
        return [a + b, a - b, a * b, a / (b + 1), b ** a, a % (b + 1)]
    _both(script, 1e-6)


def test_comparison():
    def script(mx):
        a = mx.nd.array([1.0, 2, 3])
        b = mx.nd.array([3.0, 2, 1])
        return [a == b, a != b, a > b, a >= 2, a < b, a <= 2,
                mx.nd.ones((2, 3)) > mx.nd.array([[0.0, 1, 2]])]
    _both(script)


def test_inplace():
    def script(mx):
        a = mx.nd.ones((2, 2))
        aid = id(a)
        a += 1
        r = [a.copy()]
        a *= 3
        r.append(a.copy())
        a -= mx.nd.ones((2, 2))
        a /= 4
        r.append(a)
        assert id(a) == aid
        return r
    _both(script, 1e-6)


def test_integer_arrays_follow_x64_dtypes():
    """An int32 array with a Python scalar, and ``round``, ``clip``,
    ``reciprocal`` of one, give float64 in both packages (the JAX package
    runs with x64); ``a += 1.7`` rebinds an int32 array to float64; a
    remainder by zero is 0."""
    def script(mx):
        a = mx.nd.array(np.array([1, -2, 3, 4], np.int32), dtype="int32")
        b = mx.nd.array(np.array([0, 3, -2, 0], np.int32), dtype="int32")
        r = [a + 2, a / 2, a * 1.5, 2 - a, mx.nd.round(a),
             mx.nd.clip(a, 0, 2), mx.nd.reciprocal(a), a % b, a + a]
        c = a.copy()
        c += 1.7
        r.append(c)
        return r
    _both(script, 1e-6)


def test_inplace_writes_reach_views():
    with tmx.cpu():
        a = tmx.nd.zeros((3, 4))
        row = a[1]
        row += 2                      # a view: writes into a
        a[2] = tmx.nd.ones((4,))
        assert (a.asnumpy() == [[0] * 4, [2] * 4, [1] * 4]).all()


def test_indexing():
    def script(mx):
        # basic indexing is a view in the port (and the reference): read
        # each result out before the writes below
        a = mx.nd.array(np.arange(12).reshape(3, 4))
        r = [x.asnumpy() for x in (a[1], a[1:3], a[:, ::-1], a[2, 3:0:-2],
                                   a[::-2, 1], a[-1], a[:, 1:3])]
        r.append(a[1, 2].asscalar())
        a[0] = 9
        r.append(a.asnumpy())
        a[1:3] = 0
        r.append(a.asnumpy())
        a[2, ::-1] = mx.nd.array([1.0, 2, 3, 4])
        a[0, 3:0:-2] = 5
        r.append(a.asnumpy())
        r.append(a[mx.nd.array([0, 2], dtype="int32")])
        return r
    _both(script)


def test_shape_ops():
    def script(mx):
        nd = mx.nd
        a = nd.array(np.arange(24).reshape(2, 3, 4))
        return [a.reshape((6, 4)), a.reshape((-1, 4)), a.reshape((0, -1)),
                nd.Reshape(a, shape=(-3, 4)), nd.Reshape(a, shape=(-4, 1, 2,
                                                                 -2)),
                a.transpose(), a.transpose((1, 0, 2)), a.T, a.flatten(),
                a.expand_dims(0), a.swapaxes(0, 2),
                nd.tile(a, reps=(2, 1, 1)), nd.repeat(a, repeats=2, axis=1),
                nd.squeeze(a.expand_dims(0), axis=0), a.flip(axis=1),
                a.broadcast_to((2, 3, 4)), a.slice((0, 1), (2, 3)),
                nd.moveaxis(a, 0, 2)]
    _both(script)


def test_reduce():
    x = np.random.RandomState(0).rand(3, 4, 5).astype(np.float32)

    def script(mx):
        nd = mx.nd
        a = nd.array(x)
        return [a.sum(), nd.sum(a, axis=1), nd.sum(a, axis=(0, 2)),
                nd.sum(a, axis=1, keepdims=True),
                nd.sum(a, axis=1, exclude=True), nd.mean(a, axis=0),
                nd.max(a, axis=2), nd.min(a, axis=0), nd.prod(a, axis=2),
                a.mean(), a.max(), a.min(axis=1), a.norm(), a.argmax(axis=1),
                a.argmin(axis=2)]
    _both(script, 1e-6)


def test_dot():
    rs = np.random.RandomState(1)
    a = rs.rand(4, 5).astype(np.float32)
    b = rs.rand(5, 6).astype(np.float32)
    x = rs.rand(3, 4, 5).astype(np.float32)
    y = rs.rand(3, 5, 2).astype(np.float32)

    def script(mx):
        nd = mx.nd
        return [nd.dot(nd.array(a), nd.array(b)),
                nd.dot(nd.array(a), nd.array(b.T), transpose_b=True),
                nd.dot(nd.array(a.T), nd.array(b), transpose_a=True),
                nd.batch_dot(nd.array(x), nd.array(y))]
    _both(script, 1e-6)


def test_concat_split_stack():
    def script(mx):
        nd = mx.nd
        a, b = nd.ones((2, 3)), nd.zeros((2, 3))
        parts = nd.split(nd.array(np.arange(12).reshape(4, 3)),
                         num_outputs=2, axis=0)
        return [nd.concat(a, b, dim=0), nd.Concat(a, b, dim=1), parts[0],
                parts[1], nd.stack(a, b, axis=0, num_args=2),
                nd.concatenate([a, b], axis=1), nd.add_n(a, b, a)]
    _both(script)


def test_take_onehot():
    def script(mx):
        nd = mx.nd
        w = nd.array(np.arange(20).reshape(10, 2))
        idx = nd.array([1, 3, 5], dtype="int32")
        return [nd.take(w, idx), nd.one_hot(idx, depth=10),
                nd.Embedding(idx, w, input_dim=10, output_dim=2),
                idx.one_hot(4), nd.pick(w, nd.array([0, 1] * 5), axis=1)]
    _both(script)


def test_ordering():
    x = np.random.RandomState(2).rand(5, 10).astype(np.float32)

    def script(mx):
        nd = mx.nd
        a = nd.array(x)
        topv, topi = nd.topk(a, k=3, ret_typ="both")
        return [topv, topi, nd.sort(a, axis=1), nd.argmax(a, axis=1),
                nd.argmin(a, axis=1), nd.argsort(a, axis=0),
                nd.sort(a, axis=1, is_ascend=False)]
    _both(script)


def test_save_load(tmp_path):
    rs = np.random.RandomState(3)
    x, y = rs.rand(3, 3), rs.rand(2)

    def script(mx, fname):
        nd = mx.nd
        a, b = nd.array(x), nd.array(y)
        nd.save(fname, {"a": a, "b": b})
        loaded = nd.load(fname)
        assert set(loaded) == {"a", "b"}
        nd.save(fname, [a, b])
        lst = nd.load(fname)
        return [loaded["a"], loaded["b"], lst[0], lst[1]]

    ref = script(jmx, str(tmp_path / "j.params"))
    with tmx.cpu():
        got = script(tmx, str(tmp_path / "t.params"))
    for g, r in zip(got, ref):
        compare(g.asnumpy(), r.asnumpy(), 0.0)
    assert open(tmp_path / "j.params", "rb").read() == \
        open(tmp_path / "t.params", "rb").read()


def test_astype_copy_context():
    def script(mx):
        a = mx.nd.ones((2, 2))
        b = a.astype("float64")
        c = a.copy()
        c[0] = 5
        d = a.as_in_context(mx.cpu())
        assert d.context.device_type == "cpu"
        e = mx.nd.array([1.7, -2.2]).astype("int32")
        return [a, b, c, d, e, a.astype("float32", copy=False)]
    _both(script)


def test_clip_where_maximum():
    x = np.array([-2, -1, 0, 1, 2], dtype=np.float32)

    def script(mx):
        nd = mx.nd
        a = nd.array(x)
        cond = nd.array([1, 0, 1, 0, 1], dtype="float32")
        return [nd.clip(a, a_min=-1, a_max=1), nd.maximum(a, 0),
                nd.minimum(a, 0), nd.maximum(0.5, a),
                nd.maximum(a, nd.array(-x)), nd.minimum(a, a.reshape((5, 1))),
                nd.where(cond, a, nd.array(-x)), nd.add(a, 1),
                nd.subtract(a, a), nd.multiply(a, 2), nd.divide(a, 4),
                nd.power(nd.abs(a), 2)]
    _both(script, 1e-6)


def test_save_load_reference_binary(tmp_path):
    """The reference container, byte for byte: the header, a record's
    bytes, several dtypes in dict form; a sparse record of the JAX
    package loads as the same row_sparse array."""
    f = str(tmp_path / "x.params")
    with tmx.cpu():
        a = tmx.nd.array(np.arange(6, dtype=np.float32).reshape(2, 3))
        tmx.nd.save(f, [a])
        buf = open(f, "rb").read()
        expect = struct.pack("<QQQIiIqqiii", 0x112, 0, 1, 0xF993FAC9, 0,
                             2, 2, 3, 1, 0, 0)
        assert buf[:len(expect)] == expect
        assert buf[len(expect):len(expect) + 24] == a.asnumpy().tobytes()
        (back,) = tmx.nd.load(f)
        np.testing.assert_array_equal(back.asnumpy(), a.asnumpy())
    # a sparse file written by the JAX package
    import mxnet_tpu.ndarray.sparse as sp
    rs = sp.row_sparse_array((np.ones((2, 4), np.float32), [1, 5]),
                             shape=(8, 4))
    jmx.nd.save(f, {"rs": rs})
    back = tmx.nd.load(f, ctx=tmx.cpu())["rs"]
    assert back.stype == "row_sparse"
    assert back.indices.asnumpy().tolist() == [1, 5]
    np.testing.assert_array_equal(back.asnumpy(), rs.asnumpy())


def test_not_ported_parts_raise():
    with tmx.cpu():
        a = tmx.nd.ones((2,))
        # autograd, mx.nd.contrib and sparse storage are ported (tests/
        # test_torch_autograd.py, test_torch_contrib_ops.py, test_torch_
        # sparse_storage.py): tostype and attach_grad(stype=) as in JAX
        assert a.grad is None
        a.attach_grad()
        assert a.grad.asnumpy().tolist() == [0.0, 0.0]
        j = jmx.nd.ones((2,))
        for st in ("csr", "row_sparse"):
            got, want = a.reshape((1, 2)).tostype(st), \
                j.reshape((1, 2)).tostype(st)
            assert got.stype == want.stype == st
            np.testing.assert_array_equal(got.data.asnumpy(),
                                          want.data.asnumpy())
        a.attach_grad(stype="row_sparse")    # a dense gradient, as in JAX
        j.attach_grad(stype="row_sparse")
        assert a.grad.stype == j.grad.stype == "default"
        assert tmx.nd.sparse.RowSparseNDArray is tmx.nd.RowSparseNDArray
        with pytest.raises(MXNetError):
            tmx.nd.concat(a, a, dim=0, out=[a, a])
