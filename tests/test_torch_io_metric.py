"""The rest of the classic API's metrics and iterators against the JAX
package's, on the CPU (mxnet_tpu_torch/{metric,io/io} vs
mxnet_tpu/{metric,io/io}).

* Every metric of the JAX package's registry on the same inputs over
  three updates: F1, MAE, MSE, RMSE, NegativeLogLikelihood,
  PearsonCorrelation, Loss, Torch, Caffe, a CustomMetric from
  ``metric.np`` and a callable given to ``create`` (1e-6 relative: both
  compute in numpy on the host).
* ``CSVIter`` and ``MNISTIter`` over files this test writes,
  ``ResizeIter`` and ``PrefetchingIter`` over ``NDArrayIter``: batch for
  batch, exactly, over two epochs.  The prefetch threads stop and are
  joined at the end of the data, at ``close`` and when the iterator is
  collected.
* ``NDArrayIter``: ``hard_reset``, ``state_dict`` / ``load_state_dict``
  mid-epoch, ``reshard`` and ``num_parts`` against the JAX package's.
* ``LibSVMIter`` gives the JAX package's CSR batches (more in
  ``test_torch_sparse_io.py``).
"""
import gc
import gzip
import struct
import threading

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx


def _host(pkg, x):
    return tmx.nd.array(x, ctx="cpu") if pkg is tmx else jmx.nd.array(x)


def _classes(seed, n=12, k=2):
    rs = np.random.RandomState(seed)
    probs = rs.uniform(0.01, 1, (n, k)).astype(np.float32)
    probs /= probs.sum(1, keepdims=True)
    return probs, rs.randint(0, k, n).astype(np.float32)


def _regression(seed, n=10):
    rs = np.random.RandomState(seed)
    return (rs.normal(size=(n,)).astype(np.float32),
            rs.normal(size=(n, 1)).astype(np.float32))


def _inputs(name, seed):
    """(label, pred) for one update of the metric ``name``."""
    if name in ("mae", "mse", "rmse", "pearsonr"):
        return _regression(seed)
    if name in ("loss", "torch", "caffe"):
        rs = np.random.RandomState(seed)
        return rs.normal(size=(6,)).astype(np.float32), \
            rs.uniform(size=(6, 3)).astype(np.float32)
    probs, labels = _classes(seed, k=2 if name == "f1" else 5)
    return labels, probs


@pytest.mark.parametrize("name", ["f1", "mae", "mse", "rmse", "nll_loss",
                                  "pearsonr", "loss", "torch", "caffe"])
def test_metric_matches_jax(name):
    tm, jm = tmx.metric.create(name), jmx.metric.create(name)
    for seed in range(3):
        label, pred = _inputs(name, seed)
        tm.update([_host(tmx, label)], [_host(tmx, pred)])
        jm.update([_host(jmx, label)], [_host(jmx, pred)])
    (tn, tv), (jn, jv) = tm.get(), jm.get()
    assert tn == jn and tm.num_inst == jm.num_inst
    assert abs(tv - jv) <= 1e-6 * max(1.0, abs(jv))
    assert type(tm).__name__ == type(jm).__name__


def test_f1_refuses_more_than_two_classes():
    probs, _ = _classes(0, k=3)
    for pkg in (tmx, jmx):
        with pytest.raises(ValueError):
            pkg.metric.F1().update([_host(pkg, np.array([0., 2.] * 6))],
                                   [_host(pkg, probs)])


def _feval(label, pred):
    return float(np.abs(label.ravel() - pred.argmax(1)).sum()), label.size


@pytest.mark.parametrize("how", ["np", "create", "class"])
def test_custom_metric_matches_jax(how):
    def make(pkg):
        if how == "np":
            return pkg.metric.np(_feval, name="miss")
        if how == "create":
            return pkg.metric.create(_feval)
        return pkg.metric.CustomMetric(lambda l, p: float(p.mean()))
    tm, jm = make(tmx), make(jmx)
    for seed in range(3):
        probs, labels = _classes(seed, k=4)
        tm.update([_host(tmx, labels)], [_host(tmx, probs)])
        jm.update([_host(jmx, labels)], [_host(jmx, probs)])
    assert tm.get()[0] == jm.get()[0]
    assert abs(tm.get()[1] - jm.get()[1]) <= 1e-6 * abs(jm.get()[1])


def _same_batches(t_it, j_it, epochs=2):
    for _ in range(epochs):
        t_b, j_b = list(t_it), list(j_it)
        assert len(t_b) == len(j_b) > 0
        for a, b in zip(t_b, j_b):
            assert a.pad == b.pad
            for x, y in zip(a.data + (a.label or []),
                            b.data + (b.label or [])):
                np.testing.assert_array_equal(x.asnumpy(), y.asnumpy())
        t_it.reset()
        j_it.reset()


@pytest.mark.parametrize("round_batch", [True, False])
def test_csv_iter_matches_jax(tmp_path, round_batch):
    rs = np.random.RandomState(0)
    data = rs.normal(size=(11, 6)).astype(np.float32)
    label = rs.randint(0, 3, (11, 1)).astype(np.float32)
    np.savetxt(tmp_path / "d.csv", data, delimiter=",")
    np.savetxt(tmp_path / "l.csv", label, delimiter=",")
    kw = dict(data_csv=str(tmp_path / "d.csv"), data_shape=(2, 3),
              label_csv=str(tmp_path / "l.csv"), batch_size=4,
              round_batch=round_batch)
    t_it, j_it = tmx.io.CSVIter(**kw), jmx.io.CSVIter(**kw)
    assert t_it.provide_data == j_it.provide_data
    _same_batches(t_it, j_it)
    kw.pop("label_csv")
    _same_batches(tmx.io.CSVIter(**kw), jmx.io.CSVIter(**kw), epochs=1)


def _write_idx(path, arr, gz):
    head = struct.pack(">I", 0x0800 | arr.ndim) + struct.pack(
        ">" + "I" * arr.ndim, *arr.shape)
    with (gzip.open if gz else open)(path, "wb") as f:
        f.write(head + arr.astype(np.uint8).tobytes())


@pytest.mark.parametrize("flat,gz", [(False, False), (True, True)])
def test_mnist_iter_matches_jax(tmp_path, flat, gz):
    rs = np.random.RandomState(1)
    ext = ".gz" if gz else ""
    img, lab = str(tmp_path / ("img" + ext)), str(tmp_path / ("lab" + ext))
    _write_idx(img, rs.randint(0, 256, (20, 4, 5)), gz)
    _write_idx(lab, rs.randint(0, 10, (20,)), gz)
    kw = dict(image=img, label=lab, batch_size=6, flat=flat, seed=3)
    t_it, j_it = tmx.io.MNISTIter(**kw), jmx.io.MNISTIter(**kw)
    assert t_it.provide_data == j_it.provide_data
    _same_batches(t_it, j_it)


def _arrays(n=14):
    rs = np.random.RandomState(2)
    return rs.normal(size=(n, 3)).astype(np.float32), \
        np.arange(n, dtype=np.float32)


def test_resize_iter_matches_jax():
    X, y = _arrays()
    for size in (2, 5, 9):
        t_it = tmx.io.ResizeIter(tmx.io.NDArrayIter(X, y, batch_size=4),
                                 size)
        j_it = jmx.io.ResizeIter(jmx.io.NDArrayIter(X, y, batch_size=4),
                                 size)
        assert t_it.provide_data == j_it.provide_data
        _same_batches(t_it, j_it)


def _prefetch_threads():
    return [t for t in threading.enumerate()
            if getattr(t, "_target", None) is not None
            and t._target.__name__ == "_prefetch"]


def test_prefetching_iter_matches_jax_and_stops_its_threads():
    X, y = _arrays()
    before = len(_prefetch_threads())
    t_it = tmx.io.PrefetchingIter(tmx.io.NDArrayIter(X, y, batch_size=4))
    j_it = jmx.io.PrefetchingIter(jmx.io.NDArrayIter(X, y, batch_size=4))
    assert t_it.provide_data == j_it.provide_data
    _same_batches(t_it, j_it)
    j_it._stop.set()
    # two iterators, renamed, in one batch
    t2 = tmx.io.PrefetchingIter(
        [tmx.io.NDArrayIter(X, y, batch_size=4),
         tmx.io.NDArrayIter(X * 2, y, batch_size=4)],
        rename_data=[{"data": "a"}, {"data": "b"}])
    assert [d.name for d in t2.provide_data] == ["a", "b"]
    batches = list(t2)
    assert len(batches) == 4 and len(batches[0].data) == 2
    np.testing.assert_array_equal(batches[0].data[1].asnumpy(),
                                  2 * batches[0].data[0].asnumpy())
    # at the end of the data the threads are joined
    assert len(_prefetch_threads()) == before + 1     # t_it was reset
    t_it.close()
    assert len(_prefetch_threads()) == before
    # an iterator dropped mid-epoch stops its threads when collected
    t3 = tmx.io.PrefetchingIter(tmx.io.NDArrayIter(X, y, batch_size=2))
    next(t3)
    assert len(_prefetch_threads()) == before + 1
    del t3
    gc.collect()
    assert len(_prefetch_threads()) == before


def test_prefetching_iter_raises_its_source_error():
    """An error in a source's ``next`` reaches the reader (the thread
    ends), instead of leaving it waiting for a batch forever."""
    class Broken(tmx.io.NDArrayIter):
        def next(self):
            raise OSError("disk gone")
    X, y = _arrays()
    before = len(_prefetch_threads())
    it = tmx.io.PrefetchingIter(Broken(X, y, batch_size=4))
    with pytest.raises(OSError, match="disk gone"):
        next(it)
    assert len(_prefetch_threads()) == before


def test_ndarray_iter_hard_reset_and_state_dict_match_jax():
    X, y = _arrays(22)
    kw = dict(batch_size=4, shuffle=True, seed=9, last_batch_handle="pad")
    t_it, j_it = tmx.io.NDArrayIter(X, y, **kw), \
        jmx.io.NDArrayIter(X, y, **kw)
    for it in (t_it, j_it):
        next(it)
        next(it)
    t_state, j_state = t_it.state_dict(), j_it.state_dict()
    assert {k: v for k, v in t_state.items() if k != "order"} == \
        {k: v for k, v in j_state.items() if k != "order"}
    np.testing.assert_array_equal(t_state["order"], j_state["order"])
    # a fresh iterator resumes at the next unseen batch, in both
    t_new = tmx.io.NDArrayIter(X, y, **dict(kw, seed=1))
    t_new.load_state_dict(t_state)
    j_new = jmx.io.NDArrayIter(X, y, **dict(kw, seed=1))
    j_new.load_state_dict(j_state)
    rest_t, rest_j, rest_old = list(t_new), list(j_new), list(t_it)
    assert len(rest_t) == len(rest_j) == len(rest_old) == 4
    for a, b, c in zip(rest_t, rest_j, rest_old):
        np.testing.assert_array_equal(a.data[0].asnumpy(),
                                      b.data[0].asnumpy())
        np.testing.assert_array_equal(a.data[0].asnumpy(),
                                      c.data[0].asnumpy())
    with pytest.raises(ValueError):
        tmx.io.NDArrayIter(X, y, batch_size=3).load_state_dict(t_state)
    # hard_reset goes back to epoch 0's first batch
    for it in (t_new, j_new):
        it.reset()
        next(it)
        it.hard_reset()
    assert t_new.state_dict()["epoch"] == j_new.state_dict()["epoch"] == 0
    np.testing.assert_array_equal(next(t_new).data[0].asnumpy(),
                                  next(j_new).data[0].asnumpy())


def test_ndarray_iter_reshard_matches_jax():
    X, y = _arrays(24)
    got = {}
    for pkg in (tmx, jmx):
        its = [pkg.io.NDArrayIter(X, y, batch_size=6, num_parts=2,
                                  part_index=r, shuffle=True, seed=4,
                                  last_batch_handle="discard")
               for r in range(2)]
        seen = [next(it).data[0].asnumpy() for it in its]
        for r, it in enumerate(its[:1]):
            it.reshard(part_index=0, num_parts=3)
        others = [pkg.io.NDArrayIter(X, y, batch_size=4, num_parts=3,
                                     part_index=r, shuffle=True, seed=4,
                                     last_batch_handle="discard")
                  for r in (1, 2)]
        for o in others:
            o.load_state_dict(its[0].state_dict())
        rest = [b.data[0].asnumpy() for it in [its[0]] + others
                for b in it]
        got[pkg] = seen + rest
    assert len(got[tmx]) == len(got[jmx])
    for a, b in zip(got[tmx], got[jmx]):
        np.testing.assert_array_equal(a, b)
    # every sample once over the epoch across the ranks
    rows = np.concatenate(got[tmx])[:, 0]
    assert sorted(rows) == sorted(X[:, 0])


def test_ndarray_iter_argument_checks_match_jax():
    X, y = _arrays(8)
    for kw in (dict(num_parts=2, part_index=2),
               dict(num_parts=2, last_batch_handle="roll_over"),
               dict(num_parts=2, shuffle=True)):
        for pkg in (tmx, jmx):
            with pytest.raises(ValueError):
                pkg.io.NDArrayIter(X, y, batch_size=2, **kw)


def test_libsvm_iter_names_its_queue_item(tmp_path):
    """LibSVMIter (queue A item 5, now ported) gives the JAX package's
    CSR batches on this file, the last one padded."""
    path = tmp_path / "d.libsvm"
    path.write_text("1 0:0.5 3:1.0\n0 1:2.0\n1 2:0.25\n")
    got = list(tmx.io.LibSVMIter(str(path), data_shape=(4,), batch_size=2))
    want = list(jmx.io.LibSVMIter(str(path), data_shape=(4,),
                                  batch_size=2))
    assert [b.pad for b in got] == [b.pad for b in want] == [0, 1]
    for t, j in zip(got, want):
        assert t.data[0].stype == "csr"
        np.testing.assert_array_equal(t.data[0].asnumpy(),
                                      j.data[0].asnumpy())
        np.testing.assert_array_equal(t.label[0].asnumpy(),
                                      j.label[0].asnumpy())
