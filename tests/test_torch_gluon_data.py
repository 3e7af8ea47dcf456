"""``mx.gluon.data`` of the port against the JAX package's, on the CPU:
datasets (MNIST and CIFAR files written in their raw formats from a
seed, RecordIO and image folders), samplers, the vision transforms, the
``DataLoader`` with 0 workers, 2 worker processes and threads, and
``gluon.contrib.data``.  Everything runs the same numpy and PIL code in
both packages, so the comparison is bit for bit."""
import gzip
import io as pyio
import os
import pickle
import struct

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.gluon import data as jdata
from mxnet_tpu.gluon.contrib import data as jcdata
from mxnet_tpu_torch.gluon import data as tdata
from mxnet_tpu_torch.gluon.contrib import data as tcdata


def _np(x):
    """numpy of a sample or batch leaf, whichever package made it."""
    if isinstance(x, (jmx.nd.NDArray, tmx.nd.NDArray)):
        return x.asnumpy()
    return np.asarray(x)


def _assert_same(got, want):
    """Nested lists / tuples of arrays or scalars are equal, dtype too."""
    if isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want)
        for g, w in zip(got, want):
            _assert_same(g, w)
        return
    g, w = _np(got), _np(want)
    assert g.dtype == w.dtype, (g.dtype, w.dtype)
    np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("path", [
    "gluon.data", "gluon.data.vision", "gluon.data.vision.transforms",
    "gluon.data.dataset", "gluon.data.sampler",
    "gluon.contrib.data", "contrib.text", "contrib.text.embedding"])
def test_namespace_has_every_public_name(path):
    import importlib
    j = importlib.import_module("mxnet_tpu." + path)
    t = importlib.import_module("mxnet_tpu_torch." + path)
    names = getattr(j, "__all__", None) or [
        n for n in dir(j) if getattr(getattr(j, n), "__module__",
                                     getattr(getattr(j, n), "__name__", ""))
        .startswith(j.__name__)]          # defined here, not imported
    missing = sorted(n for n in names if not n.startswith("_")
                     and not hasattr(t, n))
    assert not missing


# -- datasets ---------------------------------------------------------------

def _write_idx(path, arr, gz):
    arr = np.asarray(arr, np.uint8)
    head = struct.pack(">I", 0x0800 | arr.ndim) + \
        struct.pack(">" + "I" * arr.ndim, *arr.shape)
    op = gzip.open if gz else open
    with op(path + (".gz" if gz else ""), "wb") as f:
        f.write(head + arr.tobytes())


@pytest.fixture(scope="module")
def raw_root(tmp_path_factory):
    """MNIST idx files (train gzipped, test plain), the CIFAR-10 and
    CIFAR-100 python pickles, from one seed."""
    d = tmp_path_factory.mktemp("raw")
    rs = np.random.RandomState(0)
    mn = d / "mnist"
    mn.mkdir()
    for split, n, gz in (("train", 12, True), ("t10k", 7, False)):
        _write_idx(str(mn / ("%s-images-idx3-ubyte" % split)),
                   rs.randint(0, 256, (n, 28, 28)), gz)
        _write_idx(str(mn / ("%s-labels-idx1-ubyte" % split)),
                   rs.randint(0, 10, n), gz)
    c10 = d / "cifar10" / "cifar-10-batches-py"
    c10.mkdir(parents=True)
    for name in ["data_batch_%d" % i for i in range(1, 6)] + ["test_batch"]:
        with open(str(c10 / name), "wb") as f:
            pickle.dump({"data": rs.randint(0, 256, (3, 3072)).astype(
                np.uint8), "labels": list(rs.randint(0, 10, 3))}, f)
    c100 = d / "cifar100" / "cifar-100-python"
    c100.mkdir(parents=True)
    for name, n in (("train", 5), ("test", 4)):
        with open(str(c100 / name), "wb") as f:
            pickle.dump({"data": rs.randint(0, 256, (n, 3072)).astype(
                np.uint8), "fine_labels": list(rs.randint(0, 100, n)),
                "coarse_labels": list(rs.randint(0, 20, n))}, f)
    return d


def _items(ds):
    return [ds[i] for i in range(len(ds))]


@pytest.mark.parametrize("which", [
    ("MNIST", "mnist", dict(train=True)),
    ("MNIST", "mnist", dict(train=False)),
    ("FashionMNIST", "mnist", dict(train=True)),
    ("CIFAR10", "cifar10", dict(train=True)),
    ("CIFAR10", "cifar10", dict(train=False)),
    ("CIFAR100", "cifar100", dict(train=True, fine_label=True)),
    ("CIFAR100", "cifar100", dict(train=False)),
], ids=lambda w: "%s_%s" % (w[0], "_".join("%s" % v for v in
                                          w[2].values())))
def test_vision_datasets_match(raw_root, which):
    cls, sub, kw = which
    root = str(raw_root / sub)
    j = getattr(jdata.vision, cls)(root=root, **kw)
    t = getattr(tdata.vision, cls)(root=root, **kw)
    assert len(t) == len(j) > 0
    _assert_same(_items(t), _items(j))


@pytest.fixture(scope="module")
def image_rec(tmp_path_factory):
    from mxnet_tpu_torch import recordio
    d = tmp_path_factory.mktemp("irec")
    prefix = str(d / "imgs")
    rs = np.random.RandomState(1)
    w = recordio.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec", "w")
    for i in range(9):
        img = rs.randint(0, 256, (20 + i, 24, 3)).astype(np.uint8)
        w.write_idx(i, recordio.pack_img(recordio.IRHeader(0, float(i % 4),
                                                           i, 0), img))
    w.close()
    return prefix


def test_record_datasets_match(image_rec):
    j = jdata.RecordFileDataset(image_rec + ".rec")
    t = tdata.RecordFileDataset(image_rec + ".rec")
    assert len(t) == len(j) == 9
    assert [t[i] for i in range(9)] == [j[i] for i in range(9)]
    j = jdata.vision.ImageRecordDataset(image_rec + ".rec")
    t = tdata.vision.ImageRecordDataset(image_rec + ".rec")
    _assert_same(_items(t), _items(j))
    assert t[0][0].context == tmx.cpu()


def test_image_folder_dataset_matches(tmp_path):
    from PIL import Image
    rs = np.random.RandomState(2)
    for cls in ("b_cls", "a_cls"):
        (tmp_path / cls).mkdir()
        for i in range(3):
            Image.fromarray(rs.randint(0, 256, (10, 12, 3)).astype(
                np.uint8)).save(str(tmp_path / cls / ("%d.png" % i)))
    (tmp_path / "a_cls" / "notes.txt").write_text("skip me")
    for flag in (1, 0):
        j = jdata.vision.ImageFolderDataset(str(tmp_path), flag=flag)
        t = tdata.vision.ImageFolderDataset(str(tmp_path), flag=flag)
        assert t.synsets == j.synsets == ["a_cls", "b_cls"]
        assert t.items == j.items
        _assert_same(_items(t), _items(j))


def test_array_and_simple_datasets_and_transforms_match():
    rs = np.random.RandomState(3)
    X = rs.rand(7, 3).astype(np.float32)
    Y = np.arange(7)
    dsets = []
    for m, pkg in ((jdata, jmx), (tdata, tmx)):
        ctx = {} if pkg is jmx else {"ctx": tmx.cpu()}
        a = m.ArrayDataset(X, pkg.nd.array(Y, dtype=np.int64, **ctx))
        dsets.append([a, m.SimpleDataset(list(range(5))),
                      a.transform(lambda x, y: (x * 2, y + 1)),
                      a.transform_first(lambda x: x.sum(), lazy=False),
                      m.SimpleDataset(X).transform(lambda x: x - 1)])
    for j, t in zip(*dsets):
        assert len(t) == len(j)
        _assert_same(_items(t), _items(j))
    with pytest.raises(ValueError):
        tdata.ArrayDataset(X, Y[:3])


# -- samplers ---------------------------------------------------------------

@pytest.mark.parametrize("last_batch", ["keep", "discard", "rollover"])
def test_samplers_match(last_batch):
    for m in (jdata, tdata):
        assert list(m.SequentialSampler(5)) == [0, 1, 2, 3, 4]
    np.random.seed(4)
    j = list(jdata.RandomSampler(9))
    np.random.seed(4)
    t = list(tdata.RandomSampler(9))
    assert t == j and sorted(t) == list(range(9))
    jb = jdata.BatchSampler(jdata.SequentialSampler(10), 3, last_batch)
    tb = tdata.BatchSampler(tdata.SequentialSampler(10), 3, last_batch)
    for _ in range(3):                   # rollover carries across epochs
        assert len(tb) == len(jb)
        assert list(tb) == list(jb)
    with pytest.raises(ValueError):
        list(tdata.BatchSampler(tdata.SequentialSampler(3), 2, "bogus"))


@pytest.mark.parametrize("rollover", [True, False])
def test_interval_sampler_matches(rollover):
    j = jcdata.IntervalSampler(10, 3, rollover=rollover)
    t = tcdata.IntervalSampler(10, 3, rollover=rollover)
    assert list(t) == list(j) and len(t) == len(j)
    with pytest.raises(ValueError):
        tcdata.IntervalSampler(2, 3)


# -- transforms -------------------------------------------------------------

def _transforms(m):
    T = m.vision.transforms
    return {
        "to_tensor": T.ToTensor(),
        "normalize": T.Normalize((0.4, 0.5, 0.6), (0.2, 0.25, 0.3)),
        "resize": T.Resize(11),
        "resize_pair": T.Resize((9, 13)),
        "center_crop": T.CenterCrop(8),
        "random_resized_crop": T.RandomResizedCrop(10),
        "flip_lr": T.RandomFlipLeftRight(),
        "flip_tb": T.RandomFlipTopBottom(),
        "brightness": T.RandomBrightness(0.3),
        "cast": T.Cast("float16"),
        "compose": T.Compose([T.RandomResizedCrop(12),
                              T.RandomFlipLeftRight(), T.ToTensor(),
                              T.Normalize((0.5,) * 3, (0.2,) * 3)]),
    }


@pytest.mark.parametrize("name", sorted(_transforms(jdata)))
def test_transform_matches(name):
    rs = np.random.RandomState(5)
    img = rs.randint(0, 256, (16, 14, 3)).astype(np.uint8)
    if name == "normalize":
        img = rs.rand(3, 16, 14).astype(np.float32)
    jt, tt = _transforms(jdata)[name], _transforms(tdata)[name]
    for k in range(4):
        np.random.seed(10 + k)
        j = jt(jmx.nd.array(img, dtype=img.dtype))
        np.random.seed(10 + k)
        t = tt(tmx.nd.array(img, ctx=tmx.cpu(), dtype=img.dtype))
        assert t.context == tmx.cpu()
        _assert_same(t, j)


# -- the DataLoader ---------------------------------------------------------

def _jpeg(rs):
    from PIL import Image
    buf = pyio.BytesIO()
    Image.fromarray(rs.randint(0, 256, (18, 20, 3)).astype(
        np.uint8)).save(buf, format="JPEG", quality=90)
    return buf.getvalue()


class _Decoded:
    """A dataset of JPEG bytes decoded with PIL per item (what image
    folders and record files give): numpy samples, fork-safe."""

    def __init__(self, n, seed):
        rs = np.random.RandomState(seed)
        self.bufs = [_jpeg(rs) for _ in range(n)]

    def __len__(self):
        return len(self.bufs)

    def __getitem__(self, i):
        from PIL import Image
        img = np.asarray(Image.open(pyio.BytesIO(self.bufs[i])))
        return img, i % 5


def _loader_batches(m, ds, **kw):
    return [[_np(x) for x in b] if isinstance(b, (list, tuple)) else _np(b)
            for b in m.DataLoader(ds, **kw)]


@pytest.mark.parametrize("mode", [
    dict(num_workers=0),
    dict(num_workers=2, thread_workers=False),
    dict(num_workers=2, thread_workers=True),
], ids=["inline", "processes", "threads"])
@pytest.mark.parametrize("last_batch", ["keep", "discard"])
def test_dataloader_matches(mode, last_batch):
    """The same mode of both loaders over a dataset that decodes JPEGs
    per item (numpy samples: both pick process workers by default)."""
    ds = _Decoded(11, 6)
    want = _loader_batches(jdata, ds, batch_size=4, last_batch=last_batch,
                           **mode)
    got = _loader_batches(tdata, ds, batch_size=4, last_batch=last_batch,
                          **mode)
    assert len(got) == len(want) == (3 if last_batch == "keep" else 2)
    for g, w in zip(got, want):
        _assert_same(g, w)


def test_dataloader_with_random_transforms_matches():
    ds = _Decoded(9, 7)
    items = [ds[i] for i in range(len(ds))]
    out = []
    for m in (jdata, tdata):
        T = m.vision.transforms
        tf = T.Compose([T.RandomResizedCrop(12), T.RandomFlipLeftRight(),
                        T.ToTensor()])
        np.random.seed(7)
        out.append(_loader_batches(m, m.SimpleDataset(items)
                                   .transform_first(tf), batch_size=4))
    for g, w in zip(out[1], out[0]):
        _assert_same(g, w)


def test_dataloader_shuffle_and_loader_dtypes():
    X = np.arange(24, dtype=np.float32).reshape(12, 2)
    Y = np.arange(12)
    np.random.seed(8)
    want = _loader_batches(jdata, jdata.ArrayDataset(X, Y), batch_size=5,
                           shuffle=True, last_batch="rollover")
    np.random.seed(8)
    got = _loader_batches(tdata, tdata.ArrayDataset(X, Y), batch_size=5,
                          shuffle=True, last_batch="rollover")
    for g, w in zip(got, want):
        _assert_same(g, w)
    assert got[0][1].dtype == np.int64


def test_dataloader_processes_take_host_ndarray_samples_and_refuse_none():
    """Forked workers run with the CPU as the current context: a
    transform that makes an NDArray without a context makes a host one,
    and the process workers collate it."""

    class Made(tdata.Dataset):
        def __len__(self):
            return 6

        def __getitem__(self, i):
            return tmx.nd.array(np.full((2, 3), i, np.float32)), i

    loader = tdata.DataLoader(Made(), batch_size=4, num_workers=2)
    assert not loader._thread_workers
    got = [(d.asnumpy(), l.asnumpy()) for d, l in loader]
    np.testing.assert_array_equal(got[0][0][:, 0, 0], [0, 1, 2, 3])
    np.testing.assert_array_equal(got[1][1], [4, 5])
    with pytest.raises(ValueError):
        iter(tdata.DataLoader(Made(), batch_size=2, num_workers=2,
                              thread_workers=False,
                              batchify_fn=lambda s: s)).__next__()


def test_dataloader_worker_error_surfaces():
    class Broken(tdata.Dataset):
        def __len__(self):
            return 4

        def __getitem__(self, i):
            if i == 2:
                raise KeyError("no such record")
            return np.zeros(2), i

    for tw in (False, True):
        loader = tdata.DataLoader(Broken(), batch_size=2, num_workers=2,
                                  thread_workers=tw)
        with pytest.raises((RuntimeError, KeyError), match="record"):
            list(loader)


def test_dataloader_custom_batchify_and_ring():
    ds = tdata.ArrayDataset(np.arange(10, dtype=np.float32))
    got = list(tdata.DataLoader(ds, batch_size=3, num_workers=2,
                                thread_workers=True,
                                batchify_fn=lambda s: [float(x) for x in s]))
    assert got == [[0., 1., 2.], [3., 4., 5.], [6., 7., 8.], [9.]]
    # every batch has buffers of its own: ten kept batches stay intact
    kept = list(tdata.DataLoader(ds, batch_size=1))
    assert len({b._handle.data_ptr() for b in kept}) == 10
    _assert_same(kept, list(jdata.DataLoader(ds, batch_size=1)))


@pytest.mark.parametrize("mode", [
    dict(num_workers=0),
    dict(num_workers=2, thread_workers=False),
    dict(num_workers=2, thread_workers=True),
], ids=["inline", "processes", "threads"])
def test_dataloader_batches_kept_from_list_match(mode):
    """``list(loader)`` over six batches, read only once all are made,
    equals the JAX loader's: no batch is written again by a later one."""
    ds = _Decoded(11, 8)
    want = list(jdata.DataLoader(ds, batch_size=2, **mode))
    got = list(tdata.DataLoader(ds, batch_size=2, **mode))
    assert len(got) == len(want) == 6
    _assert_same(got, want)


def test_abandoned_thread_loader_stops_its_threads():
    import threading
    ds = tdata.SimpleDataset([np.full(3, i) for i in range(64)])
    before = threading.active_count()
    batches = iter(tdata.DataLoader(ds, batch_size=2, num_workers=4,
                                    thread_workers=True))
    next(batches)
    batches.close()
    assert threading.active_count() == before


def test_a_dead_worker_process_raises():
    class Dies(tdata.Dataset):
        def __len__(self):
            return 8

        def __getitem__(self, i):
            if i == 5:
                os._exit(3)
            return np.zeros(2)

    loader = tdata.DataLoader(Dies(), batch_size=2, num_workers=2,
                              thread_workers=False)
    with pytest.raises(RuntimeError, match="exited unexpectedly"):
        list(loader)


def test_forked_workers_reopen_records_under_a_held_lock(image_rec):
    """A worker forked while another thread holds the reader's lock (or
    mid-read on the shared file offset) reopens the file with a lock of
    its own (the JAX package's reader would deadlock or garble)."""
    ds = tdata.RecordFileDataset(image_rec + ".rec")
    want = [len(ds[i]) for i in range(len(ds))]
    lengths = ds.transform(lambda rec: len(rec))
    ds._record._read_lock.acquire()
    try:
        got = [b.asnumpy().tolist() for b in tdata.DataLoader(
            lengths, batch_size=3, num_workers=2, thread_workers=False)]
    finally:
        ds._record._read_lock.release()
    assert sum(got, []) == want
