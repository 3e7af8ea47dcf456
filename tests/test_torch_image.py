"""``mx.image`` of the port against the JAX package's, on the CPU.

Inputs are JPEGs and RecordIO files written from a seed.  Everything that
runs the same numpy and PIL code in both packages is held bit for bit:
``imdecode`` and the image functions, every augmenter and
``CreateAugmenter`` chain after the same ``mx.random.seed`` and
``random.seed``, and ``ImageIter``, ``ImageRecordIter`` (the Python
path: 1 and 4 threads, shuffle, partitions, pad, ``state_dict`` resume)
and ``ImageDetIter`` batches over two epochs.  The port's native backend
(libjpeg, built with g++ into ``build/native/``) is held to the JAX
package's Python path within ``tests/test_record_iter.py``'s bound
(2/255 scaled by the std); it is skipped, with the reason, only where g++
or libjpeg's header is missing.
"""
import io as pyio
import os
import random
import subprocess

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu import image as jimg
from mxnet_tpu import recordio as jrec
from mxnet_tpu_torch import image as timg
from mxnet_tpu_torch import recordio as trec
from mxnet_tpu_torch.io import native as tnative

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(HERE, "fixtures", "jpeg_fixture.npz")
N_IMG = 10
SHAPE = (3, 32, 32)
BS = 4
# tests/test_record_iter.py's bound between the backends: 2/255 of the
# pixel range, scaled by the std
NATIVE_BOUND = 2.0 / 57.0 + 1e-5


def _jpeg_bytes(rs, h, w, fmt="JPEG"):
    from PIL import Image
    arr = rs.randint(0, 256, (h, w, 3), dtype=np.uint8)
    buf = pyio.BytesIO()
    Image.fromarray(arr).save(buf, format=fmt, quality=95)
    return buf.getvalue()


@pytest.fixture(scope="module")
def rec_file(tmp_path_factory):
    """Indexed RecordIO file of N_IMG seeded JPEGs (36x40), label = index."""
    d = tmp_path_factory.mktemp("trecio")
    prefix = str(d / "synth")
    rs = np.random.RandomState(0)
    w = trec.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec", "w")
    for i in range(N_IMG):
        hdr = trec.IRHeader(0, float(i), i, 0)
        w.write_idx(i, trec.pack(hdr, _jpeg_bytes(rs, 36, 40)))
    w.close()
    return prefix


@pytest.fixture(scope="module")
def jpeg_dir(tmp_path_factory):
    from PIL import Image
    d = tmp_path_factory.mktemp("timgs")
    rs = np.random.RandomState(0)
    entries = []
    for i in range(N_IMG):
        arr = rs.randint(0, 255, (32 + i, 40, 3), np.uint8)
        fname = "img%d.jpg" % i
        Image.fromarray(arr).save(str(d / fname), quality=95)
        entries.append((i % 3, fname))
    return str(d), entries


def _seed(n):
    random.seed(n)
    jmx.random.seed(n)
    tmx.random.seed(n)


def _epoch(it):
    """Copies of one epoch's batches: [(data, label, pad)]."""
    it.reset()
    out = []
    while True:
        try:
            b = it.next()
        except StopIteration:
            return out
        out.append((b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad))


def _assert_epochs_equal(got, want):
    assert len(got) == len(want)
    for (gd, gl, gp), (wd, wl, wp) in zip(got, want):
        assert gp == wp
        assert gd.dtype == wd.dtype and gl.dtype == wl.dtype
        np.testing.assert_array_equal(gd, wd)
        np.testing.assert_array_equal(gl, wl)


# -- namespaces -------------------------------------------------------------

@pytest.mark.parametrize("path", ["image", "image.detection", "recordio",
                                  "io"])
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


# -- decode and the image functions -----------------------------------------

@pytest.mark.parametrize("fmt", ["JPEG", "PNG"])
@pytest.mark.parametrize("flag,to_rgb", [(1, 1), (1, 0), (0, 1)])
def test_imdecode_matches(fmt, flag, to_rgb):
    buf = _jpeg_bytes(np.random.RandomState(1), 23, 31, fmt)
    j = jimg.imdecode(buf, to_rgb=to_rgb, flag=flag).asnumpy()
    t = timg.imdecode(buf, to_rgb=to_rgb, flag=flag)
    assert t.context == tmx.cpu()
    np.testing.assert_array_equal(t.asnumpy(), j)


def test_imdecode_matches_the_fixture_pixels():
    """The committed fixture (tools/make_jpeg_fixture.py): 16 JPEGs at
    256x341, quality 95, and the JAX package's decoded pixels.  Here both
    decode with the same PIL, so bit-equal."""
    fx = np.load(FIXTURE)
    jpeg, off, pix = fx["jpeg"], fx["offsets"], fx["pixels"]
    assert pix.shape == (16, 256, 341, 3) and off.shape == (17,)
    for i in range(16):
        got = timg.imdecode(jpeg[off[i]:off[i + 1]].tobytes()).asnumpy()
        np.testing.assert_array_equal(got, pix[i])


def test_image_functions_match():
    rs = np.random.RandomState(2)
    img = rs.randint(0, 256, (30, 44, 3)).astype(np.uint8)
    jsrc, tsrc = jmx.nd.array(img, dtype=np.uint8), \
        tmx.nd.array(img, ctx=tmx.cpu(), dtype=np.uint8)
    cases = [
        ("imresize", lambda m, s: m.imresize(s, 17, 13, 1)),
        ("imresize0", lambda m, s: m.imresize(s, 50, 21, 0)),
        ("imresize2", lambda m, s: m.imresize(s, 19, 40, 2)),
        ("imresize4", lambda m, s: m.imresize(s, 9, 11, 4)),
        ("resize_short", lambda m, s: m.resize_short(s, 20)),
        ("fixed_crop", lambda m, s: m.fixed_crop(s, 3, 4, 20, 11)),
        ("fixed_crop_size", lambda m, s: m.fixed_crop(s, 3, 4, 20, 11,
                                                     (8, 8))),
        ("random_crop", lambda m, s: m.random_crop(s, (20, 12))[0]),
        ("center_crop", lambda m, s: m.center_crop(s, (50, 12))[0]),
        ("color_normalize", lambda m, s: m.color_normalize(
            s, np.array([100., 110., 120.]), np.array([50., 60., 70.]))),
        ("random_size_crop", lambda m, s: m.random_size_crop(
            s, (16, 16), 0.2, (0.75, 1.33))[0]),
    ]
    for name, fn in cases:
        _seed(7)
        j = fn(jimg, jsrc).asnumpy()
        _seed(7)
        t = fn(timg, tsrc)
        assert t.context == tmx.cpu(), name
        np.testing.assert_array_equal(t.asnumpy(), j, err_msg=name)
    for sw, sh, w, h in ((10, 20, 40, 5), (33, 9, 12, 60), (4, 4, 1, 2)):
        assert timg.scale_down((sw, sh), (w, h)) == \
            jimg.scale_down((sw, sh), (w, h))


def _augmenters(m):
    eigval = np.array([55.46, 4.794, 1.148])
    eigvec = np.array([[-0.5675, 0.7192, 0.4009],
                       [-0.5808, -0.0045, -0.8140],
                       [-0.5836, -0.6948, 0.4203]])
    return {
        "resize": m.ResizeAug(20),
        "force_resize": m.ForceResizeAug((18, 22)),
        "random_crop": m.RandomCropAug((16, 16)),
        "random_sized_crop": m.RandomSizedCropAug((16, 16), 0.3,
                                                  (0.75, 1.33)),
        "center_crop": m.CenterCropAug((16, 16)),
        "brightness": m.BrightnessJitterAug(0.3),
        "contrast": m.ContrastJitterAug(0.3),
        "saturation": m.SaturationJitterAug(0.3),
        "hue": m.HueJitterAug(0.2),
        "color_jitter": m.ColorJitterAug(0.2, 0.3, 0.4),
        "lighting": m.LightingAug(0.1, eigval, eigvec),
        "normalize": m.ColorNormalizeAug(np.array([100., 110., 120.]),
                                         np.array([50., 60., 70.])),
        "gray": m.RandomGrayAug(0.6),
        "flip": m.HorizontalFlipAug(0.6),
        "cast": m.CastAug(),
        "sequential": m.SequentialAug([m.BrightnessJitterAug(0.2),
                                       m.ContrastJitterAug(0.2)]),
        "random_order": m.RandomOrderAug([m.BrightnessJitterAug(0.2),
                                          m.SaturationJitterAug(0.2),
                                          m.HueJitterAug(0.1)]),
    }


def _same_dumps(ja, ta):
    """``dumps()`` agrees where the JAX package's serialises; where its
    numpy parameters make it raise (a fault of the JAX package), the
    port's gives them as lists, as the reference does."""
    import json
    try:
        want = ja.dumps()
    except TypeError:
        name, kw = json.loads(ta.dumps())
        assert name == type(ta).__name__.lower()
        assert kw.keys() == ja._kwargs.keys()
        return
    assert ta.dumps() == want


@pytest.mark.parametrize("name", sorted(_augmenters(jimg)))
def test_augmenter_matches(name):
    """One image through each augmenter, five times in a row after the
    same seeds, and a batch through its batched form with the module
    generator: bit-equal, host arrays."""
    ja, ta = _augmenters(jimg)[name], _augmenters(timg)[name]
    _same_dumps(ja, ta)
    rs = np.random.RandomState(3)
    img = rs.randint(0, 256, (24, 28, 3)).astype(np.uint8)
    if ja.batchable:
        img = img.astype(np.float32)
    jsrc = jmx.nd.array(img, dtype=img.dtype)
    tsrc = tmx.nd.array(img, ctx=tmx.cpu(), dtype=img.dtype)
    _seed(11)
    jout = [ja(jsrc).asnumpy() for _ in range(5)]
    _seed(11)
    tout = [ta(tsrc) for _ in range(5)]
    for j, t in zip(jout, tout):
        assert t.context == tmx.cpu()
        assert t.dtype == j.dtype
        np.testing.assert_array_equal(t.asnumpy(), j)
    if ja.batchable:
        block = rs.rand(6, 12, 10, 3).astype(np.float32) * 255
        _seed(12)
        j = ja.batch_call(block, jimg.image._rng)
        _seed(12)
        t = ta.batch_call(block, timg.image._rng)
        np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("kw", [
    dict(),
    dict(resize=20, rand_crop=True, rand_mirror=True),
    dict(rand_crop=True, rand_resize=True, mean=True, std=True),
    dict(brightness=0.2, contrast=0.2, saturation=0.2, hue=0.1,
         pca_noise=0.05, rand_gray=0.2, mean=True, std=True),
    dict(rand_mirror=True, mean=np.array([1., 2., 3.])),
], ids=["plain", "resize_crop_mirror", "sized_crop_norm", "colour",
        "mean_only"])
def test_create_augmenter_chain_matches(kw):
    jchain = jimg.CreateAugmenter((3, 16, 16), **kw)
    tchain = timg.CreateAugmenter((3, 16, 16), **kw)
    for ja, ta in zip(jchain, tchain):
        _same_dumps(ja, ta)
    rs = np.random.RandomState(4)
    img = rs.randint(0, 256, (26, 30, 3)).astype(np.uint8)
    _seed(13)
    j = jmx.nd.array(img, dtype=np.uint8)
    for a in jchain:
        j = a(j)
    _seed(13)
    t = tmx.nd.array(img, ctx=tmx.cpu(), dtype=np.uint8)
    for a in tchain:
        t = a(t)
    np.testing.assert_array_equal(t.asnumpy(), j.asnumpy())


def test_random_seed_reseeds_the_batched_generator():
    tmx.random.seed(5)
    a = timg.image._rng.random(3)
    tmx.random.seed(5)
    np.testing.assert_array_equal(timg.image._rng.random(3), a)
    jmx.random.seed(5)
    np.testing.assert_array_equal(jimg.image._rng.random(3), a)


# -- the iterators ----------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(),
    dict(shuffle=True, rand_crop=True, rand_mirror=True, brightness=0.2,
         contrast=0.2, saturation=0.2, hue=0.1, pca_noise=0.05,
         rand_gray=0.2, mean=True, std=True),
    dict(part_index=1, num_parts=2, rand_crop=True, rand_resize=True),
], ids=["plain", "shuffled_colour", "partition_sized_crop"])
def test_image_iter_matches_over_two_epochs(jpeg_dir, kw):
    root, entries = jpeg_dir
    imglist = [[lab, fn] for lab, fn in entries]
    its = []
    for m in (jimg, timg):
        _seed(21)
        its.append(m.ImageIter(batch_size=BS, data_shape=(3, 16, 16),
                               imglist=[list(x) for x in imglist],
                               path_root=root, **kw))
    for epoch in range(2):
        _seed(30 + epoch)
        want = _epoch(its[0])
        _seed(30 + epoch)
        got = _epoch(its[1])
        _assert_epochs_equal(got, want)
    its[1].reset()
    b = its[1].next()
    assert b.data[0].context == tmx.cpu()   # pinned only with a card


def test_image_iter_reads_records(rec_file):
    its = [m.ImageIter(batch_size=3, data_shape=SHAPE,
                       path_imgrec=rec_file + ".rec",
                       path_imgidx=rec_file + ".idx", rand_mirror=True)
           for m in (jimg, timg)]
    _seed(3)
    want = _epoch(its[0])
    _seed(3)
    got = _epoch(its[1])
    _assert_epochs_equal(got, want)
    assert [p for _, _, p in got] == [0, 0, 0, 2]


def _record_iters(rec_file, monkeypatch, native, **kw):
    """(the JAX package's Python-path ImageRecordIter, the port's with
    the backend asked for)."""
    kw.setdefault("batch_size", BS)
    args = dict(path_imgrec=rec_file + ".rec", path_imgidx=rec_file + ".idx",
                data_shape=SHAPE, **kw)
    monkeypatch.setenv("MXNET_TPU_NATIVE_IO", "0")
    j = jmx.io.ImageRecordIter(**args)
    monkeypatch.setenv("MXNET_TPU_NATIVE_IO", "1" if native else "0")
    t = tmx.io.ImageRecordIter(**args)
    monkeypatch.delenv("MXNET_TPU_NATIVE_IO")
    assert j._native is None
    assert (t._native is not None) == native
    return j, t


@pytest.mark.parametrize("kw", [
    dict(preprocess_threads=1, shuffle=True, seed=3, rand_crop=True,
         rand_mirror=True, resize=40),
    dict(preprocess_threads=4, shuffle=True, seed=4, mean_r=123.0,
         mean_g=117.0, mean_b=104.0, std_r=58.0, std_g=57.0, std_b=57.0),
    dict(preprocess_threads=4, num_parts=2, part_index=1, batch_size=3),
    dict(preprocess_threads=1, label_width=1, batch_size=3,
         rand_mirror=True),
], ids=["1thread_rand", "4threads_norm", "partition", "pad"])
def test_record_iter_python_path_matches_over_two_epochs(rec_file,
                                                         monkeypatch, kw):
    j, t = _record_iters(rec_file, monkeypatch, native=False, **kw)
    for epoch in range(2):
        _seed(40 + epoch)
        want = _epoch(j)
        _seed(40 + epoch)
        got = _epoch(t)
        _assert_epochs_equal(got, want)
    t.reset()
    assert t.next().label[0].shape == (kw.get("batch_size", BS),)


def test_record_iter_state_dict_resumes_exactly(rec_file, monkeypatch):
    j, t = _record_iters(rec_file, monkeypatch, native=False, shuffle=True,
                         seed=9, preprocess_threads=2)
    t.reset()
    t.next()
    state = t.state_dict()
    rest = [(b.data[0].asnumpy(), b.label[0].asnumpy()) for b in
            [t.next(), t.next()]]
    t.reset()
    nxt = t.state_dict()["order"]
    _, t2 = _record_iters(rec_file, monkeypatch, native=False,
                          shuffle=True, seed=1, preprocess_threads=2)
    t2.load_state_dict(state)
    again = [(b.data[0].asnumpy(), b.label[0].asnumpy()) for b in
             [t2.next(), t2.next()]]
    for (a, la), (b, lb) in zip(rest, again):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(la, lb)
    t2.reset()
    np.testing.assert_array_equal(t2.state_dict()["order"], nxt)
    # the JAX package's state loads into the port's iterator
    j.reset()
    j.next()
    t2.load_state_dict(j.state_dict())
    np.testing.assert_array_equal(t2.state_dict()["order"],
                                  j.state_dict()["order"])


def test_record_iter_retries_injected_io_errors(rec_file, monkeypatch):
    from mxnet_tpu_torch.resilience import chaos
    monkeypatch.setenv("MXNET_TPU_RETRY_BACKOFF", "0")
    _, t = _record_iters(rec_file, monkeypatch, native=False)
    want = _epoch(t)
    chaos.reset()
    with chaos.inject("io_error", count=2):
        got = _epoch(t)
    chaos.reset()
    _assert_epochs_equal(got, want)


def _kept(it):
    """One epoch kept as the iterator gave it (``list(it)``), read only
    once every batch is made: [(data, label, pad)]."""
    it.reset()
    batches = list(it)
    return [(b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad)
            for b in batches]


def test_ring_reuses_its_slots(rec_file, monkeypatch):
    """No buffer is reused while its batch is held, even with
    ``prefetch_buffer=1``: ten batches kept from one epoch have buffers
    of their own and equal the JAX package's."""
    j, t = _record_iters(rec_file, monkeypatch, native=False,
                         prefetch_buffer=1, batch_size=1)
    t.reset()
    held = [t.next() for _ in range(6)]
    assert len({b.data[0]._handle.data_ptr() for b in held}) == 6
    _assert_epochs_equal(_kept(t), _kept(j))


@pytest.mark.parametrize("which", ["image_iter", "record_iter", "det_iter"])
def test_batches_kept_from_list_equal_the_jax_package(rec_file, jpeg_dir,
                                                      monkeypatch, which):
    """``list(it)`` over more than four batches, read at the end, equals
    the JAX package's batch for batch."""
    root, entries = jpeg_dir
    if which == "record_iter":
        its = _record_iters(rec_file, monkeypatch, native=False,
                            batch_size=2, shuffle=True, rand_mirror=True,
                            preprocess_threads=1)   # draws in record order
    elif which == "image_iter":
        its = [m.ImageIter(batch_size=2, data_shape=(3, 16, 16),
                           imglist=[[lab, fn] for lab, fn in entries],
                           path_root=root, rand_crop=True, rand_mirror=True)
               for m in (jimg, timg)]
    else:
        imglist = _det_imglist(entries)
        its = [m.ImageDetIter(batch_size=2, data_shape=(3, 24, 24),
                              imglist=[[list(a), b] for a, b in imglist],
                              path_root=root, rand_mirror=True)
               for m in (jimg, timg)]
    _seed(70)
    want = _kept(its[0])
    _seed(70)
    got = _kept(its[1])
    assert len(got) == 5
    _assert_epochs_equal(got, want)


# -- detection --------------------------------------------------------------

def _det_imglist(entries, seed=1):
    rs = np.random.RandomState(seed)
    imglist = []
    for k, (lab, fn) in enumerate(entries):
        objs = []
        for _ in range(1 + k % 3):
            x1, y1 = rs.uniform(0, 0.5, 2)
            x2, y2 = x1 + rs.uniform(0.2, 0.5), y1 + rs.uniform(0.2, 0.5)
            objs += [float(lab), x1, y1, min(x2, 1.), min(y2, 1.)]
        imglist.append([[2, 5] + objs, fn])
    return imglist


@pytest.mark.parametrize("kw", [
    dict(),
    dict(rand_crop=0.5, rand_pad=0.5, rand_mirror=True),
    dict(rand_crop=1, rand_gray=0.3, brightness=0.2, contrast=0.2,
         saturation=0.2, hue=0.1, resize=40, shuffle=True),
], ids=["plain", "ssd_recipe", "colour"])
def test_image_det_iter_matches_over_two_epochs(jpeg_dir, kw):
    root, entries = jpeg_dir
    imglist = _det_imglist(entries)
    its = []
    for m in (jimg, timg):
        _seed(51)
        its.append(m.ImageDetIter(batch_size=BS, data_shape=(3, 24, 24),
                                  imglist=[[list(a), b] for a, b in imglist],
                                  path_root=root, **kw))
    assert its[0].provide_label[0].shape == its[1].provide_label[0].shape \
        == (BS, 3, 5)
    for epoch in range(2):
        _seed(60 + epoch)
        want = _epoch(its[0])
        _seed(60 + epoch)
        got = _epoch(its[1])
        _assert_epochs_equal(got, want)
    lab = got[0][1]
    assert lab.shape == (BS, 3, 5) and (lab[0, 1:] == -1).all()


def test_image_det_iter_normalizes(jpeg_dir):
    """``CreateDetAugmenter(mean=True, std=True)`` (SSD's recipe), which
    the JAX package cannot build (its ``dumps`` of a numpy mean raises):
    the batches are the un-normalised ones, normalised per channel."""
    root, entries = jpeg_dir
    imglist = _det_imglist(entries)
    with pytest.raises(TypeError):
        jimg.CreateDetAugmenter((3, 24, 24), mean=True, std=True)
    got = []
    for kw in (dict(), dict(mean=True, std=True)):
        _seed(81)
        it = timg.ImageDetIter(batch_size=BS, data_shape=(3, 24, 24),
                               imglist=[[list(a), b] for a, b in imglist],
                               path_root=root, rand_crop=0.5, rand_pad=0.5,
                               rand_mirror=True, **kw)
        _seed(82)
        got.append(_epoch(it))
    # ColorNormalizeAug keeps its mean and std in float32
    mean = np.float32([123.68, 116.28, 103.53]).reshape(1, 3, 1, 1)
    std = np.float32([58.395, 57.12, 57.375]).reshape(1, 3, 1, 1)
    for (d0, l0, pad), (d1, l1, _) in zip(*got):
        n = BS - pad                     # pad rows stay zero in both
        np.testing.assert_array_equal(l0, l1)
        np.testing.assert_array_equal(d1[:n], (d0[:n] - mean) / std)


def test_det_augmenters_match():
    rs = np.random.RandomState(6)
    img = rs.randint(0, 256, (30, 40, 3)).astype(np.uint8)
    label = np.array([[1, .1, .2, .5, .6], [0, .4, .3, .9, .8],
                      [-1, -1, -1, -1, -1]], np.float32)
    for name, make in (
            ("flip", lambda m: m.DetHorizontalFlipAug(0.7)),
            ("crop", lambda m: m.DetRandomCropAug(0.3, max_attempts=20)),
            ("pad", lambda m: m.DetRandomPadAug(area_range=(1.0, 2.5))),
            ("select", lambda m: m.DetRandomSelectAug(
                [m.DetRandomCropAug(), m.DetRandomPadAug()], 0.3)),
            ("borrow", lambda m: m.DetBorrowAug(
                m.ForceResizeAug((20, 20))))):
        ja = make(_Both(jimg))
        ta = make(_Both(timg))
        _same_dumps(ja, ta)
        for k in range(4):
            _seed(70 + k)
            ji, jl = ja(jmx.nd.array(img, dtype=np.uint8), label)
            _seed(70 + k)
            ti, tl = ta(tmx.nd.array(img, ctx=tmx.cpu(), dtype=np.uint8),
                        label)
            np.testing.assert_array_equal(ti.asnumpy(), ji.asnumpy(),
                                          err_msg=name)
            np.testing.assert_array_equal(tl, jl, err_msg=name)


class _Both:
    """The names of ``image`` and ``image.detection`` of one package."""

    def __init__(self, m):
        self._m = m

    def __getattr__(self, name):
        return getattr(self._m.detection, name, None) or \
            getattr(self._m, name)


# -- the native backend -----------------------------------------------------

@pytest.fixture()
def native():
    why = tnative.why_not_native()
    if why is not None:
        pytest.skip("the native IO plane cannot be built here: " + why)
    assert tnative.load_native() is not None
    return tnative


def test_native_builds_into_build_native(native):
    paths = native.build_native()
    root = os.path.dirname(HERE)
    for p in paths.values():
        assert os.path.isfile(p)
        assert p.startswith(os.path.join(root, "build", "native") + os.sep)
    assert not os.path.exists(os.path.join(root, "native", "build",
                                           "libmxnet_tpu_io.so"))


def test_native_cpp_unit_tests(native):
    exe = native.build_native()["test_native"]
    r = subprocess.run([exe], capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "native unit tests: OK" in r.stdout


def test_native_matches_the_python_path(rec_file, monkeypatch, native):
    kw = dict(mean_r=123.0, mean_g=117.0, mean_b=104.0,
              std_r=58.0, std_g=57.0, std_b=57.0)
    j, t = _record_iters(rec_file, monkeypatch, native=True, **kw)
    want, got = _epoch(j), _epoch(t)
    assert [p for _, _, p in got] == [p for _, _, p in want] == [0, 0, 2]
    for (gd, gl, _), (wd, wl, _) in zip(got, want):
        assert gd.shape == wd.shape == (BS,) + SHAPE
        np.testing.assert_array_equal(gl, wl)
        assert np.max(np.abs(gd - wd)) < NATIVE_BOUND
    _assert_epochs_equal(_epoch(t), got)          # the next epoch too


def test_native_batches_kept_from_list(rec_file, monkeypatch, native):
    """The native backend writes each batch into buffers of its own: ten
    batches kept from ``list(it)`` equal the ones copied as they came,
    and the JAX package's within the bound."""
    j, t = _record_iters(rec_file, monkeypatch, native=True, batch_size=1,
                         prefetch_buffer=1)
    kept, want = _kept(t), _epoch(j)
    assert len(kept) == N_IMG
    _assert_epochs_equal(kept, _epoch(t))
    for (gd, gl, _), (wd, wl, _) in zip(kept, want):
        np.testing.assert_array_equal(gl, wl)
        assert np.max(np.abs(gd - wd)) < NATIVE_BOUND


def test_native_shuffle_partition_and_augment(rec_file, monkeypatch,
                                              native):
    _, t = _record_iters(rec_file, monkeypatch, native=True, shuffle=True,
                         seed=5)
    l1 = np.concatenate([l for _, l, _ in _epoch(t)])
    l2 = np.concatenate([l for _, l, _ in _epoch(t)])
    assert set(range(N_IMG)) <= set(l1.astype(int))
    assert not np.array_equal(l1, l2)
    halves = []
    for part in range(2):
        _, t = _record_iters(rec_file, monkeypatch, native=True,
                             num_parts=2, part_index=part, batch_size=5)
        halves.append(set(np.concatenate(
            [l for _, l, _ in _epoch(t)]).astype(int)))
    assert halves[0].isdisjoint(halves[1])
    assert halves[0] | halves[1] == set(range(N_IMG))
    _, t = _record_iters(rec_file, monkeypatch, native=True, resize=40,
                         rand_crop=True, rand_mirror=True)
    data = np.stack([d for d, _, _ in _epoch(t)])
    assert data.shape == (3, BS) + SHAPE and np.isfinite(data).all()


def test_native_decodes_the_fixture_exactly(tmp_path, monkeypatch, native):
    """The native backend at the fixture's own size, with no resize, crop,
    mirror or normalisation, against the fixture's pixels: libjpeg here
    and PIL's libjpeg-turbo decode the same stream; the bound is one
    level, for IDCT and upsampling variants (measured: 0 here)."""
    fx = np.load(FIXTURE)
    jpeg, off, pix = fx["jpeg"], fx["offsets"], fx["pixels"]
    prefix = str(tmp_path / "fx")
    w = trec.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec", "w")
    for i in range(16):
        w.write_idx(i, trec.pack(trec.IRHeader(0, float(i), i, 0),
                                 jpeg[off[i]:off[i + 1]].tobytes()))
    w.close()
    monkeypatch.setenv("MXNET_TPU_NATIVE_IO", "1")
    it = tmx.io.ImageRecordIter(path_imgrec=prefix + ".rec",
                                data_shape=(3, 256, 341), batch_size=8)
    assert it._native is not None
    got = np.concatenate([d for d, _, _ in _epoch(it)])
    want = pix.transpose(0, 3, 1, 2).astype(np.float32)
    assert np.max(np.abs(got - want)) <= 1.0


def test_im2rec_packs_what_both_packages_read(tmp_path, monkeypatch,
                                             native):
    from PIL import Image
    rs = np.random.RandomState(1)
    img_dir = tmp_path / "imgs"
    img_dir.mkdir()
    lines = []
    for i in range(6):
        arr = rs.randint(0, 256, (32, 32, 3), dtype=np.uint8)
        name = "img%d.jpg" % i
        Image.fromarray(arr).save(str(img_dir / name), quality=95)
        lines.append("%d\t%d\t%s" % (i, i * 10, name))
    lst = tmp_path / "set.lst"
    lst.write_text("\n".join(lines) + "\n")
    prefix = str(tmp_path / "packed")
    subprocess.run([native.build_native()["im2rec"], str(lst),
                    str(img_dir) + "/", prefix], check=True,
                   capture_output=True, timeout=120)
    for use_native in (True, False):
        j, t = _record_iters(prefix, monkeypatch, native=use_native,
                             batch_size=3)
        for it in (j, t):
            labels = np.concatenate([l for _, l, _ in _epoch(it)])
            assert sorted(labels.astype(int)) == [0, 10, 20, 30, 40, 50]
    r = jrec.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec", "r")
    assert sorted(r.keys) == list(range(6))
    r.close()


def test_module_fit_on_the_native_record_iter(rec_file, monkeypatch,
                                              native):
    _, it = _record_iters(rec_file, monkeypatch, native=True, shuffle=True)
    data = tmx.sym.Variable("data")
    net = tmx.sym.Flatten(data)
    net = tmx.sym.FullyConnected(net, name="fc", num_hidden=N_IMG)
    net = tmx.sym.SoftmaxOutput(net, name="softmax")
    mod = tmx.mod.Module(net, context=tmx.cpu(0))
    mod.fit(it, num_epoch=2, optimizer_params={"learning_rate": 0.01},
            initializer=tmx.init.Uniform(0.05))
    params, _ = mod.get_params()
    assert all(np.isfinite(v.asnumpy()).all() for v in params.values())
