"""The data feed on the card: pinned batches and copies that do not block.

* Pinned batches under delayed copies: a large matmul is queued before
  every copy, so that the copies run late while the producer makes the
  next batches and the consumer has dropped the host batch; over 200
  steps every batch on the card equals its host batch bit for bit (the
  caching host allocator hands a buffer out again only after the copies
  that read it have run).  The same through ``Module.update_metric``,
  whose label copy is queued after the step.
* ``cpu_pinned`` arrays and the iterators' batches are page-locked, and
  no path pins a batch that already is.
* A data worker process never initialises CUDA.
* The native IO plane and ``im2rec`` build on this host, or the test
  says why not (g++ or libjpeg's header missing).
* The decoder this host has, against the committed fixture's pixels
  (``tools/make_jpeg_fixture.py``): PIL's ``imdecode``, and the native
  backend through its iterator, each within 3 levels of 255.

Every test is marked ``cuda`` and skips without a CUDA device.  The file
imports neither ``jax`` nor ``mxnet_tpu``::

    python -m pytest tests/test_torch_data_cuda.py --noconftest -q -s
"""
import os
import queue
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import mxnet_tpu_torch as mx  # noqa: E402
from mxnet_tpu_torch.gluon import data as gdata  # noqa: E402
from mxnet_tpu_torch.io import native, pinned  # noqa: E402

pytestmark = pytest.mark.cuda

FIXTURE = os.path.join(ROOT, "tests", "fixtures", "jpeg_fixture.npz")
STEPS = 200


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (pinned memory and the card's "
                    "copies have no CPU mode)")
    return torch.device("cuda")


def _delay(dev):
    """A large matmul queued on the current stream (~2 ms in f32)."""
    a = torch.ones(4096, 4096, device=dev)
    return lambda: a @ a


class _Steps(gdata.Dataset):
    """Sample i is a (64, 1024) float32 block filled with i."""

    def __len__(self):
        return STEPS

    def __getitem__(self, i):
        return np.full((64, 1024), i, np.float32)


def test_loader_batches_survive_delayed_copies(dev):
    mm = _delay(dev)
    loader = gdata.DataLoader(_Steps(), batch_size=1)
    on_card = []
    for batch in loader:
        assert batch._handle.is_pinned()
        mm()
        on_card.append(batch.as_in_context(mx.gpu(0)))
    torch.cuda.synchronize()
    assert len(on_card) == STEPS
    for i, d in enumerate(on_card):
        assert torch.equal(d._handle, torch.full((1, 64, 1024), float(i),
                                                 device=dev)), i


def test_producer_thread_waits_for_late_copies(dev):
    """A producer thread fills fresh pinned buffers while the consumer's
    copies wait behind matmuls; the consumer copies as the Module's
    executor group does (``copy_(non_blocking=True)``) and drops each
    buffer at once, so a freed buffer is soon handed to the producer
    again: never before its copy has run."""
    mm = _delay(dev)
    assert pinned.pinning()
    q = queue.Queue(maxsize=2)

    def produce():
        for i in range(STEPS):
            buf = pinned.empty((256, 1024), torch.float32)
            buf.fill_(float(i) if buf.is_pinned() else -1.0)
            q.put(buf)
        q.put(None)

    t = threading.Thread(target=produce, daemon=True)
    t.start()
    outs = []
    while True:
        buf = q.get(timeout=60)
        if buf is None:
            break
        mm()
        out = torch.empty(256, 1024, device=dev)
        out.copy_(buf, non_blocking=True)
        del buf
        outs.append(out)
    t.join(timeout=60)
    assert not t.is_alive()
    torch.cuda.synchronize()
    assert len(outs) == STEPS
    for i, out in enumerate(outs):
        assert bool((out == float(i)).all()), i


def test_module_update_metric_under_delayed_copies(dev):
    """``Module.update_metric`` copies each pinned label to the card
    without blocking, behind a matmul queued after the step, while the
    next batches are made in fresh buffers: over 200 steps the metric
    equals the accuracy counted on the host."""
    mm = _delay(dev)
    net = mx.sym.SoftmaxOutput(mx.sym.FullyConnected(
        mx.sym.Variable("data"), num_hidden=10), name="softmax")
    mod = mx.mod.Module(net, context=mx.gpu(0))
    mod.bind(data_shapes=[("data", (64, 16))],
             label_shapes=[("softmax_label", (64,))], for_training=False)
    mod.init_params()
    metric = mx.metric.Accuracy()
    rs = np.random.RandomState(0)
    labels, decided = [], []
    for _ in range(STEPS):
        x = rs.randn(64, 16).astype(np.float32)
        y = rs.randint(0, 10, 64).astype(np.float32)
        d, lab = pinned.stage([x, y])
        assert lab.is_pinned()
        batch = mx.io.DataBatch([mx.nd.NDArray(d)], [mx.nd.NDArray(lab)])
        del d, lab
        mod.forward(batch, is_train=False)
        decided.append(mod.get_outputs()[0]._handle.argmax(1))
        mm()
        mod.update_metric(metric, batch.label)
        labels.append(y)
        del batch
    torch.cuda.synchronize()
    hits = sum(int((p.cpu().numpy() == y).sum())
               for p, y in zip(decided, labels))
    assert metric.num_inst == 64 * STEPS
    assert metric.sum_metric == hits


def test_cpu_pinned_arrays_are_pinned(dev):
    a = mx.nd.array(np.arange(6, dtype=np.float32), ctx=mx.cpu_pinned())
    z = mx.nd.zeros((3, 2), ctx=mx.cpu_pinned())
    for x in (a, z, a.copyto(mx.cpu_pinned())):
        assert x._handle.is_pinned()
        assert x.context == mx.cpu_pinned()
    assert mx.nd.array([1.0], ctx=mx.cpu()).context == mx.cpu()
    on_card = a.as_in_context(mx.gpu(0))
    np.testing.assert_array_equal(on_card.asnumpy(), np.arange(6))


def test_no_path_pins_a_pinned_batch_again(dev, monkeypatch, tmp_path):
    """The Module's copy of an ImageIter batch and Gluon's
    ``split_and_load`` of a loader batch call ``pin_memory`` on nothing."""
    from PIL import Image
    rs = np.random.RandomState(0)
    names = []
    for i in range(8):
        Image.fromarray(rs.randint(0, 256, (20, 20, 3)).astype(
            np.uint8)).save(str(tmp_path / ("%d.jpg" % i)))
        names.append([float(i % 2), "%d.jpg" % i])
    it = mx.image.ImageIter(batch_size=4, data_shape=(3, 16, 16),
                            imglist=names, path_root=str(tmp_path))
    data = mx.sym.Variable("data")
    net = mx.sym.FullyConnected(mx.sym.Flatten(data), num_hidden=2)
    net = mx.sym.SoftmaxOutput(net, name="softmax")
    mod = mx.mod.Module(net, context=mx.gpu(0))
    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    mod.init_params()
    calls = []
    orig = torch.Tensor.pin_memory

    def counting(self, *a, **k):
        calls.append(tuple(self.shape))
        return orig(self, *a, **k)

    monkeypatch.setattr(torch.Tensor, "pin_memory", counting)
    for batch in it:
        assert batch.data[0].context == mx.cpu_pinned()
        mod.forward(batch, is_train=False)
        host = batch.data[0].asnumpy()
        bound = mod._exec_group.execs[0].arg_dict["data"].asnumpy()
        np.testing.assert_array_equal(bound, host)
    loader = gdata.DataLoader(gdata.ArrayDataset(
        np.arange(12, dtype=np.float32).reshape(6, 2)), batch_size=3)
    for b in loader:
        (x,) = mx.gluon.utils.split_and_load(b, [mx.gpu(0)])
        np.testing.assert_array_equal(x.asnumpy(), b.asnumpy())
    assert calls == []


class _Probe(gdata.Dataset):
    def __len__(self):
        return 8

    def __getitem__(self, i):
        # an array made with the default context, and its context read,
        # in the worker: a host array, no CUDA call
        x = mx.nd.array(np.full(2, float(i)))
        assert x.context == mx.cpu() and x.as_in_context(mx.cpu()) is x
        return np.array([float(torch.cuda.is_initialized()),
                         float(os.getpid())])


def test_worker_processes_never_initialise_cuda(dev):
    torch.zeros(1, device=dev)                # CUDA is live in the parent
    assert torch.cuda.is_initialized()
    loader = gdata.DataLoader(_Probe(), batch_size=2, num_workers=2,
                              thread_workers=False)
    got = np.concatenate([b.asnumpy() for b in loader])
    assert (got[:, 0] == 0).all()
    pids = set(got[:, 1].astype(int))
    assert os.getpid() not in pids and len(pids) >= 1


def test_native_plane_builds_here_or_says_why(dev, tmp_path):
    why = native.why_not_native()
    if why is not None:
        assert native.load_native() is None
        pytest.skip("the native IO plane cannot be built on this host: "
                    + why)
    paths = native.build_native()
    r = subprocess.run([paths["test_native"]], capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0 and "native unit tests: OK" in r.stdout
    from PIL import Image
    (tmp_path / "imgs").mkdir()
    lines = []
    for i in range(4):
        Image.fromarray(np.full((24, 24, 3), 40 * i, np.uint8)).save(
            str(tmp_path / "imgs" / ("%d.jpg" % i)))
        lines.append("%d\t%d\t%d.jpg" % (i, i, i))
    (tmp_path / "a.lst").write_text("\n".join(lines) + "\n")
    subprocess.run([paths["im2rec"], str(tmp_path / "a.lst"),
                    str(tmp_path / "imgs") + "/", str(tmp_path / "a")],
                   check=True, capture_output=True, timeout=120)
    it = mx.io.ImageRecordIter(path_imgrec=str(tmp_path / "a.rec"),
                               data_shape=(3, 24, 24), batch_size=2)
    assert it._native is not None
    labels = np.concatenate([b.label[0].asnumpy() for b in it])
    assert sorted(labels.tolist()) == [0, 1, 2, 3]


def fixture_errors():
    """(PIL imdecode's largest difference from the fixture's pixels, the
    native backend's or None where it does not build here), in levels of
    255."""
    fx = np.load(FIXTURE)
    jpeg, off, pix = fx["jpeg"], fx["offsets"], fx["pixels"]
    streams = [jpeg[off[i]:off[i + 1]].tobytes() for i in range(len(pix))]
    pil = max(int(np.abs(mx.image.imdecode(s).asnumpy().astype(int)
                         - pix[i]).max()) for i, s in enumerate(streams))
    if native.why_not_native() is not None:
        return pil, None
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        prefix = os.path.join(d, "fx")
        w = mx.recordio.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec",
                                          "w")
        for i, s in enumerate(streams):
            w.write_idx(i, mx.recordio.pack(
                mx.recordio.IRHeader(0, float(i), i, 0), s))
        w.close()
        it = mx.io.ImageRecordIter(path_imgrec=prefix + ".rec",
                                   data_shape=(3,) + pix.shape[1:3],
                                   batch_size=len(pix))
        got = it.next().data[0].asnumpy()
    nat = float(np.abs(got - pix.transpose(0, 3, 1, 2)).max())
    return pil, nat


def test_decoders_against_the_fixture(dev):
    """Both decoders within 3 levels of 255 of the fixture's pixels:
    libjpeg-turbo on both sides decodes the same stream bit for bit
    (measured 0 with PIL 12.2.0 on the card's host), other IDCTs and
    chroma upsampling differ by a few levels."""
    pil, nat = fixture_errors()
    import PIL
    from PIL import features
    print("imdecode: PIL %s (libjpeg-turbo %s): max |diff| %d levels; "
          "native: %s" % (PIL.__version__,
                          features.version("libjpeg_turbo"), pil,
                          "not built here (%s)" % native.why_not_native()
                          if nat is None else "%g levels" % nat))
    assert pil <= 3
    assert nat is None or nat <= 3
