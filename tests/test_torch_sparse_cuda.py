"""Sparse storage on the card against the plain versions on the CPU: the
lazy SGD and Adam over a CUDA table (B5 reads, B6 writes, counted),
``row_sparse_pull`` from dense and row_sparse stores into row_sparse and
dense outs, and the dense form and ``retain`` of a row_sparse array.

Every test here is marked ``cuda`` and skips without a CUDA device.  The
file imports neither ``jax`` nor ``mxnet_tpu``, so it runs on the card's
host without the repository's conftest::

    python -m pytest tests/test_torch_sparse_cuda.py --noconftest -q

Tolerances: data movement (pulls, retain, densifying) bit for bit; the
lazy updates too (each row's arithmetic is the same elementwise chain on
both devices, no reduction order), and any other difference is a fault.
"""
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import mxnet_tpu_torch as mx  # noqa: E402
from mxnet_tpu_torch.ndarray import sparse as sp  # noqa: E402
from mxnet_tpu_torch.ops import kernels  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _rsp(data, idx, shape, device):
    return sp.RowSparseNDArray(torch.from_numpy(data).to(device),
                               torch.from_numpy(np.asarray(idx)).to(device),
                               shape)


def _launches():
    return (kernels.LAUNCHES["embedding_gather"],
            kernels.LAUNCHES["embedding_scatter"])


@pytest.mark.parametrize("weight", ["dense", "row_sparse"])
@pytest.mark.parametrize("opt", ["sgd", "sgd-momentum", "adam"])
def test_lazy_update_on_card_matches_cpu_and_runs_the_kernels(dev, opt,
                                                              weight):
    rs = np.random.RandomState(3)
    shape = (5000, 32)
    ids = np.sort(rs.choice(5000, 700, replace=False))
    g = rs.randn(700, 32).astype(np.float32)
    w0 = rs.randn(*shape).astype(np.float32)
    s0 = [np.abs(rs.randn(*shape)).astype(np.float32) for _ in range(2)]
    out = {}
    for d in (dev, torch.device("cpu")):
        ctx = mx.gpu(0) if d.type == "cuda" else mx.cpu()
        if weight == "dense":
            w = mx.nd.array(w0, ctx=ctx)
        else:
            w = _rsp(w0, np.arange(5000), shape, d)
        states = [mx.nd.array(s, ctx=ctx) for s in s0]
        grad = _rsp(g, ids, shape, d)
        before = _launches()
        for _ in range(2):
            if opt == "adam":
                sp.adam_row_sparse_update(w, grad, states[0], states[1],
                                          lr=0.01, wd=0.01,
                                          rescale_grad=0.5,
                                          clip_gradient=1.0)
            else:
                sp.sgd_row_sparse_update(
                    w, grad, states[0] if opt == "sgd-momentum" else None,
                    lr=0.1, momentum=0.9, wd=0.01, rescale_grad=0.5)
        n_g, n_s = (a - b for a, b in zip(_launches(), before))
        out[d.type] = ([w.asnumpy()] + [s.asnumpy() for s in states],
                       n_g, n_s)
    per = {"sgd": (1, 1), "sgd-momentum": (2, 2), "adam": (3, 3)}[opt]
    assert out["cuda"][1:] == (2 * per[0], 2 * per[1])
    assert out["cpu"][1:] == (0, 0)
    for a, b in zip(out["cuda"][0], out["cpu"][0]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("store", ["dense", "row_sparse"])
def test_row_sparse_pull_on_card_matches_cpu(dev, store):
    rs = np.random.RandomState(4)
    shape = (3000, 16)
    val = rs.randn(*shape).astype(np.float32)
    stored = np.sort(rs.choice(3000, 900, replace=False))
    req = rs.randint(0, 3000, 2000)
    got = {}
    for d, ctx in ((dev, mx.gpu(0)), (torch.device("cpu"), mx.cpu())):
        kv = mx.kv.create("device", device=d)
        kv.init("k", mx.nd.array(val, ctx=ctx) if store == "dense"
                else _rsp(val[stored], stored, shape, d))
        o_rsp = sp.zeros_sparse("row_sparse", shape, ctx=ctx)
        o_dense = mx.nd.ones(shape, ctx=ctx)
        before = _launches()
        kv.row_sparse_pull("k", out=[o_rsp, o_dense], row_ids=req)
        got[d.type] = (o_rsp.indices.asnumpy(), o_rsp.data.asnumpy(),
                       o_dense.asnumpy(),
                       tuple(a - b for a, b in zip(_launches(), before)))
    for a, b in zip(got["cuda"][:3], got["cpu"][:3]):
        np.testing.assert_array_equal(a, b)
    assert got["cuda"][3] == (2, 1) and got["cpu"][3] == (0, 0)


def test_dense_form_and_retain_on_card_match_cpu(dev):
    rs = np.random.RandomState(5)
    idx = np.array([9, 2, 2, 40, 7, 40, 40])
    data = rs.randn(7, 3, 4).astype(np.float32)
    res = {}
    for d in (dev, torch.device("cpu")):
        a = _rsp(data, idx, (50, 3, 4), d)
        r = a.retain(np.array([40, 2, 11]))
        res[d.type] = (a.asnumpy(), a.indices.asnumpy(), r.asnumpy(),
                       r.data.asnumpy())
    for x, y in zip(res["cuda"], res["cpu"]):
        np.testing.assert_array_equal(x, y)


def test_lazy_adam_root_is_correctly_rounded_on_card(dev):
    """The lazy Adam takes its square root in float64 and rounds once, so
    its roots are the correctly rounded float32 ones (as the JAX op's) on
    the card and on the CPU; prints how many of torch's own float32 roots
    differ from them on each device."""
    v = np.abs(np.random.RandomState(6).randn(22400)).astype(np.float32)
    want = np.sqrt(v.astype(np.float64)).astype(np.float32)
    for d in (dev, torch.device("cpu")):
        t = torch.from_numpy(v).to(d)
        ours = torch.sqrt(t.to(torch.float64)).to(torch.float32).cpu()
        np.testing.assert_array_equal(ours.numpy(), want)
        raw = torch.sqrt(t).cpu().numpy()
        print("torch's float32 sqrt on %s: %d of %d roots not correctly "
              "rounded" % (d.type, int((raw != want).sum()), v.size))
