"""Parity of the port's decode kernels' plain versions with the JAX
package: paged decode attention, int8/int4 weight quantization and the
quantized matmul (mxnet_tpu_torch/ops/kernels.py vs
mxnet_tpu/ops/pallas_kernels.py).

Inputs are made with numpy from a seed and handed to both packages.  The
JAX side runs its Pallas kernels in interpret mode (``use_pallas=True``
on the CPU) and its XLA formulations; the port runs on CPU tensors,
where its wrappers take the plain versions.  The CUDA kernels themselves
are held against the same plain versions on the card
(tests/test_torch_kernels_cuda.py, chip_smoke.py).
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from mxnet_tpu.ops import pallas_kernels as pk
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import build, kernels


def _attention_inputs(seed=0, S=5, H=4, D=8, page=4, max_pages=4, P=13):
    rs = np.random.RandomState(seed)
    q = rs.randn(S, H, D).astype(np.float32)
    kp = rs.randn(P, H, page, D).astype(np.float32)
    vp = rs.randn(P, H, page, D).astype(np.float32)
    pt = rs.randint(0, P, (S, max_pages)).astype(np.int32)
    # inactive, one token, a page boundary, mid-page, the whole table
    lens = np.array([0, 1, page, page + 2, page * max_pages], np.int32)[:S]
    return q, kp, vp, pt, lens


@pytest.mark.parametrize("use_pallas", [True, False],
                         ids=["pallas-interpret", "xla"])
def test_decode_attention_plain_matches_jax(use_pallas):
    q, kp, vp, pt, lens = _attention_inputs()
    ref = np.asarray(pk.decode_attention(q, kp, vp, pt, lens,
                                         use_pallas=use_pallas))
    out = kernels.decode_attention(*map(torch.from_numpy,
                                        (q, kp, vp, pt, lens))).numpy()
    active = lens > 0
    # same f32 math, different summation order: 1e-5 absolute
    assert np.abs(out[active] - ref[active]).max() < 1e-5
    assert np.isfinite(out).all()     # inactive slot: finite, not compared


def test_decode_attention_explicit_scale_matches_jax():
    q, kp, vp, pt, lens = _attention_inputs(seed=1, D=16)
    ref = np.asarray(pk.decode_attention(q, kp, vp, pt, lens, scale=0.3,
                                         use_pallas=False))
    out = kernels.decode_attention(*map(torch.from_numpy,
                                        (q, kp, vp, pt, lens)),
                                   scale=0.3).numpy()
    assert np.abs(out[lens > 0] - ref[lens > 0]).max() < 1e-5


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("shape", [(24, 32), (7, 33), (5, 1)],
                         ids=["even", "odd-k", "k1"])
def test_quantize_weight_bytes_identical(bits, shape):
    rs = np.random.RandomState(shape[1])
    w = rs.randn(*shape).astype(np.float32)
    w[0] = 0.0                         # an all-zero row takes scale 1.0
    qa, sa = kernels.quantize_weight(w, bits)
    qb, sb = pk.quantize_weight(w, bits)
    assert qa.dtype == qb.dtype and qa.shape == qb.shape
    assert qa.tobytes() == qb.tobytes()
    assert sa.tobytes() == sb.tobytes()


def test_quantize_weight_rejects_like_jax():
    with pytest.raises(ValueError):
        kernels.quantize_weight(np.zeros((2, 2), np.float32), 3)
    with pytest.raises(ValueError):
        kernels.quantize_weight(np.zeros(4, np.float32), 8)


def test_unpack_int4_matches_jax():
    packed = np.arange(256, dtype=np.uint8).reshape(8, 32)
    ref = np.asarray(pk._unpack_int4(packed))
    out = kernels.unpack_int4(torch.from_numpy(packed)).numpy()
    assert np.array_equal(out, ref)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("lead", [(5,), (2, 3)], ids=["2d", "3d"])
def test_quant_matmul_plain_matches_jax_pallas(bits, lead):
    rs = np.random.RandomState(bits)
    w = rs.randn(24, 32).astype(np.float32)
    x = rs.randn(*lead, 32).astype(np.float32)
    qw, sc = pk.quantize_weight(w, bits)
    ref = np.asarray(pk.quant_matmul(x, qw, sc, bits, use_pallas=True,
                                     block_n=8, block_k=16))
    out = kernels.quant_matmul(torch.from_numpy(x), torch.from_numpy(qw),
                               torch.from_numpy(sc), bits).numpy()
    assert out.shape == ref.shape == lead + (24,)
    # the Pallas kernel scales once at the end, the plain version scales
    # the weight first: 1e-5 relative to the result's scale covers it
    assert np.abs(out - ref).max() <= 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize("bits", [8, 4])
def test_quant_matmul_plain_matches_jax_xla(bits):
    rs = np.random.RandomState(10 + bits)
    w = rs.randn(40, 48).astype(np.float32)
    x = rs.randn(3, 48).astype(np.float32)
    qw, sc = pk.quantize_weight(w, bits)
    ref = np.asarray(pk.quant_matmul(x, qw, sc, bits, use_pallas=False))
    out = kernels.quant_matmul(torch.from_numpy(x), torch.from_numpy(qw),
                               torch.from_numpy(sc), bits).numpy()
    assert np.abs(out - ref).max() <= 1e-5 * np.abs(ref).max()


def test_cpu_tensors_take_the_plain_versions_and_launch_nothing():
    before = dict(kernels.LAUNCHES)
    q, kp, vp, pt, lens = map(torch.from_numpy, _attention_inputs())
    a = kernels.decode_attention(q, kp, vp, pt, lens)
    b = kernels.decode_attention_plain(q, kp, vp, pt, lens)
    assert torch.equal(a, b)
    x = torch.randn(3, 32, generator=torch.Generator().manual_seed(0))
    qw, sc = map(torch.from_numpy, kernels.quantize_weight(
        np.random.RandomState(0).randn(8, 32), 4))
    assert torch.equal(kernels.quant_matmul(x, qw, sc, 4),
                       kernels.quant_matmul_plain(x, qw, sc, 4))
    assert kernels.LAUNCHES == before


# (S, H, page, max_pages, chunk): the full-width decode step, one long
# slot of small pages, many slots and heads, a one-page table, a table
# of 1000 pages
CHUNKS = [(8, 12, 64, 16, 3), (1, 1, 4, 256, 32), (1, 12, 16, 64, 8),
          (64, 32, 16, 128, 128), (8, 12, 8, 1, 1), (3, 2, 4, 1000, 125)]


@pytest.mark.parametrize("S,H,page,max_pages,chunk", CHUNKS)
def test_decode_chunk_pages_come_from_the_shapes(S, H, page, max_pages,
                                                 chunk):
    """The split the wrapper hands the CUDA kernel, from the shapes and
    the SM count alone: whole pages, at most 8 chunks per (slot, head)
    (they merge in one portable cluster), at least 64 tokens a chunk
    where the table holds that many, and about four blocks per SM."""
    got = kernels.decode_chunk_pages(S, H, page, max_pages, 132)
    assert got == chunk
    n_split = -(-max_pages // got)
    assert 1 <= got <= max_pages and n_split <= 8
    assert got * page >= min(64, max_pages * page)


def test_wrappers_refuse_devices_without_a_kernel():
    meta = torch.device("meta")
    q = torch.empty(2, 2, 8, device=meta)
    pool = torch.empty(3, 2, 4, 8, device=meta)
    ints = torch.empty(2, 1, dtype=torch.int32, device=meta)
    with pytest.raises(MXNetError):
        kernels.decode_attention(q, pool, pool, ints, ints[:, 0])
    with pytest.raises(MXNetError):
        kernels.quant_matmul(torch.empty(2, 8, device=meta),
                             torch.empty(4, 8, dtype=torch.int8,
                                         device=meta),
                             torch.empty(4, device=meta), 8)
    with pytest.raises(MXNetError):
        kernels.quant_matmul(torch.zeros(2, 8), torch.zeros(4, 8), None, 3)


def test_build_runs_one_nvcc_per_source_together(tmp_path, monkeypatch):
    """The kernel build compiles every source for sm_90a with one nvcc
    each, all started before any is waited on, into build/kernels-style
    libraries named by content; a second build reuses them."""
    started, waited = [], []

    class FakeProc:
        returncode = 0

        def __init__(self, cmd, **_kw):
            self.cmd = cmd
            started.append(cmd)
            assert not waited, "an nvcc started after another was waited"

        def communicate(self):
            waited.append(self.cmd)
            out = self.cmd[self.cmd.index("-o") + 1]
            with open(out, "wb") as f:
                f.write(b"\x7fELF")
            return "ptxas info    : Used 40 registers", None

    monkeypatch.setattr(build, "build_dir", lambda: str(tmp_path))
    monkeypatch.setattr(build, "find_nvcc", lambda: "fake-nvcc")
    monkeypatch.setattr(build.subprocess, "Popen", FakeProc)
    paths = build.build_kernels()
    assert set(paths) == set(build.SOURCES)
    assert len(started) == len(build.SOURCES)
    for cmd in started:
        assert "arch=compute_90a,code=sm_90a" in cmd
        assert "-shared" in cmd and cmd[-1].endswith(".cu")
    for p in paths.values():
        assert os.path.exists(p) and p.startswith(str(tmp_path))
    assert "registers" in build.build_log("quant_matmul")
    build.build_kernels()
    assert len(started) == len(build.SOURCES)       # nothing rebuilt


def test_build_failure_is_a_typed_error(tmp_path, monkeypatch):
    class FailProc:
        returncode = 2

        def __init__(self, cmd, **_kw):
            pass

        def communicate(self):
            return "error: expected a ';'", None

    monkeypatch.setattr(build, "build_dir", lambda: str(tmp_path))
    monkeypatch.setattr(build, "find_nvcc", lambda: "fake-nvcc")
    monkeypatch.setattr(build.subprocess, "Popen", FailProc)
    with pytest.raises(MXNetError, match="expected a ';'"):
        build.build_kernels(["decode_attention"])


def test_kernel_sources_carry_their_header_note():
    csrc = os.path.join(os.path.dirname(build.__file__), "..", "csrc")
    # the file of the TPU kernels each source replaces
    replaced = {"embedding.cu": "mxnet_tpu/sparse/kernels.py",
                "nms.cu": "mxnet_tpu/ops/contrib.py"}
    for src in build.SOURCES.values():
        text = open(os.path.join(csrc, src)).read()
        head = text[:text.index("#include")]
        assert "Replaces: " + replaced.get(
            src, "mxnet_tpu/ops/pallas_kernels.py") in head
        assert "bounds it on the H100" in head
        assert "What the design does about it" in head
        assert 'extern "C" int mxt_' in text
        assert "return static_cast<int>(cudaGetLastError());" in text


def test_nvcc_is_not_run_at_import(tmp_path):
    code = ("import sys; sys.path.insert(0, %r); import subprocess\n"
            "subprocess.Popen = None\n"
            "import mxnet_tpu_torch.ops.kernels, "
            "mxnet_tpu_torch.serving.decode\nprint('ok')"
            % os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
