"""The port's CUDA kernels against their plain PyTorch versions, on the
card: decode attention (split over the sequence: lengths around its page
and chunk boundaries, page ids out of the pool, bit-equal reruns, no host
sync), the int8/int4 quantized matmul (at the decode step's shapes too),
the three flash-attention kernels (forward, dQ, dK/dV; bit-equal reruns,
and inputs on which 1xTF32 exceeds the tolerance that their 3xTF32
meets) and their bf16 entry points (B9, against the plain versions within
one bf16 step, at logits of +-20 and ragged non-causal tiles too; the f32
kernels and the bf16 forward and dK/dV give the bits they gave before the
bf16 dQ was rewritten) and f16 ones (B9 f16, within one f16 step, at dO
of a loss scale's size and where ds passes f16's range; f16 HMMA alone
in their SASS), the embedding gather and scatter (runs of 1 to
1000 equal ids with inexact payloads, bit-equal to an in-order float32 fold) and the
two-bit gradient compression at ragged and odd shapes that the
full-width smoke run does not reach, in f16, bf16 and f64 too (B10,
exactly; strided gradients; a push of mixed dtypes, one launch each),
both grouped kernels (the two-bit
compression over the LM's 198 keys, the gather over the recommender's
tables; misaligned views, empty segments, more segments than one launch
takes, no host sync), a small decode step and a small
recommender step on the card against the same steps on the CPU, a
compressing KVStore push on the card, a Module that lands on the card
when given no context, remat's gradients on the flash path equal to
'none''s, ``nd.contrib.fused_attention`` under ``autograd.record``
through the flash kernels and a hybridized Gluon block's gradients card
vs CPU, and the imperative slice: the user kernels of
``rtc.CudaModule`` against their plain versions (exactly), its errors,
exports and large shared memory, every ``mx.nd`` op case on the card
against the CPU, and ``nd.save`` / ``nd.load`` on the card; the ``RNN``
op on cuDNN (never its plain loop) against the plain loop in every mode,
its gradient under a predict-mode recording, its dropout drawn from
``mx.random.seed``, and bfloat16 through cuDNN in float32; the greedy NMS
kernel (``csrc/nms.cu``) against its plain version bit for bit in f32
and f64, with class ids and a valid mask, on adversarial boxes, at every
cluster size, a batch in waves, one launch over the batch, and its
refusals.

Every test here is marked ``cuda`` and skips without a CUDA device.  This
file imports neither ``jax`` nor ``mxnet_tpu`` (the card's host has only
PyTorch), so it runs there without the repository's conftest::

    python -m pytest tests/test_torch_kernels_cuda.py --noconftest -q
"""
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from mxnet_tpu_torch import convert  # noqa: E402
from mxnet_tpu_torch.ops import kernels  # noqa: E402
from mxnet_tpu_torch.parallel import MeshSpec, make_mesh  # noqa: E402
from mxnet_tpu_torch.sparse import kernels as sparse_kernels  # noqa: E402
from mxnet_tpu_torch.sparse import (ShardedEmbedding,  # noqa: E402
                                    make_recommender_step,
                                    recommender_state)
from mxnet_tpu_torch.serving.decode import (DecodeConfig,  # noqa: E402
                                            DecodeProgram,
                                            init_decode_params)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def test_bf16_products_round_one_way_whatever_ran_first(dev):
    """The cuBLAS policy that importing the ops sets holds for every bf16
    product, the caller's own included: ``dot``, ``batch_dot`` and an
    einsum give the same bits before and after a ``FullyConnected``
    ran, at a depth (K 16384) where cuBLAS would split the reduction."""
    from mxnet_tpu_torch.ops.registry import get_op
    m = torch.backends.cuda.matmul
    assert not m.allow_bf16_reduced_precision_reduction
    assert not m.allow_fp16_reduced_precision_reduction
    g = torch.Generator().manual_seed(0)
    a = torch.randn(64, 16384, generator=g).to(dev, torch.bfloat16)
    b = torch.randn(16384, 64, generator=g).to(dev, torch.bfloat16)
    ops = {n: get_op(n) for n in ("dot", "batch_dot", "FullyConnected")}

    def products():
        return (ops["dot"].fn(ops["dot"].parse_attrs({}), a, b),
                ops["batch_dot"].fn(ops["batch_dot"].parse_attrs({}),
                                    a[None], b[None]),
                torch.einsum("ik,kj->ij", a, b))

    before = products()
    fc = ops["FullyConnected"]
    fc.fn(fc.parse_attrs({"num_hidden": 64, "no_bias": True}), a,
          b.t().contiguous())
    torch.cuda.synchronize()
    for x, y in zip(before, products()):
        assert torch.equal(x, y)


@pytest.mark.parametrize("D,page,lens", [
    (8, 4, [0, 1, 4, 6, 16]),
    (64, 64, [1, 63, 64, 65, 1024, 0, 300, 777]),
    (100, 16, [5, 0, 17, 48]),
    (128, 8, [3, 8, 9, 31, 32]),
], ids=["d8", "d64-full", "d100-ragged", "d128"])
def test_decode_attention_kernel_matches_plain(dev, D, page, lens):
    rs = np.random.RandomState(D)
    S, H = len(lens), 3
    max_pages = -(-max(lens) // page)
    P = 1 + S * max_pages
    q = torch.from_numpy(rs.randn(S, H, D).astype(np.float32)).to(dev)
    kp = torch.from_numpy(rs.randn(P, H, page, D).astype(np.float32)).to(dev)
    vp = torch.from_numpy(rs.randn(P, H, page, D).astype(np.float32)).to(dev)
    pt = torch.from_numpy(
        rs.permutation(np.arange(1, P)).reshape(S, max_pages)
        .astype(np.int32)).to(dev)
    sl = torch.tensor(lens, dtype=torch.int32, device=dev)
    before = kernels.LAUNCHES["decode_attention"]
    out = kernels.decode_attention(q, kp, vp, pt, sl)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["decode_attention"] == before + 1
    ref = kernels.decode_attention_plain(q, kp, vp, pt, sl)
    act = sl > 0
    # f32 on both sides; online vs one-pass softmax and another summation
    # order over up to 1024 terms: 1e-5 absolute on outputs of size ~1
    assert (out[act] - ref[act]).abs().max().item() < 1e-5
    assert torch.isfinite(out).all()
    assert (out[~act] == 0).all()      # the TPU kernel's inactive output


# (S, H, D, page): every D of 8/64/100/128 at every page of 4/16/64, with
# S 1 and 8 and H 1 and 12 in turn; a cap of 1024 tokens per slot
DECODE_SPLIT = [((1, 8)[i % 2], (1, 12)[i // 2 % 2], D, page)
                for i, (D, page) in enumerate(
                    (D, page) for D in (8, 64, 100, 128)
                    for page in (4, 16, 64))]


def _decode_lens(page, chunk, cap):
    """Lengths at and one either side of page and chunk boundaries, a
    slot at the cap, 0, negative and above the cap."""
    c = chunk * page
    want = {0, 1, page - 1, page, page + 1, c - 1, c, c + 1, 2 * c - 1,
            2 * c, 2 * c + 1, cap - page - 1, cap - 1, cap}
    return sorted(x for x in want if 0 <= x <= cap) + [-3, cap + 5]


@pytest.mark.parametrize("S,H,D,page", DECODE_SPLIT,
                         ids=["s%d-h%d-d%d-p%d" % c for c in DECODE_SPLIT])
def test_decode_attention_split_kernel_at_boundaries(dev, S, H, D, page):
    """The split-sequence kernel against its plain version at lengths
    around its page and chunk boundaries, with page ids out of the pool
    (the kernel clamps them; the plain version is given them clamped),
    bit-equal on a rerun."""
    cap = 1024
    max_pages = cap // page
    chunk = kernels.decode_chunk_pages(
        S, H, page, max_pages,
        torch.cuda.get_device_properties(dev).multi_processor_count)
    lens = _decode_lens(page, chunk, cap)
    rs = np.random.RandomState(D * page + S + H)
    P = 1 + max(S, 2) * max_pages
    q = torch.from_numpy(rs.randn(S, H, D).astype(np.float32)).to(dev)
    kp = torch.from_numpy(rs.randn(P, H, page, D).astype(np.float32)).to(dev)
    vp = torch.from_numpy(rs.randn(P, H, page, D).astype(np.float32)).to(dev)
    for at in range(0, len(lens), S):
        group = (lens[at:at + S] + lens[:S])[:S]
        pt = rs.permutation(np.arange(1, P))[:S * max_pages] \
            .reshape(S, max_pages).astype(np.int32)
        wild = pt.copy()
        wild[:, 1::3] = P + np.arange(max_pages)[1::3]
        wild[:, 2::5] = -1 - np.arange(max_pages)[2::5]
        sl = torch.tensor(group, dtype=torch.int32, device=dev)
        wild_t = torch.from_numpy(wild).to(dev)
        out = kernels.decode_attention(q, kp, vp, wild_t, sl)
        again = kernels.decode_attention(q, kp, vp, wild_t, sl)
        ref = kernels.decode_attention_plain(
            q, kp, vp, wild_t.clamp(0, P - 1), sl.clamp(0, cap))
        torch.cuda.synchronize()
        act = sl > 0
        # as test_decode_attention_kernel_matches_plain
        assert ((out[act] - ref[act]).abs() < 1e-5).all(), group
        assert (out[~act] == 0).all(), group
        assert torch.equal(out, again), group


def test_decode_attention_makes_no_host_sync(dev):
    """The wrapper sizes its split from the shapes, never from seq_lens:
    a call under ``set_sync_debug_mode("error")`` raises nothing."""
    rs = np.random.RandomState(5)
    S, H, D, page, max_pages = 8, 12, 64, 64, 16
    P = 1 + S * max_pages
    q = torch.from_numpy(rs.randn(S, H, D).astype(np.float32)).to(dev)
    kp = torch.from_numpy(rs.randn(P, H, page, D).astype(np.float32)).to(dev)
    vp = torch.from_numpy(rs.randn(P, H, page, D).astype(np.float32)).to(dev)
    pt = torch.from_numpy(rs.permutation(np.arange(1, P)).reshape(
        S, max_pages).astype(np.int32)).to(dev)
    sl = torch.tensor([0, 1, 64, 100, 1024, 513, 300, 777],
                      dtype=torch.int32, device=dev)
    first = kernels.decode_attention(q, kp, vp, pt, sl)   # builds, queries
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = kernels.decode_attention(q, kp, vp, pt, sl)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.equal(out, first)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("M,N,K", [(8, 768, 768), (3, 40, 33), (13, 9, 1),
                                   (1, 257, 1030), (8, 64, 3072)],
                         ids=["decode", "odd-k", "k1", "m1-ragged",
                              "wide-k"])
def test_quant_matmul_kernel_matches_plain(dev, bits, M, N, K):
    rs = np.random.RandomState(M * N + K)
    w = rs.randn(N, K).astype(np.float32)
    qw, sc = kernels.quantize_weight(w, bits)
    x = torch.from_numpy(rs.randn(M, K).astype(np.float32)).to(dev)
    qw, sc = torch.from_numpy(qw).to(dev), torch.from_numpy(sc).to(dev)
    key = "quant_matmul_int%d" % bits
    before = kernels.LAUNCHES[key]
    out = kernels.quant_matmul(x, qw, sc, bits)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[key] == before + 1
    ref = kernels.quant_matmul_plain(x, qw, sc, bits)
    # scale applied after vs before the f32 sum, another summation order:
    # 1e-5 relative to the result's scale
    scale = ref.abs().max().item()
    assert (out - ref).abs().max().item() <= 1e-5 * max(scale, 1.0)


@pytest.mark.parametrize("bits", [8, 4])
def test_quant_matmul_kernel_unaligned_x_matches_plain(dev, bits):
    """x whose rows are not 16-byte aligned takes the scalar staging
    path of the kernel."""
    rs = np.random.RandomState(bits)
    M, N, K = 8, 96, 768
    qw, sc = kernels.quantize_weight(rs.randn(N, K).astype(np.float32), bits)
    qw, sc = torch.from_numpy(qw).to(dev), torch.from_numpy(sc).to(dev)
    flat = torch.from_numpy(rs.randn(M * K + 1).astype(np.float32)).to(dev)
    x = flat[1:].view(M, K)
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    out = kernels.quant_matmul(x, qw, sc, bits)
    ref = kernels.quant_matmul_plain(x, qw, sc, bits)
    assert (out - ref).abs().max().item() <= 1e-5 * max(
        ref.abs().max().item(), 1.0)


# the decode step's shapes at 8 slots (q/k/v/proj, ff1, ff2 and the
# vocabulary head of the full-width LM), one slot, 13 rows (two row
# tiles); N = 768 splits K across the block's warps
QUANT_DECODE = [(8, 768, 768), (8, 3072, 768), (8, 768, 3072),
                (8, 32768, 768), (1, 768, 768), (13, 3072, 768)]
QUANT_DECODE_IDS = ["qkv-splitk", "ff1", "ff2-splitk", "head", "m1",
                    "m13"]


def _quant_inputs(dev, bits, M, N, K, seed):
    rs = np.random.RandomState(seed)
    qw, sc = kernels.quantize_weight(
        (rs.randn(N, K) * 0.02).astype(np.float32), bits)
    x = torch.from_numpy(rs.randn(M, K).astype(np.float32)).to(dev)
    return x, torch.from_numpy(qw).to(dev), torch.from_numpy(sc).to(dev)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("M,N,K", QUANT_DECODE, ids=QUANT_DECODE_IDS)
def test_quant_matmul_kernel_at_decode_shapes(dev, bits, M, N, K):
    """The decode path's shapes, within the tolerance of
    test_quant_matmul_kernel_matches_plain, and the same bits on a
    rerun (the k slices are summed in a fixed order, no atomics)."""
    x, qw, sc = _quant_inputs(dev, bits, M, N, K, M + N + K)
    out = kernels.quant_matmul(x, qw, sc, bits)
    again = kernels.quant_matmul(x, qw, sc, bits)
    ref = kernels.quant_matmul_plain(x, qw, sc, bits)
    # as test_quant_matmul_kernel_matches_plain
    assert (out - ref).abs().max().item() <= 1e-5 * max(
        ref.abs().max().item(), 1.0)
    assert torch.equal(out, again)


@pytest.mark.parametrize("bits", [8, 4])
def test_quant_matmul_kernel_is_not_1xtf32(dev, bits):
    """The kernel splits x into two TF32 parts (the integer weights are
    exact in TF32): it stays within the tolerance that the plain version
    run in TF32 (``allow_tf32``, x and the weights rounded to 10 mantissa
    bits) exceeds."""
    x, qw, sc = _quant_inputs(dev, bits, 8, 768, 768, 7)
    ref = kernels.quant_matmul_plain(x, qw, sc, bits)
    got = kernels.quant_matmul(x, qw, sc, bits)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32 = kernels.quant_matmul_plain(x, qw, sc, bits)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    tol = 1e-5 * max(ref.abs().max().item(), 1.0)   # as above
    assert (got - ref).abs().max().item() <= tol
    assert (tf32 - ref).abs().max().item() > tol, \
        "1xTF32 stays within the tolerance"


def test_kernels_refuse_wrong_dtype_and_layout(dev):
    from mxnet_tpu_torch.base import MXNetError
    x = torch.randn(4, 16, device=dev)
    qw = torch.zeros(8, 16, dtype=torch.int8, device=dev)
    sc = torch.ones(8, device=dev)
    with pytest.raises(MXNetError):
        kernels.quant_matmul(x.double(), qw, sc, 8)
    with pytest.raises(MXNetError):
        kernels.quant_matmul(x, qw.t().contiguous().t(), sc, 8)
    with pytest.raises(MXNetError):
        kernels.quant_matmul(x, qw, sc.cpu(), 8)


@pytest.mark.parametrize("quantize", [None, "int8", "int4"])
def test_decode_step_on_card_matches_cpu(dev, quantize):
    cfg = DecodeConfig(64, 2, 32, 4, 16, page_size=4, max_seqs=3)
    params = init_decode_params(cfg, seed=3)
    progs = [DecodeProgram(params, cfg, quantize=quantize, device=d)
             for d in ("cpu", dev)]
    kvs = [p.fresh_cache() for p in progs]
    S, pp = cfg.max_seqs, cfg.pages_per_seq
    table = np.zeros((S, pp), np.int32)
    for s in range(2):                      # slot 2 stays inactive
        table[s] = 1 + s * pp + np.arange(pp)
    act = np.array([1, 1, 0], np.int32)
    toks = np.random.RandomState(1).randint(0, 64, (S, 16)).astype(np.int32)
    for t in range(16):
        pos = np.full(S, t, np.int32) * act
        args = (toks[:, t], pos, (pos + 1) * act,
                table[np.arange(S), pos // 4] * act, (pos % 4) * act, table)
        outs = [p.step(kv, *args) for p, kv in zip(progs, kvs)]
        (n0, l0, kvs[0]), (n1, l1, kvs[1]) = outs
        assert (l1[:2].cpu() - l0[:2]).abs().max().item() < 1e-4
        assert torch.equal(n1[:2].cpu(), n0[:2])
    assert torch.allclose(kvs[1][:, :, 1:].cpu(), kvs[0][:, :, 1:],
                          atol=1e-5)


def _flash_inputs(dev, B, Tq, Tk, H, D, seed):
    rs = np.random.RandomState(seed)
    mk = lambda T: torch.from_numpy(  # noqa: E731
        rs.randn(B, T, H, D).astype(np.float32)).to(dev)
    return mk(Tq), mk(Tk), mk(Tk), mk(Tq)


FLASH_CASES = [(2, 64, 64, 2, 64, True), (2, 1000, 1000, 3, 64, True),
               (1, 130, 130, 2, 64, False), (2, 48, 48, 2, 8, True),
               (1, 77, 77, 2, 100, True), (1, 200, 200, 1, 128, True),
               (2, 96, 160, 2, 32, True), (1, 160, 96, 2, 16, False)]
FLASH_IDS = ["t64", "t1000-ragged", "noncausal-t130", "d8-t48",
             "d100-t77", "d128-t200", "tq96-tk160-causal",
             "tq160-tk96-noncausal"]


@pytest.mark.parametrize("B,Tq,Tk,H,D,causal", FLASH_CASES, ids=FLASH_IDS)
def test_flash_attention_fwd_kernel_matches_plain(dev, B, Tq, Tk, H, D,
                                                  causal):
    q, k, v, _ = _flash_inputs(dev, B, Tq, Tk, H, D, Tq + D)
    before = kernels.LAUNCHES["flash_attention_fwd"]
    out, lse = kernels.flash_attention_fwd(q, k, v, causal=causal)
    out2, none = kernels.flash_attention_fwd(q, k, v, causal=causal,
                                             with_lse=False)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["flash_attention_fwd"] == before + 2
    assert none is None
    ref, ref_lse = kernels.flash_attention_fwd_plain(q, k, v, causal=causal)
    # f32 both sides; online vs one-pass softmax over up to 1000 keys in
    # another summation order: 1e-5 absolute on outputs and lse of size ~1
    assert (out - ref).abs().max().item() < 1e-5
    assert (lse - ref_lse).abs().max().item() < 1e-5
    assert torch.equal(out, out2)


@pytest.mark.parametrize("B,Tq,Tk,H,D,causal", FLASH_CASES, ids=FLASH_IDS)
def test_flash_attention_bwd_kernels_match_plain(dev, B, Tq, Tk, H, D,
                                                 causal):
    q, k, v, do = _flash_inputs(dev, B, Tq, Tk, H, D, Tq * 3 + D)
    out, lse = kernels.flash_attention_fwd_plain(q, k, v, causal=causal)
    delta = kernels.flash_delta(out, do)
    n_dq = kernels.LAUNCHES["flash_attention_bwd_dq"]
    n_dkv = kernels.LAUNCHES["flash_attention_bwd_dkv"]
    dq = kernels.flash_attention_bwd_dq(q, k, v, do, lse, delta, causal)
    dk, dv = kernels.flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["flash_attention_bwd_dq"] == n_dq + 1
    assert kernels.LAUNCHES["flash_attention_bwd_dkv"] == n_dkv + 1
    refs = kernels.flash_attention_bwd_plain(q, k, v, out, lse, do,
                                             causal=causal)
    for got, ref in zip((dq, dk, dv), refs):
        # sums over up to 1000 rows in another order: 1e-4 relative to
        # the gradient's own scale
        tol = 1e-4 * max(1.0, ref.abs().max().item())
        assert (got - ref).abs().max().item() < tol


# shapes the full-width path does not reach: D 72 (between the kernels'
# templates, zero-padded to 128), T 1 (a single row and key)
BWD_EXTRA = [(2, 70, 70, 3, 72, True), (3, 1, 1, 2, 64, True),
             (2, 1, 5, 2, 64, False)]
BWD_EXTRA_IDS = ["d72-t70", "t1-causal", "tq1-tk5-noncausal"]


@pytest.mark.parametrize("B,Tq,Tk,H,D,causal", BWD_EXTRA,
                         ids=BWD_EXTRA_IDS)
def test_flash_attention_bwd_kernels_match_plain_odd_shapes(dev, B, Tq, Tk,
                                                            H, D, causal):
    q, k, v, do = _flash_inputs(dev, B, Tq, Tk, H, D, Tq * 7 + D)
    out, lse = kernels.flash_attention_fwd_plain(q, k, v, causal=causal)
    delta = kernels.flash_delta(out, do)
    dq = kernels.flash_attention_bwd_dq(q, k, v, do, lse, delta, causal)
    dk, dv = kernels.flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal)
    refs = kernels.flash_attention_bwd_plain(q, k, v, out, lse, do,
                                             causal=causal)
    for got, ref in zip((dq, dk, dv), refs):
        # as test_flash_attention_bwd_kernels_match_plain
        tol = 1e-4 * max(1.0, ref.abs().max().item())
        assert (got - ref).abs().max().item() < tol


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_flash_attention_bwd_kernels_are_deterministic(dev, causal):
    """Every output tile has one owner block and no atomics: two launches
    on the same inputs give the same bits."""
    q, k, v, do = _flash_inputs(dev, 2, 300, 300, 3, 64, 11)
    out, lse = kernels.flash_attention_fwd_plain(q, k, v, causal=causal)
    delta = kernels.flash_delta(out, do)
    runs = [(kernels.flash_attention_bwd_dq(q, k, v, do, lse, delta, causal),)
            + kernels.flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal)
            for _ in range(2)]
    for a, b in zip(*runs):
        assert torch.equal(a, b)


# inputs scaled so that logits reach ~+-20: one TF32 product (10 mantissa
# bits) moves a logit by ~1e-2, which the gradients' tolerance sees; the
# kernels' 3xTF32 (~2^-21 per product) stays inside it
TF32_SCALE = 2.5


def test_flash_attention_bwd_kernels_are_not_1xtf32(dev):
    """The tolerance tells 3xTF32 from 1xTF32: the plain version's einsums
    run in TF32 (``allow_tf32``) exceed it on these inputs, the kernels
    stay inside it."""
    q, k, v, do = _flash_inputs(dev, 2, 256, 256, 2, 64, 21)
    q, k = q * TF32_SCALE, k * TF32_SCALE
    out, lse = kernels.flash_attention_fwd_plain(q, k, v, causal=True)
    delta = kernels.flash_delta(out, do)
    refs = kernels.flash_attention_bwd_plain(q, k, v, out, lse, do,
                                             causal=True)
    got = (kernels.flash_attention_bwd_dq(q, k, v, do, lse, delta, True),) \
        + kernels.flash_attention_bwd_dkv(q, k, v, do, lse, delta, True)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32 = kernels.flash_attention_bwd_plain(q, k, v, out, lse, do,
                                                 causal=True)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    worst_tf32 = 0.0
    for g, t, ref in zip(got, tf32, refs):
        tol = 1e-4 * max(1.0, ref.abs().max().item())
        assert (g - ref).abs().max().item() < tol
        worst_tf32 = max(worst_tf32, (t - ref).abs().max().item() / tol)
    assert worst_tf32 > 1.0, "1xTF32 stays within the tolerance"


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_flash_attention_fwd_kernel_is_deterministic(dev, causal):
    """One owner block per output tile, no atomics: two launches of the
    forward give the same bits, out and lse."""
    q, k, v, _ = _flash_inputs(dev, 2, 300, 300, 3, 64, 12)
    runs = [kernels.flash_attention_fwd(q, k, v, causal=causal)
            for _ in range(2)]
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_flash_attention_fwd_kernel_is_not_1xtf32(dev):
    """The forward's tolerance tells 3xTF32 from 1xTF32: on logits that
    reach ~+-20 the plain version's einsums in TF32 (``allow_tf32``)
    exceed it, the kernel stays inside it.  The tolerance is
    test_flash_attention_fwd_kernel_matches_plain's 1e-5, scaled to
    max(1, max|ref|) because out and lse grow with the logits here (lse
    to ~20), as the backward's is."""
    q, k, v, _ = _flash_inputs(dev, 2, 256, 256, 2, 64, 21)
    q, k = q * TF32_SCALE, k * TF32_SCALE
    refs = kernels.flash_attention_fwd_plain(q, k, v, causal=True)
    got = kernels.flash_attention_fwd(q, k, v, causal=True)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32 = kernels.flash_attention_fwd_plain(q, k, v, causal=True)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    worst_tf32 = 0.0
    for g, t, ref in zip(got, tf32, refs):
        tol = 1e-5 * max(1.0, ref.abs().max().item())
        assert (g - ref).abs().max().item() < tol
        worst_tf32 = max(worst_tf32, (t - ref).abs().max().item() / tol)
    assert worst_tf32 > 1.0, "1xTF32 stays within the tolerance"


def test_flash_attention_autograd_on_card_matches_cpu(dev):
    """The FlashAttention Function on the card (forward kernel with lse,
    dQ and dK/dV kernels) against the same Function on the CPU (plain
    versions), through a non-contiguous incoming gradient."""
    B, T, H, D = 2, 130, 2, 64
    q, k, v, g = _flash_inputs("cpu", B, T, T, H, D, 5)
    grads = []
    for d in ("cpu", dev):
        qs = [t.to(d).clone().requires_grad_() for t in (q, k, v)]
        out = kernels.flash_attention(*qs, causal=True)
        # a transposed view as the incoming gradient
        gt = g.to(d).transpose(1, 2).contiguous().transpose(1, 2)
        assert not gt.is_contiguous()
        out.backward(gt)
        grads.append([out.detach().cpu()] + [t.grad.cpu() for t in qs])
    for a, b in zip(*grads):
        assert (a - b).abs().max().item() < 1e-4 * max(
            1.0, a.abs().max().item())


def test_flash_kernels_refuse_wrong_dtype_and_shape(dev):
    from mxnet_tpu_torch.base import MXNetError
    q = torch.randn(1, 8, 2, 16, device=dev)
    with pytest.raises(MXNetError):
        kernels.flash_attention_fwd(q.double(), q.double(), q.double())
    big = torch.randn(1, 8, 1, 160, device=dev)
    with pytest.raises(MXNetError):
        kernels.flash_attention_fwd(big, big, big)
    with pytest.raises(MXNetError):
        kernels.flash_attention_fwd(q, q[:, :, :1], q)
    with pytest.raises(MXNetError):     # one dtype for q, k and v
        kernels.flash_attention_fwd(q.bfloat16(), q, q)


# B9: the bf16 kernels.  Both sides compute in f32 from the same bf16
# inputs and round out, dq, dk and dv to bf16, so an element may land one
# bf16 step apart (2^-7 of its magnitude at most) on top of the f32
# kernels' own tolerances (1e-5 for out and lse, 1e-4 for the gradients,
# each x max(1, max|ref|)).  The reference's own bf16 bar is far looser
# (tests/test_flash_vjp.py: rtol 0.1, atol 0.05).
BF16_CASES = [(2, 1024, 1024, 12, 64, True), (2, 1000, 1000, 3, 64, True),
              (1, 130, 130, 2, 64, False), (1, 77, 77, 2, 100, True),
              (1, 200, 200, 1, 128, True), (2, 96, 160, 2, 32, True),
              (1, 70, 70, 2, 12, True), (3, 1, 1, 2, 64, True)]
BF16_IDS = ["t1024-d64", "t1000-ragged", "noncausal-t130", "d100-t77",
            "d128-t200", "tq96-tk160-d32", "d12-unaligned", "t1"]


def _bf16_close(got, ref, base):
    """Every element within one bf16 step of the plain version's, plus
    ``base`` x max(1, max|ref|); returns the largest error over that."""
    assert got.dtype == ref.dtype
    got, ref = got.float(), ref.float()
    tol = 2.0 ** -7 * ref.abs() + base * max(1.0, ref.abs().max().item())
    return ((got - ref).abs() / tol).max().item()


def _check_bf16_kernels(q, k, v, do, causal):
    """The three B9 kernels against their plain versions on bf16 q, k, v,
    dO: one launch each (and none of the f32 ones), lse within 1e-5,
    out / dq / dk / dv within one bf16 step plus 1e-5 / 1e-4 x max(1,
    max|ref|), and a rerun gives the same bits."""
    before = dict(kernels.LAUNCHES)
    out, lse = kernels.flash_attention_fwd(q, k, v, causal=causal)
    ref, ref_lse = kernels.flash_attention_fwd_plain(q, k, v, causal=causal)
    delta = kernels.flash_delta(ref, do)
    dq = kernels.flash_attention_bwd_dq(q, k, v, do, ref_lse, delta, causal)
    dk, dv = kernels.flash_attention_bwd_dkv(q, k, v, do, ref_lse, delta,
                                             causal)
    torch.cuda.synchronize()
    # the bf16 entry points ran, once each; the f32 ones did not
    for name in ("flash_attention_fwd", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv"):
        assert kernels.LAUNCHES[name + "_bf16"] == before[name + "_bf16"] + 1
        assert kernels.LAUNCHES[name] == before[name]
    assert lse.dtype == torch.float32
    assert (lse - ref_lse).abs().max().item() < 1e-5 * max(
        1.0, ref_lse.abs().max().item())
    assert _bf16_close(out, ref, 1e-5) <= 1.0
    refs = kernels.flash_attention_bwd_plain(q, k, v, ref, ref_lse, do,
                                             causal=causal)
    for got, want in zip((dq, dk, dv), refs):
        assert _bf16_close(got, want, 1e-4) <= 1.0
    # every output tile has one owner: a rerun gives the same bits
    again = (kernels.flash_attention_fwd(q, k, v, causal=causal)[0],
             kernels.flash_attention_bwd_dq(q, k, v, do, ref_lse, delta,
                                            causal)) + \
        kernels.flash_attention_bwd_dkv(q, k, v, do, ref_lse, delta, causal)
    for a, b in zip((out, dq, dk, dv), again):
        assert torch.equal(a, b)


@pytest.mark.parametrize("B,Tq,Tk,H,D,causal", BF16_CASES, ids=BF16_IDS)
def test_flash_attention_bf16_kernels_match_plain(dev, B, Tq, Tk, H, D,
                                                  causal):
    q, k, v, do = (t.bfloat16() for t in _flash_inputs(
        dev, B, Tq, Tk, H, D, Tq * 5 + D))
    _check_bf16_kernels(q, k, v, do, causal)


# the edges of the bf16 tiling and of p's hi + lo split: logits that reach
# ~+-20 (q and k x 2.5: p spans e^-40..1 in one row), and Tq != Tk without
# the causal mask at D 32 and 128 (ragged 64-row tiles on both sides)
@pytest.mark.parametrize("B,Tq,Tk,H,D,causal,gain", [
    (2, 256, 256, 2, 64, True, 2.5), (1, 96, 160, 2, 32, False, 1.0),
    (2, 160, 96, 2, 128, False, 1.0)],
    ids=["logits20-t256", "full-tq96-tk160-d32", "full-tq160-tk96-d128"])
def test_flash_attention_bf16_kernels_at_the_edges(dev, B, Tq, Tk, H, D,
                                                   causal, gain):
    q, k, v, do = _flash_inputs(dev, B, Tq, Tk, H, D, 21 + D)
    q, k = q * gain, k * gain
    if gain > 1:
        s = torch.einsum("bqhd,bkhd->bhqk", q, k) / D ** 0.5
        assert s.abs().max().item() > 15
    _check_bf16_kernels(*(t.bfloat16() for t in (q, k, v, do)), causal)


# B9 f16: the same three kernels over f16 tiles and f16 MMAs.  One f16
# step of each element is 2^-10 of its magnitude; the f32 terms are the
# bf16 ones.
def _f16_close(got, ref, base):
    """Every element within one f16 step of the plain version's, plus
    ``base`` x max(1, max finite |ref|); inf and NaN only where the plain
    version has them.  Returns the largest error over that."""
    assert got.dtype == ref.dtype == torch.float16
    got, ref = got.float(), ref.float()
    same = (got == ref) | (torch.isnan(got) & torch.isnan(ref))
    fin = ref[torch.isfinite(ref)]
    tol = 2.0 ** -10 * ref.abs() + base * max(
        1.0, fin.abs().max().item() if fin.numel() else 1.0)
    return torch.where(same, torch.zeros((), device=got.device),
                       (got - ref).abs() / tol).max().item()


def _check_f16_kernels(q, k, v, do, causal, rerun=True):
    before = dict(kernels.LAUNCHES)
    out, lse = kernels.flash_attention_fwd(q, k, v, causal=causal)
    ref, ref_lse = kernels.flash_attention_fwd_plain(q, k, v, causal=causal)
    delta = kernels.flash_delta(ref, do)
    dq = kernels.flash_attention_bwd_dq(q, k, v, do, ref_lse, delta, causal)
    dk, dv = kernels.flash_attention_bwd_dkv(q, k, v, do, ref_lse, delta,
                                             causal)
    torch.cuda.synchronize()
    for name in ("flash_attention_fwd", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv"):
        assert kernels.LAUNCHES[name + "_f16"] == before[name + "_f16"] + 1
        assert kernels.LAUNCHES[name] == before[name]
        assert kernels.LAUNCHES[name + "_bf16"] == before[name + "_bf16"]
    assert lse.dtype == torch.float32
    assert (lse - ref_lse).abs().max().item() < 1e-5 * max(
        1.0, ref_lse.abs().max().item())
    assert _f16_close(out, ref, 1e-5) <= 1.0
    refs = kernels.flash_attention_bwd_dq_plain(
        q, k, v, do, ref_lse, delta, causal), \
        *kernels.flash_attention_bwd_dkv_plain(q, k, v, do, ref_lse, delta,
                                               causal)
    for got, want in zip((dq, dk, dv), refs):
        assert _f16_close(got, want, 1e-4) <= 1.0
    if rerun:
        again = (kernels.flash_attention_fwd(q, k, v, causal=causal)[0],
                 kernels.flash_attention_bwd_dq(q, k, v, do, ref_lse, delta,
                                                causal)) + \
            kernels.flash_attention_bwd_dkv(q, k, v, do, ref_lse, delta,
                                            causal)
        for a, b in zip((out, dq, dk, dv), again):
            assert torch.equal(a, b)
    return refs


@pytest.mark.parametrize("B,Tq,Tk,H,D,causal", BF16_CASES, ids=BF16_IDS)
def test_flash_attention_f16_kernels_match_plain(dev, B, Tq, Tk, H, D,
                                                 causal):
    q, k, v, do = (t.half() for t in _flash_inputs(
        dev, B, Tq, Tk, H, D, Tq * 5 + D))
    _check_f16_kernels(q, k, v, do, causal)


@pytest.mark.parametrize("do_max", [1e3, 1e4, 6e4])
def test_flash_attention_f16_kernels_at_a_loss_scale(dev, do_max):
    """dO at the sizes a loss scale of 2^10-2^16 gives it (its largest
    |dO| up to 6e4, next to f16's largest value 65504; 1e5 is not an f16
    value), with logits to ~+-20: within one f16 step of the plain
    versions, inf only where they have it."""
    q, k, v, do = _flash_inputs(dev, 2, 256, 256, 2, 64, 31)
    q, k = q * 2.5, k * 2.5
    do = do * (do_max / do.abs().max().item())
    _check_f16_kernels(*(t.half() for t in (q, k, v, do)), True)


def test_flash_attention_f16_ds_past_f16_range(dev):
    """ds ~1e5, past f16's range, while dq stays ~1e4 (two keys share
    each query's weight, v_1 = -v_0, dO = 3e4 sign(v_0):
    ``tests/test_torch_flash_f16_split.overflow_inputs``): dq within one
    f16 step of the plain version and finite, where f16 hi + lo terms of
    the unscaled ds would give NaN."""
    from test_torch_flash_f16_split import overflow_inputs
    q, k, v, do = (t.to(dev) for t in overflow_inputs(amp=3e4,
                                                      spread=0.1))
    _p, ds = kernels._flash_bwd_parts(
        q.cpu(), k.cpu(), v.cpu(), do.cpu(),
        *(lambda o, l: (l, kernels.flash_delta(o, do.cpu())))(
            *kernels.flash_attention_fwd_plain(q.cpu(), k.cpu(), v.cpu())),
        False, 1.0 / 8.0)
    assert ds.abs().max().item() > 65504.0
    dq_ref, _dk, _dv = _check_f16_kernels(q, k, v, do, False)
    assert bool(torch.isfinite(dq_ref).all())


def test_flash_f16_kernels_sass_holds_f16_hmma(dev):
    """The SASS of every f16 instantiation holds f16 HMMA.16816 and no
    TF32 HMMA; the bf16 instantiations hold bf16 ones."""
    import re
    import shutil
    import subprocess
    from mxnet_tpu_torch.ops import build
    path = build.build_kernels(["flash_attention"])["flash_attention"]
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", path], capture_output=True,
                          text=True, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            counts[fn] = [0, 0, 0]
        elif fn and "HMMA" in line:
            counts[fn][0] += "TF32" in line
            counts[fn][1] += "HMMA.16816.F32.BF16" in line
            counts[fn][2] += "HMMA.16816.F32 " in line or \
                line.rstrip().endswith("HMMA.16816.F32")
    for kind in ("fwd16", "bwd_dq16", "bwd_dkv16"):
        f16 = [n for f, n in counts.items()
               if "flash_%s_kernel" % kind in f and "__half" in f]
        bf16 = [n for f, n in counts.items()
                if "flash_%s_kernel" % kind in f and "__nv_bfloat16" in f]
        assert len(f16) == 3 and len(bf16) == 3, (kind, counts)
        assert all(n[0] == 0 and n[1] == 0 and n[2] > 0 for n in f16), f16
        assert all(n[0] == 0 and n[1] > 0 and n[2] == 0 for n in bf16), bf16


# The f32 kernels (B1, B2a, B2b) and the bf16 forward and dK/dV are the
# same code as before the bf16 dQ was redesigned: SHA-256 (first 16 hex
# digits) of their outputs at fixed inputs, as the earlier sources gave
# them on the H100 (the f32 entries: commit cd7afa8; the bf16 ones:
# e6878f0).  The bf16 dK/dV reads lse and delta of the plain versions, so
# that it does not depend on the forward.
FLASH_DIGESTS = {
    "T1000-D64 out": "001023db11a41cad",
    "T1000-D64 lse": "c1105eee0cf06b42",
    "T1000-D64 dq": "a7760161e18de24f",
    "T1000-D64 dk": "a91928aeb2fa97ae",
    "T1000-D64 dv": "6f5c896be33f48a1",
    "T1000-D64 out_bf16": "3d885af5d130038e",
    "T1000-D64 lse_bf16": "771bf4b09a39ef17",
    "T1000-D64 dk_bf16": "7d8edc6ab8f2a8aa",
    "T1000-D64 dv_bf16": "a3a31520db274344",
    "T160-D128 out": "9fd9fde54f85c201",
    "T160-D128 lse": "1599631a6df556c5",
    "T160-D128 dq": "e69225bf6b6d8ff6",
    "T160-D128 dk": "85045e675546132e",
    "T160-D128 dv": "d4faebd584fd8850",
    "T160-D128 out_bf16": "e3250b17aceed12f",
    "T160-D128 lse_bf16": "f451ace19ef63d10",
    "T160-D128 dk_bf16": "8053618ae026d4db",
    "T160-D128 dv_bf16": "cfef198789952976",
}


def flash_digests(dev):
    """{output name: digest} of the f32 forward (out, lse), dQ, dK, dV and
    the bf16 forward (out, lse) and dK/dV at two fixed inputs."""
    import hashlib
    out = {}
    for B, Tq, Tk, H, D, causal in [(2, 1000, 1000, 3, 64, True),
                                    (1, 160, 96, 2, 128, False)]:
        q, k, v, do = _flash_inputs(dev, B, Tq, Tk, H, D, 7)
        o, lse = kernels.flash_attention_fwd(q, k, v, causal)
        delta = kernels.flash_delta(o, do)
        dq = kernels.flash_attention_bwd_dq(q, k, v, do, lse, delta, causal)
        dk, dv = kernels.flash_attention_bwd_dkv(q, k, v, do, lse, delta,
                                                 causal)
        qb, kb, vb, dob = (t.bfloat16() for t in (q, k, v, do))
        ob, lseb = kernels.flash_attention_fwd(qb, kb, vb, causal)
        ref, ref_lse = kernels.flash_attention_fwd_plain(qb, kb, vb, causal)
        dkb, dvb = kernels.flash_attention_bwd_dkv(
            qb, kb, vb, dob, ref_lse, kernels.flash_delta(ref, dob), causal)
        torch.cuda.synchronize()
        for name, t in (("out", o), ("lse", lse), ("dq", dq), ("dk", dk),
                        ("dv", dv), ("out_bf16", ob), ("lse_bf16", lseb),
                        ("dk_bf16", dkb), ("dv_bf16", dvb)):
            out["T%d-D%d %s" % (Tq, D, name)] = hashlib.sha256(
                t.cpu().view(torch.int16 if t.dtype == torch.bfloat16
                             else torch.int32).numpy().tobytes()
            ).hexdigest()[:16]
    return out


def test_flash_f32_kernels_and_bf16_fwd_dkv_give_the_earlier_bits(dev):
    assert flash_digests(dev) == FLASH_DIGESTS


def test_flash_attention_bf16_autograd_on_card_matches_cpu(dev):
    """The FlashAttention Function in bf16 on the card (the B9 kernels)
    against the same Function on the CPU (plain versions in f32 from the
    same bf16 inputs), outputs and gradients in bf16, one bf16 step plus
    1e-4 x max(1, max|ref|) apart at most."""
    B, T, H, D = 2, 130, 2, 64
    q, k, v, g = (t.bfloat16() for t in _flash_inputs("cpu", B, T, T, H, D,
                                                      6))
    res = []
    for d in ("cpu", dev):
        qs = [t.to(d).clone().requires_grad_() for t in (q, k, v)]
        out = kernels.flash_attention(*qs, causal=True)
        out.backward(g.to(d))
        res.append([out.detach().cpu()] + [t.grad.cpu() for t in qs])
    for a, b in zip(res[1], res[0]):
        assert a.dtype == torch.bfloat16
        assert _bf16_close(a, b, 1e-4) <= 1.0


# (rows, D, n): the bench's D 16, the Criteo run's D 64, D 13 and 1 (the
# scalar path), n = 1
EMBED_CASES = [(1000, 16, 512), (5000, 64, 300), (77, 13, 40), (50, 1, 33),
               (20, 16, 1)]
EMBED_IDS = ["d16", "d64", "d13", "d1", "n1"]


def _embed_inputs(dev, rows, D, n, seed, pads=3):
    """A table of multiples of 2^-6, sorted ids with a run of duplicates,
    0 and rows-1 among them, then ``pads`` ids >= rows; payload rows of
    multiples of 2^-10 (sums are exact in any order)."""
    rs = np.random.RandomState(seed)
    table = (rs.randint(-64, 64, (rows, D)) / 64.0).astype(np.float32)
    ids = rs.randint(0, rows, n)
    ids[0] = 0
    ids[-1] = rows - 1
    if n > 4:
        ids[1:4] = ids[2]
    ids = np.concatenate([np.sort(ids), rows + np.arange(pads)])
    src = (rs.randint(-512, 512, (len(ids), D)) / 1024.0).astype(np.float32)
    return (torch.from_numpy(table).to(dev),
            torch.from_numpy(ids.astype(np.int32)).to(dev),
            torch.from_numpy(src).to(dev))


def _misaligned(t):
    """The same values at an address that is not 16-byte aligned."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = flat[1:].view(t.shape)
    out.copy_(t)
    assert out.is_contiguous() and out.data_ptr() % 16 != 0
    return out


@pytest.mark.parametrize("aligned", [True, False],
                         ids=["aligned", "misaligned"])
@pytest.mark.parametrize("rows,D,n", EMBED_CASES, ids=EMBED_IDS)
def test_embedding_gather_kernel_matches_plain(dev, rows, D, n, aligned):
    table, ids, _src = _embed_inputs(dev, rows, D, n, rows + D, pads=0)
    if not aligned:
        table = _misaligned(table)
    before = kernels.LAUNCHES["embedding_gather"]
    out = sparse_kernels.embedding_gather(table, ids)
    # an id out of range is clamped, never read out of bounds
    wild = torch.tensor([-5, rows, rows + 1000], dtype=torch.int32,
                        device=dev)
    edge = sparse_kernels.embedding_gather(table, wild)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["embedding_gather"] == before + 2
    assert torch.equal(out, sparse_kernels.embedding_gather_plain(table,
                                                                  ids))
    assert torch.equal(out, table[ids.long()])
    assert torch.equal(edge, table[[0, rows - 1, rows - 1]])


@pytest.mark.parametrize("mode", ["add", "set"])
@pytest.mark.parametrize("aligned", [True, False],
                         ids=["aligned", "misaligned"])
@pytest.mark.parametrize("rows,D,n", EMBED_CASES, ids=EMBED_IDS)
def test_embedding_scatter_kernel_matches_plain(dev, rows, D, n, aligned,
                                                mode):
    """Pads follow a real update of the last row and carry the no-op
    payload: zero rows (add), the current row (set)."""
    table, ids, src = _embed_inputs(dev, rows, D, n, rows * 3 + D)
    if mode == "add":
        src[n:] = 0.0
    else:
        src[n:] = table[rows - 1]
    if not aligned:
        table, src = _misaligned(table), _misaligned(src)
    ref = sparse_kernels.embedding_scatter_plain(table.clone(), ids, src,
                                                 mode)
    before = kernels.LAUNCHES["embedding_scatter"]
    out = sparse_kernels.embedding_scatter(table, ids, src, mode)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["embedding_scatter"] == before + 1
    assert out is table                          # in place
    assert torch.equal(out, ref)


def _runs_inputs(rs, rows, D, lengths, pads, pad_alone):
    """Sorted ids in runs of the given lengths (distinct rows), then
    ``pads`` ids >= rows, which follow a real run of the last row or,
    with ``pad_alone``, form a run of their own; an inexact table and
    payloads, zero payloads on the pads (the add contract)."""
    top = rows - 2 if pad_alone else rows - 1
    heads = np.sort(rs.choice(top, len(lengths) - 1, replace=False))
    heads = np.append(heads, top)
    ids = np.concatenate([np.full(k, r) for r, k in zip(heads, lengths)] +
                         [rows + np.arange(pads)]).astype(np.int32)
    table = (rs.randn(rows, D) * 10).astype(np.float32)
    src = rs.randn(len(ids), D).astype(np.float32)
    src[len(ids) - pads:] = 0.0
    return table, ids, src


def _fold(table, ids, src, mode):
    """The TPU kernel's result in numpy: t + r_i + r_{i+1} + ... over each
    run in order, in float32 (add), or the run's first payload (set)."""
    out = table.copy()
    rows = len(table)
    cl = np.minimum(ids, rows - 1)
    i = 0
    while i < len(ids):
        j = i
        acc = out[cl[i]].copy() if mode == "add" else src[i].copy()
        while j < len(ids) and cl[j] == cl[i]:
            if mode == "add":
                acc = acc + src[j]
            j += 1
        out[cl[i]] = acc
        i = j
    return out


# runs of 1, 2, 33 and 1000 equal ids; 31 + 2 crosses a 32-entry slice,
# 1000 crosses many, 40 + 90 cross a 128-thread block's items
SCATTER_RUNS = {
    "ones-twos": [1] * 20 + [2] * 11 + [1] * 9,
    "run33": [3, 29, 33, 1, 1, 2],
    "run1000": [1, 2, 1000, 1, 2],
    "crossing": [31, 2, 30, 3, 40, 90, 1, 64, 32],
}


@pytest.mark.parametrize("mode", ["add", "set"])
@pytest.mark.parametrize("pad_alone", [False, True],
                         ids=["pads-after-run", "pads-alone"])
@pytest.mark.parametrize("D", [16, 64, 7])
@pytest.mark.parametrize("runs", list(SCATTER_RUNS))
def test_embedding_scatter_kernel_runs_bit_equal_numpy(dev, runs, D,
                                                       pad_alone, mode):
    """Inexact payloads, so the order of the adds shows: the kernel is
    bit-equal to an in-order float32 fold (add) or the first write (set),
    and to itself on a rerun."""
    rs = np.random.RandomState(len(SCATTER_RUNS[runs]) * D + pad_alone)
    table, ids, src = _runs_inputs(rs, 3000, D, SCATTER_RUNS[runs], 3,
                                   pad_alone)
    if mode == "set":          # pads carry the current last row
        src[len(ids) - 3:] = table[-1]
    want = _fold(table, ids, src, mode)
    t = torch.from_numpy(table).to(dev)
    i, r = torch.from_numpy(ids).to(dev), torch.from_numpy(src).to(dev)
    got = sparse_kernels.embedding_scatter(t.clone(), i, r, mode)
    again = sparse_kernels.embedding_scatter(t.clone(), i, r, mode)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got.cpu().numpy(), want)
    assert torch.equal(got, again)


def test_embedding_kernels_refuse_what_they_do_not_take(dev):
    from mxnet_tpu_torch.base import MXNetError
    table = torch.zeros(10, 4, device=dev)
    ids = torch.zeros(3, dtype=torch.int32, device=dev)
    rows = torch.zeros(3, 4, device=dev)
    for backend in ("plain", "xla", "pallas"):
        with pytest.raises(MXNetError):
            sparse_kernels.embedding_gather(table, ids, backend=backend)
        with pytest.raises(MXNetError):
            sparse_kernels.embedding_scatter(table, ids, rows, "set",
                                             backend=backend)
    with pytest.raises(MXNetError):      # f16, bf16 and f64 are taken
        sparse_kernels.embedding_gather(table.int(), ids)
    with pytest.raises(MXNetError):
        sparse_kernels.embedding_gather(table, ids.cpu())
    with pytest.raises(MXNetError):
        sparse_kernels.embedding_scatter(table, ids, rows[:2], "add")
    with pytest.raises(MXNetError):
        sparse_kernels.embedding_scatter(table.t().contiguous().t(), ids,
                                         rows, "add")
    with pytest.raises(MXNetError):
        sparse_kernels.embedding_gather(table, ids.float())


# B11: the embedding kernels at the table's dtype
B11_DTYPES = {"bf16": torch.bfloat16, "f16": torch.float16,
              "f64": torch.float64}
B11_CASES = [(1000, 16, 512), (2000, 64, 300), (77, 13, 40), (50, 1, 33),
             (20, 16, 1), (300, 7, 1200)]
B11_IDS = ["d16", "d64", "d13", "d1", "n1", "d7-runs"]


def _b11_inputs(dev, dtype, rows, D, n, seed, pads=3):
    """An inexact table in ``dtype``; sorted ids with runs of duplicates
    (long ones where n > rows), 0 and rows-1 among them, then ``pads``
    ids >= rows; inexact float32 payloads (rounded to the table's dtype
    by the wrapper), so the order of the adds shows."""
    rs = np.random.RandomState(seed)
    table = torch.from_numpy(rs.randn(rows, D) * 10).to(dtype)
    ids = rs.randint(0, rows, n)
    ids[0] = 0
    ids[-1] = rows - 1
    if n > 4:
        ids[1:4] = ids[2]
    ids = np.concatenate([np.sort(ids), rows + np.arange(pads)])
    src = torch.from_numpy(rs.randn(len(ids), D).astype(np.float32))
    return (table.to(dev), torch.from_numpy(ids.astype(np.int32)).to(dev),
            src.to(dev))


@pytest.mark.parametrize("aligned", [True, False],
                         ids=["aligned", "misaligned"])
@pytest.mark.parametrize("rows,D,n", B11_CASES, ids=B11_IDS)
@pytest.mark.parametrize("kind", list(B11_DTYPES))
def test_embedding_kernels_b11_match_plain(dev, kind, rows, D, n, aligned):
    """The gather, set and add at bf16, f16 and f64, exactly equal to the
    plain versions (the add folds each run in order, rounding to the
    table's dtype after every add), two launches bit-equal, each counted
    under its dtype; pads carry the no-op payloads."""
    dtype = B11_DTYPES[kind]
    table, ids, src = _b11_inputs(dev, dtype, rows, D, n, rows + D + n)
    if not aligned:
        table, src = _misaligned(table), _misaligned(src)
    ga = ids.clamp(max=rows - 1)
    before = dict(kernels.LAUNCHES)
    out = sparse_kernels.embedding_gather(table, ga)
    again = sparse_kernels.embedding_gather(table, ga)
    add_src = src.clone()
    add_src[n:] = 0.0
    set_src = src.to(dtype)
    set_src[n:] = table[rows - 1]
    got = {m: sparse_kernels.embedding_scatter(table.clone(), ids, s, m)
           for m, s in (("add", add_src), ("set", set_src))}
    rerun = {m: sparse_kernels.embedding_scatter(table.clone(), ids, s, m)
             for m, s in (("add", add_src), ("set", set_src))}
    torch.cuda.synchronize()
    assert out.dtype == dtype and torch.equal(out, again)
    assert torch.equal(out, sparse_kernels.embedding_gather_plain(table,
                                                                  ga))
    for m, s in (("add", add_src), ("set", set_src)):
        want = sparse_kernels.embedding_scatter_plain(table.clone(), ids, s,
                                                      m)
        assert got[m].dtype == dtype
        assert torch.equal(got[m], want), m
        assert torch.equal(got[m], rerun[m]), m
    assert kernels.LAUNCHES["embedding_gather"] == \
        before["embedding_gather"] + 2
    assert kernels.LAUNCHES["embedding_scatter_" + kind] == \
        before["embedding_scatter_" + kind] + 4
    assert kernels.LAUNCHES["embedding_scatter"] == \
        before["embedding_scatter"]


@pytest.mark.parametrize("geo", ["bench", "criteo"])
def test_embedding_gather_many_bf16_tables_with_f32_momentum(dev, geo):
    """The bf16 recommender's update gather: each table's bf16 rows and
    its float32 momentum rows in one launch, bit-equal to the plain
    version, each output in its buffer's dtype and 16-byte aligned."""
    rows, D, n, F = {"bench": (100000, 16, 4096, 4),
                     "criteo": (1000000, 64, 8192, 26)}[geo]
    gen = torch.Generator(device=dev).manual_seed(3)
    tabs = [torch.randn(rows, D, generator=gen, device=dev)
            .to(torch.bfloat16) for _ in range(2)]
    moms = [torch.randn(rows, D, generator=gen, device=dev)
            for _ in range(2)]
    rs = np.random.RandomState(3)
    bufs, ids = [], []
    for f in range(F):
        u = np.unique(rs.randint(0, rows, n))
        i = torch.from_numpy(np.concatenate(
            [u, np.full(n - len(u), rows - 1)]).astype(np.int32)).to(dev)
        bufs += [tabs[f % 2], moms[f % 2]]
        ids += [i, i]
    before = kernels.LAUNCHES["embedding_gather"]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        outs = sparse_kernels.embedding_gather_many(bufs, ids)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["embedding_gather"] == before + 1
    for out, b, want in zip(outs, bufs,
                            sparse_kernels.embedding_gather_many_plain(
                                bufs, ids)):
        assert out.dtype == b.dtype and out.data_ptr() % 16 == 0
        assert torch.equal(out, want)


def test_bf16_recommender_steps_on_card_match_cpu(dev):
    """Two steps of the recommender over bf16 tables on the card (two
    grouped gathers per step, each table's bf16 and momentum rows in the
    update's; a bf16 and a float32 scatter per table) against the same
    steps on the CPU: tables within one bf16 step of the CPU's per
    element plus 1e-3 of their largest update, momentum and MLP within
    1e-3 of their largest update, losses within 1e-5."""
    F, V, D, B = 3, 300, 16, 128
    state0, steps = None, {}
    rs = np.random.RandomState(2)
    batches = [{"ids": torch.from_numpy(rs.randint(0, V, (F, B))
                                        .astype(np.int32)),
                "dense": torch.from_numpy(rs.rand(B, 13).astype(np.float32)),
                "label": torch.from_numpy((rs.rand(B) > 0.5)
                                          .astype(np.float32))}
               for _ in range(2)]
    for d in ("cpu", dev):
        spec = MeshSpec(make_mesh((1,), ("dp",), device=d))
        embs = [ShardedEmbedding(V, D, spec, name="b%d" % f,
                                 dtype="bfloat16") for f in range(F)]
        if state0 is None:
            state0 = recommender_state(embs, dense_dim=13, seed=1)
        state = {k: (tuple(t.to(d, copy=True) for t in v)
                     if isinstance(v, tuple) else
                     {n: t.to(d, copy=True) for n, t in v.items()})
                 for k, v in state0.items()}
        step = make_recommender_step(embs, lr=0.05, momentum=0.9)
        losses = []
        for b in batches:
            b = {k: v.to(d) for k, v in b.items()}
            before = dict(kernels.LAUNCHES)
            if d != "cpu":
                torch.cuda.synchronize()
                torch.cuda.set_sync_debug_mode("error")
            try:
                state, loss = step(state, b)
            finally:
                if d != "cpu":
                    torch.cuda.set_sync_debug_mode(0)
            losses.append(float(loss))
            if d != "cpu":
                assert kernels.LAUNCHES["embedding_gather"] == \
                    before["embedding_gather"] + 2
                assert kernels.LAUNCHES["embedding_scatter_bf16"] == \
                    before["embedding_scatter_bf16"] + F
                assert kernels.LAUNCHES["embedding_scatter"] == \
                    before["embedding_scatter"] + F
        steps[str(d)] = (convert.recommender_state_to_numpy(state), losses)
    start = convert.recommender_state_to_numpy(state0)
    (cpu, l_cpu), (card, l_card) = steps["cpu"], steps[str(dev)]
    for a, b in zip(l_cpu, l_card):
        assert abs(a - b) <= 1e-5
    for i, (a, b) in enumerate(zip(cpu["tables"], card["tables"])):
        upd = np.abs(a - start["tables"][i]).max()
        step_bf16 = np.abs(a) * 2.0 ** -7
        assert (np.abs(a - b) <= step_bf16 + 1e-3 * upd).all(), i
    for part in ("moms",):
        for i, (a, b) in enumerate(zip(cpu[part], card[part])):
            upd = np.abs(a - start[part][i]).max()
            assert np.abs(a - b).max() <= 1e-3 * upd, (part, i)
    for part in ("mlp", "mlp_mom"):
        for k in cpu[part]:
            upd = np.abs(cpu[part][k] - start[part][k]).max()
            assert np.abs(cpu[part][k] - card[part][k]).max() <= 1e-3 * upd


def test_recommender_steps_on_card_match_cpu(dev):
    """Two steps of the recommender on the card (kernels, no host sync
    before the loss is read; two grouped gathers and two scatters per
    table each) against the same steps on the CPU (plain versions) from
    one state: every tensor within 1e-3 of its largest update, losses
    within 1e-5."""
    F, V, D, B = 3, 300, 16, 128
    state0, steps = None, {}
    rs = np.random.RandomState(2)
    batches = [{"ids": torch.from_numpy(rs.randint(0, V, (F, B))
                                        .astype(np.int32)),
                "dense": torch.from_numpy(rs.rand(B, 13).astype(np.float32)),
                "label": torch.from_numpy((rs.rand(B) > 0.5)
                                          .astype(np.float32))}
               for _ in range(2)]
    for d in ("cpu", dev):
        spec = MeshSpec(make_mesh((1,), ("dp",), device=d))
        embs = [ShardedEmbedding(V, D, spec, name="c%d" % f)
                for f in range(F)]
        if state0 is None:
            state0 = convert.recommender_state_to_numpy(
                recommender_state(embs, dense_dim=13, seed=1))
        state = convert.recommender_state_from_numpy(state0, d)
        step = make_recommender_step(embs, lr=0.05, momentum=0.9)
        losses = []
        for b in batches:
            b = {k: v.to(d) for k, v in b.items()}
            before = dict(kernels.LAUNCHES)
            if d != "cpu":
                torch.cuda.synchronize()
                torch.cuda.set_sync_debug_mode("error")
            try:
                state, loss = step(state, b)
            finally:
                if d != "cpu":
                    torch.cuda.set_sync_debug_mode(0)
            losses.append(float(loss))
            if d != "cpu":     # one grouped gather per lookup / update
                assert kernels.LAUNCHES["embedding_gather"] == \
                    before["embedding_gather"] + 2
                assert kernels.LAUNCHES["embedding_scatter"] == \
                    before["embedding_scatter"] + 2 * F
        steps[str(d)] = (convert.recommender_state_to_numpy(state), losses)
    (cpu, l_cpu), (card, l_card) = steps["cpu"], steps[str(dev)]
    for a, b in zip(l_cpu, l_card):
        assert abs(a - b) <= 1e-5
    for part in ("tables", "moms"):
        for i, (a, b) in enumerate(zip(cpu[part], card[part])):
            upd = np.abs(a - state0[part][i]).max()
            assert np.abs(a - b).max() <= 1e-3 * upd, (part, i)
    for part in ("mlp", "mlp_mom"):
        for k in cpu[part]:
            upd = np.abs(cpu[part][k] - state0[part][k]).max()
            assert np.abs(cpu[part][k] - card[part][k]).max() <= 1e-3 * upd


# the shapes of the LM's pushes (GPT-2-small), a tail, a one-element and
# a 1023-element vector
TWO_BIT_SHAPES = [(32768, 768), (3072, 768), (768, 3072), (768, 768),
                  (1024, 768), (32768,), (3072,), (768,), (1,), (1023,),
                  (25165827,)]


def _two_bit_inputs(dev, shape, seed, offset=0):
    rs = np.random.RandomState(seed)
    n = int(np.prod(shape))
    g = torch.from_numpy(rs.normal(0, 0.5, n + offset).astype(np.float32))
    r = torch.from_numpy(rs.normal(0, 0.2, n + offset).astype(np.float32))
    g, r = g.to(dev)[offset:], r.to(dev)[offset:]
    return g.reshape(shape), r.reshape(shape)


def _assert_two_bit_equal(g, r, t):
    q0, r0 = kernels.two_bit_compress_plain(g, r, t)
    before = kernels.LAUNCHES["two_bit_compress"]
    q, r1 = kernels.two_bit_compress(g, r.clone(), t)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["two_bit_compress"] == before + 1
    assert torch.equal(q, q0)
    nan = torch.isnan(r0)
    assert torch.equal(torch.isnan(r1), nan)
    assert torch.equal(r1[~nan], r0[~nan])


@pytest.mark.parametrize("shape", TWO_BIT_SHAPES,
                         ids=["x".join(map(str, s)) for s in TWO_BIT_SHAPES])
def test_two_bit_kernel_matches_plain(dev, shape):
    g, r = _two_bit_inputs(dev, shape, sum(shape))
    _assert_two_bit_equal(g, r, 0.5)


@pytest.mark.parametrize("threshold", [0.5, 0.3])
def test_two_bit_kernel_edges_and_misaligned_views(dev, threshold):
    """Threshold +- 1 ulp, NaN and +-inf, and views whose pointers are
    not 16-byte aligned (the scalar path)."""
    t32 = np.float32(threshold)
    edges = np.array([t32, np.nextafter(t32, np.float32(1)),
                      np.nextafter(t32, np.float32(0)), -t32, 0.0, np.nan,
                      np.inf, -np.inf], np.float32)
    r = torch.from_numpy(np.tile(edges, 129)).to(dev)
    _assert_two_bit_equal(torch.zeros_like(r), r, threshold)
    for offset in (1, 2, 3):
        g, r = _two_bit_inputs(dev, (4099,), offset, offset=offset)
        _assert_two_bit_equal(g, r, threshold)


def test_two_bit_kernel_refuses_what_it_does_not_take(dev):
    """An integer gradient, a residual of another dtype or shape, a
    residual on another device."""
    from mxnet_tpu_torch.base import MXNetError
    g = torch.zeros(8, 4, device=dev)
    with pytest.raises(MXNetError):
        kernels.two_bit_compress(g.int(), g.int())
    with pytest.raises(MXNetError):
        kernels.two_bit_compress(g.half(), g.clone())
    with pytest.raises(MXNetError):
        kernels.two_bit_compress(g.t(), torch.zeros(8, 4, device=dev))
    with pytest.raises(MXNetError):
        kernels.two_bit_compress(g, torch.zeros(8, 4))


# B10: the kernel over f16, bf16 and f64 gradients and strided ones
TWO_BIT_DTYPES = [torch.float16, torch.bfloat16, torch.float64]


def _two_bit_typed(dev, shape, dtype, seed, offset=0, edges=True):
    """g, r of ``dtype``, views ``offset`` elements into their buffers;
    with ``edges`` the residual's front holds the threshold's neighbours
    (+-1 ulp in f32 and in ``dtype``), NaN and +-inf under a zero g."""
    g, r = _two_bit_inputs(dev, shape, seed, offset=offset)
    g, r = g.to(dtype), r.to(dtype)
    if edges and r.numel() >= 12:
        t32 = np.float32(0.5)
        e = torch.tensor([t32, np.nextafter(t32, np.float32(1)),
                          np.nextafter(t32, np.float32(0)), -t32, 0.0,
                          np.nan, np.inf, -np.inf], device=dev).to(dtype)
        lo = torch.tensor([0.5], device=dev).to(dtype)
        e = torch.cat([e, torch.nextafter(lo, lo + 1), torch.nextafter(
            lo, lo - 1), -torch.nextafter(lo, lo + 1), 65504.0 * lo])
        r.view(-1)[:12] = e
        g.view(-1)[:12] = 0
    return g, r


@pytest.mark.parametrize("dtype", TWO_BIT_DTYPES,
                         ids=["f16", "bf16", "f64"])
@pytest.mark.parametrize("shape", [(768, 768), (3072,), (1023,), (1,),
                                   (25165827,)],
                         ids=["768x768", "3072", "1023", "1", "25M"])
def test_two_bit_kernel_matches_plain_in_every_dtype(dev, dtype, shape):
    """q and the new residual bit-equal to the plain version (NaN where
    it has NaN), in the gradient's dtype, one launch of that dtype's
    entry point; aligned, and misaligned by 1-3 elements."""
    for offset in (0, 1, 3):
        g, r = _two_bit_typed(dev, shape, dtype, sum(shape) + offset,
                              offset)
        q0, r0 = kernels.two_bit_compress_plain(g, r, 0.5)
        name = "two_bit_compress" + kernels._TWO_BIT_DTYPES[dtype]
        before = dict(kernels.LAUNCHES)
        q, r1 = kernels.two_bit_compress(g, r.clone(), 0.5)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES[name] == before[name] + 1
        assert all(kernels.LAUNCHES[n] == before[n] for n in before
                   if n != name)
        assert q.dtype == r1.dtype == dtype and q.shape == g.shape
        assert torch.equal(q, q0)
        nan = torch.isnan(r0)
        assert torch.equal(torch.isnan(r1), nan)
        assert torch.equal(r1[~nan], r0[~nan])


def test_two_bit_kernel_compresses_strided_gradients(dev):
    """A transposed gradient and a residual that is a strided view: q of
    the gradient's shape, the residual updated in place, both as the
    plain version gives them, over three pushes."""
    for dtype in (torch.float32, torch.float16):
        base = torch.randn(100, 96, device=dev, dtype=torch.float32)
        r = torch.zeros(200, 96, device=dev, dtype=dtype)[::2, :].t()
        r_want = r.clone()
        for i in range(3):
            g = (base * (i + 1) * 0.2).to(dtype).t()
            assert not g.is_contiguous() and not r.is_contiguous()
            q0, r_want = kernels.two_bit_compress_plain(g, r_want, 0.5)
            q, r1 = kernels.two_bit_compress(g, r, 0.5)
            assert r1 is r and q.shape == g.shape
            assert torch.equal(q, q0) and torch.equal(r, r_want)


def test_two_bit_many_kernel_over_mixed_dtypes(dev):
    """One push of f32, f16, bf16 and f64 keys, misaligned views among
    them: bit-equal per key, one launch per dtype, no host sync."""
    rs = np.random.RandomState(9)
    gs, rs_ = [], []
    for i in range(40):
        dtype = [torch.float32, torch.float16, torch.bfloat16,
                 torch.float64][i % 4]
        n = int(rs.randint(1, 5000))
        g, r = _two_bit_typed(dev, (n,), dtype, i, offset=i % 3,
                              edges=i % 5 == 0)
        gs.append(g)
        rs_.append(r)
    want_q, want_r = kernels.two_bit_compress_many_plain(gs, rs_, 0.5)
    before = dict(kernels.LAUNCHES)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        qs = kernels.two_bit_compress_many(gs, rs_, 0.5)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    for suffix in kernels._TWO_BIT_DTYPES.values():
        n = "two_bit_compress" + suffix
        assert kernels.LAUNCHES[n] == before[n] + 1
    for g, r, q, q0, r0 in zip(gs, rs_, qs, want_q, want_r):
        assert q.dtype == g.dtype and q.shape == g.shape
        assert torch.equal(q, q0)
        nan = torch.isnan(r0)
        assert torch.equal(torch.isnan(r), nan)
        assert torch.equal(r[~nan], r0[~nan])


# the LM's pushes per Module.fit step (GPT-2-small, 198 keys), as
# chip_smoke.py's TWO_BIT_PUSHES: (shape, keys of that shape)
LM_PUSHES = [((32768, 768), 2), ((3072, 768), 12), ((768, 3072), 12),
             ((768, 768), 48), ((1024, 768), 1), ((32768,), 1),
             ((3072,), 12), ((768,), 110)]


def _view(dev, n, offset, gen, scale):
    """n normal values times ``scale``, a view ``offset`` floats into its
    buffer (not 16-byte aligned when ``offset`` % 4)."""
    return (torch.randn(n + offset, generator=gen, device=dev)
            * scale)[offset:]


def _two_bit_segments(dev, shapes, threshold, seed):
    """Grads and residuals of ``shapes``; pair i a view i % 4 floats into
    its buffers (three of four misaligned), the edge values of the
    threshold (+-1 ulp, NaN, +-inf) at the front of every eighth
    residual, with a zero gradient."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    t32 = np.float32(threshold)
    edges = torch.tensor([t32, np.nextafter(t32, np.float32(1)),
                          np.nextafter(t32, np.float32(0)), -t32, 0.0,
                          np.nan, np.inf, -np.inf], device=dev)
    gs, rs_ = [], []
    for i, shape in enumerate(shapes):
        n = int(np.prod(shape))
        g = _view(dev, n, i % 4, gen, 0.5)
        r = _view(dev, n, (i + 1) % 4, gen, 0.2)
        if i % 8 == 0 and n:
            m = min(n, edges.numel())
            g[:m] = 0.0
            r[:m] = edges[:m]
        gs.append(g.view(shape))
        rs_.append(r.view(shape))
    return gs, rs_


def _assert_many_equal(gs, rs_, threshold):
    """The grouped kernel against its plain version, exactly, with no
    host sync; returns the launches it counted."""
    want_q, want_r = kernels.two_bit_compress_many_plain(gs, rs_, threshold)
    before = kernels.LAUNCHES["two_bit_compress"]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        qs = kernels.two_bit_compress_many(gs, rs_, threshold)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    for g, r, q, q0, r0 in zip(gs, rs_, qs, want_q, want_r):
        assert q.shape == g.shape and q.data_ptr() % 16 == 0
        assert torch.equal(q, q0)
        nan = torch.isnan(r0)
        assert torch.equal(torch.isnan(r), nan)
        assert torch.equal(r[~nan], r0[~nan])
    return kernels.LAUNCHES["two_bit_compress"] - before


@pytest.mark.parametrize("threshold", [0.5, 0.3])
def test_two_bit_many_kernel_over_the_lm_push(dev, threshold):
    """All 198 keys of the LM's push and n = 0, 1, 3, 1023 in one call,
    most of them misaligned views: bit-equal to the plain version per
    key, ceil(non-empty keys / segments per launch) launches."""
    shapes = [s for s, k in LM_PUSHES for _ in range(k)]
    shapes += [(0,), (1,), (3,), (1023,), (0, 7)]
    gs, rs_ = _two_bit_segments(dev, shapes, threshold, 3)
    per = kernels.two_bit_segments_per_launch()
    assert per >= 80
    want = -(-(len(shapes) - 2) // per)
    assert _assert_many_equal(gs, rs_, threshold) == want


def test_two_bit_many_kernel_beyond_one_launch(dev):
    """More keys than one launch's parameters hold: the next launch takes
    the rest, and every key is still exact."""
    per = kernels.two_bit_segments_per_launch()
    rs = np.random.RandomState(6)
    shapes = [(int(n),) for n in rs.randint(1, 3000, per + 7)]
    gs, rs_ = _two_bit_segments(dev, shapes, 0.3, 4)
    assert _assert_many_equal(gs, rs_, 0.3) == 2


def test_two_bit_many_kernel_refuses_what_it_does_not_take(dev):
    from mxnet_tpu_torch.base import MXNetError
    g = torch.zeros(8, 4, device=dev)
    before = kernels.LAUNCHES["two_bit_compress"]
    for gs, rs_ in (([g, g.double()], [g.clone(), g.float()]),
                    ([g, g.int()], [g.clone(), g.int()]),
                    ([g, g], [g.clone(), torch.zeros(8, 4)]),
                    ([g, g], [g.clone(), g.clone()[:4]])):
        with pytest.raises(MXNetError):
            kernels.two_bit_compress_many(gs, rs_, 0.5)
    r = torch.zeros(8, 4, device=dev)
    with pytest.raises(MXNetError):
        kernels.two_bit_compress_many([g, g], [r, r], 0.5)
    assert kernels.LAUNCHES["two_bit_compress"] == before


# chip_smoke.py's recommender geometries: (rows, D, n, tables)
GATHER_GEOS = {"bench": (100000, 16, 4096, 4),
               "criteo": (1000000, 64, 8192, 26)}


def _gather_segments(dev, rows, D, n, count, seed):
    """``count`` segments at (rows, D, n) over four distinct tables
    (segments share them cyclically: a gather only reads), sorted unique
    ids + pads clamped into range as the update's, and three segments of
    other widths: D 7 and 13 over misaligned tables, and an empty one."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    tables = [torch.randn(rows, D, generator=gen, device=dev)
              for _ in range(min(count, 4))]
    rs = np.random.RandomState(seed)
    segs = []
    for i in range(count):
        u = np.unique(rs.randint(0, rows, n))
        ids = np.concatenate([u, np.full(n - len(u), rows - 1)])
        segs.append((tables[i % len(tables)],
                     torch.from_numpy(ids.astype(np.int32)).to(dev)))
    for Dx, nx in ((7, 300), (13, 1), (16, 0)):
        t = _misaligned(torch.randn(997, Dx, generator=gen, device=dev))
        ids = torch.from_numpy(rs.randint(-5, 1002, nx).astype(np.int32))
        segs.append((t, ids.to(dev)))
    return segs


def _assert_gather_many_equal(segs):
    tables, ids = [t for t, _ in segs], [i for _, i in segs]
    before = kernels.LAUNCHES["embedding_gather"]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        outs = sparse_kernels.embedding_gather_many(tables, ids)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    for out, want in zip(outs, sparse_kernels.embedding_gather_many_plain(
            tables, ids)):
        assert out.data_ptr() % 16 == 0
        assert torch.equal(out, want)
    return kernels.LAUNCHES["embedding_gather"] - before


@pytest.mark.parametrize("per_table", [1, 2], ids=["lookup", "update"])
@pytest.mark.parametrize("geo", list(GATHER_GEOS))
def test_embedding_gather_many_kernel_at_step_shapes(dev, geo, per_table):
    """The recommender step's grouped gathers (4 and 8 segments at the
    bench geometry, 26 and 52 at the Criteo shape) with segments of D 7
    and 13 over misaligned tables, ids out of range and an empty segment
    beside them: bit-equal to the plain version, one launch, no host
    sync."""
    rows, D, n, F = GATHER_GEOS[geo]
    segs = _gather_segments(dev, rows, D, n, per_table * F, 9)
    per = sparse_kernels.embedding_segments_per_launch()
    assert per >= 80
    assert _assert_gather_many_equal(segs) == 1


def test_embedding_gather_many_kernel_beyond_one_launch(dev):
    per = sparse_kernels.embedding_segments_per_launch()
    segs = _gather_segments(dev, 500, 16, 40, per + 2, 10)
    assert _assert_gather_many_equal(segs) == 2


def test_kvstore_push_on_card_runs_the_kernel(dev, monkeypatch):
    """A compressing push on the card launches B7 once per push and never
    reaches the plain version."""
    from mxnet_tpu_torch import kvstore, nd

    def refuse(*a, **k):
        raise AssertionError("the plain version ran on the card")

    monkeypatch.setattr(kernels, "two_bit_compress_plain", refuse)
    kv = kvstore.create("device")
    assert kv.device.type == "cuda"
    kv.set_gradient_compression({"type": "2bit", "threshold": 0.5})
    w = nd.array(np.ones((64, 3), np.float32))
    kv.init("w", w)
    before = kernels.LAUNCHES["two_bit_compress"]
    g = nd.array(np.full((64, 3), 0.7, np.float32))
    kv.push("w", g)
    out = nd.zeros((64, 3))
    kv.pull("w", out=out)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["two_bit_compress"] == before + 1
    assert (out.asnumpy() == 0.5).all()
    assert (w.asnumpy() == 1.0).all()


def test_module_without_a_context_lands_on_the_card(dev):
    import mxnet_tpu_torch as mx
    net = mx.sym.FullyConnected(mx.sym.Variable("data"), num_hidden=4,
                                name="fc")
    net = mx.sym.SoftmaxOutput(net, name="softmax")
    mod = mx.mod.Module(net)
    mod.bind(data_shapes=[("data", (8, 5))],
             label_shapes=[("softmax_label", (8,))])
    mod.init_params()
    ex = mod._exec_group.execs[0]
    assert all(a.handle.device.type == "cuda" for a in ex.arg_arrays)
    assert mx.current_context().device_type == "gpu"


@pytest.mark.parametrize("policy", ["dots", "dots_no_batch", "full"])
def test_remat_gradients_on_card_equal_none(dev, policy):
    """A small LM on the flash path (T 128, every layer through B1/B2a/
    B2b) on the card: one forward and backward under each remat policy
    against 'none' from the same state.  The recompute relaunches B1 with
    the same inputs, so the gradients are the same bits; B2a/B2b launch
    once per layer either way."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.executor import set_backward_mirror
    from mxnet_tpu_torch.models.transformer import get_symbol
    net = get_symbol(vocab_size=64, seq_len=128, num_layers=2, hidden=64,
                     heads=2, flash_min_seq=128)
    shapes = {"data": (2, 128), "softmax_label": (2, 128)}
    rs = np.random.RandomState(0)
    vals = {n: (rs.randint(0, 64, s) if n in shapes else
                rs.normal(0, 0.1, s)).astype(np.float32)
            for n, s in zip(net.list_arguments(),
                            net.infer_shape(**shapes)[0])}
    grads, launches = {}, {}
    try:
        for p in ("none", policy):
            set_backward_mirror(p)
            ex = net.simple_bind(mx.gpu(), **shapes)
            for n, v in vals.items():
                ex.arg_dict[n][:] = mx.nd.array(v)
            kernels.reset_launches()
            ex.forward(is_train=True)
            ex.backward()
            torch.cuda.synchronize()
            launches[p] = dict(kernels.LAUNCHES)
            grads[p] = {n: g.asnumpy() for n, g in ex.grad_dict.items()
                        if g is not None}
    finally:
        set_backward_mirror(None)
    assert launches["none"]["flash_attention_fwd"] == 2
    assert launches[policy]["flash_attention_fwd"] == 4
    for key in ("flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
        assert launches["none"][key] == launches[policy][key] == 2
    for n, want in grads["none"].items():
        np.testing.assert_allclose(grads[policy][n], want, rtol=1e-5,
                                   atol=1e-6, err_msg=n)


# ---------------------------------------------------------------------------
# autograd and Gluon on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("marked", ["qkv", "q"], ids=["qkv", "q-only"])
def test_fused_attention_under_autograd_runs_the_kernels(dev, marked):
    """``nd.contrib.fused_attention`` under ``autograd.record`` at T 128
    (``flash_min_seq`` 128): one launch each of B1, B2a and B2b, the
    output and the marked arrays' gradients against the plain versions on
    the same card (phase 6's tolerances: out 1e-5 absolute, gradients
    1e-4 x max(1, max|ref|))."""
    import mxnet_tpu_torch as mx
    rs = np.random.RandomState(11)
    host = [rs.randn(2, 128, 4, 32).astype(np.float32) for _ in range(4)]
    q, k, v, do = [mx.nd.array(a, ctx=mx.gpu()) for a in host]
    named = dict(q=q, k=k, v=v)
    bufs = [mx.nd.zeros(named[n].shape, ctx=mx.gpu()) for n in marked]
    mx.autograd.mark_variables([named[n] for n in marked], bufs)
    kernels.reset_launches()
    with mx.autograd.record():
        o = mx.nd.contrib.fused_attention(q, k, v, causal=True,
                                          flash_min_seq=128)
    o.backward(do)
    torch.cuda.synchronize()
    for key in ("flash_attention_fwd", "flash_attention_bwd_dq",
                "flash_attention_bwd_dkv"):
        assert kernels.LAUNCHES[key] == 1, (key, dict(kernels.LAUNCHES))
    tq, tk, tv, tdo = (torch.from_numpy(a).to(dev) for a in host)
    ref, lse = kernels.flash_attention_fwd_plain(tq, tk, tv, True)
    refs = dict(zip("qkv", kernels.flash_attention_bwd_plain(
        tq, tk, tv, ref, lse, tdo, True)))
    assert (o._handle - ref).abs().max().item() <= 1e-5
    for n, buf in zip(marked, bufs):
        want = refs[n]
        tol = 1e-4 * max(1.0, want.abs().max().item())
        assert (buf._handle - want).abs().max().item() <= tol, n


def test_hybridized_block_gradients_on_card_match_cpu(dev):
    """A hybridized Dense/BatchNorm block trained one recorded forward and
    backward on the card and on the CPU from the same weights: outputs,
    the parameters' gradients and the moving statistics within 1e-4 of
    each tensor's largest magnitude (f32 both sides, cuBLAS/cuDNN vs the
    CPU's kernels)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon import nn

    def make():
        with mx.name.NameManager():
            net = nn.HybridSequential()
            with net.name_scope():
                # the Dense before the BatchNorm has a ReLU between them:
                # a bias straight before a BatchNorm gets no gradient
                net.add(nn.Dense(16, in_units=12, activation="relu"),
                        nn.BatchNorm(in_channels=16),
                        nn.Dense(5, in_units=16))
        return net

    rs = np.random.RandomState(12)
    x = rs.randn(8, 12).astype(np.float32)
    cot = rs.randn(8, 5).astype(np.float32)
    mx.random.seed(0)
    cpu_net = make()
    cpu_net.initialize(mx.init.Xavier(), ctx=mx.cpu())
    arrays = {k: p.data().asnumpy()
              for k, p in cpu_net.collect_params().items()}
    got = {}
    for ctx, net in ((mx.cpu(), cpu_net), (mx.gpu(), make())):
        if ctx.device_type == "gpu":
            convert.gluon_params_from_numpy(net.collect_params(), arrays,
                                            ctx=ctx)
        net.hybridize()
        with mx.autograd.record():
            out = net(mx.nd.array(x, ctx=ctx))
        out.backward(mx.nd.array(cot, ctx=ctx))
        got[ctx.device_type] = dict(
            out=out.asnumpy(),
            **{k: (p.grad() if p.grad_req != "null" else p.data()).asnumpy()
               for k, p in net.collect_params().items()})
    for k, want in got["cpu"].items():
        scale = max(np.abs(want).max(), 1e-6)
        assert np.abs(got["gpu"][k] - want).max() <= 1e-4 * scale, k


# ---------------------------------------------------------------------------
# the imperative slice: rtc.CudaModule (B8) and mx.nd on the card
# ---------------------------------------------------------------------------

_RTC = {}


def _rtc_module(options=("--fmad=false",)):
    """One CudaModule of the user kernels per option set (compiled once)."""
    from mxnet_tpu_torch import rtc
    import torch_cases as tc
    if options not in _RTC:
        _RTC[options] = rtc.CudaModule(tc.rtc_source(), options=options)
    return _RTC[options]


@pytest.mark.parametrize("shape", [(8, 128), (1000, 3), (1,)],
                         ids=["8x128", "ragged-3000", "n1"])
@pytest.mark.parametrize("name", ["axpy", "doubled", "split_sign", "ident",
                                  "axpy_inplace", "sgd_mom"])
def test_rtc_user_kernel_equals_plain(dev, name, shape):
    """Each user kernel, compiled by NVRTC with --fmad=false, equals its
    plain PyTorch version bit for bit; one launch counted."""
    import mxnet_tpu_torch as mx
    import torch_cases as tc
    mod = _rtc_module()
    k = mod.get_kernel(name, tc.RTC_SIGNATURES[name])
    t = tc.rtc_arrays(name, shape, sum(shape), dev)
    want = tc.rtc_plain(name, {a: v.clone() for a, v in t.items()})
    before = kernels.LAUNCHES["rtc"]
    tc.rtc_launch(k, name, t, mx.gpu(0))
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["rtc"] == before + 1
    for arg, v in want.items():
        assert torch.equal(t[arg], v), (name, arg)


def test_rtc_errors(dev):
    """A CPU context, a wrong dtype, a non-contiguous array, an array on
    the CPU, a refused launch (2048 threads), a failed compile and a
    missing kernel each raise MXNetError; none launches."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import rtc
    from mxnet_tpu_torch.base import MXNetError
    import torch_cases as tc
    k = _rtc_module().get_kernel("ident", tc.RTC_SIGNATURES["ident"])
    x = mx.nd.NDArray(torch.randn(8, 128, device=dev))
    o = mx.nd.NDArray(torch.zeros(8, 128, device=dev))
    good = ((4, 1, 1), (256, 1, 1))
    before = kernels.LAUNCHES["rtc"]
    bad = [
        ([x, o, 1024], mx.cpu(), good),
        ([mx.nd.NDArray(x.handle.double()), o, 1024], mx.gpu(0), good),
        ([mx.nd.NDArray(x.handle.t()), o, 1024], mx.gpu(0), good),
        ([mx.nd.NDArray(x.handle.cpu()), o, 1024], mx.gpu(0), good),
        ([x, o, x], mx.gpu(0), good),
        ([x, o, 1024], mx.gpu(0), ((4, 1, 1), (2048, 1, 1))),
    ]
    for args, ctx, (grid, block) in bad:
        with pytest.raises(MXNetError):
            k.launch(args, ctx, grid, block)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["rtc"] == before
    with pytest.raises(MXNetError, match="compile"):
        rtc.CudaModule('extern "C" __global__ void k(float *x) { x[0] = y; }')
    with pytest.raises(MXNetError, match="nope"):
        _rtc_module().get_kernel("nope", "float *x")
    # the module still launches after the refused calls
    k.launch([x, o, 1024], mx.gpu(0), *good)
    torch.cuda.synchronize()
    assert torch.equal(o.handle, x.handle)


def test_rtc_exports_and_large_shared_memory(dev):
    """A template kernel found through ``exports`` (its lowered name), and
    a launch with 64 KB of dynamic shared memory (above the 48 KB that
    needs cuFuncSetAttribute)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import rtc
    src = r'''
    template <typename T> __global__ void scale(T *x, T a, int n) {
      int i = blockIdx.x * blockDim.x + threadIdx.x;
      if (i < n) x[i] = x[i] * a;
    }
    extern "C" __global__ void reverse_block(const float *x, float *y) {
      extern __shared__ float buf[];
      int n = 16384, t = threadIdx.x;
      for (int i = t; i < n; i += blockDim.x) buf[i] = x[i];
      __syncthreads();
      for (int i = t; i < n; i += blockDim.x) y[i] = buf[n - 1 - i];
    }'''
    mod = rtc.CudaModule(src, exports=("scale<float>", "scale<double>"))
    x = torch.arange(1000, dtype=torch.float64, device=dev)
    k = mod.get_kernel("scale<double>", "double *x, double a, int n")
    k.launch([mx.nd.NDArray(x), 0.5, 1000], mx.gpu(0), (4, 1, 1),
             (256, 1, 1))
    y = torch.randn(16384, device=dev)
    out = torch.empty_like(y)
    r = mod.get_kernel("reverse_block", "const float *x, float *y")
    r.launch([mx.nd.NDArray(y), mx.nd.NDArray(out)], mx.gpu(0), (1, 1, 1),
             (512, 1, 1), shared_mem=16384 * 4)
    torch.cuda.synchronize()
    assert torch.equal(x, torch.arange(1000, dtype=torch.float64,
                                       device=dev) * 0.5)
    assert torch.equal(out, y.flip(0))


def test_nd_ops_on_card_match_cpu(dev):
    """Every op case of the five op modules through mx.nd on the card and
    on the CPU from the same numpy inputs, within its tolerance; random
    ops by shape, dtype and same-seed reproducibility on the card."""
    import torch_cases as tc
    for key in sorted(tc.OP_CASES):
        _, case = tc.op_case(key)
        card = tc.run_port(key, dev)
        cpu = tc.run_port(key, "cpu")
        assert len(card) == len(cpu), key
        for c, h in zip(card, cpu):
            if case["random"]:
                assert c.shape == h.shape and c.dtype == h.dtype, key
            else:
                tc.compare(c, h, max(case["tol"], tc.ARITH)
                           if case["tol"] else 0.0)
        if case["random"]:
            again = tc.run_port(key, dev)
            for a, b in zip(card, again):
                np.testing.assert_array_equal(a, b)


def test_div_scalar_on_card_is_correctly_rounded(dev):
    """C26: ``_div_scalar`` and ``_rdiv_scalar`` of float32 data on the
    card give the float32 rounding of the exact quotient, as the JAX op
    does.  The port divides by a 0-d tensor on the card; a Python scalar
    divisor would let ATen multiply by its reciprocal there.  Prints how
    many quotients ``x / s`` with a Python ``s`` gets wrong on the
    card."""
    from mxnet_tpu_torch.ops.registry import get_op
    x = np.random.RandomState(0).uniform(0.1, 100, 20000).astype(np.float32)
    t = torch.from_numpy(x).to(dev)
    x64 = x.astype(np.float64)
    for name, s, exact in (("_div_scalar", 3.0, x64 / 3.0),
                           ("_div_scalar", 0.1, x64 / np.float64(
                               np.float32(0.1))),
                           ("_rdiv_scalar", 3.0, 3.0 / x64)):
        op = get_op(name)
        got = op.fn(op.parse_attrs({"scalar": s}), t).cpu().numpy()
        np.testing.assert_array_equal(got, exact.astype(np.float32), name)
    raw = (t / 3.0).cpu().numpy()
    print("torch's x / 3.0 on the card: %d of %d quotients not correctly "
          "rounded" % ((raw != (x64 / 3.0).astype(np.float32)).sum(),
                       x.size))


def test_out_of_range_ids_on_card_do_not_assert(dev):
    """Embedding, pick and batch_take with ids below -n and at or past n:
    NaN where the CPU gives NaN, no device assert (which would end the
    process's CUDA context), and the card still answers afterwards."""
    import mxnet_tpu_torch as mx
    w = np.arange(12, dtype=np.float32).reshape(3, 4)
    ids = np.array([-1, 5, 1, -4, 3], np.float32)
    outs = []
    for ctx in (mx.gpu(0), mx.cpu()):
        wt, it = mx.nd.array(w, ctx=ctx), mx.nd.array(ids, ctx=ctx)
        outs.append([
            mx.nd.Embedding(it, wt, input_dim=3, output_dim=4).asnumpy(),
            mx.nd.pick(wt, it[:3], axis=1).asnumpy(),
            mx.nd.batch_take(wt, it[:3]).asnumpy()])
    torch.cuda.synchronize()
    for c, h in zip(*outs):
        np.testing.assert_array_equal(c, h)       # NaN where NaN
    assert np.isnan(outs[0][0][1]).all() and (outs[0][0][0] == w[2]).all()
    assert torch.ones(4, device=dev).sum().item() == 4.0


def test_nd_save_load_on_card(dev, tmp_path):
    """Arrays on the card save to the same bytes as their CPU copies and
    load back onto the card bit for bit."""
    import mxnet_tpu_torch as mx
    rs = np.random.RandomState(5)
    host = {"w": rs.randn(64, 33).astype(np.float32),
            "i": rs.randint(-9, 9, size=(7,)).astype(np.int64),
            "h": rs.randn(3, 2).astype(np.float16)}
    on_card = {k: mx.nd.array(v, ctx=mx.gpu(0)) for k, v in host.items()}
    f_card, f_cpu = str(tmp_path / "card.params"), str(tmp_path / "cpu.params")
    mx.nd.save(f_card, on_card)
    mx.nd.save(f_cpu, {k: mx.nd.array(v, ctx=mx.cpu())
                       for k, v in host.items()})
    assert open(f_card, "rb").read() == open(f_cpu, "rb").read()
    back = mx.nd.load(f_card)
    for k, v in host.items():
        assert back[k].context == mx.gpu(0)
        np.testing.assert_array_equal(back[k].asnumpy(), v)


# -- the RNN op on cuDNN ------------------------------------------------------

def _rnn_inputs(dev, mode, layers, bidir, dtype, seed, T=7, N=5, C=12, H=16):
    from mxnet_tpu_torch.ops import rnn as trnn
    g = torch.Generator().manual_seed(seed)
    d = 2 if bidir else 1
    ins = [torch.randn(T, N, C, generator=g, dtype=torch.float64),
           torch.randn(trnn.rnn_param_size(layers, C, H, bidir, mode),
                       generator=g, dtype=torch.float64) * 0.3,
           torch.randn(layers * d, N, H, generator=g, dtype=torch.float64)]
    if mode == "lstm":
        ins.append(torch.randn(layers * d, N, H, generator=g,
                               dtype=torch.float64))
    return [t.to(dev, dtype) for t in ins], (layers, C, H, bidir)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("layers,bidir", [(1, False), (2, True)])
@pytest.mark.parametrize("mode", ["lstm", "gru", "rnn_tanh", "rnn_relu"])
def test_rnn_op_runs_cudnn_and_matches_its_plain_loop(dev, mode, layers,
                                                      bidir, dtype):
    """The op on CUDA tensors runs cuDNN (never the plain loop), and its
    outputs and gradients equal the plain loop's on the same tensors."""
    from mxnet_tpu_torch.ops import rnn as trnn
    from mxnet_tpu_torch.ops.registry import get_op
    ins, (L, C, H, bi) = _rnn_inputs(dev, mode, layers, bidir, dtype, 3)
    torch.backends.cudnn.allow_tf32 = True       # the op turns it off
    op = get_op("RNN")
    attrs = op.parse_attrs(dict(state_size=H, num_layers=L, mode=mode,
                                bidirectional=bi, state_outputs=True))

    def run(fn):
        leaves = [t.clone().requires_grad_() for t in ins]
        outs = fn(leaves)
        cots = [torch.ones_like(o) for o in outs]
        return [o.detach() for o in outs], \
            torch.autograd.grad(outs, leaves, cots)

    def plain(leaves):
        w = trnn._unpack(leaves[1], L, C, H, bi, mode)
        out = trnn.rnn_plain(mode, leaves[0], w, leaves[2],
                             leaves[3] if mode == "lstm" else None)
        return out if mode == "lstm" else out[:2]

    trnn.CALLS.update(cudnn=0, plain=0)
    try:
        got = run(lambda leaves: op.fn(attrs, None, *leaves))
        assert trnn.CALLS == {"cudnn": 1, "plain": 0}
        assert not torch.backends.cudnn.allow_tf32 or dtype != torch.float32
    finally:
        torch.backends.cudnn.allow_tf32 = False
    want = run(plain)
    # cuDNN's f32 recurrences round in their own order over T steps
    tol = 1e-10 if dtype == torch.float64 else 1e-4
    for a, b in zip(got[0] + list(got[1]), want[0] + list(want[1])):
        assert (a - b).abs().max().item() <= tol * max(1.0, b.abs().max()
                                                       .item())


def test_rnn_op_gradient_under_predict_mode_recording(dev):
    """cuDNN's backward needs its forward in training mode: a recording
    with ``train_mode=False`` still differentiates (the op passes
    ``train=True`` to cuDNN when a gradient is wanted), without dropout."""
    import mxnet_tpu_torch as mx
    ins, (L, C, H, bi) = _rnn_inputs(dev, "lstm", 2, False, torch.float64,
                                     4)
    grads = []
    for ctx in (mx.gpu(0), mx.cpu()):
        with ctx:
            a = [mx.nd.array(t.cpu().numpy(), dtype="float64") for t in ins]
            for v in a[:2]:
                v.attach_grad()
            with mx.autograd.record(train_mode=False):
                out = mx.nd.RNN(*a, state_size=H, num_layers=L, mode="lstm",
                                p=0.5)
            out.backward()
            grads.append([v.grad.asnumpy() for v in a[:2]])
    for g, w in zip(*grads):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-10)


def test_rnn_op_dropout_on_card_follows_the_seed(dev):
    """Between-layer dropout on the card draws from the op's generator
    (``mx.random.seed``), one cuDNN call per layer: the same seed gives
    the same output, the plain loop's draw from the same seed equals it,
    and cuDNN's own dropout (torch's default generator) is never used."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import rnn as trnn
    from mxnet_tpu_torch.ops.registry import get_op
    from mxnet_tpu_torch.rng import next_generator
    ins, (L, C, H, bi) = _rnn_inputs(dev, "gru", 2, True, torch.float32, 5)
    op = get_op("RNN")
    attrs = op.parse_attrs(dict(state_size=H, num_layers=L, mode="gru",
                                bidirectional=bi, p=0.4))
    attrs["_train"] = True
    outs = []
    for seed, torch_seed in ((1, 10), (1, 11), (2, 10)):
        mx.random.seed(seed)
        torch.manual_seed(torch_seed)
        outs.append(op.fn(attrs, None, *ins))
    assert torch.equal(outs[0], outs[1]) and not torch.equal(outs[0],
                                                             outs[2])
    mx.random.seed(1)
    w = trnn._unpack(ins[1], L, C, H, bi, "gru")
    ref = trnn.rnn_plain("gru", ins[0], w, ins[2], None, p=0.4, train=True,
                         gen=next_generator(dev))[0]
    assert (outs[0] - ref).abs().max().item() <= 2e-5


def test_rnn_op_bf16_runs_cudnn_in_f32(dev):
    from mxnet_tpu_torch.ops import rnn as trnn
    from mxnet_tpu_torch.ops.registry import get_op
    ins, (L, C, H, bi) = _rnn_inputs(dev, "lstm", 2, True, torch.bfloat16,
                                     6)
    op = get_op("RNN")
    attrs = op.parse_attrs(dict(state_size=H, num_layers=L, mode="lstm",
                                bidirectional=bi))
    trnn.CALLS.update(cudnn=0, plain=0)
    got = op.fn(attrs, None, *ins)
    assert got.dtype == torch.bfloat16 and trnn.CALLS["cudnn"] == 1
    f32 = [t.float() for t in ins]
    w = trnn._unpack(f32[1], L, C, H, bi, "lstm")
    ref = trnn.rnn_plain("lstm", f32[0], w, f32[2], f32[3])[0]
    assert (got.float() - ref).abs().max().item() <= 2 ** -8


# -- greedy NMS (csrc/nms.cu) -------------------------------------------------

def _nms_boxes(seed, B, n, dtype, dev):
    rs = np.random.RandomState(seed)
    centre = rs.uniform(0.3, 0.7, (B, n, 2))
    half = rs.uniform(0.02, 0.25, (B, n, 2))
    boxes = np.concatenate([centre - half, centre + half], -1)
    return torch.from_numpy(boxes).to(dev, dtype)


def _nms_plain(boxes, thresh, ids, valid):
    """The plain version on the card (n dependent steps of a few ops)."""
    return kernels.greedy_nms_plain(
        boxes, thresh, ids=None if ids is None else ids.to(boxes.dtype),
        valid=valid)


@pytest.mark.parametrize("B,n,dtype,with_ids,with_valid,kind,thresh", [
    (1, 1, torch.float32, False, False, "random", 0.45),
    (3, 257, torch.float32, False, False, "random", 0.45),
    (2, 1500, torch.float64, False, True, "random", 0.45),
    (4, 999, torch.float32, True, True, "random", 0.45),
    (1, 6000, torch.float64, False, False, "random", 0.45),
    (2, 6000, torch.float64, False, False, "random", 0.45),
    (2, 6000, torch.float64, False, False, "random", 0.7),
    (1, 70000, torch.float32, False, False, "random", 0.45),
    (3, 300, torch.float64, False, False, "random", 0.45),
    (2, 5001, torch.float32, False, True, "random", 0.5),
    (1, 12345, torch.float64, True, False, "random", 0.45),
    (2, 30120, torch.float64, False, True, "random", 0.45),
    (2, 20000, torch.float64, True, True, "random", 0.45),
    (200, 2000, torch.float32, False, False, "random", 0.45),
    (2, None, torch.float32, False, False, "adversarial", 0.0),
    (2, None, torch.float32, False, False, "adversarial", 1.0),
    (2, None, torch.float64, False, False, "adversarial", 0.0),
    (2, None, torch.float64, False, False, "adversarial", 1.0),
    (2, None, torch.float64, True, True, "adversarial", 0.45),
    (2, None, torch.float32, False, False, "adversarial", -0.1),
    (2, None, torch.float64, False, False, "adversarial", float("nan"))])
def test_greedy_nms_kernel_matches_plain(dev, B, n, dtype, with_ids,
                                         with_valid, kind, thresh):
    """The keep mask equals the plain version's (on the card) bit for bit
    (the IoU in _box_iou's order with no FMA, the division skipped only
    where it cannot decide), one launch over the batch: below one CTA's
    threads, n not a multiple of the cluster's threads, MultiProposal's
    (2, 6000) and Proposal's (1, 6000), SSD's 30,120 boxes with a valid
    mask, past the shared-memory slots (n 70000), a batch in waves (200
    images), and the adversarial boxes of torch_cases (NaN, +-inf,
    zero-area, inverted, subnormal, IoUs within ulps of t)."""
    import torch_cases as tc
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    if kind == "adversarial":
        boxes = torch.from_numpy(tc.nms_adversarial_sets(np_dtype, 17,
                                                         B)).to(dev)
        n = boxes.shape[1]
    else:
        boxes = _nms_boxes(n, B, n, dtype, dev)
    rs = np.random.RandomState(n + 1)
    ids = torch.from_numpy(rs.randint(0, 3, (B, n))).to(dev) \
        if with_ids else None
    valid = torch.from_numpy(rs.rand(B, n) > 0.1).to(dev) \
        if with_valid else None
    before = kernels.LAUNCHES["greedy_nms" + kernels._NMS_DTYPES[dtype]]
    keep = kernels.greedy_nms(boxes, thresh, ids=ids, valid=valid)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["greedy_nms" + kernels._NMS_DTYPES[dtype]] == \
        before + 1
    assert torch.equal(keep, _nms_plain(boxes, thresh, ids, valid))
    again = kernels.greedy_nms(boxes, thresh, ids=ids, valid=valid)
    assert torch.equal(keep, again)


_NMS_CLUSTER_CASE = {}


@pytest.mark.parametrize("cluster", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_greedy_nms_kernel_every_cluster_size(dev, cluster, dtype):
    """Each cluster size the kernel may pick (one CTA, 2-16 CTAs through
    distributed shared memory) gives the plain version's mask, with ids
    and a valid mask, on 3 x 20000 boxes: past the shared-memory slots
    at small clusters (20 flags a thread at 1 CTA, 7 or 14 on chip)."""
    import ctypes
    from mxnet_tpu_torch.ops import build
    B, n = 3, 20000
    if dtype not in _NMS_CLUSTER_CASE:
        rs = np.random.RandomState(21)
        boxes = _nms_boxes(21, B, n, dtype, dev)
        ids = torch.from_numpy(rs.randint(0, 2, (B, n))).to(dev, dtype)
        valid = torch.from_numpy(rs.rand(B, n) > 0.05).to(dev)
        _NMS_CLUSTER_CASE[dtype] = (boxes, ids, valid, _nms_plain(
            boxes, 0.45, ids, valid))
    boxes, ids, valid, want = _NMS_CLUSTER_CASE[dtype]
    lib = build.library("nms")
    plan = (ctypes.c_int * 7)()
    assert lib.mxt_greedy_nms_plan(B, n, boxes.element_size(), cluster,
                                   plan) == 0
    assert plan[0] == cluster and plan[1] == -(-n // (cluster * 1024))
    keep = torch.empty(B, n, dtype=torch.uint8, device=dev)
    ok = valid.to(torch.uint8)
    suffix = "_f64" if dtype == torch.float64 else "_f32"
    rc = getattr(lib, "mxt_greedy_nms_cluster" + suffix)(
        boxes.data_ptr(), ids.data_ptr(), ok.data_ptr(), keep.data_ptr(),
        B, n, cluster, kernels._nms_threshold(dtype, 0.45),
        torch.cuda.current_stream().cuda_stream)
    assert rc == 0
    torch.cuda.synchronize()
    assert torch.equal(keep.bool(), want)


def test_greedy_nms_kernel_refuses_what_it_does_not_take(dev):
    from mxnet_tpu_torch.base import MXNetError
    boxes = _nms_boxes(0, 1, 10, torch.float32, dev)
    with pytest.raises(MXNetError):
        kernels.greedy_nms(boxes.half(), 0.5)
    with pytest.raises(MXNetError):
        kernels.greedy_nms(boxes[0], 0.5)
    with pytest.raises(MXNetError):
        kernels.greedy_nms(boxes, 0.5, valid=torch.ones(1, 9, device=dev))
    big = 64 * 1024 * 8 + 1     # 64 flag bits a thread, 8 CTAs of 1024
    with pytest.raises(MXNetError, match="launch failed"):
        kernels.greedy_nms(torch.zeros(1, big, 4, device=dev), 0.5)
