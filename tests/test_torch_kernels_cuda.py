"""The port's CUDA kernels against their plain PyTorch versions, on the
card: decode attention, the int8/int4 quantized matmul, the three
flash-attention kernels (forward, dQ, dK/dV), the embedding gather and
scatter and the two-bit gradient compression at ragged and odd shapes
that the full-width smoke run does not reach, a small decode step and a
small recommender step on the card against the same steps on the CPU,
a compressing KVStore push on the card, a Module that lands on the
card when given no context, and the imperative slice: the user kernels
of ``rtc.CudaModule`` against their plain versions (exactly), its
errors, exports and large shared memory, every ``mx.nd`` op case on the
card against the CPU, and ``nd.save`` / ``nd.load`` on the card.

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
    with pytest.raises(MXNetError):
        sparse_kernels.embedding_gather(table.double(), ids)
    with pytest.raises(MXNetError):
        sparse_kernels.embedding_gather(table, ids.cpu())
    with pytest.raises(MXNetError):
        sparse_kernels.embedding_scatter(table, ids, rows[:2], "add")
    with pytest.raises(MXNetError):
        sparse_kernels.embedding_scatter(table.t().contiguous().t(), ids,
                                         rows, "add")
    with pytest.raises(MXNetError):
        sparse_kernels.embedding_gather(table, ids.float())


def test_recommender_steps_on_card_match_cpu(dev):
    """Two steps of the recommender on the card (kernels, no host sync
    before the loss is read) against the same steps on the CPU (plain
    versions) from one state: every tensor within 1e-3 of its largest
    update, losses within 1e-5."""
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
            if d != "cpu":
                assert kernels.LAUNCHES["embedding_gather"] == \
                    before["embedding_gather"] + 3 * F
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
    from mxnet_tpu_torch.base import MXNetError
    g = torch.zeros(8, 4, device=dev)
    with pytest.raises(MXNetError):
        kernels.two_bit_compress(g.double(), g.double())
    with pytest.raises(MXNetError):
        kernels.two_bit_compress(g.t(), torch.zeros(4, 8, device=dev))
    with pytest.raises(MXNetError):
        kernels.two_bit_compress(g, torch.zeros(8, 4))


def test_kvstore_push_on_card_runs_the_kernel(dev, monkeypatch):
    """A compressing push on the card launches B7 once per key and never
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
