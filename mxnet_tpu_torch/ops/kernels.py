"""The port's kernels: on the decode path paged decode attention and
weight-only quantized matmul, on the training path flash attention
forward, dQ and dK/dV (f32, and bf16 as bench.py trains, and f16), on
the kvstore's push two-bit gradient compression (f16, bf16, f32, f64;
port of
``mxnet_tpu/ops/pallas_kernels.py``), and on the detection ops' path the
greedy NMS (f32, f64), which has no Pallas counterpart.

Each kernel has three parts here:

* a **wrapper** (:func:`decode_attention`, :func:`quant_matmul`,
  :func:`flash_attention_fwd`, :func:`flash_attention_bwd_dq`,
  :func:`flash_attention_bwd_dkv`, :func:`two_bit_compress`,
  :func:`two_bit_compress_many`, :func:`greedy_nms`) that
  checks device, dtype, shape and contiguity and launches the hand-written
  CUDA kernel (``mxnet_tpu_torch/csrc/*.cu``) on the current stream for a
  CUDA tensor, or raises.  It takes the plain version only for a tensor
  that lies on the CPU; nothing selects the plain version for a CUDA
  tensor (no backend knob, no autotune fallback);
* a **plain PyTorch version** (:func:`decode_attention_plain`,
  :func:`quant_matmul_plain`, :func:`flash_attention_fwd_plain`,
  :func:`flash_attention_bwd_plain`, :func:`two_bit_compress_plain`,
  :func:`two_bit_compress_many_plain`, :func:`greedy_nms_plain`)
  with the semantics of the JAX
  package's XLA formulation or Pallas kernel.  It is the tests' oracle and
  the CPU path, never a fallback on the card;
* a **launch count**: :data:`LAUNCHES` gains one where the wrapper
  launches its kernel and nowhere else, so a run can show that its main
  path went through the kernel.

:func:`quantize_weight` is a numpy copy of the JAX package's, byte for
byte, so both packages quantize a weight to identical payloads.
:class:`FlashAttention` is the ``torch.autograd.Function`` that runs the
flash forward and its two backward kernels.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..base import MXNetError
from . import build

__all__ = ["LAUNCHES", "reset_launches", "quantize_weight", "unpack_int4",
           "decode_attention", "decode_attention_plain",
           "decode_chunk_pages", "quant_matmul",
           "quant_matmul_plain", "flash_attention", "FlashAttention",
           "flash_attention_fwd", "flash_attention_fwd_plain",
           "flash_attention_bwd", "flash_attention_bwd_plain",
           "flash_attention_bwd_dq", "flash_attention_bwd_dq_plain",
           "flash_attention_bwd_dkv", "flash_attention_bwd_dkv_plain",
           "flash_delta", "two_bit_compress", "two_bit_compress_plain",
           "two_bit_compress_many", "two_bit_compress_many_plain",
           "two_bit_segments_per_launch", "greedy_nms", "greedy_nms_plain"]

# launches per kernel; quant_matmul's two template instantiations count
# apart, the flash kernels' f32, bf16 and f16 entry points count apart
# (under ``*_bf16`` and ``*_f16``), so do the two-bit kernel's f32, f16,
# bf16 and f64 ones, the flash forward counts with and without
# the lse alike, and the
# embedding kernels (``mxnet_tpu_torch.sparse.kernels``) and the user
# kernels of ``rtc.CudaModule`` (all under "rtc") count here too
LAUNCHES = {"decode_attention": 0, "quant_matmul_int8": 0,
            "quant_matmul_int4": 0, "flash_attention_fwd": 0,
            "flash_attention_bwd_dq": 0, "flash_attention_bwd_dkv": 0,
            "flash_attention_fwd_bf16": 0, "flash_attention_bwd_dq_bf16": 0,
            "flash_attention_bwd_dkv_bf16": 0,
            "flash_attention_fwd_f16": 0, "flash_attention_bwd_dq_f16": 0,
            "flash_attention_bwd_dkv_f16": 0, "embedding_gather": 0,
            "embedding_scatter": 0, "embedding_scatter_bf16": 0,
            "embedding_scatter_f16": 0, "embedding_scatter_f64": 0,
            "two_bit_compress": 0,
            "two_bit_compress_f16": 0, "two_bit_compress_bf16": 0,
            "two_bit_compress_f64": 0, "greedy_nms": 0,
            "greedy_nms_f64": 0, "rtc": 0}

_NEG_BIG = -1e30          # the JAX kernels' mask value (not -inf)
_QMAX = {8: 127, 4: 7}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _stream_ptr(index):
    """The raw ``cudaStream_t`` of the device's current stream, as an
    int.  ``torch._C._cuda_getCurrentRawStream`` skips building a Stream
    object (a few microseconds of host time per launch on a step that is
    host-bound); the public spelling is the same value."""
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None:
        return raw(index)
    return torch.cuda.current_stream(index).cuda_stream


def _require(cond, msg, *args):
    if not cond:
        raise MXNetError(msg % args)


def _check_cuda(name, *tensors):
    dev = tensors[0].device
    for t in tensors:
        _require(t.device == dev, "%s: tensors on %s and %s", name,
                 dev, t.device)
        _require(t.is_contiguous(), "%s: tensor of shape %s is not "
                 "contiguous", name, tuple(t.shape))


def _launch(name, device, fn, *args):
    """Launch on ``device``'s current stream; the C entry point returns
    the launch's ``cudaGetLastError()``.  The CUDA runtime launches on the
    calling thread's current device, so switch only when it differs."""
    idx = device.index
    if idx == torch.cuda.current_device():
        rc = fn(*args, _stream_ptr(idx))
    else:
        with torch.cuda.device(idx):
            rc = fn(*args, _stream_ptr(idx))
    if rc != 0:
        raise MXNetError("%s: CUDA kernel launch failed (cudaError %d)"
                         % (name, rc))


# ---------------------------------------------------------------------------
# paged single-query decode attention
# ---------------------------------------------------------------------------

def decode_attention_plain(q, k_pages, v_pages, page_table, seq_lens,
                           scale=None):
    """``_decode_attn_xla`` semantics: gather the slots' pages, mask
    positions at or past ``seq_lens[s]`` with -1e30, one softmax.  An
    inactive slot (length 0) gets a uniform softmax over its masked row:
    garbage-but-finite, as in the JAX formulation."""
    S, H, D = q.shape
    page = k_pages.shape[2]
    n_pages = page_table.shape[1]
    T = n_pages * page
    scale = 1.0 / math.sqrt(D) if scale is None else float(scale)
    pt = page_table.long()
    # (S, n_pages, H, page, D) -> (S, H, T, D)
    k = k_pages[pt].permute(0, 2, 1, 3, 4).reshape(S, H, T, D)
    v = v_pages[pt].permute(0, 2, 1, 3, 4).reshape(S, H, T, D)
    s = torch.einsum("shd,shtd->sht", q.float(), k.float()) * scale
    pos = torch.arange(T, device=q.device)[None, None, :]
    s = torch.where(pos < seq_lens.long()[:, None, None], s,
                    torch.full_like(s, _NEG_BIG))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("sht,shtd->shd", p, v.float()).to(q.dtype)


def decode_attention(q, k_pages, v_pages, page_table, seq_lens,
                     scale=None):
    """Single-query attention against a paged KV pool.

    ``q``: (S, H, D) f32, one query token per decode slot; ``k_pages`` /
    ``v_pages``: (P, H, page, D) f32 page pools; ``page_table``:
    (S, max_pages) int32 physical page per (slot, logical page);
    ``seq_lens``: (S,) int32 cached tokens per slot (0 = inactive slot:
    output finite, not meaningful).  Returns (S, H, D).

    CUDA tensors launch ``csrc/decode_attention.cu``, which splits each
    slot's pages into chunks (:func:`decode_chunk_pages`, from the shapes
    alone, so no host sync) and reads only the pages below
    ``ceil(seq_lens[s] / page)``; CPU tensors run
    :func:`decode_attention_plain`; anything else raises."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_pages, v_pages, page_table,
                                      seq_lens, scale)
    _require(q.device.type == "cuda", "decode_attention: no kernel for "
             "device %s", q.device)
    _require(q.dim() == 3, "decode_attention: q must be (S, H, D), got %s",
             tuple(q.shape))
    S, H, D = q.shape
    _require(k_pages.dim() == 4 and k_pages.shape == v_pages.shape
             and k_pages.shape[1] == H and k_pages.shape[3] == D,
             "decode_attention: pools %s / %s do not match q %s",
             tuple(k_pages.shape), tuple(v_pages.shape), tuple(q.shape))
    _require(page_table.dim() == 2 and page_table.shape[0] == S
             and tuple(seq_lens.shape) == (S,),
             "decode_attention: page_table %s / seq_lens %s for %d slots",
             tuple(page_table.shape), tuple(seq_lens.shape), S)
    for t, want in ((q, torch.float32), (k_pages, torch.float32),
                    (v_pages, torch.float32), (page_table, torch.int32),
                    (seq_lens, torch.int32)):
        _require(t.dtype == want, "decode_attention: %s tensor where %s "
                 "is required", t.dtype, want)
    _require(D <= 128, "decode_attention: head_dim %d > 128", D)
    _check_cuda("decode_attention", q, k_pages, v_pages, page_table,
                seq_lens)
    P, _, page, _ = k_pages.shape
    max_pages = page_table.shape[1]
    scale = 1.0 / math.sqrt(D) if scale is None else float(scale)
    _require(page > 0 and P > 0, "decode_attention: empty page pool %s",
             tuple(k_pages.shape))
    out = torch.empty_like(q)
    if out.numel() == 0 or max_pages == 0:     # no cached token anywhere
        return out.zero_()
    chunk = decode_chunk_pages(S, H, page, max_pages,
                               _sm_count(q.device))
    vec = int(D % 4 == 0 and all(t.data_ptr() % 16 == 0
                                 for t in (q, k_pages, v_pages, out)))
    fn = build.library("decode_attention").mxt_decode_attention
    _launch("decode_attention", q.device, fn, q.data_ptr(),
            k_pages.data_ptr(), v_pages.data_ptr(), page_table.data_ptr(),
            seq_lens.data_ptr(), out.data_ptr(), S, H, D, page, max_pages,
            P, chunk, vec, scale)
    LAUNCHES["decode_attention"] += 1
    return out


_SMS = {}


def _sm_count(device):
    """The card's SM count (cached: a device query, no sync)."""
    n = _SMS.get(device.index)
    if n is None:
        n = _SMS[device.index] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return n


def decode_chunk_pages(S, H, page, max_pages, sms):
    """Whole pages per chunk of the decode kernel's split token axis, from
    the shapes alone (never from ``seq_lens``, which would cost a host
    sync): enough chunks per (slot, head) that ``S * H * chunks`` blocks
    put about four on each of ``sms`` SMs, at most 8 chunks (the chunks
    of one (slot, head) merge in a thread-block cluster, whose portable
    size is 8), and at least 64 tokens a chunk."""
    want = min(8, -(-4 * sms // (S * H)))
    return min(max_pages, max(-(-max_pages // want), -(-64 // page)))


# ---------------------------------------------------------------------------
# weight-only quantized matmul (int8 / packed int4, per-channel scales)
# ---------------------------------------------------------------------------

def quantize_weight(w, bits: int = 8):
    """Quantize an FC weight (N, K) -> (qw, scales) with per-output-
    channel scales, byte-identical to the JAX package's
    ``quantize_weight``.  int8: ``qw`` is (N, K) int8.  int4: ``qw`` is
    (N, ceil(K/2)) uint8 with two nibbles per byte (low nibble = even k,
    high nibble = odd k, K padded to even), values in [-7, 7].
    Dequantization is ``w ≈ qw * scales[:, None]``."""
    if bits not in _QMAX:
        raise ValueError("quantize_weight: bits must be 8 or 4, got %r"
                         % (bits,))
    w = np.asarray(w, np.float32)
    if w.ndim != 2:
        raise ValueError("quantize_weight wants a 2-D FC weight, got %s"
                         % (w.shape,))
    qmax = _QMAX[bits]
    scales = np.max(np.abs(w), axis=1) / qmax
    scales = np.where(scales == 0, 1.0, scales).astype(np.float32)
    q = np.clip(np.rint(w / scales[:, None]), -qmax, qmax)
    if bits == 8:
        return q.astype(np.int8), scales
    if w.shape[1] % 2:
        q = np.concatenate([q, np.zeros((w.shape[0], 1), q.dtype)], axis=1)
    lo = q[:, 0::2].astype(np.int64) & 0xF
    hi = q[:, 1::2].astype(np.int64) & 0xF
    return ((hi << 4) | lo).astype(np.uint8), scales


def unpack_int4(packed):
    """(N, K//2) uint8 -> (N, K) f32 in [-7, 7] (sign-extended nibbles,
    low nibble first), as ``_unpack_int4``."""
    p = packed.to(torch.int32)
    both = torch.stack([p & 0xF, (p >> 4) & 0xF], dim=-1)
    both = both.reshape(p.shape[0], -1)
    return torch.where(both > 7, both - 16, both).float()


def quant_matmul_plain(x, qw, scales, bits: int = 8):
    """``_quant_matmul_xla`` semantics: dequantize the whole weight
    (scales applied to ``w`` first), then one f32 product."""
    K = x.shape[-1]
    w = unpack_int4(qw)[:, :K] if bits == 4 else qw.float()
    w = w * scales[:, None]
    return (x.float() @ w.T).to(x.dtype)


def quant_matmul(x, qw, scales, bits: int = 8):
    """``x @ dequant(qw).T`` with per-channel scales (see
    :func:`quantize_weight`).  ``x``: (..., K) f32; returns (..., N).

    CUDA tensors launch ``csrc/quant_matmul.cu`` (dequantization in
    registers, x split into two TF32 parts on the tensor cores, the
    scale applied once per output);
    CPU tensors run :func:`quant_matmul_plain`; anything else raises."""
    if bits not in _QMAX:
        raise MXNetError("quant_matmul: bits must be 8 or 4, got %r"
                         % (bits,))
    if x.device.type == "cpu":
        return quant_matmul_plain(x, qw, scales, bits)
    _require(x.device.type == "cuda", "quant_matmul: no kernel for device "
             "%s", x.device)
    K = x.shape[-1]
    N = qw.shape[0]
    want_q = torch.int8 if bits == 8 else torch.uint8
    row_bytes = K if bits == 8 else (K + 1) // 2
    _require(qw.dim() == 2 and qw.shape[1] == row_bytes,
             "quant_matmul: int%d weight %s does not match K=%d", bits,
             tuple(qw.shape), K)
    _require(tuple(scales.shape) == (N,), "quant_matmul: scales %s for "
             "N=%d", tuple(scales.shape), N)
    for t, want in ((x, torch.float32), (qw, want_q),
                    (scales, torch.float32)):
        _require(t.dtype == want, "quant_matmul: %s tensor where %s is "
                 "required", t.dtype, want)
    lead = tuple(x.shape[:-1])
    x2 = x.reshape(-1, K)
    _check_cuda("quant_matmul", x2, qw, scales)
    M = x2.shape[0]
    out = torch.empty((M, N), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out.reshape(lead + (N,))
    # 16-byte (int8) / 8-byte (int4) weight loads and float4 loads of x
    # where alignment allows
    lane_bytes = 16 if bits == 8 else 8
    vec = int(row_bytes % lane_bytes == 0
              and qw.data_ptr() % lane_bytes == 0)
    xvec = int(K % 4 == 0 and x2.data_ptr() % 16 == 0)
    fn = build.library("quant_matmul").mxt_quant_matmul
    _launch("quant_matmul", x.device, fn, x2.data_ptr(), qw.data_ptr(),
            scales.data_ptr(), out.data_ptr(), M, N, K, bits, vec, xvec)
    LAUNCHES["quant_matmul_int%d" % bits] += 1
    return out.reshape(lead + (N,))


# ---------------------------------------------------------------------------
# flash attention: forward (B1), dQ (B2a), dK/dV (B2b)
# ---------------------------------------------------------------------------
#
# q/k/v/out/dO are (B, T, H, D), the layout the FC -> Reshape of the LM
# graph produces, read in place by the kernels; lse and delta are
# (B*H, Tq) f32 (the TPU kernels carry them lane-broadcast to 128).

def _plain_device(t):
    """The plain versions run for CPU tensors, and for ``meta`` tensors
    when the executor infers shapes; nothing else takes them."""
    return t.device.type in ("cpu", "meta")


def _flash_scale(D, scale):
    return 1.0 / math.sqrt(D) if scale is None else float(scale)


def _flash_scores(q, k, causal, scale):
    """Scaled logits (B, H, Tq, Tk) with the kernels' causal rule:
    ``q_idx >= k_idx`` on absolute indices, -1e30 elsewhere."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if causal:
        keep = torch.ones((q.shape[1], k.shape[1]), dtype=torch.bool,
                          device=q.device).tril()
        s = s.masked_fill(~keep, _NEG_BIG)
    return s


def flash_attention_fwd_plain(q, k, v, causal=False, scale=None):
    """The einsum formulation of the attention op plus the row
    logsumexp of the scaled logits, ``m + log(max(l, 1e-37))`` as the
    TPU kernel writes it.  Returns ``(out (B, Tq, H, D), lse (B*H, Tq))``."""
    B, Tq, H, D = q.shape
    scale = _flash_scale(D, scale)
    s = _flash_scores(q.float(), k.float(), causal, scale)
    m = s.amax(-1, keepdim=True)
    e = torch.exp(s - m)
    l = e.sum(-1, keepdim=True)
    out = torch.einsum("bhqk,bkhd->bqhd", e / l, v.float()).to(q.dtype)
    lse = (m + torch.log(l.clamp_min(1e-37))).reshape(B * H, Tq)
    return out, lse


def flash_delta(out, do):
    """``delta = rowsum(dO * O)`` as (B*H, Tq) f32: the softmax-normaliser
    term both backward kernels read.  One small PyTorch reduction, as the
    JAX package computes it in XLA outside its kernels."""
    B, Tq, H, _ = out.shape
    d = torch.einsum("bthd,bthd->bht", do.float(), out.float())
    return d.reshape(B * H, Tq).contiguous()


def _flash_bwd_parts(q, k, v, do, lse, delta, causal, scale):
    """``p = exp(s - lse)`` rebuilt from the saved logsumexp, and
    ``ds = p (dO v^T - delta) scale``, both (B, H, Tq, Tk)."""
    B, Tq, H, _ = q.shape
    s = _flash_scores(q.float(), k.float(), causal, scale)
    p = torch.exp(s - lse.reshape(B, H, Tq, 1))
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    ds = p * (dp - delta.reshape(B, H, Tq, 1)) * scale
    return p, ds


def flash_attention_bwd_dq_plain(q, k, v, do, lse, delta, causal=False,
                                 scale=None):
    """The dQ kernel's function: ``dq = ds k``."""
    _p, ds = _flash_bwd_parts(q, k, v, do, lse, delta, causal,
                              _flash_scale(q.shape[-1], scale))
    return torch.einsum("bhqk,bkhd->bqhd", ds, k.float()).to(q.dtype)


def flash_attention_bwd_dkv_plain(q, k, v, do, lse, delta, causal=False,
                                  scale=None):
    """The dK/dV kernel's function: ``dk = ds^T q``, ``dv = p^T dO``."""
    p, ds = _flash_bwd_parts(q, k, v, do, lse, delta, causal,
                             _flash_scale(q.shape[-1], scale))
    return (torch.einsum("bhqk,bqhd->bkhd", ds, q.float()).to(k.dtype),
            torch.einsum("bhqk,bqhd->bkhd", p, do.float()).to(v.dtype))


def flash_attention_bwd_plain(q, k, v, out, lse, do, causal=False,
                              scale=None):
    """The explicit lse-based backward of the TPU kernels
    (``_flash_bwd_dq_kernel`` / ``_flash_bwd_dkv_kernel``) with
    whole-tensor ops: ``dq = ds k``, ``dk = ds^T q``, ``dv = p^T dO``."""
    scale = _flash_scale(q.shape[-1], scale)
    p, ds = _flash_bwd_parts(q, k, v, do, lse, flash_delta(out, do),
                             causal, scale)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float()).to(q.dtype)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()).to(k.dtype)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do.float()).to(v.dtype)
    return dq, dk, dv


# the flash kernels' element types: f32 (B1, B2a, B2b), bf16 and f16 (B9),
# each its own C entry point (``*_bf16``, ``*_f16``) and launch count
_FLASH_DTYPES = {torch.float32: "", torch.bfloat16: "_bf16",
                 torch.float16: "_f16"}


def _check_flash(name, q, k, v, *rows):
    """Device, dtype, shape and contiguity of a flash kernel's operands;
    ``rows`` are the (B*H, Tq) lse/delta vectors.  q, k and v are one
    dtype, float32, bfloat16 or float16; the rows are float32.  Returns
    the suffix of the entry point and launch count for that dtype."""
    _require(q.device.type == "cuda", "%s: no kernel for device %s", name,
             q.device)
    _require(q.dim() == 4 and k.dim() == 4 and k.shape == v.shape
             and q.shape[0] == k.shape[0] and q.shape[2:] == k.shape[2:],
             "%s: q %s and k/v %s / %s are not (B, T, H, D) of one B, H, D",
             name, tuple(q.shape), tuple(k.shape), tuple(v.shape))
    B, Tq, H, D = q.shape
    _require(Tq > 0 and k.shape[1] > 0 and B * H > 0,
             "%s: empty sequence in q %s, k %s", name, tuple(q.shape),
             tuple(k.shape))
    _require(D <= 128, "%s: head_dim %d > 128", name, D)
    _require(B * H <= 65535, "%s: B*H = %d > 65535", name, B * H)
    _require(q.dtype in _FLASH_DTYPES, "%s: %s tensors where float32, "
             "bfloat16 or float16 is required", name, q.dtype)
    for t in (k, v):
        _require(t.dtype == q.dtype, "%s: %s tensor beside %s q", name,
                 t.dtype, q.dtype)
    for t in rows:
        _require(t.dtype == torch.float32, "%s: %s lse/delta where float32 "
                 "is required", name, t.dtype)
    for t in rows:
        _require(tuple(t.shape) == (B * H, Tq), "%s: row vector %s, want "
                 "(%d, %d)", name, tuple(t.shape), B * H, Tq)
    _check_cuda(name, q, k, v, *rows)
    return _FLASH_DTYPES[q.dtype]


def flash_attention_fwd(q, k, v, causal=False, scale=None, with_lse=True):
    """Flash attention forward over (B, T, H, D) f32, bf16 or f16 tensors;
    returns ``(out, lse)`` with ``out`` in the input dtype and ``lse``
    (B*H, Tq) f32, or ``None`` when ``with_lse`` is false (nothing will
    differentiate).

    CUDA tensors launch ``mxt_flash_attention_fwd`` (``_bf16``, ``_f16``) of
    ``csrc/flash_attention.cu``; CPU tensors run
    :func:`flash_attention_fwd_plain`; anything else raises."""
    scale = _flash_scale(q.shape[-1], scale)
    if _plain_device(q):
        out, lse = flash_attention_fwd_plain(q, k, v, causal, scale)
        return out, (lse if with_lse else None)
    name = "flash_attention_fwd" + _check_flash("flash_attention_fwd", q, k,
                                                 v)
    B, Tq, H, D = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((B * H, Tq), dtype=torch.float32, device=q.device) \
        if with_lse else None
    fn = getattr(build.library("flash_attention"), "mxt_" + name)
    _launch(name, q.device, fn, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), None if lse is None else lse.data_ptr(), B, H,
            Tq, k.shape[1], D, int(bool(causal)), scale)
    LAUNCHES[name] += 1
    return out, lse


def flash_attention_bwd_dq(q, k, v, do, lse, delta, causal=False,
                           scale=None):
    """dQ of flash attention from the saved ``lse`` and ``delta``
    (:func:`flash_delta`).  CUDA tensors launch
    ``mxt_flash_attention_bwd_dq``; CPU tensors the plain version."""
    scale = _flash_scale(q.shape[-1], scale)
    if _plain_device(q):
        return flash_attention_bwd_dq_plain(q, k, v, do, lse, delta, causal,
                                            scale)
    name = "flash_attention_bwd_dq" + _check_flash(
        "flash_attention_bwd_dq", q, k, v, lse, delta)
    _require(do.shape == q.shape, "flash_attention_bwd_dq: dO %s for q %s",
             tuple(do.shape), tuple(q.shape))
    _check_flash("flash_attention_bwd_dq", do, k, v)
    B, Tq, H, D = q.shape
    dq = torch.empty_like(q)
    fn = getattr(build.library("flash_attention"), "mxt_" + name)
    _launch(name, q.device, fn, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            B, H, Tq, k.shape[1], D, int(bool(causal)), scale)
    LAUNCHES[name] += 1
    return dq


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal=False,
                            scale=None):
    """(dK, dV) of flash attention from the saved ``lse`` and ``delta``.
    CUDA tensors launch ``mxt_flash_attention_bwd_dkv``; CPU tensors the
    plain version."""
    scale = _flash_scale(q.shape[-1], scale)
    if _plain_device(q):
        return flash_attention_bwd_dkv_plain(q, k, v, do, lse, delta,
                                             causal, scale)
    name = "flash_attention_bwd_dkv" + _check_flash(
        "flash_attention_bwd_dkv", q, k, v, lse, delta)
    _require(do.shape == q.shape, "flash_attention_bwd_dkv: dO %s for q %s",
             tuple(do.shape), tuple(q.shape))
    _check_flash("flash_attention_bwd_dkv", do, k, v)
    B, Tq, H, D = q.shape
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    fn = getattr(build.library("flash_attention"), "mxt_" + name)
    _launch(name, q.device, fn, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), B, H, Tq, k.shape[1], D, int(bool(causal)),
            scale)
    LAUNCHES[name] += 1
    return dk, dv


def flash_attention_bwd(q, k, v, out, lse, do, causal=False, scale=None):
    """(dQ, dK, dV) from the forward's ``out`` and ``lse``: ``delta`` by
    :func:`flash_delta`, then the dQ kernel and the dK/dV kernel on CUDA
    tensors; :func:`flash_attention_bwd_plain` on CPU tensors."""
    if _plain_device(q):
        return flash_attention_bwd_plain(q, k, v, out, lse, do, causal,
                                         scale)
    # the kernels read dO's rows in place; autograd may hand the backward
    # a non-contiguous view of it, which is copied here and only then
    do = do.contiguous()
    delta = flash_delta(out, do)
    dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, causal, scale)
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal, scale)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Attention whose forward is the flash kernel (saving the row
    logsumexp when a gradient is wanted) and whose backward is the dQ and
    dK/dV kernels over that residual: no (T, T) tensor is stored."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, with_lse):
        out, lse = flash_attention_fwd(q, k, v, causal, scale,
                                       with_lse=with_lse)
        if with_lse:
            ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do, ctx.causal,
                                         ctx.scale)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, causal=False, scale=None):
    """Differentiable flash attention over (B, T, H, D): the forward
    kernel takes the logsumexp only when autograd will need it."""
    with_lse = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v))
    return FlashAttention.apply(q, k, v, bool(causal),
                                _flash_scale(q.shape[-1], scale), with_lse)


# ---------------------------------------------------------------------------
# two-bit gradient quantization with error feedback (B7)
# ---------------------------------------------------------------------------

def _f32_threshold(threshold):
    """The threshold as the f32 value both packages compare against (the
    JAX kernel's ``jnp.float32(t)``): a threshold such as 0.3 is never
    compared in f64."""
    return float(np.float32(threshold))


def two_bit_compress_plain(grad, residual, threshold=0.5):
    """``_two_bit_kernel`` / ``_two_bit_xla`` semantics, functionally:
    ``comp = g + r`` in f32, ``q = t`` where ``comp >= t``, ``-t`` where
    ``comp <= -t``, else 0, and ``new_r = comp - q``; both returned in
    ``grad``'s dtype.  NaN gives ``q = 0`` and ``new_r = NaN``."""
    t = _f32_threshold(threshold)
    comp = grad.float() + residual.float()
    pos = torch.full((), t, dtype=torch.float32, device=comp.device)
    zero = torch.zeros((), dtype=torch.float32, device=comp.device)
    q = torch.where(comp >= pos, pos, torch.where(comp <= -pos, -pos, zero))
    return q.to(grad.dtype), (comp - q).to(grad.dtype)


def two_bit_compress_many_plain(grads, residuals, threshold=0.5):
    """:func:`two_bit_compress_plain` per segment: ``(qs, new_rs)``,
    lists in the order of ``grads``.  The oracle of
    :func:`two_bit_compress_many` and its CPU path."""
    out = [two_bit_compress_plain(g, r, threshold)
           for g, r in zip(grads, residuals)]
    return [q for q, _ in out], [nr for _, nr in out]


def two_bit_segments_per_launch():
    """How many segments one launch of ``mxt_two_bit_compress_many``
    takes (the kernel parameters' capacity; builds the library)."""
    return build.library("two_bit").mxt_two_bit_segments_per_launch()


# B7 / B10: the element types of the two-bit kernel, each its own C entry
# point and launch count (f32 under the plain name)
_TWO_BIT_DTYPES = {torch.float32: "", torch.float16: "_f16",
                   torch.bfloat16: "_bf16", torch.float64: "_f64"}


def _aligned_offsets(sizes):
    """Offsets of ``sizes`` in one flat buffer, each a multiple of 4
    elements (one vector of the kernel: 16 bytes of f32), and the
    buffer's length."""
    offs, total = [], 0
    for n in sizes:
        offs.append(total)
        total += -(-n // 4) * 4
    return offs, total


def _two_bit_launch(dev, grads, residuals, t, suffix):
    """One dtype's pairs (contiguous) into ``mxt_two_bit_compress_many``
    ``suffix``: returns their ``q``, views of one new flat tensor."""
    dtype = grads[0].dtype
    sizes = [g.numel() for g in grads]
    offs, total = _aligned_offsets(sizes)
    flat = torch.empty(total, dtype=dtype, device=dev)
    qs = [flat[o:o + n].view(g.shape)
          for o, n, g in zip(offs, sizes, grads)]
    align = 4 * flat.element_size()       # one vector of 4 elements
    desc = []
    for g, r, q, n in zip(grads, residuals, qs, sizes):
        if n:
            gp, rp, qp = g.data_ptr(), r.data_ptr(), q.data_ptr()
            desc += [gp, rp, qp, rp, n, int(gp % align == 0
                                           and rp % align == 0
                                           and qp % align == 0)]
    count = len(desc) // 6
    if count:
        lib = build.library("two_bit")
        arr = np.array(desc, dtype=np.int64)
        name = "two_bit_compress" + suffix
        _launch(name, dev, getattr(lib, "mxt_two_bit_compress_many" + suffix),
                arr.ctypes.data, count, t)
        per = lib.mxt_two_bit_segments_per_launch()
        LAUNCHES[name] += -(-count // per)
    return qs


def two_bit_compress_many(grads, residuals, threshold=0.5):
    """:func:`two_bit_compress` over many keys at once: quantize each
    ``grads[i] + residuals[i]`` to {-t, 0, +t} and carry the error
    forward.  Returns the list of ``q``, each of its grad's shape and
    dtype: per dtype, views of ONE new flat tensor, each aligned to 4
    elements.  Every residual is updated IN PLACE (the compressor owns
    them); the grads are only read.  float16, bfloat16, float32 and
    float64 are taken (computed in f32 as the reference does, ``q`` and
    the new residual rounded back to the gradient's dtype); a residual
    has its gradient's dtype and shape.  A strided gradient or residual
    is compressed through a contiguous copy.

    CUDA tensors (all on one device) launch
    ``mxt_two_bit_compress_many`` (``_f16``, ``_bf16``, ``_f64``) over
    every non-empty pair of that dtype: one launch per
    :func:`two_bit_segments_per_launch` pairs of a dtype, each counted in
    ``LAUNCHES["two_bit_compress"]`` (``..._f16`` and so on).  CPU
    tensors run :func:`two_bit_compress_many_plain` and copy its
    residuals back; any other device raises.  A residual must not
    appear twice."""
    grads, residuals = list(grads), list(residuals)
    _require(len(grads) == len(residuals), "two_bit_compress: %d grads "
             "and %d residuals", len(grads), len(residuals))
    for g, r in zip(grads, residuals):
        _require(g.shape == r.shape, "two_bit_compress: grad %s and "
                 "residual %s differ in shape", tuple(g.shape),
                 tuple(r.shape))
        _require(g.dtype in _TWO_BIT_DTYPES and r.dtype == g.dtype,
                 "two_bit_compress: %s gradient and %s residual where one "
                 "of float16, bfloat16, float32, float64 is required",
                 g.dtype, r.dtype)
    if not grads:
        return []
    _require(len({r.data_ptr() for r in residuals if r.numel()})
             == sum(1 for r in residuals if r.numel()),
             "two_bit_compress: a residual appears twice")
    dev = grads[0].device
    if dev.type == "cpu":
        for t in grads + residuals:
            _require(t.device.type == "cpu", "two_bit_compress: tensors "
                     "on cpu and %s", t.device)
        qs, new_rs = two_bit_compress_many_plain(grads, residuals,
                                                 threshold)
        for r, nr in zip(residuals, new_rs):
            r.copy_(nr)
        return qs
    _require(dev.type == "cuda", "two_bit_compress: no kernel for device "
             "%s", dev)
    for t in grads + residuals:
        _require(t.device == dev, "two_bit_compress: tensors on %s and %s",
                 dev, t.device)
    t = _f32_threshold(threshold)
    # strided operands through contiguous copies; the residual's copy is
    # written back after the launch
    gs = [g.contiguous() for g in grads]
    rs = [r if r.is_contiguous() else r.contiguous() for r in residuals]
    qs = [None] * len(grads)
    by_dtype = {}
    for i, g in enumerate(gs):
        by_dtype.setdefault(g.dtype, []).append(i)
    for dtype, idx in by_dtype.items():
        for i, q in zip(idx, _two_bit_launch(
                dev, [gs[i] for i in idx], [rs[i] for i in idx], t,
                _TWO_BIT_DTYPES[dtype])):
            qs[i] = q
    for r, rc in zip(residuals, rs):
        if rc is not r:
            r.copy_(rc)
    return qs


def two_bit_compress(grad, residual, threshold=0.5):
    """Quantize ``grad + residual`` to {-t, 0, +t} and carry the error
    forward.  Returns ``(q, residual)``: ``q`` a new tensor of ``grad``'s
    shape, ``residual`` the tensor passed in, updated IN PLACE to ``grad
    + residual - q`` (the compressor owns it).  ``grad`` is only read.

    The one-key case of :func:`two_bit_compress_many`: CUDA tensors
    launch ``csrc/two_bit.cu`` with one segment (f16, bf16, f32 or f64,
    one shape and dtype; anything else raises); CPU tensors run
    :func:`two_bit_compress_plain` and copy its residual back; any other
    device raises."""
    q, = two_bit_compress_many([grad], [residual], threshold)
    return q, residual


# ---------------------------------------------------------------------------
# greedy non-maximum suppression over score-sorted boxes (no Pallas
# counterpart: the JAX package runs it as a lax.fori_loop,
# ``mxnet_tpu/ops/contrib.py`` ``_greedy_nms:154`` and ``box_nms:773``)
# ---------------------------------------------------------------------------

# the NMS kernel's element types, each its own C entry point and launch
# count (f32 under the plain name)
_NMS_DTYPES = {torch.float32: "", torch.float64: "_f64"}


def _nms_threshold(dtype, thresh):
    """The JAX loop compares the IoU with a Python float, weakly typed:
    rounded to the boxes' dtype."""
    return float(np.float32(thresh)) if dtype == torch.float32 \
        else float(thresh)


def _nms_iou_row(a, b):
    """IoU of each image's box ``a`` (B, 4) with its boxes ``b`` (B, n,
    4), in ``_box_iou``'s order of operations (contrib.py:80-92)."""
    zero = torch.zeros((), dtype=b.dtype, device=b.device)
    a = a[:, None, :]
    iw = torch.maximum(torch.minimum(a[..., 2], b[..., 2])
                       - torch.maximum(a[..., 0], b[..., 0]), zero)
    ih = torch.maximum(torch.minimum(a[..., 3], b[..., 3])
                       - torch.maximum(a[..., 1], b[..., 1]), zero)
    inter = iw * ih
    area_a = torch.maximum((a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1]),
                           zero)
    area_b = torch.maximum((b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1]),
                           zero)
    union = area_a + area_b - inter
    return inter / torch.maximum(union, torch.full_like(zero, 1e-12))


def greedy_nms_plain(boxes, thresh, ids=None, valid=None, pairs=None,
                     overlaps=None):
    """The JAX loop (``_greedy_nms``, ``box_nms``'s body), vectorised over
    the batch: ``boxes`` (B, n, 4) sorted by score; box j is suppressed
    when a kept box i < j that is ``valid`` (if given) and of the same
    class (``ids``, if given) overlaps it with IoU > ``thresh``.  Returns
    the keep mask (B, n) bool.  ``pairs`` (an int64 tensor of one
    element), if given, gains the number of pairs the rule decides: each
    kept, valid box against each later box still kept at its turn, of its
    class; ``overlaps`` likewise those of them with an IoU > 0, the pairs
    that need more than an overlap test.  The oracle of
    :func:`greedy_nms` and its CPU path."""
    B, n, _ = boxes.shape
    keep = torch.ones(B, n, dtype=torch.bool, device=boxes.device)
    t = _nms_threshold(boxes.dtype, thresh)
    order = torch.arange(n, device=boxes.device)
    for i in range(n):
        act = keep[:, i:i + 1]
        if valid is not None:
            act = act & valid[:, i:i + 1]
        iou = _nms_iou_row(boxes[:, i], boxes)
        sup = (iou > t) & (order > i) & act
        if ids is not None:
            same = ids == ids[:, i:i + 1]
            sup = sup & same
        if pairs is not None or overlaps is not None:
            live = keep & (order > i) & act
            if ids is not None:
                live = live & same
            if pairs is not None:
                pairs += live.sum()
            if overlaps is not None:
                overlaps += (live & (iou > 0)).sum()
        keep = keep & ~sup
    return keep


def greedy_nms(boxes, thresh, ids=None, valid=None):
    """Greedy NMS of score-sorted boxes: the keep mask (B, n) bool under
    the rule of :func:`greedy_nms_plain` (float32 or float64 boxes, class
    ``ids`` (B, n) of any dtype compared as the boxes' dtype, ``valid``
    (B, n) bool).

    CUDA tensors launch ``csrc/nms.cu`` (``mxt_greedy_nms_f32`` /
    ``_f64``): one launch over the batch, each image on a cluster of
    CTAs, counted in ``LAUNCHES["greedy_nms"]`` (``..._f64``); more
    boxes per image than 64 flag bits for each of 8 x 1024 threads
    (524,288) fail the launch and raise.  CPU tensors run
    :func:`greedy_nms_plain`; ``meta`` tensors (shape inference) give a
    mask of ones; any other device raises."""
    _require(boxes.dim() == 3 and boxes.shape[2] == 4, "greedy_nms: boxes "
             "of shape %s where (B, n, 4) is required", tuple(boxes.shape))
    _require(boxes.dtype in _NMS_DTYPES, "greedy_nms: %s boxes where "
             "float32 or float64 is required", boxes.dtype)
    B, n, _ = boxes.shape
    for name, t in (("ids", ids), ("valid", valid)):
        _require(t is None or tuple(t.shape) == (B, n), "greedy_nms: %s of "
                 "shape %s where %s is required", name,
                 None if t is None else tuple(t.shape), (B, n))
    if ids is not None:
        ids = ids.to(boxes.dtype)
    if valid is not None:
        valid = valid.to(torch.bool)
    dev = boxes.device
    if dev.type == "meta":
        return torch.ones(B, n, dtype=torch.bool, device=dev)
    if dev.type == "cpu":
        return greedy_nms_plain(boxes, thresh, ids, valid)
    _require(dev.type == "cuda", "greedy_nms: no kernel for device %s", dev)
    keep = torch.empty(B, n, dtype=torch.uint8, device=dev)
    if not B or not n:
        return keep.bool()
    lib = build.library("nms")
    boxes = boxes.contiguous()
    ids = None if ids is None else ids.contiguous()
    valid = None if valid is None else valid.to(torch.uint8).contiguous()
    _check_cuda("greedy_nms", boxes, keep,
                *[t for t in (ids, valid) if t is not None])
    suffix = _NMS_DTYPES[boxes.dtype]
    _launch("greedy_nms" + suffix, dev,
            getattr(lib, "mxt_greedy_nms" + (suffix or "_f32")),
            boxes.data_ptr(), None if ids is None else ids.data_ptr(),
            None if valid is None else valid.data_ptr(), keep.data_ptr(),
            B, n, _nms_threshold(boxes.dtype, thresh))
    LAUNCHES["greedy_nms" + suffix] += 1
    return keep.bool()
