"""The decode path's two kernels: paged decode attention and weight-only
quantized matmul (port of the decode half of
``mxnet_tpu/ops/pallas_kernels.py``).

Each kernel has three parts here:

* a **wrapper** (:func:`decode_attention`, :func:`quant_matmul`) that
  checks device, dtype, shape and contiguity and launches the hand-written
  CUDA kernel (``mxnet_tpu_torch/csrc/*.cu``) on the current stream for a
  CUDA tensor, or raises.  It takes the plain version only for a tensor
  that lies on the CPU; nothing selects the plain version for a CUDA
  tensor (no backend knob, no autotune fallback);
* a **plain PyTorch version** (:func:`decode_attention_plain`,
  :func:`quant_matmul_plain`) with the semantics of the JAX package's XLA
  formulation (``_decode_attn_xla``, ``_quant_matmul_xla``).  It is the
  tests' oracle and the CPU path, never a fallback on the card;
* a **launch count**: :data:`LAUNCHES` gains one where the wrapper
  launches its kernel and nowhere else, so a run can show that its main
  path went through the kernel.

:func:`quantize_weight` is a numpy copy of the JAX package's, byte for
byte, so both packages quantize a weight to identical payloads.
"""
from __future__ import annotations

import math

import numpy as np

from ..base import MXNetError
from . import build

__all__ = ["LAUNCHES", "reset_launches", "quantize_weight", "unpack_int4",
           "decode_attention", "decode_attention_plain", "quant_matmul",
           "quant_matmul_plain"]

# launches per kernel; quant_matmul's two template instantiations count
# apart
LAUNCHES = {"decode_attention": 0, "quant_matmul_int8": 0,
            "quant_matmul_int4": 0}

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
    import torch
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
    import torch
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
    import torch
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

    CUDA tensors launch ``csrc/decode_attention.cu``, which reads only
    the pages below ``ceil(seq_lens[s] / page)``; CPU tensors run
    :func:`decode_attention_plain`; anything else raises."""
    import torch
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
    scale = 1.0 / math.sqrt(D) if scale is None else float(scale)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    fn = build.library("decode_attention").mxt_decode_attention
    _launch("decode_attention", q.device, fn, q.data_ptr(),
            k_pages.data_ptr(), v_pages.data_ptr(), page_table.data_ptr(),
            seq_lens.data_ptr(), out.data_ptr(), S, H, D, page,
            page_table.shape[1], P, scale)
    LAUNCHES["decode_attention"] += 1
    return out


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
    import torch
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
    registers, f32 accumulation, the scale applied once per output);
    CPU tensors run :func:`quant_matmul_plain`; anything else raises."""
    import torch
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
    # 4-byte weight words / float4 rows of x where alignment allows
    vec = int(row_bytes % 4 == 0 and qw.data_ptr() % 4 == 0)
    xvec = int(K % 4 == 0 and x2.data_ptr() % 16 == 0)
    fn = build.library("quant_matmul").mxt_quant_matmul
    _launch("quant_matmul", x.device, fn, x2.data_ptr(), qw.data_ptr(),
            scales.data_ptr(), out.data_ptr(), M, N, K, bits, vec, xvec)
    LAUNCHES["quant_matmul_int%d" % bits] += 1
    return out.reshape(lead + (N,))
