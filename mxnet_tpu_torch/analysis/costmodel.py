"""Analytic costs: one paged decode step (port of
``mxnet_tpu/analysis/costmodel.py`` ``decode_step_model``) and one
transformer training step (a copy of ``transformer_flops_per_step`` of
``tools/bench_ideal.py``, the bench's FLOP count).  The HLO-text models of
the rest of that module wait for ROADMAP queue A13.

``chip_smoke.py`` holds measured decode and training steps against them.
"""
from __future__ import annotations

from typing import Dict

__all__ = ["decode_step_model", "transformer_flops_per_step"]


def decode_step_model(num_layers: int, hidden: int, vocab: int,
                      slots: int, cached_tokens: int,
                      quant_bits: int = 32) -> Dict[str, float]:
    """Analytic cost of ONE paged decode step (all slots, one token
    each).

    Decode is weights-bandwidth-bound: every step re-reads every matmul
    weight once (12·L·h² block weights + V·h head at ``quant_bits`` per
    value — weight-only quantization divides exactly this term) and the
    cached K/V once (``cached_tokens`` across all slots, f32 pages),
    while FLOPs are a thin 2·bytes multiply-accumulate over the same
    weights.  Returns flops / weight_bytes / kv_bytes / hbm_bytes per
    step; tokens-per-second roofline = slots / (hbm_bytes / memory rate).
    """
    h, L, V, S = int(hidden), int(num_layers), int(vocab), int(slots)
    matmul_params = 12 * L * h * h + V * h
    weight_bytes = matmul_params * quant_bits / 8.0 \
        + (V + (L * 4 + 2) * h) * 4.0          # embeddings + LN affine f32
    flops = 2.0 * S * matmul_params \
        + 4.0 * S * int(cached_tokens) / max(S, 1) * h * L  # attn qk+pv
    kv_bytes = 2.0 * L * int(cached_tokens) * h * 4.0      # read k+v
    kv_bytes += 2.0 * L * S * h * 4.0                      # this step's write
    return {"flops": flops, "weight_bytes": weight_bytes,
            "kv_bytes": kv_bytes,
            "hbm_bytes": weight_bytes + kv_bytes + S * V * 4.0}


def transformer_flops_per_step(batch, seq, layers, hidden, vocab):
    """Model FLOPs for one train step of the LM (fwd+bwd = 3x fwd
    matmuls).

    Matmul counting (dense 2mnk): qkv+out projections 4*D^2/tok/layer,
    FFN 8*D^2/tok/layer, vocab head D*V/tok; attention scores+values
    4*T*D/tok/layer counted over the FULL score matrix (the convention
    of the reference's bench; halve it for the causal-skip count)."""
    tokens = batch * seq
    proj = 2 * tokens * (layers * 12 * hidden * hidden + hidden * vocab)
    attn = 2 * tokens * layers * 2 * (2 * seq * hidden)
    return 3 * (proj + attn)
