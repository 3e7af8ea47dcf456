"""The arithmetic of the bf16 flash-attention kernels (B9 in
``mxnet_tpu_torch/csrc/flash_attention.cu``: the forward, dQ and dK/dV),
emulated in PyTorch on the CPU, where the kernels cannot run.

The kernels multiply on bf16 tensor cores with f32 sums: q k^T, dO v^T,
v dO^T and k q^T have bf16 operands on both sides, whose products are
exact in f32.  The probabilities p (for ``out += p v`` and ``dv += p^T
dO``) and ds (for ``dq += ds k`` and ``dk += ds^T q``) are f32, and go
into the MMA as two bf16 terms, ``hi = bf16(x)`` and ``lo = bf16(x -
hi)``, each product summed in f32.  Here the same split runs over the
kernels' 64-key tiles (the forward with the online softmax in exp2 units
and a fresh accumulator per tile; dQ summing tile after tile), on bf16
inputs made with numpy from a seed, at small causal shapes whose first
rows have 1 to 4 live keys.  Held to ``chip_smoke.lowp_close`` against
the plain versions (``ops/kernels.py``), as the card holds the kernels:
out, dq, dk and dv stand within one bf16 step of each element plus 1e-5
(out) / 1e-4 (dq, dk, dv) x max(1, max|ref|); the one-term form, p and
ds rounded once to bf16, does not.  That is why the kernels pay a second
MMA.
"""
import math
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from chip_smoke import lowp_close  # noqa: E402
from mxnet_tpu_torch.ops import kernels  # noqa: E402

TILE = 64                  # keys of the forward's tiles
LOG2E = 1.0 / math.log(2.0)


def _inputs(B=1, T=256, H=2, D=64, seed=12):
    rs = np.random.RandomState(seed)
    return [torch.from_numpy(rs.randn(B, T, H, D).astype(
        np.float32)).bfloat16() for _ in range(4)]


def _parts(x, terms):
    """``x`` (f32) as ``terms`` bf16 values held in f32: bf16(x), then
    bf16 of what is left."""
    hi = x.bfloat16().float()
    return [hi, (x - hi).bfloat16().float()][:terms]


def _bhtd(t):
    return t.float().permute(0, 2, 1, 3)       # (B, T, H, D) -> (B, H, T, D)


def emulate_fwd(q, k, v, causal, terms):
    """The forward kernel's arithmetic: per 64-key tile, s = q k^T scaled
    to log2 units, the running max and sum, ``p = 2^(s - m)`` split into
    ``terms`` bf16 parts, their products with v summed into a fresh f32
    accumulator, then ``acc = acc corr + pv``; ``out = acc / l`` rounded
    to bf16."""
    B, Tq, H, D = q.shape
    scale2 = LOG2E / math.sqrt(D)
    qf, kf, vf = _bhtd(q), _bhtd(k), _bhtd(v)
    m = torch.full((B, H, Tq, 1), -1e30)
    l = torch.zeros(B, H, Tq, 1)
    acc = torch.zeros(B, H, Tq, D)
    qi = torch.arange(Tq)[:, None]
    for k0 in range(0, kf.shape[2], TILE):
        kt, vt = kf[:, :, k0:k0 + TILE], vf[:, :, k0:k0 + TILE]
        s = (qf @ kt.transpose(-1, -2)) * scale2
        if causal:
            kj = torch.arange(k0, k0 + kt.shape[2])[None, :]
            s = s.masked_fill(qi < kj, -math.inf)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        corr = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        pv = sum(part @ vt for part in _parts(p, terms))
        acc = acc * corr + pv
        m = m_new
    return (acc / l).permute(0, 2, 1, 3).bfloat16()


def emulate_dq(q, k, v, do, lse, delta, causal, terms):
    """The dQ kernel's arithmetic, per 64-key tile in the kernel's order:
    ``p = 2^(s scale2 - lse log2 e)`` (0 where masked), ``ds = p (dO v^T
    - delta) scale``, then ``dq += ds k`` with ds split into ``terms``
    bf16 parts; rounded to bf16."""
    B, Tq, H, D = q.shape
    scale = 1.0 / math.sqrt(D)
    qf, kf, vf, of = _bhtd(q), _bhtd(k), _bhtd(v), _bhtd(do)
    lse2 = lse.reshape(B, H, Tq, 1) * LOG2E
    dl = delta.reshape(B, H, Tq, 1)
    dq = torch.zeros(B, H, Tq, D)
    qi = torch.arange(Tq)[:, None]
    for k0 in range(0, kf.shape[2], TILE):
        kt, vt = kf[:, :, k0:k0 + TILE], vf[:, :, k0:k0 + TILE]
        p = torch.exp2((qf @ kt.transpose(-1, -2)) * (scale * LOG2E) - lse2)
        if causal:
            kj = torch.arange(k0, k0 + kt.shape[2])[None, :]
            p = torch.where(qi < kj, torch.zeros(()), p)
        ds = p * (of @ vt.transpose(-1, -2) - dl) * scale
        dq = dq + sum(part @ kt for part in _parts(ds, terms))
    return dq.permute(0, 2, 1, 3).bfloat16()


def emulate_dkv(q, k, v, do, lse, delta, causal, terms):
    """The dK/dV kernel's arithmetic: ``p = 2^(s scale2 - lse log2 e)``
    (0 where masked), ``ds = p (dO v^T - delta) scale``, then ``dv = p^T
    dO`` and ``dk = ds^T q`` with p and ds split into ``terms`` bf16
    parts; rounded to bf16."""
    B, Tq, H, D = q.shape
    scale = 1.0 / math.sqrt(D)
    qf, kf, vf, of = _bhtd(q), _bhtd(k), _bhtd(v), _bhtd(do)
    s = qf @ kf.transpose(-1, -2)
    p = torch.exp2(s * (scale * LOG2E)
                   - lse.reshape(B, H, Tq, 1) * LOG2E)
    if causal:
        keep = torch.ones(Tq, kf.shape[2], dtype=torch.bool).tril()
        p = torch.where(keep, p, torch.zeros(()))
    ds = p * (of @ vf.transpose(-1, -2) - delta.reshape(B, H, Tq, 1)) * scale
    dv = sum(part.transpose(-1, -2) @ of for part in _parts(p, terms))
    dk = sum(part.transpose(-1, -2) @ qf for part in _parts(ds, terms))
    return (dk.permute(0, 2, 1, 3).bfloat16(),
            dv.permute(0, 2, 1, 3).bfloat16())


# (T, D, seed): the LM's head width and one at the kernels' widest
@pytest.fixture(scope="module", params=[(256, 64, 12), (200, 128, 7)],
                ids=["t256-d64", "t200-d128"])
def case(request):
    T, D, seed = request.param
    q, k, v, do = _inputs(T=T, D=D, seed=seed)
    out, lse = kernels.flash_attention_fwd_plain(q, k, v, causal=True)
    delta = kernels.flash_delta(out, do)
    dq = kernels.flash_attention_bwd_dq_plain(q, k, v, do, lse, delta,
                                              causal=True)
    dk, dv = kernels.flash_attention_bwd_dkv_plain(q, k, v, do, lse, delta,
                                                   causal=True)
    return (q, k, v, do, lse, delta), {"out": out, "dq": dq, "dk": dk,
                                       "dv": dv}


def _ratios(case, terms):
    (q, k, v, do, lse, delta), ref = case
    got = {"out": emulate_fwd(q, k, v, True, terms),
           "dq": emulate_dq(q, k, v, do, lse, delta, True, terms)}
    got["dk"], got["dv"] = emulate_dkv(q, k, v, do, lse, delta, True, terms)
    return {n: lowp_close(torch, got[n], ref[n],
                          1e-5 if n == "out" else 1e-4)[0] for n in got}


def test_hi_lo_split_stands_within_the_bf16_tolerance(case):
    # an element one bf16 step off (the two sides round across a
    # midpoint) may reach ~0.99: its step is 2^-7 of a magnitude just
    # above a power of two
    ratio = _ratios(case, terms=2)
    assert all(r <= 1.0 for r in ratio.values()), ratio


def test_one_bf16_term_breaks_the_tolerance(case):
    ratio = _ratios(case, terms=1)
    assert ratio["out"] > 2.0, ratio
    assert ratio["dq"] > 2.0, ratio
    assert max(ratio["dk"], ratio["dv"]) > 1.0, ratio
