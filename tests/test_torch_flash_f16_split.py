"""The arithmetic of the f16 flash-attention kernels (B9 f16 in
``mxnet_tpu_torch/csrc/flash_attention.cu``: ``flash_fwd16_kernel``,
``flash_bwd_dq16_kernel`` and ``flash_bwd_dkv16_kernel`` over ``__half``),
emulated in PyTorch on the CPU, where the kernels cannot run.

The kernels are B9's bf16 kernels with f16 tiles and f16 m16n8k16 MMAs:
q k^T, dO v^T, k q^T and v dO^T multiply f16 by f16, exact in f32.  The
f32 side of p v, ds k, p^T dO and ds^T q goes in as two f16 terms, ``hi
= f16(x)`` and ``lo = f16(x - hi)``.  f16's range is not f32's (largest
65504, normal from 2^-14), so before the split

* p (at most 1) is multiplied by 2^15 and the sums by 2^-15 after;
* ds, whose size follows dO's (a loss scale puts it far past 65504), is
  multiplied per row by 2^-e, e the row's running exponent: the largest
  |ds| of the row so far times 2^-e lies in [2^14, 2^15); when a tile
  raises e the row's accumulator is scaled down by the same power of two
  first, and the sum is multiplied by 2^e at the end.

Here that runs over the kernels' 64-key (dQ, forward) and 64-query
(dK/dV) tiles on f16 inputs made with numpy from a seed, held to
:func:`f16_close` against the plain versions (``ops/kernels.py``), as the
card holds the kernels: one f16 step of each element (2^-10 of its
magnitude) plus 1e-5 (out) / 1e-4 (dq, dk, dv) x max(1, max|ref|).  The
tests show what decided the design: the hi + lo split stands within the
tolerance and one f16 term does not (as in bf16, by a smaller margin);
with dO at a loss scale's size (largest |dO| 6e4, next to f16's largest
value) the scaled split stands within the tolerance, and on inputs whose
ds passes 65504 while dq stays small (:func:`overflow_inputs`) the
unscaled split gives NaN where the plain version is finite; a case with
large logits puts most lo parts, and many hi parts, among f16's
subnormals.
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

TILE = 64
LOG2E = 1.0 / math.log(2.0)
P_SCALE = 2.0 ** 15
E_MIN = -110


def _inputs(B=1, T=256, H=2, D=64, seed=12, qk=1.0, do_max=None):
    rs = np.random.RandomState(seed)
    q, k, v, do = [rs.randn(B, T, H, D).astype(np.float32)
                   for _ in range(4)]
    if do_max is not None:
        do = do * np.float32(do_max / np.abs(do).max())
    return [torch.from_numpy(x).half()
            for x in (q * qk, k * qk, v, do)]


def _parts(x, terms):
    """``x`` (f32) as ``terms`` f16 values held in f32: f16(x), then f16
    of what is left (f16's subnormals kept, as the card keeps them)."""
    hi = x.half().float()
    return [hi, (x - hi).half().float()][:terms]


def _bhtd(t):
    return t.float().permute(0, 2, 1, 3)


def _pow2(n):
    """2^n for an integer tensor, 0 below 2^-126 (``pow2i``)."""
    return torch.where(n < -126, torch.zeros(()), torch.exp2(n.float()))


def _rescale(x, acc, re):
    """``rescale_rows``: the running exponent of each row of ``x`` (...,
    rows, cols), ``acc``'s rows scaled down where it rose, ``x`` times
    2^-e."""
    m = x.abs().amax(-1, keepdim=True)
    ex = torch.where(m > 0, torch.floor(torch.log2(m)).clamp(min=-141),
                     torch.full((), -141.0)).long() - 14
    e_new = torch.maximum(re, ex.clamp(max=110))
    acc = acc * _pow2(re - e_new)
    return x * _pow2(-e_new), acc, e_new


def emulate_fwd(q, k, v, causal, terms, scaled=True):
    B, Tq, H, D = q.shape
    scale2 = LOG2E / math.sqrt(D)
    qf, kf, vf = _bhtd(q), _bhtd(k), _bhtd(v)
    m = torch.full((B, H, Tq, 1), -1e30)
    l = torch.zeros(B, H, Tq, 1)
    acc = torch.zeros(B, H, Tq, D)
    qi = torch.arange(Tq)[:, None]
    mul = P_SCALE if scaled else 1.0
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
        pv = sum(part @ vt for part in _parts(p * mul, terms))
        acc = acc * corr + pv
        m = m_new
    return (acc * ((1.0 / mul) / l)).permute(0, 2, 1, 3).half()


def _p_ds(qf, kt, vt, of, lse2, dl, scale, causal, k0, qi):
    p = torch.exp2((qf @ kt.transpose(-1, -2)) * (scale * LOG2E) - lse2)
    if causal:
        kj = torch.arange(k0, k0 + kt.shape[2])[None, :]
        p = torch.where(qi < kj, torch.zeros(()), p)
    return p, p * (of @ vt.transpose(-1, -2) - dl) * scale


def emulate_dq(q, k, v, do, lse, delta, causal, terms, scaled=True):
    B, Tq, H, D = q.shape
    scale = 1.0 / math.sqrt(D)
    qf, kf, vf, of = _bhtd(q), _bhtd(k), _bhtd(v), _bhtd(do)
    lse2 = lse.reshape(B, H, Tq, 1) * LOG2E
    dl = delta.reshape(B, H, Tq, 1)
    dq = torch.zeros(B, H, Tq, D)
    re = torch.full((B, H, Tq, 1), E_MIN, dtype=torch.long)
    qi = torch.arange(Tq)[:, None]
    for k0 in range(0, kf.shape[2], TILE):
        kt, vt = kf[:, :, k0:k0 + TILE], vf[:, :, k0:k0 + TILE]
        _p, ds = _p_ds(qf, kt, vt, of, lse2, dl, scale, causal, k0, qi)
        if scaled:
            ds, dq, re = _rescale(ds, dq, re)
        dq = dq + sum(part @ kt for part in _parts(ds, terms))
    if scaled:
        dq = dq * _pow2(re)
    return dq.permute(0, 2, 1, 3).half()


def emulate_dkv(q, k, v, do, lse, delta, causal, terms, scaled=True):
    """dK/dV per 64-query tile, keys as rows: p^T times 2^15, ds^T times
    each key row's 2^-e."""
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    scale = 1.0 / math.sqrt(D)
    qf, kf, vf, of = _bhtd(q), _bhtd(k), _bhtd(v), _bhtd(do)
    lse2 = lse.reshape(B, H, Tq, 1) * LOG2E
    dl = delta.reshape(B, H, Tq, 1)
    dk = torch.zeros(B, H, Tk, D)
    dv = torch.zeros(B, H, Tk, D)
    re = torch.full((B, H, Tk, 1), E_MIN, dtype=torch.long)
    qi = torch.arange(Tq)[:, None]
    mul = P_SCALE if scaled else 1.0
    for q0 in range(0, Tq, TILE):
        sl = slice(q0, q0 + TILE)
        p, ds = _p_ds(qf[:, :, sl], kf, vf, of[:, :, sl], lse2[:, :, sl],
                      dl[:, :, sl], scale, causal, 0, qi[sl])
        pT, dsT = p.transpose(-1, -2), ds.transpose(-1, -2)
        if scaled:
            dsT, dk, re = _rescale(dsT, dk, re)
        dv = dv + sum(part @ of[:, :, sl] for part in _parts(pT * mul, terms))
        dk = dk + sum(part @ qf[:, :, sl] for part in _parts(dsT, terms))
    if scaled:
        dk = dk * _pow2(re)
    return (dk.permute(0, 2, 1, 3).half(),
            (dv / mul).permute(0, 2, 1, 3).half())


def _refs(q, k, v, do):
    out, lse = kernels.flash_attention_fwd_plain(q, k, v, causal=True)
    delta = kernels.flash_delta(out, do)
    dq = kernels.flash_attention_bwd_dq_plain(q, k, v, do, lse, delta,
                                              causal=True)
    dk, dv = kernels.flash_attention_bwd_dkv_plain(q, k, v, do, lse, delta,
                                                   causal=True)
    return (lse, delta), {"out": out, "dq": dq, "dk": dk, "dv": dv}


def _emulate(q, k, v, do, lse, delta, terms, scaled):
    got = {"out": emulate_fwd(q, k, v, True, terms, scaled),
           "dq": emulate_dq(q, k, v, do, lse, delta, True, terms, scaled)}
    got["dk"], got["dv"] = emulate_dkv(q, k, v, do, lse, delta, True, terms,
                                       scaled)
    return got


def _ratios(got, ref):
    return {n: lowp_close(torch, got[n], ref[n],
                          1e-5 if n == "out" else 1e-4)[0] for n in got}


# (T, D, seed, logit factor, largest |dO|): the LM's head width; the
# kernels' widest; logits to ~+-30, so that most p (and their lo parts)
# are f16 subnormals before the 2^15; dO at a loss scale's size
CASES = [(256, 64, 12, 1.0, None), (200, 128, 7, 1.0, None),
         (256, 64, 5, 2.5, None), (256, 64, 3, 1.0, 6e4)]
IDS = ["t256-d64", "t200-d128", "large-logits", "do-6e4"]


@pytest.fixture(scope="module", params=CASES, ids=IDS)
def case(request):
    T, D, seed, qk, do_max = request.param
    q, k, v, do = _inputs(T=T, D=D, seed=seed, qk=qk, do_max=do_max)
    (lse, delta), ref = _refs(q, k, v, do)
    return (q, k, v, do, lse, delta), ref


def test_scaled_hi_lo_split_stands_within_the_f16_tolerance(case):
    (q, k, v, do, lse, delta), ref = case
    got = _emulate(q, k, v, do, lse, delta, terms=2, scaled=True)
    for n, t in got.items():
        assert torch.equal(torch.isfinite(t), torch.isfinite(ref[n])), n
    ratio = _ratios(got, ref)
    assert all(r <= 1.0 for r in ratio.values()), ratio


def test_one_f16_term_breaks_the_tolerance():
    q, k, v, do = _inputs(T=256, D=64, seed=12)
    (lse, delta), ref = _refs(q, k, v, do)
    ratio = _ratios(_emulate(q, k, v, do, lse, delta, terms=1, scaled=True),
                    ref)
    assert max(ratio["out"], ratio["dq"], ratio["dk"], ratio["dv"]) > 1.0, \
        ratio


def overflow_inputs(T=64, D=64, seed=8, amp=2e4, spread=0.1):
    """Inputs on which ds passes f16's largest value while dq stays
    below it: every query puts about half its weight on key 0 and half on
    key 1 (the two keys ``spread`` apart, their logits ~20 above the
    rest), v_1 = -v_0, and dO = amp sign(v_0).  Then dp_0 = -dp_1 ~ amp
    sum|v_0|, ds_0 = -ds_1 = p_0 p_1 (dp_0 - dp_1) / sqrt(D) (~7e4 at amp
    2e4), and dq = ds_0 (k_0 - k_1) + ... is ~1e4.  Non-causal."""
    rs = np.random.RandomState(seed)
    u = rs.randn(D).astype(np.float32)
    u /= np.linalg.norm(u)
    a = np.float32(math.sqrt(20.0 * math.sqrt(D)))     # q . kap / sqrt(D) = 20
    q = a * u + np.float32(0.05) * rs.randn(1, T, 1, D).astype(np.float32)
    kap = a * u
    k = rs.randn(1, T, 1, D).astype(np.float32) * np.float32(0.01)
    k[:, 0] = kap
    k[:, 1] = kap + np.float32(spread) * rs.randn(D).astype(np.float32)
    v = rs.randn(1, T, 1, D).astype(np.float32)
    v[:, 1] = -v[:, 0]
    do = np.broadcast_to(np.sign(v[:, :1]) * np.float32(amp),
                         q.shape).copy()
    return [torch.from_numpy(x).half() for x in (q, k, v, do)]


def test_unscaled_split_overflows_where_the_reference_is_finite():
    """ds past 65504 rounds to inf in an unscaled f16 hi term, and dq
    becomes NaN (inf - inf) where the plain version is finite; with the
    per-row power of two it stands within the tolerance."""
    q, k, v, do = overflow_inputs()
    out, lse = kernels.flash_attention_fwd_plain(q, k, v)
    delta = kernels.flash_delta(out, do)
    _p, ds = kernels._flash_bwd_parts(q, k, v, do, lse, delta, False,
                                      1.0 / 8.0)
    assert float(ds.abs().max()) > 65504.0
    ref = kernels.flash_attention_bwd_dq_plain(q, k, v, do, lse, delta)
    assert bool(torch.isfinite(ref).all())
    bad = emulate_dq(q, k, v, do, lse, delta, False, 2, scaled=False)
    assert not bool(torch.isfinite(bad).all())
    good = emulate_dq(q, k, v, do, lse, delta, False, 2, scaled=True)
    assert lowp_close(torch, good, ref, 1e-4)[0] <= 1.0


def test_large_logits_put_the_split_among_f16_subnormals():
    q, k, v, _ = _inputs(T=256, D=64, seed=5, qk=2.5)
    _out, lse = kernels.flash_attention_fwd_plain(q, k, v, causal=True)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / 8.0
    p = torch.exp(s - lse.reshape(1, 2, 256, 1)).tril()
    scaled = p[p > 0] * P_SCALE
    lo = scaled - scaled.half().float()
    sub = 2.0 ** -14
    assert float((lo[lo != 0].abs() < sub).float().mean()) > 0.5
    assert float((scaled < sub).float().mean()) > 0.05
