"""Parity of the port's flash-attention plain versions and of its
``_contrib_fused_attention`` op with the JAX package
(mxnet_tpu_torch/ops/kernels.py, ops/nn.py vs
mxnet_tpu/ops/pallas_kernels.py, ops/nn.py).

Inputs are made with numpy from a seed and handed to both packages.  The
JAX side runs its Pallas flash kernels in interpret mode on the CPU, as
tests/test_flash_vjp.py does; the port runs on CPU tensors, where its
wrappers take the plain versions.  The CUDA kernels are held against the
same plain versions on the card (tests/test_torch_kernels_cuda.py,
chip_smoke.py).  Tolerance throughout: f32 on both sides in another
summation order, rtol 1e-4 / atol 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.ops import pallas_kernels as pk
from mxnet_tpu.ops.registry import get_op as jax_get_op
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import kernels
from mxnet_tpu_torch.ops.registry import get_op

RTOL, ATOL = 1e-4, 1e-5

# (B, T, H, D); T = 48 and 37 are not multiples of the card kernels'
# 64-row tile (37 is a multiple of no power of two above 1)
SHAPES = [(2, 48, 2, 8), (2, 48, 2, 16), (1, 37, 2, 8)]
SHAPE_IDS = ["b2t48h2d8", "b2t48h2d16", "b1t37h2d8"]


def _inputs(B, T, H, D, seed):
    rs = np.random.RandomState(seed)
    return [rs.randn(B, T, H, D).astype(np.float32) for _ in range(4)]


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_plain_forward_and_lse_match_jax_pallas(shape, causal):
    q, k, v, _ = _inputs(*shape, seed=sum(shape))
    out, lse = pk.fused_attention_fwd(q, k, v, causal=causal)
    got, got_lse = kernels.flash_attention_fwd(
        *map(torch.from_numpy, (q, k, v)), causal=causal)
    _close(got.numpy(), out)
    _close(got_lse.numpy(), np.asarray(lse)[..., 0])


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_plain_backward_matches_jax_pallas(shape, causal):
    q, k, v, do = _inputs(*shape, seed=3 * sum(shape))
    out, lse = pk.fused_attention_fwd(q, k, v, causal=causal)
    want = pk.fused_attention_bwd(q, k, v, out, lse, do, causal=causal)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    t_out, t_lse = kernels.flash_attention_fwd(tq, tk, tv, causal=causal)
    got = kernels.flash_attention_bwd(tq, tk, tv, t_out, t_lse, tdo,
                                      causal=causal)
    for g, w in zip(got, want):
        _close(g.numpy(), w)
    # the split wrappers (dQ alone, dK/dV alone) give the same values
    delta = kernels.flash_delta(t_out, tdo)
    dq = kernels.flash_attention_bwd_dq(tq, tk, tv, tdo, t_lse, delta,
                                        causal)
    dk, dv = kernels.flash_attention_bwd_dkv(tq, tk, tv, tdo, t_lse, delta,
                                             causal)
    for g, w in zip((dq, dk, dv), got):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_plain_backward_matches_autograd_of_einsum(causal):
    """The lse-based backward against autograd through the einsum form,
    in float64 so the reference itself is exact to the bar."""
    q, k, v, do = (torch.from_numpy(a).double()
                   for a in _inputs(2, 48, 2, 16, seed=7))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    s = torch.einsum("bqhd,bkhd->bhqk", *leaves[:2]) / 4.0
    if causal:
        s = s.masked_fill(~torch.ones(48, 48, dtype=torch.bool).tril(),
                          float("-inf"))
    ref = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), leaves[2])
    ref.backward(do)
    f32 = [t.float() for t in (q, k, v, do)]
    out, lse = kernels.flash_attention_fwd(*f32[:3], causal=causal)
    got = kernels.flash_attention_bwd(*f32[:3], out, lse, f32[3],
                                      causal=causal)
    _close(out.numpy(), ref.detach().float().numpy())
    for g, leaf in zip(got, leaves):
        _close(g.numpy(), leaf.grad.float().numpy())


def _jax_op_grads(T, fms, causal, q, k, v, g):
    op = jax_get_op("_contrib_fused_attention")
    attrs = op.parse_attrs(dict(causal=causal, flash_min_seq=fms))

    def loss(q, k, v):
        return jnp.sum(op.fn(attrs, q, k, v) * g)

    out = op.fn(attrs, q, k, v)
    return (out,) + jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(q, k, v)


def _port_op_grads(fms, causal, q, k, v, g):
    op = get_op("_contrib_fused_attention")
    attrs = op.parse_attrs(dict(causal=causal, flash_min_seq=fms))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = op.fn(attrs, *leaves)
    out.backward(torch.from_numpy(g))
    return (out.detach(),) + tuple(t.grad for t in leaves)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("fms", [10000, 48], ids=["einsum-path",
                                                  "flash-path"])
def test_fused_attention_op_matches_jax_across_dispatch(fms, causal):
    """The registered op on both sides of ``flash_min_seq``: the einsum
    formulation with autograd below it, the flash Function (plain
    versions on the CPU) at and above it; forward and the three
    gradients agree with the JAX op (Pallas in interpret mode)."""
    q, k, v, g = _inputs(2, 48, 2, 8, seed=11)
    want = _jax_op_grads(48, fms, causal, q, k, v, g)
    before = dict(kernels.LAUNCHES)
    got = _port_op_grads(fms, causal, q, k, v, g)
    for a, b in zip(got, want):
        _close(a.numpy(), b)
    # CPU tensors never launch a kernel
    assert kernels.LAUNCHES == before


def test_flash_forward_takes_lse_only_for_autograd(monkeypatch):
    """The Function asks the forward for the logsumexp only when a
    gradient will be taken."""
    seen = []
    real = kernels.flash_attention_fwd

    def spy(*args, **kw):
        seen.append(kw.get("with_lse"))
        return real(*args, **kw)

    monkeypatch.setattr(kernels, "flash_attention_fwd", spy)
    q, k, v, _ = map(torch.from_numpy, _inputs(1, 16, 2, 8, seed=2))
    with torch.no_grad():
        kernels.flash_attention(q, k, v, causal=True)
    kernels.flash_attention(q, k, v.requires_grad_(), causal=True)
    assert seen == [False, True]


def test_fused_attention_op_refuses_negative_block_q():
    op = get_op("_contrib_fused_attention")
    attrs = op.parse_attrs(dict(causal=True, block_q=-1))
    x = torch.zeros(1, 8, 1, 4)
    with pytest.raises(MXNetError):
        op.fn(attrs, x, x, x)


def test_flash_remat_backward_is_not_ported(monkeypatch):
    """``MXNET_TPU_FLASH_BWD=remat`` is ported (the name is the refusal's
    it replaces): the op's output and its gradients against the JAX op's
    under the same setting (the flash forward and the einsum
    formulation's rematerialising vjp), above and below the
    threshold."""
    from mxnet_tpu.ops import nn as jnn
    from mxnet_tpu_torch.ops import nn
    monkeypatch.setattr(nn, "_FLASH_BWD", "remat")
    monkeypatch.setattr(jnn, "_FLASH_BWD", "remat")
    q, k, v, do = _inputs(1, 16, 2, 8, seed=4)
    for min_seq in (8, 17):
        params = dict(causal=True, flash_min_seq=min_seq)
        jop = jax_get_op("_contrib_fused_attention")
        jattrs = jop.parse_attrs(dict(params))
        want, vjp = jax.vjp(lambda *x: jop.fn(jattrs, *x),
                            *map(jnp.asarray, (q, k, v)))
        want_grads = vjp(jnp.asarray(do))
        op = get_op("_contrib_fused_attention")
        x = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
        got = op.fn(op.parse_attrs(dict(params)), *x)
        grads = torch.autograd.grad(got, x, torch.from_numpy(do))
        _close(got.detach().numpy(), want)
        for g, w in zip(grads, want_grads):
            _close(g.numpy(), w)


def test_flash_wrappers_refuse_a_device_without_a_kernel():
    x = torch.zeros(1, 8, 1, 4)
    with pytest.raises(MXNetError):
        kernels._check_flash("flash_attention_fwd", x, x, x)
