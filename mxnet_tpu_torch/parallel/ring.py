"""Ring-attention sequence parallelism (port of
``mxnet_tpu/parallel/ring.py``) over the flash kernels.

q/k/v are sharded along the sequence over the mesh's ``sp`` axis: rank
``i`` of the axis holds sequence block ``i`` of each, ``(B, T/n, H, D)``.
k and v travel around the ring, one hop a step, in one exchange of the
two stacked, so that at step ``s`` rank ``i`` holds block ``(i - s) mod
n``; n-1 hops, none after the last block.  Each hop is started before
the block it carries is needed and waited for after the block in hand
is computed.

Each block is one launch of the flash forward (B1,
:func:`~mxnet_tpu_torch.ops.kernels.flash_attention_fwd`, its bf16 / f16
forms B9): causal on the diagonal block (the kernels' causal rule counts
q and k indices from 0 within the block, which is the global rule when
the two blocks share their offset), without a mask below it, and not at
all above it under ``causal`` (a fully masked block adds nothing; the
hop still happens).  B1's output is normalised, so the blocks merge by
their row logsumexp, in float32: ``lse = logaddexp(lse_a, lse_b)``, ``o
= o_a exp(lse_a - lse) + o_b exp(lse_b - lse)``, a row masked so far
guarded as ``ring.py``'s merge guards it.

The backward is written by hand (:class:`_RingAttention`): with the
merged (global) ``lse`` and ``delta = rowsum(dO * O)``, each block is one
dQ launch (B2a, summed into dq) and one dK/dV launch (B2b); each block's
dK/dV accumulator, in float32, travels with it and needs n hops to get
home.  On CPU tensors the same code runs the kernels' plain versions.

Loss convention: ``out`` is sharded like q; each rank's loss is its local
part, the parts summed over the ranks giving the JAX loss, and each
rank's dq/dk/dv is the JAX gradient of its shards.

Not ported: the hang watchdog around the collectives
(``resilience/watchdog.py``, ROADMAP queue A item 8), the OOM guard and
``perf.maybe_attribute_fn`` (item 9).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from .comm import ppermute_start, ring_perm

__all__ = ["ring_attention", "local_ring_attention_fn"]


def _kernels():
    from ..ops import kernels
    return kernels


def _rows(lse, B, H, T):
    """(B*H, T) row values as (B, T, H, 1), to scale a (B, T, H, D)."""
    return lse.view(B, H, T).permute(0, 2, 1).unsqueeze(-1)


def _merge(o_acc, lse_acc, o_b, lse_b):
    """Merge block ``(o_b, lse_b)`` (normalised out, row logsumexp) into
    the float32 accumulators; either may be None (nothing yet)."""
    o_b = o_b.float()
    if o_acc is None:
        return o_b, lse_b
    B, T, H, _ = o_b.shape
    new = torch.logaddexp(lse_acc, lse_b)
    safe = torch.where(torch.isfinite(new), new, torch.zeros_like(new))
    zero = torch.zeros_like(new)
    alpha = torch.where(torch.isfinite(lse_acc), torch.exp(lse_acc - safe),
                        zero)
    beta = torch.where(torch.isfinite(lse_b), torch.exp(lse_b - safe), zero)
    return (o_acc * _rows(alpha, B, H, T) + o_b * _rows(beta, B, H, T),
            new)


class _Plan:
    """The ring of one call: the axis group, its size, this rank's index,
    the mask and scale."""

    def __init__(self, group, axis, n, index, causal, scale):
        self.group, self.axis, self.n, self.index = group, axis, n, index
        self.causal, self.scale = bool(causal), float(scale)
        self.perm = ring_perm(n)

    def block_mask(self, step):
        """The block held at ``step``: "full", "causal" or None (skipped)."""
        j = (self.index - step) % self.n
        if not self.causal or j < self.index:
            return "full"
        return "causal" if j == self.index else None

    def hop(self, t, tag):
        return ppermute_start(t, self.perm, self.group, self.axis,
                              "parallel.ring_attention " + tag)


def _forward(q, k, v, plan):
    kernels = _kernels()
    kv = torch.stack([k, v])
    o = lse = None
    for step in range(plan.n):
        pending = plan.hop(kv, "k/v") if step < plan.n - 1 else None
        mask = plan.block_mask(step)
        if mask is not None:
            o_b, lse_b = kernels.flash_attention_fwd(
                q, kv[0], kv[1], mask == "causal", plan.scale)
            o, lse = _merge(o, lse, o_b, lse_b)
        if pending is not None:
            kv = pending.wait()
    return o.to(q.dtype), lse


def _backward(q, k, v, out, lse, do, plan):
    kernels = _kernels()
    do = do.contiguous()
    delta = kernels.flash_delta(out, do)
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    kv = torch.stack([k, v])
    acc = sent = None
    for step in range(plan.n):
        pending = plan.hop(kv, "k/v") if step < plan.n - 1 else None
        mask = plan.block_mask(step)
        dkv = None
        if mask is not None:
            causal = mask == "causal"
            dq += kernels.flash_attention_bwd_dq(
                q, kv[0], kv[1], do, lse, delta, causal, plan.scale).float()
            dkv = torch.stack(kernels.flash_attention_bwd_dkv(
                q, kv[0], kv[1], do, lse, delta, causal, plan.scale)).float()
        # the accumulator of the block in hand, sent by the left
        # neighbour while this block was computed
        if sent is not None:
            acc = sent.wait()
        # step 0 holds the diagonal block, so acc exists from there on
        if dkv is not None:
            acc = dkv if acc is None else acc + dkv
        sent = plan.hop(acc, "dk/dv")
        if pending is not None:
            kv = pending.wait()
    acc = sent.wait()
    return dq.to(q.dtype), acc[0].to(k.dtype), acc[1].to(v.dtype)


class _RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, plan):
        out, lse = _forward(q, k, v, plan)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.plan = plan
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _backward(q, k, v, out, lse, do, ctx.plan)
        return dq, dk, dv, None


def _plan(mesh, axis, causal, scale, D):
    from .placement import as_mesh
    m = as_mesh(mesh)
    scale = 1.0 / math.sqrt(D) if scale is None else float(scale)
    return _Plan(m.group(axis), axis, m.shape.get(axis, 1),
                 m.axis_index(axis), causal, scale)


def _run(q, k, v, plan):
    if q.shape != k.shape or k.shape != v.shape:
        raise ValueError("ring_attention: q %s, k %s, v %s must be blocks "
                         "of one shape (B, T/n, H, D)"
                         % (tuple(q.shape), tuple(k.shape), tuple(v.shape)))
    return _RingAttention.apply(q.contiguous(), k.contiguous(),
                                v.contiguous(), plan)


def local_ring_attention_fn(axis_name: str, causal: bool, scale: float,
                            num_devices: int, mesh=None):
    """``fn(q_blk, k_blk, v_blk)`` over this rank's sequence blocks, for
    use inside a larger per-rank program over ``mesh`` (default: the
    current mesh) whose ``axis_name`` has ``num_devices`` ranks."""
    from .mesh import current_mesh
    mesh = mesh if mesh is not None else current_mesh()
    from .placement import as_mesh
    n = as_mesh(mesh).shape.get(axis_name, 1)
    if n != num_devices:
        raise ValueError("local_ring_attention_fn: axis %r has %d ranks, "
                         "not %d" % (axis_name, n, num_devices))

    def fn(q, k, v):
        return _run(q, k, v, _plan(mesh, axis_name, causal, scale,
                                   q.shape[-1]))

    return fn


def ring_attention(q, k, v, mesh, axis: str = "sp", causal: bool = False,
                   scale: Optional[float] = None):
    """Attention over sequence-sharded q/k/v: this rank's blocks (B, T/n,
    H, D) of one dtype (float32, bfloat16, float16) in, this rank's block
    of the output out (see the module docstring).  ``mesh`` (a Mesh or
    MeshSpec) may carry other axes: only ``axis``'s group talks."""
    from .. import telemetry as _tel
    plan = _plan(mesh, axis, causal, scale, q.shape[-1])
    hop = 2 * k.numel() * k.element_size()
    with _tel.span("collective/ring_attention", cat="collective",
                   metric="parallel.collective_seconds",
                   kind="collective-permute", bytes=hop * (plan.n - 1)):
        return _run(q, k, v, plan)


def reference_attention(q, k, v, causal=False, scale=None):
    """Single-process reference for testing: softmax attention over whole
    (B, T, H, D) tensors, in float32."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        T = q.shape[1]
        keep = torch.ones((T, T), dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)
