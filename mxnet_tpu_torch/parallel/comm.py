"""Differentiable collectives over one mesh axis's process group: the
``lax.ppermute``, ``lax.all_to_all``, ``lax.psum`` / ``pmean`` and the
replicated-input transpose of the JAX package's ``shard_map`` programs,
for the port's one process per device.

* :func:`ppermute` — the neighbour exchange.  Each rank of the axis
  group sends its whole tensor to its target under ``perm`` (a list of
  ``(source, target)`` axis indices, as ``lax.ppermute`` takes), and a
  rank that no pair targets receives zeros.  It runs as one
  ``all_to_all_single`` with split sizes: all of ``x`` to the target,
  nothing to any other rank.  gloo runs that collective on CUDA tensors
  (its point-to-point path takes host tensors only), and NCCL moves the
  same bytes as one send/recv pair.  Backward: the inverse permutation.
* :func:`all_to_all` — the tiled all-to-all along dim 0: chunk ``j`` of
  ``x``'s ``n`` equal chunks goes to axis index ``j``, and chunk ``j`` of
  the result came from ``j``.  Backward: the same exchange.
* :func:`replicated_input` — identity forward, sum over the axis
  backward: a value every rank holds whole (a gate, a stage input) whose
  gradient on every rank must be the whole gradient (the ``psum`` JAX's
  transpose inserts).
* :func:`replicated_sum` / :func:`replicated_mean` — ``psum`` / ``pmean``
  whose result every rank feeds into the same loss term: the backward
  passes each rank's cotangent through unchanged (``pmean``: over n),
  with no collective.

The loss convention of the entry points built on these: a **sharded**
output contributes each rank's local part, the parts summed over the
ranks giving the JAX loss (the dp trainer's convention); a
**replicated** output enters every rank's loss whole.  Every rank of the
group calls each collective in the same order, forward and backward:
callers keep every rank's autograd graph identical (select with
``torch.where`` instead of branching on the rank), so the backward's
collectives line up too.  Each call goes through
:func:`~mxnet_tpu_torch.parallel.audit.collective` under the axis name,
never over the default group: an axis of one rank (``mesh.group(axis)``
is None) moves nothing.
"""
from __future__ import annotations

import torch

from .audit import collective, record_collective

__all__ = ["ppermute", "ppermute_start", "all_to_all", "replicated_input",
           "replicated_sum", "replicated_mean", "ring_perm"]


def _dist():
    import torch.distributed as dist
    return dist


def ring_perm(n):
    """``[(j, (j + 1) % n)]``: every axis index to its right neighbour."""
    return [(j, (j + 1) % n) for j in range(n)]


def _group(mesh, axis):
    from . import axis_group
    return axis_group(axis, mesh)[0]


class _Pending:
    """An exchange in flight: :meth:`wait` returns its result and records
    it in the audit trail (a completed collective)."""

    def __init__(self, work, out, shape, kind, tag, nbytes, axis):
        self.work, self.out, self.shape = work, out, shape
        self.rec = (kind, tag, nbytes, axis)

    def wait(self):
        if self.work is not None:
            self.work.wait()
            kind, tag, nbytes, axis = self.rec
            record_collective(kind, tag, bytes=nbytes, group=axis)
        return self.out.view(self.shape)


def _permute_splits(perm, n, me, numel):
    dst = dict(perm)
    src = {d: s for s, d in perm}
    if len(dst) != len(perm) or len(src) != len(perm):
        raise ValueError("ppermute: %r sends or receives twice" % (perm,))
    ins, outs = [0] * n, [0] * n
    if me in dst:
        ins[dst[me]] = numel
    if me in src:
        outs[src[me]] = numel
    return ins, outs


def ppermute_start(x, perm, group, axis, tag):
    """Start :func:`ppermute`'s exchange of ``x`` without autograd; returns
    a handle whose ``wait()`` gives the received tensor (``x``'s shape and
    dtype).  ``group`` None (one rank) returns ``x`` as it is when
    ``perm`` maps 0 to 0, zeros otherwise."""
    shape = tuple(x.shape)
    if group is None:
        keep = (0, 0) in [tuple(p) for p in perm]
        return _Pending(None, x if keep else torch.zeros_like(x), shape,
                        None, None, None, None)
    dist = _dist()
    n, me = dist.get_world_size(group), dist.get_rank(group)
    flat = x.contiguous().view(-1)
    ins, outs = _permute_splits(perm, n, me, flat.numel())
    out = torch.empty_like(flat) if sum(outs) else torch.zeros_like(flat)
    work = dist.all_to_all_single(out, flat, outs, ins, group=group,
                                  async_op=True)
    return _Pending(work, out, shape, "collective-permute", tag,
                    flat.numel() * flat.element_size() if sum(ins) else 0,
                    axis)


def _inverse(perm):
    return [(d, s) for s, d in perm]


class _Permute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, perm, group, axis, tag):
        ctx.perm, ctx.group, ctx.axis, ctx.tag = perm, group, axis, tag
        return ppermute_start(x, perm, group, axis, tag).wait()

    @staticmethod
    def backward(ctx, g):
        return (ppermute_start(g, _inverse(ctx.perm), ctx.group, ctx.axis,
                               ctx.tag + " backward").wait(),
                None, None, None, None)


def ppermute(x, perm, axis, mesh, tag="parallel.ppermute"):
    """``lax.ppermute(x, axis, perm)`` over ``mesh``'s group on ``axis``
    (see the module docstring); differentiable."""
    return _Permute.apply(x, [tuple(p) for p in perm], _group(mesh, axis),
                         axis, tag)


def _a2a(x, group, axis, tag):
    dist = _dist()
    x = x.contiguous()
    out = torch.empty_like(x)
    collective("all-to-all", tag, lambda: dist.all_to_all_single(
        out, x, group=group), nbytes=x.numel() * x.element_size(),
        axis=axis)
    return out


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, axis, tag):
        ctx.group, ctx.axis, ctx.tag = group, axis, tag
        return _a2a(x, group, axis, tag)

    @staticmethod
    def backward(ctx, g):
        return _a2a(g, ctx.group, ctx.axis, ctx.tag + " backward"), \
            None, None, None


def all_to_all(x, axis, mesh, tag="parallel.all_to_all"):
    """The tiled all-to-all of ``x`` along dim 0 over ``axis`` (``x.shape[0]``
    divides by the axis size); differentiable.  ``x`` itself on an axis of
    one rank."""
    group = _group(mesh, axis)
    if group is None:
        return x
    return _AllToAll.apply(x, group, axis, tag)


def _allreduce(t, axis, mesh, tag):
    """Sum of ``t`` over ``axis`` through
    :func:`~mxnet_tpu_torch.parallel.allreduce_array`, as a new tensor;
    16-bit values are summed in float32 (gloo has no bfloat16 sum)."""
    from . import allreduce_array
    wide = t.float() if t.dtype in (torch.float16, torch.bfloat16) else t
    return allreduce_array(wide, axis, mesh, tag).to(t.dtype)


class _ReplicatedInput(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, mesh, tag):
        ctx.axis, ctx.mesh, ctx.tag = axis, mesh, tag
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _allreduce(g, ctx.axis, ctx.mesh, ctx.tag + " backward"), \
            None, None, None


def replicated_input(x, axis, mesh, tag="parallel.replicated_input"):
    """``x`` itself, whose gradient is summed over ``axis`` in the backward
    (every rank holds ``x`` whole and gets its whole gradient).  ``x`` on
    an axis of one rank or when ``x`` needs no gradient."""
    if _group(mesh, axis) is None or not x.requires_grad:
        return x
    return _ReplicatedInput.apply(x, axis, mesh, tag)


class _ReplicatedSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, mesh, tag, scale):
        ctx.scale = scale
        y = _allreduce(x, axis, mesh, tag)
        return y * scale if scale != 1.0 else y

    @staticmethod
    def backward(ctx, g):
        return (g * ctx.scale if ctx.scale != 1.0 else g), None, None, \
            None, None


def replicated_sum(x, axis, mesh, tag="parallel.psum", scale=1.0):
    """``psum(x) * scale`` over ``axis`` for a result every rank feeds into
    the same loss: the backward passes the cotangent through (times
    ``scale``), with no collective."""
    if _group(mesh, axis) is None:
        return x * scale if scale != 1.0 else x
    return _ReplicatedSum.apply(x, axis, mesh, tag, float(scale))


def replicated_mean(x, axis, mesh, tag="parallel.pmean"):
    """``pmean(x)`` over ``axis`` (see :func:`replicated_sum`)."""
    from .placement import as_mesh
    n = as_mesh(mesh).shape.get(axis, 1)
    return replicated_sum(x, axis, mesh, tag, scale=1.0 / n)
