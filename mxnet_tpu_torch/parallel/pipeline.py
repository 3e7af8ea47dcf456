"""Pipeline parallelism: the micro-batched GPipe schedule over a 'pp'
mesh axis (port of ``mxnet_tpu/parallel/pipeline.py``).

Rank ``s`` of the axis holds stage ``s``'s parameters and applies
``stage_fn(params_local, x) -> y`` (x and y of one shape) on every tick.
The schedule is the JAX package's: M micro-batches take M + 2(S - 1)
ticks; stage 0 ingests micro-batch t at tick t, every other stage the
activation its left neighbour computed two ticks earlier, each boundary
activation sent one tick after it is computed (:func:`~.comm.ppermute`
around the ring); the last stage emits micro-batch t - 2(S - 1) at tick
t, and an all-reduce over the axis gives every rank the outputs.

Every rank builds the same autograd graph: the stage input and the
emitted outputs are selected with ``torch.where`` on the rank's stage
(both branches computed), as the JAX program selects on ``axis_index``,
so the backward's collectives (each hop's inverse) line up across ranks.
``loss_and_grad`` differentiates straight through the schedule with
torch's autograd.

Gradient rule: the outputs are replicated and every rank feeds them into
the same loss, so their all-reduce passes the cotangent through
unchanged; the input ``x_micro`` is replicated, so its gradient is summed
over the axis (every rank gets the JAX gradient); each rank's parameter
gradients are the JAX gradients of its stage's slice.

Not ported: the hang watchdog (``resilience/watchdog.py``, ROADMAP queue
A item 8) and ``perf.maybe_attribute_fn`` (item 9).
"""
from __future__ import annotations

from typing import Callable

import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

from .comm import ppermute, replicated_input, replicated_sum, ring_perm

__all__ = ["pipeline_apply", "PipelineRunner"]


def pipeline_apply(stage_fn: Callable, num_stages: int, mesh, axis: str,
                   params_local, x_micro):
    """Run micro-batches ``x_micro`` (M, mb, ...) — every rank passes the
    same — through the stages; returns the (M, mb, ...) outputs on every
    rank.  ``params_local`` is this rank's stage of the stacked
    parameters (a tensor or a list / tuple / dict of them).  ``mesh`` (a
    Mesh or MeshSpec) may carry other axes: only ``axis``'s group talks."""
    from .. import telemetry as _tel
    from .placement import as_mesh
    m = as_mesh(mesh)
    S = int(num_stages)
    if m.shape.get(axis, 1) != S:
        raise ValueError("pipeline_apply: %d stages over axis %r of %d "
                         "ranks" % (S, axis, m.shape.get(axis, 1)))
    stage = m.axis_index(axis)
    M = x_micro.shape[0]
    T = M + 2 * (S - 1)
    mb_bytes = x_micro[0].numel() * x_micro.element_size()
    act_bytes = mb_bytes * M
    dev = x_micro.device
    first = torch.tensor(stage == 0, device=dev)
    last = torch.tensor(stage == S - 1, device=dev)
    perm = ring_perm(S)
    with _tel.span("collective/pipeline_apply", cat="collective",
                   metric="parallel.collective_seconds",
                   kind="collective-permute,all-reduce",
                   bytes=mb_bytes * T + act_bytes):
        x_all = replicated_input(x_micro, axis, m,
                                 "parallel.pipeline_apply input")
        zeros = torch.zeros_like(x_micro[0])
        y_send, buf = zeros, zeros
        outputs = [None] * M
        for t in range(T):
            # last tick's activation goes out first: the hop depends on
            # nothing computed this tick
            buf_next = ppermute(y_send, perm, axis, m,
                                "parallel.pipeline_apply")
            x_in = x_all[t] if t < M else zeros
            y = stage_fn(params_local, torch.where(first, x_in, buf))
            emit = t - 2 * (S - 1)
            if emit >= 0:
                outputs[emit] = torch.where(last, y, torch.zeros_like(y))
            y_send, buf = y, buf_next
        # only the last stage holds real outputs: the sum broadcasts them
        return replicated_sum(torch.stack(outputs), axis, m,
                              "parallel.pipeline_apply output psum")


class PipelineRunner:
    """Homogeneous stages (e.g. stacked transformer layers), this rank's
    stage of the stacked parameters, trainable end to end."""

    def __init__(self, stage_fn, num_stages, mesh, axis="pp"):
        from .placement import as_mesh
        self.stage_fn = stage_fn
        self.num_stages = num_stages
        self.mesh = as_mesh(mesh)
        self.axis = axis

    def forward(self, params_local, x_micro):
        return pipeline_apply(self.stage_fn, self.num_stages, self.mesh,
                              self.axis, params_local, x_micro)

    def loss_and_grad(self, loss_fn, params_local, x_micro, y_micro):
        """``loss_fn(pred, target) -> scalar``, computed on every rank from
        the replicated outputs; returns ``(loss, grads)``, ``grads`` this
        rank's stage gradients in ``params_local``'s structure."""
        leaves, tree = tree_flatten(params_local)
        leaves = [p.detach().requires_grad_() for p in leaves]
        with torch.enable_grad():
            loss = loss_fn(self.forward(tree_unflatten(leaves, tree),
                                        x_micro), y_micro)
            grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), tree_unflatten(list(grads), tree)
