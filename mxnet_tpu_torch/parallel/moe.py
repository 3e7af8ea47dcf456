"""Expert parallelism (MoE) over the 'ep' mesh axis (port of
``mxnet_tpu/parallel/moe.py``).

Switch-style top-1 routing in the GShard dispatch/combine-mask
formulation: each rank routes its own tokens, building a (tokens,
experts, capacity) one-hot dispatch tensor; the packed (E, C, d) expert
blocks go to the experts' ranks with one all-to-all (expert axis split
over the ranks, the received blocks stacked along capacity), each rank
runs its E/n experts, a second all-to-all brings the results back, and
the combine mask weighted by the gate probability reassembles the
output.  Tokens over an expert's capacity are dropped (their rows are 0)
and a load-balancing auxiliary loss keeps routing uniform.  The expert
products are ``torch`` batched matmuls: the JAX package computes them as
XLA einsums, outside any Pallas kernel.

Arguments are this rank's: ``x`` its (tokens/n, d) tokens, ``w1`` /
``w2`` its (E/n, d, h) / (E/n, h, d) experts, ``wg`` (d, E) whole on
every rank.  Returns this rank's (tokens/n, d) output and the aux loss,
averaged over the axis (the same on every rank).

Gradient rule: ``out`` is sharded (each rank's loss holds its local
part, the parts summed over the ranks giving the JAX loss); ``aux`` is
replicated (every rank adds the same aux term to its loss; its mean
passes each rank's cotangent through over n); ``wg`` is replicated, so
its gradient is summed over the axis and every rank gets the JAX
gradient; ``w1`` / ``w2`` get the JAX gradients of their experts.

Not ported: the hang watchdog (``resilience/watchdog.py``, ROADMAP queue
A item 8) and ``perf.maybe_attribute_fn`` (item 9).
"""
from __future__ import annotations

import math

import torch

from .comm import all_to_all, replicated_input, replicated_mean

__all__ = ["moe_ffn", "moe_ffn_dense", "top1_gating"]


def top1_gating(logits, capacity: int):
    """Switch top-1 routing for one token shard.  ``logits``: (T, E).
    Returns (dispatch (T, E, C) 0/1, combine (T, E, C), aux scalar); a
    token whose 1-based position in its expert exceeds ``capacity`` is
    dropped (its dispatch row is all zero)."""
    T, E = logits.shape
    probs = torch.softmax(logits, dim=-1)
    gate, expert = probs.max(dim=-1)
    onehot = torch.nn.functional.one_hot(expert, E).to(logits.dtype)
    # load-balance loss (Switch eq. 4): E * sum_e f_e * P_e
    aux = E * torch.sum(onehot.mean(dim=0) * probs.mean(dim=0))
    pos = torch.cumsum(onehot, dim=0) * onehot             # 1-based slots
    keep = (pos > 0) & (pos <= capacity)
    slot = (pos - 1).clamp(0, capacity - 1).long()
    dispatch = torch.where(
        keep[..., None],
        torch.nn.functional.one_hot(slot, capacity).to(logits.dtype),
        torch.zeros((), dtype=logits.dtype, device=logits.device))
    combine = dispatch * gate[:, None, None]
    return dispatch, combine, aux


def _expert_ffn(blocks, w1, w2, activation):
    """blocks (E_l, C, d); w1 (E_l, d, h); w2 (E_l, h, d)."""
    return torch.bmm(activation(torch.bmm(blocks, w1)), w2)


def moe_ffn_dense(x, wg, w1, w2, activation=torch.relu):
    """Exact single-process reference: every token through its argmax
    expert, no capacity limit.  O(T*E) work: tests and the one-rank
    path."""
    probs = torch.softmax(x @ wg, dim=-1)
    gate, expert = probs.max(dim=-1)
    h = activation(torch.einsum("td,edh->teh", x, w1))
    all_out = torch.einsum("teh,ehd->ted", h, w2)             # (T, E, d)
    picked = all_out.gather(1, expert[:, None, None].expand(
        -1, 1, x.shape[-1]))[:, 0]
    E = wg.shape[1]
    frac = torch.nn.functional.one_hot(expert, E).to(x.dtype).mean(dim=0)
    aux = E * torch.sum(frac * probs.mean(dim=0))
    return picked * gate[:, None], aux


def moe_ffn(x, wg, w1, w2, mesh, axis: str = "ep",
            capacity_factor: float = 1.25, activation=torch.relu):
    """The sharded gated expert FFN (see the module docstring).  ``mesh``
    (a Mesh or MeshSpec) may carry other axes: only ``axis``'s group
    talks.  One rank on the axis takes :func:`moe_ffn_dense`."""
    from .. import telemetry as _tel
    from .placement import as_mesh
    m = as_mesh(mesh)
    n = m.shape.get(axis, 1)
    E = wg.shape[1]
    T = x.shape[0] * n
    if E % n or w1.shape[0] * n != E or w2.shape[0] * n != E:
        raise ValueError("tokens (%d) and experts (%d) must divide the "
                         "'%s' axis size %d (this rank's experts: %d)"
                         % (T, E, axis, n, w1.shape[0]))
    if n == 1:
        return moe_ffn_dense(x, wg, w1, w2, activation)
    t_local, d = x.shape
    E_l = E // n
    capacity = max(1, math.ceil(t_local * capacity_factor / E))
    a2a_bytes = 2 * E * capacity * d * x.element_size()
    with _tel.span("collective/moe_ffn", cat="collective",
                   metric="parallel.collective_seconds",
                   kind="all-to-all,all-reduce", bytes=a2a_bytes):
        wg = replicated_input(wg, axis, m, "parallel.moe_ffn wg")
        dispatch, combine, aux = top1_gating(x @ wg, capacity)
        packed = torch.einsum("tec,td->ecd", dispatch, x)       # (E, C, d)
        # expert axis over the ranks; block j of the result came from j
        recv = all_to_all(packed, axis, m, "parallel.moe_ffn dispatch")
        recv = recv.view(n, E_l, capacity, d).transpose(0, 1).reshape(
            E_l, n * capacity, d)
        done = _expert_ffn(recv, w1, w2, activation)
        done = done.view(E_l, n, capacity, d).transpose(0, 1).reshape(
            E, capacity, d)
        back = all_to_all(done, axis, m, "parallel.moe_ffn combine")
        out = torch.einsum("tec,ecd->td", combine, back)
        aux = replicated_mean(aux, axis, m, "parallel.moe_ffn aux-loss pmean")
    return out, aux
