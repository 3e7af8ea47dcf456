"""Two-tier hierarchical all-reduce for multi-island meshes (port of
``mxnet_tpu/parallel/hierarchy.py``).

An island's links (NVLink within a host) carry an order of magnitude
more than the tier between islands, so a flat ring all-reduce over both
tiers is priced by its slowest links.  The two-tier schedule moves only
a 1/k shard over the slow tier:

1. **reduce-scatter over the fast axis**: each of the k ranks of an
   island ends up with the island's sum of one 1/k shard;
2. **all-reduce over the slow axis** of that shard, among the ranks of
   the m islands that own it: 2(m-1)/m · P/k bytes a rank on the slow
   tier, against 2(N-1)/N · P on a flat ring's crossing link;
3. **all-gather over the fast axis**: every rank reassembles the whole
   sum.

Each rank passes its own value (the JAX package's ``stacked`` row r, in
island-major rank order) and gets the global sum.  A value whose element
count does not divide k is zero-padded for the scatter and trimmed after
the gather.  Each call's audit trail, per axis, equals
:func:`~mxnet_tpu_torch.parallel.audit.hierarchical_allreduce_model_bytes`.

Not ported: the hang watchdog (``resilience/watchdog.py``, ROADMAP queue
A item 8).
"""
from __future__ import annotations

import torch
from torch.utils._pytree import tree_map

from .audit import collective

__all__ = ["two_tier_psum", "hierarchical_allreduce", "flat_allreduce",
           "hierarchical_grad_allreduce"]


def _dist():
    import torch.distributed as dist
    return dist


def _mesh(mesh):
    from .mesh import current_mesh
    from .placement import as_mesh
    return as_mesh(mesh if mesh is not None else current_mesh())


def two_tier_psum(v, fast_axis: str, fast_size: int, slow_axis: str,
                  mesh=None):
    """The two-tier all-reduce of this rank's ``v`` over ``mesh``'s (default:
    the current mesh's) ``fast_axis`` (``fast_size`` ranks) and
    ``slow_axis``: reduce-scatter(fast), all-reduce(slow) on the 1/k
    shard, all-gather(fast).  Returns the global sum in ``v``'s shape; an
    axis of one rank moves nothing."""
    dist = _dist()
    m = _mesh(mesh)
    k = max(1, int(fast_size))
    if m.shape.get(fast_axis, 1) != k:
        raise ValueError("two_tier_psum: axis %r has %d ranks, not %d"
                         % (fast_axis, m.shape.get(fast_axis, 1), k))
    fast, slow = m.group(fast_axis), m.group(slow_axis)
    flat = v.reshape(-1)
    size = flat.numel()
    pad = (-size) % k
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    flat = flat.contiguous()
    elem = flat.element_size()
    if fast is not None:
        shard = flat.new_empty(flat.numel() // k)
        collective("reduce-scatter", "parallel.hierarchical fast tier",
                   lambda: dist.reduce_scatter_tensor(shard, flat,
                                                      group=fast),
                   nbytes=shard.numel() * elem, axis=fast_axis)
    else:
        shard = flat.clone()
    if slow is not None:
        collective("all-reduce", "parallel.hierarchical slow tier",
                   lambda: dist.all_reduce(shard, group=slow),
                   nbytes=shard.numel() * elem, axis=slow_axis)
    if fast is not None:
        full = flat.new_empty(flat.numel())
        collective("all-gather", "parallel.hierarchical fast tier",
                   lambda: dist.all_gather_into_tensor(full, shard,
                                                       group=fast),
                   nbytes=full.numel() * elem, axis=fast_axis)
    else:
        full = shard
    return full[:size].view(v.shape)


def hierarchical_allreduce(v, mesh, slow_axis: str = "island",
                           fast_axis: str = "dp"):
    """The global sum of every rank's ``v`` by the two-tier schedule over
    ``mesh`` (a Mesh or MeshSpec naming both axes)."""
    m = _mesh(mesh)
    return two_tier_psum(v, fast_axis, m.shape.get(fast_axis, 1), slow_axis,
                         m)


def flat_allreduce(v, mesh, slow_axis: str = "island", fast_axis: str = "dp"):
    """The flat baseline: one all-reduce over the group spanning both axes
    (recorded under ``"<slow>,<fast>"``); what the two-tier schedule's
    slow-tier bytes are audited against."""
    m = _mesh(mesh)
    group = m.joint_group((slow_axis, fast_axis))
    y = v.clone()
    if group is not None:
        collective("all-reduce", "parallel.flat_allreduce",
                   lambda: _dist().all_reduce(y, group=group),
                   nbytes=y.numel() * y.element_size(),
                   axis=slow_axis + "," + fast_axis)
    return y


def hierarchical_grad_allreduce(tree, mesh, slow_axis: str = "island",
                                fast_axis: str = "dp"):
    """:func:`hierarchical_allreduce` of every tensor of a list / tuple /
    dict tree, in its structure."""
    return tree_map(lambda v: hierarchical_allreduce(v, mesh, slow_axis,
                                                     fast_axis), tree)
