"""Placement over a named-axis mesh (port of
``mxnet_tpu/parallel/placement.py``): :func:`as_mesh` and the ZeRO state
rule.

A placement is a :class:`P`, one entry per tensor dim: a mesh-axis name
(the dim is split over that axis) or None (replicated), as the JAX
package's ``PartitionSpec``.  Where the JAX package hands a
``NamedSharding`` to GSPMD, the port's trainer reads the spec itself: a
rank holds the contiguous slice :func:`local_slice` names along the
sharded dim.  The ``__shard__`` grammar and the tensor-parallel recipe
(``resolve_spec``, ``param_sharding`` with a tp axis, the activation
constraints) are queue A item 7's second half.
"""
from __future__ import annotations

from typing import Optional

__all__ = ["P", "as_mesh", "zero_shard_dim", "state_sharding",
           "batch_sharding", "local_slice"]


class P(tuple):
    """A partition spec: ``P("dp", None)`` splits dim 0 over ``dp``."""

    def __new__(cls, *dims):
        return super().__new__(cls, dims)

    def __repr__(self):
        return "P%s" % (tuple.__repr__(self),)


def as_mesh(mesh_or_spec):
    """Accept a :class:`~mxnet_tpu_torch.parallel.mesh.Mesh` or a
    ``MeshSpec`` everywhere a mesh is needed."""
    return getattr(mesh_or_spec, "mesh", mesh_or_spec)


def zero_shard_dim(shape, taken, size: int) -> Optional[int]:
    """The dim the ZeRO state shard rides on: the LARGEST free dim that
    divides by the dp extent (the JAX package's rule: an exact division
    of the biggest dim keeps per-shard minor dims fat).  Ties break to the
    earliest dim (the same layout on every rank)."""
    best = None
    for i, d in enumerate(shape):
        if taken[i] is not None:
            continue
        if d % size == 0 and d >= size:
            if best is None or d > shape[best]:
                best = i
    return best


def state_sharding(base, shape, mesh, dp_axis: Optional[str]) -> P:
    """Placement of one optimizer-state tensor (and the ZeRO grad/update
    view of its parameter): the parameter's own placement ``base`` plus
    the dp axis over :func:`zero_shard_dim`, so per-rank optimizer bytes
    scale as 1/dp."""
    size = mesh.shape.get(dp_axis, 1) if dp_axis else 1
    if size <= 1:
        return P(*base)
    dims = list(base) + [None] * (len(shape) - len(base))
    i = zero_shard_dim(shape, dims, size)
    if i is not None:
        dims[i] = dp_axis
    return P(*dims)


def batch_sharding(mesh, dp_axis: Optional[str], accum: int = 1) -> P:
    """Placement of one batch tensor: dp over dim 0, or, with gradient
    accumulation, dp over dim 1 under the micro dim the step walks."""
    if accum > 1:
        return P(None, dp_axis)
    return P(dp_axis)


def local_slice(spec, shape, mesh, index: int):
    """``(dim, start, stop)`` of the part of a ``shape`` tensor placed by
    ``spec`` that the rank at ``index`` on the spec's one split axis
    holds, or None for a replicated tensor."""
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        n = mesh.shape[axis]
        k = shape[dim] // n
        return dim, index * k, (index + 1) * k
    return None
