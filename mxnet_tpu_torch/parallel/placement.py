"""Placement over a named-axis mesh (port of
``mxnet_tpu/parallel/placement.py``): the ``__shard__`` grammar, the
default tensor-parallel recipe, the ZeRO state rule and the batch specs,
one rule source for every axis.

A placement is a :class:`Sharding`: a mesh plus one entry per tensor
dim, a mesh-axis name (the dim is split over that axis) or None
(replicated), as the JAX package's ``NamedSharding`` over a
``PartitionSpec`` (:class:`P`; ``sharding.spec`` is one).  Where the JAX
package hands the sharding to GSPMD, the port's callers read it
themselves: a rank holds the contiguous block :func:`shard_of` cuts
along each sharded dim, at its coordinate on that dim's axis, and
:func:`unshard` gathers the blocks back over the axes' process groups.

The ``__shard__`` grammar (a Symbol attr, per tensor): a comma list of
mesh-axis names or ``*`` per tensor dim, e.g. ``"tp,*"`` shards dim 0
over ``tp``; trailing dims default to ``*``.  More names than dims, or an
axis the mesh does not have, raise ``ValueError``; a named dim that does
not divide by its axis's extent silently becomes replicated (the
annotation is a layout hint, not a shape contract).  Unused axes mean
replication: a parameter names only the axes it is split over.
"""
from __future__ import annotations

from typing import Optional

__all__ = ["P", "Sharding", "as_mesh", "resolve_spec", "param_sharding",
           "zero_shard_dim", "state_sharding", "batch_sharding",
           "replicated", "constrain_outputs", "local_slice",
           "local_shape", "shard_of", "unshard"]


class P(tuple):
    """A partition spec: ``P("dp", None)`` splits dim 0 over ``dp``."""

    def __new__(cls, *dims):
        return super().__new__(cls, dims)

    def __repr__(self):
        return "P%s" % (tuple.__repr__(self),)


class Sharding(P):
    """A :class:`P` over a mesh (the JAX package's ``NamedSharding``):
    ``mesh`` and ``spec`` as there; the dims themselves are the tuple."""

    def __new__(cls, mesh, spec=()):
        self = super().__new__(cls, *tuple(spec))
        self.mesh = mesh
        return self

    @property
    def spec(self) -> P:
        return P(*self)

    def __repr__(self):
        return "Sharding(%s)" % (tuple.__repr__(self),)


def as_mesh(mesh_or_spec):
    """Accept a :class:`~mxnet_tpu_torch.parallel.mesh.Mesh` or a
    ``MeshSpec`` everywhere a mesh is needed."""
    return getattr(mesh_or_spec, "mesh", mesh_or_spec)


def resolve_spec(ann: str, shape, mesh, name: str = "") -> P:
    """``__shard__`` annotation -> :class:`P` over ``mesh``, one entry per
    dim of ``shape``.  Raises on arity overflow or unknown axis names;
    makes non-divisible named dims replicated."""
    mesh = as_mesh(mesh)
    dims = [None if d.strip() in ("*", "None", "") else d.strip()
            for d in str(ann).split(",")]
    if len(dims) > len(shape):
        raise ValueError(
            "__shard__=%r on %s names %d dims but the tensor has %d"
            % (ann, name or "<tensor>", len(dims), len(shape)))
    unknown = [d for d in dims if d is not None and d not in mesh.axis_names]
    if unknown:
        raise ValueError(
            "__shard__=%r on %s names mesh axes %s not in mesh %s"
            % (ann, name or "<tensor>", unknown, tuple(mesh.axis_names)))
    dims += [None] * (len(shape) - len(dims))
    dims = [d if (d is not None and shape[i] % mesh.shape[d] == 0)
            else None for i, d in enumerate(dims)]
    return P(*dims)


def param_sharding(name: str, shape, mesh, tp_axis: Optional[str] = None,
                   ann: Optional[str] = None) -> Sharding:
    """Placement of one parameter.  An explicit ``__shard__`` wins and may
    name any mesh axis.  Otherwise, with a tensor-parallel axis of more
    than one device, the default recipe shards dim 0 (output channels of
    an FC or Convolution weight, the vocab rows of an Embedding) of every
    ``*_weight`` of rank 2 or 4 whose dim 0 divides by the axis.
    Everything else is replicated over every axis."""
    mesh = as_mesh(mesh)
    if ann is not None:
        return Sharding(mesh, resolve_spec(ann, shape, mesh, name))
    if tp_axis is None or mesh.shape.get(tp_axis, 1) <= 1:
        return Sharding(mesh, ())
    size = mesh.shape[tp_axis]
    if name.endswith("_weight") and len(shape) in (2, 4) \
            and shape[0] % size == 0 and shape[0] >= size:
        return Sharding(mesh, [tp_axis] + [None] * (len(shape) - 1))
    return Sharding(mesh, ())


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


def state_sharding(base, shape, mesh, dp_axis: Optional[str]) -> Sharding:
    """Placement of one optimizer-state tensor (and the ZeRO grad/update
    view of its parameter): the parameter's own placement ``base`` plus
    the dp axis over :func:`zero_shard_dim`, so per-rank optimizer bytes
    scale as 1/dp."""
    mesh = as_mesh(mesh)
    size = mesh.shape.get(dp_axis, 1) if dp_axis else 1
    if size <= 1:
        return Sharding(mesh, tuple(base))
    dims = list(base) + [None] * (len(shape) - len(base))
    i = zero_shard_dim(shape, dims, size)
    if i is not None:
        dims[i] = dp_axis
    return Sharding(mesh, dims)


def batch_sharding(mesh, dp_axis: Optional[str],
                   accum: int = 1) -> Sharding:
    """Placement of one batch tensor: dp over dim 0, or, with gradient
    accumulation, dp over dim 1 under the micro dim the step walks."""
    if accum > 1:
        return Sharding(as_mesh(mesh), (None, dp_axis))
    return Sharding(as_mesh(mesh), (dp_axis,))


def replicated(mesh) -> Sharding:
    return Sharding(as_mesh(mesh), ())


def constrain_outputs(outs, ann: str, mesh, name: str = ""):
    """Activation annotation (the JAX package's
    ``with_sharding_constraint`` on an op's outputs, which changes no
    value): every output with enough dims for ``ann`` is checked against
    the grammar (:func:`resolve_spec`: the same errors) and passes through
    unchanged, since every rank of the port holds an activation whole;
    outputs the grammar cannot describe pass through unchecked."""
    n_dims = len(str(ann).split(","))
    for o in outs:
        shape = getattr(o, "shape", None)
        if shape is not None and len(shape) >= n_dims:
            resolve_spec(ann, shape, mesh, name)
    return tuple(outs)


def local_slice(spec, shape, mesh, index: int):
    """``(dim, start, stop)`` of the part of a ``shape`` tensor placed by
    ``spec`` that the rank at ``index`` on the spec's first split axis
    holds, or None for a replicated tensor."""
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        n = as_mesh(mesh).shape[axis]
        k = shape[dim] // n
        return dim, index * k, (index + 1) * k
    return None


def local_shape(shape, sharding, mesh=None):
    """The shape of one rank's block of a ``shape`` tensor."""
    mesh = as_mesh(mesh if mesh is not None else sharding.mesh)
    return tuple(d // mesh.shape[a] if a is not None else d
                 for d, a in zip(tuple(shape), tuple(sharding)
                                 + (None,) * len(shape)))


def shard_of(tensor, sharding, mesh=None):
    """This rank's block of the whole ``tensor`` (a view): along each
    sharded dim, the ``axis_index``-th of the axis's equal parts."""
    mesh = as_mesh(mesh if mesh is not None else sharding.mesh)
    for dim, axis in enumerate(sharding):
        if axis is None or mesh.shape.get(axis, 1) <= 1:
            continue
        k = tensor.shape[dim] // mesh.shape[axis]
        tensor = tensor.narrow(dim, mesh.axis_index(axis) * k, k)
    return tensor


def unshard(local, sharding, mesh=None, tag="placement.unshard",
            step=None):
    """The whole tensor from every rank's block (:func:`shard_of`): one
    all-gather over the group of each sharded dim's axis."""
    import torch
    import torch.distributed as dist

    from .audit import collective
    mesh = as_mesh(mesh if mesh is not None else sharding.mesh)
    for dim, axis in reversed(list(enumerate(sharding))):
        n = mesh.shape.get(axis, 1) if axis is not None else 1
        if n <= 1:
            continue
        moved = local.movedim(dim, 0).contiguous()
        out = torch.empty((n * moved.shape[0],) + tuple(moved.shape[1:]),
                          dtype=moved.dtype, device=moved.device)
        group = mesh.group(axis)
        collective("all-gather", tag, lambda: dist.all_gather_into_tensor(
            out, moved, group=group), nbytes=out.numel() *
            out.element_size(), step=step, axis=axis)
        local = out.movedim(0, dim)
    return local
