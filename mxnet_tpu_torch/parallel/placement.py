"""Placement over a named-axis mesh (port of
``mxnet_tpu/parallel/placement.py``).

Only :func:`as_mesh` so far: the embedding plane accepts a mesh or a
:class:`~mxnet_tpu_torch.parallel.mesh.MeshSpec` through it.  The
``__shard__`` grammar, the tensor-parallel recipe and the ZeRO state rule
need a mesh of more than one device (ROADMAP queue A item 7).
"""
from __future__ import annotations

__all__ = ["as_mesh"]


def as_mesh(mesh_or_spec):
    """Accept a :class:`~mxnet_tpu_torch.parallel.mesh.Mesh` or a
    ``MeshSpec`` everywhere a mesh is needed."""
    return getattr(mesh_or_spec, "mesh", mesh_or_spec)
