"""Device mesh (port of ``MeshSpec`` / ``make_mesh`` from
``mxnet_tpu/parallel/mesh.py``) over ONE device.

Axis names keep the JAX package's roles ('dp' data parallel, 'tp' tensor
parallel, ...), so a caller builds the same ``MeshSpec(make_mesh((1,),
("dp",)))``.  A mesh of more than one device needs collectives over NCCL
(ROADMAP queue A5) and raises :class:`~mxnet_tpu_torch.base.NotPortedYet`.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from ..base import NotPortedYet, resolve_device

__all__ = ["Mesh", "MeshSpec", "make_mesh"]

class Mesh:
    """Named axes over one torch device: ``shape`` maps each axis name to
    its size (all 1)."""

    def __init__(self, axis_names: Sequence[str], device):
        self.axis_names = tuple(axis_names)
        self.shape = {n: 1 for n in self.axis_names}
        self.device = device

    def __repr__(self):
        return "Mesh(%s on %s)" % (self.shape, self.device)


def make_mesh(shape: Sequence[int], axis_names: Sequence[str],
              device=None) -> Mesh:
    """A mesh of ``shape`` over the card (``device=None``; a typed
    :class:`~mxnet_tpu_torch.base.DeviceUnavailable` without one) or the
    device given (``"cpu"``).  Every axis must have size 1."""
    shape = tuple(int(s) for s in shape)
    if len(shape) != len(axis_names):
        raise ValueError("mesh shape %r does not match axis names %r"
                         % (shape, tuple(axis_names)))
    if int(np.prod(shape)) != 1:
        raise NotPortedYet("a mesh of %d devices (%s): meshes of more than "
                           "one device need NCCL collectives (ROADMAP A5)"
                           % (int(np.prod(shape)), dict(zip(axis_names,
                                                            shape))))
    return Mesh(axis_names, resolve_device(device))


class MeshSpec:
    """One mesh plus the axis-role layout (the JAX package's
    ``MeshSpec``); here every axis has size 1 and ``device`` is where the
    state and the step run."""

    def __init__(self, mesh: Mesh, dp_axis="dp", tp_axis=None, pp_axis=None,
                 sp_axis=None, ep_axis=None, generation=0):
        self.mesh = mesh
        self.dp_axis = dp_axis
        self.tp_axis = tp_axis
        self.pp_axis = pp_axis
        self.sp_axis = sp_axis
        self.ep_axis = ep_axis
        self.generation = int(generation)

    @property
    def device(self):
        return self.mesh.device
