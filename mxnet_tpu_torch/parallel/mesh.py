"""Device mesh (port of ``mxnet_tpu/parallel/mesh.py``): named axes over
the ranks of the default ``torch.distributed`` group, one device per
rank.

Axis names keep the JAX package's roles ('dp' data parallel, 'tp' tensor
parallel, 'pp', 'sp', 'ep'), so a caller builds the same
``MeshSpec(make_mesh((2,), ("dp",)))`` or ``MeshSpec.build({"dp": 2})``.
A mesh of one device needs no gang; a mesh of more joins the one
``tools/launch.py`` started (:func:`~mxnet_tpu_torch.parallel.
init_distributed`) and must span every rank.  Only the dp axis may
exceed one device, so its collectives run over the default group;
tp/pp/sp/ep and user-named axes, and the process group of each axis that
they need, wait for queue A item 7's second half
(:class:`~mxnet_tpu_torch.base.NotPortedYet`).
"""
from __future__ import annotations

import threading
from typing import Optional, Sequence

import numpy as np
import torch

from ..base import NotPortedYet, resolve_device

__all__ = ["Mesh", "MeshSpec", "make_mesh", "data_parallel_mesh",
           "reform_mesh", "current_mesh", "set_current_mesh", "shard_batch",
           "replicate", "describe_devices"]

_ROLE_AXES = ("dp", "tp", "pp", "sp", "ep")
_DATA_AXIS = "dp"


class Mesh:
    """Named axes over the ranks: ``shape`` maps each axis name to its
    size, ``device`` is this rank's device, ``size`` the number of
    ranks."""

    def __init__(self, axis_names: Sequence[str], shape: Sequence[int],
                 device):
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in shape)))
        self.size = int(np.prod(list(self.shape.values()) or [1]))
        self.device = device

    def axis_index(self, axis) -> int:
        """This rank's coordinate on ``axis`` (0 on an axis of size 1)."""
        if self.shape.get(axis, 1) <= 1:
            return 0
        import torch.distributed as dist
        return dist.get_rank()

    def __repr__(self):
        return "Mesh(%s on %s)" % (self.shape, self.device)


def make_mesh(shape: Sequence[int], axis_names: Sequence[str],
              device=None) -> Mesh:
    """A mesh of ``shape``.  One device: the card (``device=None``; a
    typed :class:`~mxnet_tpu_torch.base.DeviceUnavailable` without one)
    or the device given.  More: one rank per device, the gang joined
    here if it is not yet, on each rank's own device (or ``device``)."""
    shape = tuple(int(s) for s in shape)
    axis_names = tuple(axis_names)
    if len(shape) != len(axis_names):
        raise ValueError("mesh shape %r does not match axis names %r"
                         % (shape, axis_names))
    n = int(np.prod(shape))
    if n == 1:
        return Mesh(axis_names, shape, resolve_device(device))
    wide = [a for a, s in zip(axis_names, shape) if s > 1 and a != _DATA_AXIS]
    if wide:
        raise NotPortedYet(
            "mesh %s: an axis other than 'dp' over more than one device "
            "(tp/pp/sp/ep placement, ring, pipeline, MoE) is queue A item "
            "7's second half" % dict(zip(axis_names, shape)))
    from . import init_distributed, world_size
    init_distributed(device=device)
    if world_size() != n:
        raise ValueError("mesh of %d devices requested, the gang has %d "
                         "processes (one device per rank)"
                         % (n, world_size()))
    return Mesh(axis_names, shape, resolve_device(device))


class MeshSpec:
    """One mesh plus the axis-role layout (the JAX package's
    ``MeshSpec``); ``device`` is where this rank's state and step run."""

    def __init__(self, mesh: Mesh, dp_axis="dp", tp_axis=None, pp_axis=None,
                 sp_axis=None, ep_axis=None, generation=0):
        self.mesh = mesh
        self.dp_axis = dp_axis
        self.tp_axis = tp_axis
        self.pp_axis = pp_axis
        self.sp_axis = sp_axis
        self.ep_axis = ep_axis
        self.generation = int(generation)

    @classmethod
    def build(cls, axes, device=None, generation=0) -> "MeshSpec":
        """One mesh from an ``{axis_name: size}`` mapping (or a ``(name,
        size)`` sequence, outermost first); conventionally-named axes
        (dp/tp/pp/sp/ep) are wired to their roles."""
        items = list(axes.items()) if isinstance(axes, dict) else \
            [(str(n), int(s)) for n, s in axes]
        names = [n for n, _ in items]
        if len(set(names)) != len(names):
            raise ValueError("duplicate mesh axis names: %r" % (names,))
        mesh = make_mesh([s for _, s in items], names, device=device)
        roles = {a + "_axis": (a if a in names else None)
                 for a in _ROLE_AXES}
        return cls(mesh, generation=generation, **roles)

    @property
    def device(self):
        return self.mesh.device

    def axis_size(self, name) -> int:
        return int(self.mesh.shape.get(name, 1)) if name else 1

    @property
    def dp_size(self):
        return self.axis_size(self.dp_axis)

    @property
    def dp_rank(self) -> int:
        return self.mesh.axis_index(self.dp_axis)

    @property
    def model_axes(self):
        """Active (size > 1) non-dp role axes."""
        return tuple(a for a in (self.tp_axis, self.pp_axis, self.sp_axis,
                                 self.ep_axis)
                     if a and self.axis_size(a) > 1)


_state = threading.local()


def data_parallel_mesh(num_devices: Optional[int] = None,
                       generation: Optional[int] = None,
                       device=None) -> MeshSpec:
    """A pure-dp mesh over the gang (every rank; one device outside a
    gang).  ``generation`` defaults to 0: the elastic incarnation counter
    is queue A item 8."""
    from . import init_distributed, world_size
    init_distributed(device=device)
    n = num_devices or world_size()
    return MeshSpec(make_mesh((n,), ("dp",), device=device),
                    generation=generation or 0)


def reform_mesh(spec: MeshSpec, generation: Optional[int] = None,
                devices=None) -> MeshSpec:
    """Re-form ``spec`` over the current gang (or ``devices`` of them, a
    count or a sequence): non-dp axes keep their extent and the dp axis
    absorbs the change; the generation is bumped."""
    from . import world_size
    if devices is None:
        n = world_size()
    else:
        n = devices if isinstance(devices, int) else len(list(devices))
    axes = list(spec.mesh.axis_names)
    sizes = dict(spec.mesh.shape)
    other = 1
    for a in axes:
        if a != spec.dp_axis:
            other *= sizes[a]
    if other <= 0 or n % other:
        raise ValueError(
            "cannot re-form mesh %s over %d devices: non-dp axes need "
            "%d-device multiples" % (dict(sizes), n, other))
    sizes[spec.dp_axis] = n // other
    shape = tuple(sizes[a] for a in axes)
    gen = spec.generation + 1 if generation is None else int(generation)
    return MeshSpec(make_mesh(shape, axes, device=spec.device),
                    dp_axis=spec.dp_axis, tp_axis=spec.tp_axis,
                    pp_axis=spec.pp_axis, sp_axis=spec.sp_axis,
                    ep_axis=spec.ep_axis, generation=gen)


def current_mesh() -> Optional[MeshSpec]:
    return getattr(_state, "mesh", None)


def set_current_mesh(spec: Optional[MeshSpec]):
    _state.mesh = spec


def _as_tensor(x, device):
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.as_tensor(np.asarray(x), device=device)


def shard_batch(x, spec: MeshSpec, axis: int = 0):
    """This rank's dp shard of a host batch (the ``dp_rank``-th of
    ``dp_size`` equal parts along ``axis``), on the rank's device."""
    n, r = spec.dp_size, spec.dp_rank
    extent = x.shape[axis]
    if extent % n:
        raise ValueError("batch dim %d is not divisible by the dp size %d"
                         % (extent, n))
    k = extent // n
    part = x[(slice(None),) * axis + (slice(r * k, (r + 1) * k),)]
    return _as_tensor(part, spec.device)


def replicate(x, spec: MeshSpec):
    """``x`` on this rank's device (every rank holds the same value)."""
    return _as_tensor(x, spec.device)


def describe_devices() -> dict:
    """Topology snapshot for diagnostics: process rank/count, the devices
    of this process, and the current mesh layout if one is active.  Never
    raises: each field degrades to an error string."""
    from . import rank, world_size
    out = {}
    try:
        out["process_index"] = rank()
        out["process_count"] = world_size()
    except Exception as e:  # noqa: BLE001 - diagnostics never raise
        out["process"] = repr(e)
    try:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        out["devices"] = [
            {"id": i, "platform": "gpu", "process_index": out.get(
                "process_index", 0), "kind": torch.cuda.get_device_name(i)}
            for i in range(n)] or [{"id": 0, "platform": "cpu",
                                    "process_index": out.get(
                                        "process_index", 0), "kind": "cpu"}]
    except Exception as e:  # noqa: BLE001
        out["devices"] = repr(e)
    try:
        spec = current_mesh()
        if spec is not None:
            out["mesh"] = {"shape": dict(spec.mesh.shape),
                           "axes": list(spec.mesh.axis_names),
                           "generation": spec.generation}
    except Exception as e:  # noqa: BLE001
        out["mesh"] = repr(e)
    return out
