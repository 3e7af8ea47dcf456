"""Device mesh (port of ``mxnet_tpu/parallel/mesh.py``): named axes over
the ranks of a ``torch.distributed`` gang, one device per rank.

Axis names keep the JAX package's roles ('dp' data parallel, 'tp' tensor
parallel, 'pp', 'sp', 'ep'; any other name is a plain axis that
``__shard__`` annotations may name), so a caller builds the same
``MeshSpec(make_mesh((2, 2), ("dp", "tp")))`` or
``MeshSpec.build({"dp": 2, "tp": 2})``.  A mesh of one device needs no
gang; a mesh of more joins the one ``tools/launch.py`` started
(:func:`~mxnet_tpu_torch.parallel.init_distributed`) and spans every
rank.  Rank ``r`` sits at ``np.unravel_index(r, shape)``, the row-major
order in which the JAX package lays its devices out, so rank ``r`` holds
the shard the JAX package places on device ``r``.

Every axis wider than one device has its own process groups, one per
coordinate of the other axes: for dp2 x tp2 the tp groups are ranks
{0, 1} and {2, 3}, the dp groups {0, 2} and {1, 3}.  Every rank creates
every group, in the same order, when the mesh is made (a layout's groups
are made once per gang and shared by the meshes of that layout);
:meth:`Mesh.group` is this rank's group on an axis and
:meth:`Mesh.axis_index` its position there.  The dp and tp trainers and
tensor-parallel decode run each collective over the group of its axis,
never over the default group.

On the CPU the gang talks gloo.  On cards it talks NCCL, one rank per
card; where two ranks share one card (one H100 host), NCCL refuses the
communicator, and the caller names gloo (``MXNET_TPU_DIST_BACKEND=gloo``),
which carries CUDA tensors through the host, subgroups included.
"""
from __future__ import annotations

import itertools
import threading
from typing import Optional, Sequence

import numpy as np
import torch

from ..base import resolve_device

__all__ = ["Mesh", "MeshSpec", "make_mesh", "data_parallel_mesh",
           "reform_mesh", "current_mesh", "set_current_mesh", "shard_batch",
           "replicate", "describe_devices"]

_ROLE_AXES = ("dp", "tp", "pp", "sp", "ep")
# (default group, axis names, shape, axes) -> this rank's group on axes
_GROUPS = {}


class Mesh:
    """Named axes over the ranks: ``shape`` maps each axis name to its
    size, ``device`` is this rank's device, ``size`` the number of ranks,
    ``rank`` this rank's index (its coordinates are its unravelled
    index)."""

    def __init__(self, axis_names: Sequence[str], shape: Sequence[int],
                 device, rank: int = 0, groups=None):
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in shape)))
        self.size = int(np.prod(list(self.shape.values()) or [1]))
        self.device = device
        self.rank = int(rank)
        dims = tuple(self.shape[a] for a in self.axis_names)
        self.coords = dict(zip(self.axis_names, (
            int(c) for c in np.unravel_index(self.rank, dims)))) \
            if dims else {}
        self._groups = dict(groups or {})

    def axis_index(self, axis) -> int:
        """This rank's coordinate on ``axis`` (0 on an axis of size 1 or
        one the mesh does not have)."""
        return self.coords.get(axis, 0)

    def axis_ranks(self, axis):
        """The ranks of this rank's group on ``axis``, in axis order."""
        n = self.shape.get(axis, 1)
        dims = tuple(self.shape[a] for a in self.axis_names)
        out = []
        for j in range(n):
            c = dict(self.coords, **{axis: j}) if axis in self.shape \
                else dict(self.coords)
            out.append(int(np.ravel_multi_index(
                tuple(c[a] for a in self.axis_names), dims)) if dims else 0)
        return out

    def group(self, axis):
        """This rank's process group on ``axis``, or None for an axis of
        one device (nothing to talk to)."""
        if self.shape.get(axis, 1) <= 1:
            return None
        return self._groups[axis]

    def joint_group(self, axes):
        """This rank's process group spanning every axis in ``axes`` at
        once (the ranks that share this rank's coordinates on the other
        axes), or None when they span one rank.  Made on first use, by
        every rank in the same order (a collective call)."""
        axes = tuple(a for a in self.axis_names if a in axes)
        if int(np.prod([self.shape[a] for a in axes] or [1])) <= 1:
            return None
        if axes not in self._groups:
            self._groups[axes] = _joint_groups(self.axis_names, tuple(
                self.shape[a] for a in self.axis_names), axes)
        return self._groups[axes]

    def __repr__(self):
        return "Mesh(%s on %s)" % (self.shape, self.device)


def _axis_groups(axis_names, shape):
    """This rank's group of each axis wider than 1 (:func:`_joint_groups`
    of the axis alone, axis by axis)."""
    return {a: _joint_groups(axis_names, shape, (a,))
            for a, n in zip(axis_names, shape) if n > 1}


def _joint_groups(axis_names, shape, axes):
    """One ``new_group`` per coordinate of the axes not in ``axes``, over
    the ranks that vary along ``axes`` (row-major, every rank in the same
    order); returns this rank's, cached per layout."""
    import torch.distributed as dist
    from . import _STATE
    from torch.distributed import distributed_c10d
    key = (id(distributed_c10d._get_default_group()), tuple(axis_names),
           tuple(shape), tuple(axes))
    if key in _GROUPS:
        return _GROUPS[key]
    me = dist.get_rank()
    timeout = _STATE.get("timeout")
    kw = {"timeout": timeout} if timeout is not None else {}
    inner = [i for i, a in enumerate(axis_names) if a in axes]
    outer = [i for i in range(len(shape)) if i not in inner]
    mine = None
    for rest in itertools.product(*[range(shape[i]) for i in outer]):
        ranks = []
        for c in itertools.product(*[range(shape[i]) for i in inner]):
            idx = [0] * len(shape)
            for i, x in zip(outer, rest):
                idx[i] = x
            for i, x in zip(inner, c):
                idx[i] = x
            ranks.append(int(np.ravel_multi_index(idx, tuple(shape))))
        g = dist.new_group(sorted(ranks), **kw)
        if me in ranks:
            mine = g
    _GROUPS[key] = mine
    return mine


def make_mesh(shape: Sequence[int], axis_names: Sequence[str],
              device=None) -> Mesh:
    """A mesh of ``shape``.  One device: the card (``device=None``; a
    typed :class:`~mxnet_tpu_torch.base.DeviceUnavailable` without one)
    or the device given.  More: one rank per device, the gang joined
    here if it is not yet, on each rank's own device (or ``device``), and
    the process groups of every axis wider than one device made."""
    shape = tuple(int(s) for s in shape)
    axis_names = tuple(axis_names)
    if len(shape) != len(axis_names):
        raise ValueError("mesh shape %r does not match axis names %r"
                         % (shape, axis_names))
    n = int(np.prod(shape))
    if n == 1:
        return Mesh(axis_names, shape, resolve_device(device))
    from . import init_distributed, rank, world_size
    init_distributed(device=device)
    if world_size() != n:
        raise ValueError("mesh of %d devices requested, the gang has %d "
                         "processes (one device per rank)"
                         % (n, world_size()))
    return Mesh(axis_names, shape, resolve_device(device), rank=rank(),
                groups=_axis_groups(axis_names, shape))


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
