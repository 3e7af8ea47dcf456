"""Training over a device mesh (port of ``mxnet_tpu/parallel``).

The JAX package is one process over many devices (GSPMD inserts the
collectives); the port is one process per device, as PyTorch and MXNet's
own dist kvstores are, over ``torch.distributed``:

* :func:`init_distributed` joins the gang ``tools/launch.py`` starts,
  from its env protocol: ``DMLC_NUM_WORKER``, ``DMLC_WORKER_ID`` and
  ``MXNET_TPU_COORDINATOR`` (the ``TCPStore`` address).  A rank sits on
  card ``DMLC_WORKER_ID % device_count`` and talks NCCL, unless
  ``MXNET_TPU_DIST_DEVICE=cpu`` (the launcher's default) puts it on the
  CPU with gloo.  The caller may name the device and the backend
  (``MXNET_TPU_DIST_BACKEND`` too); a rank never switches backend
  because one failed.  Every group has a timeout, so a lost rank fails
  in seconds instead of hanging its peers.
* :mod:`.mesh` (named axes over the ranks, one process group per axis
  coordinate), :mod:`.placement` (the ``__shard__`` grammar, the tp
  recipe, the ZeRO state rule, shard and unshard), :mod:`.trainer` (dp,
  tp and ZeRO), :mod:`.audit` (the collective trail by axis, and the wire
  models).
* :func:`barrier`, :func:`allreduce_array`, :func:`allreduce_many`,
  :func:`allgather_tensor` and :func:`allreduce_row_sparse` (the JAX
  package's union-sum), each through :func:`audit.collective`.  The first
  four take ``axis=`` (default "dp") and ``mesh=``: over a mesh's axis
  they run over that axis's group; with no mesh (a store spanning the
  gang) over the default group, recorded as "world".

A tensor-parallel gang on the CPU is a launcher gang with
``--dist-device cpu`` (gloo).  On cards each rank has its card and talks
NCCL; two ranks of one card (tp 2 on one H100) must name gloo
(``MXNET_TPU_DIST_BACKEND=gloo``): NCCL refuses the communicator, and no
rank falls back by itself.

The per-axis programs of the JAX package's ``shard_map`` kernels, each
over one axis's group and taking this rank's shard of a sharded
argument: :mod:`.ring` (ring attention over sp on the flash kernels),
:mod:`.pipeline` (the GPipe tick schedule over pp), :mod:`.moe` (switch
top-1 dispatch over ep) and :mod:`.hierarchy` (the two-tier all-reduce),
built on :mod:`.comm`'s differentiable collectives (``ppermute`` as one
``all_to_all_single`` with split sizes, the all-to-all, the
replicated-input and replicated-output rules).  A mesh that also carries
dp/tp axes composes: only the named axis's group talks.
"""
from __future__ import annotations

import contextlib
import datetime
import os
from collections import namedtuple

import torch

from ..base import DeviceUnavailable, MXNetError
from .audit import collective
from .hierarchy import (flat_allreduce, hierarchical_allreduce,
                        hierarchical_grad_allreduce, two_tier_psum)
from .mesh import (Mesh, MeshSpec, current_mesh, data_parallel_mesh,
                   describe_devices, make_mesh, reform_mesh, replicate,
                   set_current_mesh, shard_batch)
from .moe import moe_ffn, moe_ffn_dense, top1_gating
from .pipeline import PipelineRunner, pipeline_apply
from .ring import local_ring_attention_fn, ring_attention
from .trainer import ShardedTrainer

__all__ = ["Topology", "topology", "init_distributed", "barrier",
           "allreduce_array", "allreduce_many", "allreduce_row_sparse",
           "Mesh", "MeshSpec", "make_mesh", "data_parallel_mesh",
           "reform_mesh", "current_mesh", "set_current_mesh", "shard_batch",
           "replicate", "describe_devices", "ShardedTrainer", "rank",
           "world_size", "gang_device", "allgather_tensor",
           "ring_attention", "local_ring_attention_fn", "pipeline_apply",
           "PipelineRunner", "moe_ffn", "moe_ffn_dense", "top1_gating",
           "two_tier_psum", "hierarchical_allreduce", "flat_allreduce",
           "hierarchical_grad_allreduce"]

Topology = namedtuple("Topology", ["process_index", "process_count",
                                   "local_device_count",
                                   "global_device_count"])

_STATE = {"device": None, "backend": None, "timeout": None}


def _dist():
    import torch.distributed as dist
    return dist


def _initialized() -> bool:
    dist = _dist()
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return _dist().get_rank() if _initialized() else 0


def world_size() -> int:
    return _dist().get_world_size() if _initialized() else 1


def _gang_env():
    """``(coordinator, world, rank)`` under the launcher's env protocol
    with more than one worker, else None."""
    coord = os.environ.get("MXNET_TPU_COORDINATOR")
    world = int(os.environ.get("DMLC_NUM_WORKER", "1") or 1)
    if not coord or world <= 1:
        return None
    return coord, world, int(os.environ.get("DMLC_WORKER_ID", "0") or 0)


def _pick_device(device, rank_id):
    """The caller's device, else the CPU when ``MXNET_TPU_DIST_DEVICE``
    says ``cpu``, else card ``rank % device_count`` (a typed
    :class:`~mxnet_tpu_torch.base.DeviceUnavailable` without one).  Only
    counts the cards: CUDA is not initialised here, so a parent that
    forks data workers afterwards stays fork-safe."""
    if device is not None:
        return torch.device(device)
    if os.environ.get("MXNET_TPU_DIST_DEVICE", "").strip().lower() == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise DeviceUnavailable(
            "rank %d: no CUDA device is visible; launch with --dist-device "
            "cpu (MXNET_TPU_DIST_DEVICE=cpu) for the CPU" % rank_id)
    return torch.device("cuda", rank_id % torch.cuda.device_count())


def gang_device():
    """This rank's device in a gang (the one :func:`init_distributed`
    chose, or the one it would choose from the launcher's env), else
    None outside a gang.  ``base.resolve_device(None)`` asks here, so
    every entry point of a rank defaults to the rank's device."""
    if _STATE["device"] is not None:
        return _STATE["device"]
    env = _gang_env()
    if env is None:
        return None
    return _pick_device(None, env[2])


def backend():
    """The default group's backend ("nccl" / "gloo"), or None."""
    return _dist().get_backend() if _initialized() else None


def topology() -> Topology:
    if not _initialized():
        return Topology(0, 1, 1, 1)
    dev = _STATE["device"]
    local = torch.cuda.device_count() if dev is not None and \
        dev.type == "cuda" else 1
    return Topology(rank(), world_size(), local, world_size())


def init_distributed(coordinator_address=None, num_processes=None,
                     process_id=None, backend=None, device=None,
                     timeout=None) -> Topology:
    """Join the gang (the tracker/Postoffice analog; reference
    tools/launch.py + ps::Postoffice).  Arguments override the launcher's
    env; with no coordinator, or one process that was not asked for by
    ``num_processes=1``, this is a no-op.  A second
    call returns the topology of the first.  ``backend`` defaults to
    ``MXNET_TPU_DIST_BACKEND``, else NCCL for a rank on a card and gloo on
    the CPU; ``timeout`` (seconds) to ``MXNET_TPU_DIST_TIMEOUT``, else 60.
    A communicator the backend refuses raises at its first collective;
    the rank does not fall back to another backend."""
    dist = _dist()
    if _initialized():
        return topology()
    env = os.environ
    coord = coordinator_address or env.get("MXNET_TPU_COORDINATOR")
    world = int(num_processes if num_processes is not None else
                env.get("DMLC_NUM_WORKER", "1") or 1)
    rk = int(process_id if process_id is not None else
             env.get("DMLC_WORKER_ID", "0") or 0)
    if not coord or (world <= 1 and num_processes is None):
        return topology()
    dev = _pick_device(device, rk)
    backend = (backend or os.environ.get("MXNET_TPU_DIST_BACKEND", "")
               .strip() or ("nccl" if dev.type == "cuda" else "gloo"))
    if backend == "nccl" and dev.type != "cuda":
        raise MXNetError("the nccl backend needs ranks on cards; rank %d is "
                         "on %s" % (rk, dev))
    secs = float(timeout if timeout is not None else
                 os.environ.get("MXNET_TPU_DIST_TIMEOUT", "60"))
    timeout = datetime.timedelta(seconds=secs)
    dist.init_process_group(backend, init_method="tcp://" + coord,
                            world_size=world, rank=rk, timeout=timeout)
    _STATE.update(device=dev, backend=backend, timeout=timeout)
    return topology()


def store():
    """The default group's ``TCPStore`` (the coordinator), or None."""
    if not _initialized():
        return None
    from torch.distributed import distributed_c10d
    return distributed_c10d._get_default_store()


def barrier(name="kvstore_barrier"):
    """Global barrier (reference KVStore::Barrier, kvstore.h:349)."""
    if world_size() <= 1:
        return
    dist = _dist()
    dev = _STATE["device"]
    kw = {"device_ids": [dev.index]} if backend() == "nccl" else {}
    collective("barrier", name, lambda: dist.barrier(**kw), nbytes=0)


def _tensor(x):
    return getattr(x, "_handle", x)


def axis_group(axis="dp", mesh=None):
    """``(group, label)`` a collective over ``axis`` runs on: the group of
    ``mesh`` (a Mesh or MeshSpec) on that axis, else the default group
    (the gang as one dp axis), labelled "world"."""
    from .placement import as_mesh
    m = as_mesh(mesh)
    if m is not None and m.shape.get(axis, 1) > 1:
        return m.group(axis), axis
    return None, "world"


def allreduce_array(x, axis="dp", mesh=None, tag="parallel.allreduce_array"):
    """The sum of ``x`` (a tensor or an NDArray) over ``axis`` (see
    :func:`axis_group`), as a new tensor (an NDArray for an NDArray);
    ``x`` itself with one process.  ``tag`` names it in the audit trail."""
    if world_size() <= 1:
        return x
    group, label = axis_group(axis, mesh)
    t = _tensor(x).clone()
    collective("all-reduce", tag,
               lambda: _dist().all_reduce(t, group=group), nbytes=t.numel() *
               t.element_size(), axis=label)
    if t is not x and hasattr(x, "_handle"):
        from ..ndarray.ndarray import NDArray
        return NDArray(t)
    return t


def allreduce_many(tensors, tag, step=None, axis="dp", mesh=None):
    """Each tensor summed over ``axis`` (see :func:`axis_group`): one
    all-reduce per dtype and device over a flat buffer.  Returns the sums
    (views of the buffers), in order; the inputs are left as they
    were."""
    group, label = axis_group(axis, mesh)
    out = list(tensors)
    buckets = {}
    for i, t in enumerate(out):
        buckets.setdefault((t.dtype, t.device), []).append(i)
    for idx in buckets.values():
        flat = torch.cat([out[i].reshape(-1) for i in idx])
        collective("all-reduce", tag,
                   lambda: _dist().all_reduce(flat, group=group),
                   nbytes=flat.numel() * flat.element_size(), step=step,
                   axis=label)
        off = 0
        for i in idx:
            n = out[i].numel()
            out[i] = flat[off:off + n].view(out[i].shape)
            off += n
    return out


def allgather_tensor(t, tag="parallel.allgather", axis="dp", mesh=None,
                     step=None):
    """``(n, *t.shape)``: the ``t`` of every rank of this rank's group on
    ``axis`` (see :func:`axis_group`), stacked in axis order."""
    dist = _dist()
    group, label = axis_group(axis, mesh)
    n = dist.get_world_size(group)
    t = t.contiguous().reshape((1,) + tuple(t.shape)) if t.dim() == 0 \
        else t.contiguous()
    out = torch.empty((n * t.shape[0],) + tuple(t.shape[1:]),
                      dtype=t.dtype, device=t.device)
    collective("all-gather", tag, lambda: dist.all_gather_into_tensor(
        out, t, group=group), nbytes=out.numel() * out.element_size(),
        step=step, axis=label)
    return out.view((n,) + tuple(t.shape))


def allreduce_row_sparse(rs):
    """The union-sum of a RowSparseNDArray over the processes, never
    densified (the reference's sparse push aggregation,
    kvstore_dist_server.h:223; the JAX package's
    ``_allreduce_row_sparse_impl``): nnz differs per rank, so the rows are
    padded to the largest nnz (padding ids -1), all-gathered and merged.
    ``rs`` itself with one process."""
    if world_size() <= 1:
        return rs
    from ..ndarray.sparse import RowSparseNDArray, merge_row_sparse
    data, idx = rs._data, rs._indices
    nnz = torch.tensor([data.shape[0]], dtype=torch.int64,
                       device=data.device)
    max_nnz = int(allgather_tensor(nnz, tag="allreduce_row_sparse nnz")
                  .max())
    pad = max_nnz - data.shape[0]
    data = torch.cat([data, data.new_zeros((pad,) + tuple(data.shape[1:]))])
    idx = torch.cat([idx.to(torch.int64),
                     torch.full((pad,), -1, dtype=torch.int64,
                                device=idx.device)])
    all_data = allgather_tensor(data, tag="allreduce_row_sparse data")
    all_idx = allgather_tensor(idx, tag="allreduce_row_sparse ids")
    parts = []
    for p in range(all_idx.shape[0]):
        keep = all_idx[p] >= 0
        if not bool(keep.any()):
            continue
        parts.append(RowSparseNDArray(all_data[p][keep],
                                      all_idx[p][keep].to(rs._indices.dtype),
                                      rs.shape))
    return merge_row_sparse(parts) if parts else rs


# -- global batch statistics under dp (the sync BatchNorm) ---------------

_BATCH_STATS = []      # (group, axis) of each open global_batch_stats


@contextlib.contextmanager
def global_batch_stats(mesh=None, axis="dp"):
    """Inside, a training-mode BatchNorm computes its statistics over the
    batch of every rank of this rank's group on ``axis`` (see
    :func:`axis_group`: the global batch the JAX package's GSPMD step
    normalises over), and a loss head normalised by its batch counts that
    batch, through :func:`allreduce_sum_grad`."""
    _BATCH_STATS.append(axis_group(axis, mesh))
    try:
        yield
    finally:
        _BATCH_STATS.pop()


def batch_stats_global() -> bool:
    """Whether :func:`global_batch_stats` is on."""
    return bool(_BATCH_STATS)


def batch_stats_ranks() -> int:
    """The number of ranks whose batches the innermost
    :func:`global_batch_stats` sums over."""
    return _dist().get_world_size(_BATCH_STATS[-1][0])


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        _dist().all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        _dist().all_reduce(g, group=ctx.group)
        return g, None


def allreduce_sum_grad(x, tag="parallel.allreduce_sum_grad"):
    """A differentiable all-reduce (sum) over the batch axis of the
    innermost :func:`global_batch_stats`: its backward all-reduces the
    incoming gradient (each rank's loss depends on every rank's ``x``)."""
    group, label = _BATCH_STATS[-1] if _BATCH_STATS else (None, "world")
    out = []
    collective("all-reduce", tag,
               lambda: out.append(_AllReduceSum.apply(x, group)),
               nbytes=x.numel() * x.element_size(), axis=label)
    return out[0]
