"""Mesh-sharded embedding tables with touched-rows-only compute (port of
``mxnet_tpu/sparse/embedding.py``).

The table is row-sharded over one mesh axis (``ep`` when active, else
``dp``), so each device holds ``table/S`` rows.  A lookup is owner-shard
routing: dedup the local ids, bucket them by owner shard, exchange the id
lists (all-to-all), gather locally (:mod:`mxnet_tpu_torch.sparse.kernels`,
kernel B5), and exchange the rows back.  The gradient path dedups and
segment-sums duplicate contributions, routes the ``(ids, rows)`` pairs to
their owners, and the lazy update (:meth:`ShardedEmbedding.apply_sgd` /
:meth:`~ShardedEmbedding.apply_adam`) touches ONLY those rows of the table
and its optimizer slots (gather B5, scatter B6).

Each of these is split at its row reads into a half before (the plan:
``_lookup_plan``, ``_update_plan``) and a half after (``_lookup_finish``,
``_sgd_finish``), around one grouped gather (:func:`gather_rows`, one
kernel launch for many buffers): ``lookup`` reads one segment,
``apply_sgd`` two (the weight and momentum rows), ``apply_adam`` three.
The recommender step (:mod:`mxnet_tpu_torch.sparse.step`) runs the same
halves for every table around one gather per phase.

Where the JAX package compiles each of these into one program under
``shard_map``, PyTorch runs them eagerly, and issues no host
synchronisation on the card: the fixed-size ``unique`` of the reference
(``jnp.unique(size=b, fill_value=...)``) is built from a sort, a flag on
each run start, a ``cumsum`` and a scatter of the inverse, and the
``.at[...].set(mode="drop")`` scatters send dropped entries to a spare
slot instead of indexing with a mask.  Duplicate gradient rows are summed
with ``index_add_``, which on the card adds in no fixed order, so sums of
duplicates may differ in their last bits between runs.

Tables and slots are updated IN PLACE (the reference's Pallas scatter
aliases the table to its output); ``apply_sgd`` / ``apply_adam`` return
the same tensors, keeping the JAX signatures.

A table may be float32, bfloat16, float16 or float64 (``dtype=``), as in
the JAX package: a lookup returns rows in the table's dtype; an update
sums the routed gradient in float32, keeps its slots float32
(``zeros_slot``'s default), computes the new rows in float32 from the
table's rows and rounds them once to the table's dtype.

The routing is written for any shard count ``S``; :func:`_a2a` is the one
place that needs a collective, and raises
:class:`~mxnet_tpu_torch.base.NotPortedYet` for ``S > 1`` until the NCCL
slice lands (ROADMAP queue A item 7).  Not ported: the hang watchdog
around the collectives (``resilience/watchdog.py``, ROADMAP queue A
item 8), and ``resilience.checkpoint.save_embedding`` / ``restore_embedding``.
"""
from __future__ import annotations

import math
import weakref
from typing import Dict, Optional

import numpy as np
import torch

from ..base import MXNetError, NotPortedYet, dtype_torch
from . import kernels as _kernels

__all__ = ["ShardedEmbedding", "lookup_wire_bytes",
           "step_alltoall_model_bytes", "live_tables"]

# live ShardedEmbedding registry (weak): the table sizes in play
_REGISTRY: "weakref.WeakValueDictionary[int, ShardedEmbedding]" = \
    weakref.WeakValueDictionary()
_REG_SEQ = [0]


def live_tables():
    """[(name, global_table_bytes)] for every live ShardedEmbedding."""
    return [(emb.name, emb.table_bytes) for emb in list(_REGISTRY.values())]


def lookup_wire_bytes(n_ids_global: int, dim: int, num_shards: int,
                      capacity: Optional[int] = None,
                      itemsize: int = 4) -> Dict[str, int]:
    """Analytic per-device all-to-all payload of ONE routed lookup:
    ``{"ids": S*C*4, "rows": S*C*dim*itemsize}``.  Note what is absent:
    the table's row count."""
    S = max(1, int(num_shards))
    b = int(n_ids_global) // S
    C = int(capacity) if capacity else b
    return {"ids": S * C * 4, "rows": S * C * int(dim) * int(itemsize)}


def step_alltoall_model_bytes(n_ids_global: int, dim: int, num_shards: int,
                              capacity: Optional[int] = None,
                              itemsize: int = 4) -> int:
    """Analytic per-device all-to-all bytes of one full training step on
    one table: the lookup's (ids + rows) pair plus the update's mirror
    pair — ``2*(S*C*4 + S*C*D*itemsize)``."""
    w = lookup_wire_bytes(n_ids_global, dim, num_shards, capacity, itemsize)
    return 2 * (w["ids"] + w["rows"])


# ---------------------------------------------------------------------------
# routing plan (shard-local)
# ---------------------------------------------------------------------------

def _unique_fixed(x, size: int, fill: int):
    """``jnp.unique(x, size=size, fill_value=fill, return_inverse=True)``
    for 1-D int ``x`` of length ``size``, with no host synchronisation:
    sort, flag each run start, number the runs with a ``cumsum``, scatter
    each run's value to its number and each element's number back to its
    original position.  Returns ``(uniq int32 (size,), inv int64 (n,))``."""
    srt, perm = torch.sort(x, stable=True)
    start = torch.ones_like(srt, dtype=torch.bool)
    start[1:] = srt[1:] != srt[:-1]
    seg = torch.cumsum(start, 0) - 1                 # run number per slot
    uniq = torch.full((size,), fill, dtype=torch.int32, device=x.device)
    uniq.scatter_(0, seg, srt.to(torch.int32))       # equal values collide
    inv = torch.empty_like(seg).scatter_(0, perm, seg)
    return uniq, inv


def _plan(ids, S: int, rows_per: int, C: int, vpad: int):
    """Owner-shard routing plan for one device's ids: dedup, compute each
    unique id's owner shard and slot in that owner's bucket.

    Returns ``(uniq, inv, owner, pos, ok, dropped)``: ``uniq`` sorted
    unique ids padded with ``vpad`` (= S*rows_per, so pad entries get
    owner S and are dropped); ``inv`` maps original positions onto uniq;
    ``ok`` marks entries that fit their bucket; ``dropped`` counts real
    ids that overflowed capacity ``C``."""
    b = ids.shape[0]
    ids = ids.reshape(-1).to(torch.int32)
    uniq, inv = _unique_fixed(ids, b, vpad)
    owner = torch.div(uniq, rows_per, rounding_mode="floor")   # pads -> S
    # uniq is sorted, so owner is sorted: position-in-bucket is the offset
    # from the first element of the owner's run
    first = torch.searchsorted(owner, owner)
    pos = torch.arange(b, device=ids.device) - first
    valid = uniq < vpad
    ok = valid & (pos < C)
    dropped = (valid & (pos >= C)).sum().to(torch.int32)
    return uniq, inv, owner.long(), pos, ok, dropped


def _bucket(values, owner, pos, ok, S: int, C: int, fill):
    """``full((S, C) + row, fill).at[owner, pos].set(values, mode="drop")``:
    entries that are not ``ok`` land in a spare slot that is cut off."""
    flat = torch.where(ok, owner * C + pos, S * C)
    buf = torch.full((S * C + 1,) + tuple(values.shape[1:]), fill,
                     dtype=values.dtype, device=values.device)
    buf.index_copy_(0, flat, values)
    return buf[:S * C].reshape((S, C) + tuple(values.shape[1:]))


def _a2a(x, axis: str, S: int):
    """All-to-all over the mesh axis, split and concatenated on dim 0:
    the identity on one shard."""
    if S == 1:
        return x
    raise NotPortedYet("all-to-all over mesh axis %r of %d devices: the "
                       "embedding plane routes across devices once NCCL "
                       "collectives land (ROADMAP queue A item 7)"
                       % (axis, S))


def _axis_index(S: int) -> int:
    return 0 if S == 1 else torch.distributed.get_rank()


def _span(name: str, nbytes: int):
    """The span around an all-to-all pair of the plane (a collective
    entry point: span + audit-trail record, the moe_ffn discipline)."""
    from .. import telemetry as _tel
    return _tel.span(name, cat="collective",
                     metric="parallel.collective_seconds",
                     kind="all-to-all", bytes=nbytes)


def gather_rows(embs, bufs, idxs):
    """One grouped gather (kernel B5) of ``bufs[i][idxs[i]]`` for every i:
    ``embs[i]`` is the plane that owns ``bufs[i]`` (a table or a slot),
    whose backend that buffer is held to."""
    if len({e.backend for e in embs}) > 1:
        for e, b in zip(embs, bufs):
            _kernels._path("embedding_gather", b, e.backend)
    return _kernels.embedding_gather_many(bufs, idxs,
                                          backend=embs[0].backend)


class ShardedEmbedding:
    """One row-sharded embedding table over a named mesh axis.

    Functional state as in the JAX package: the table (and optimizer
    slots) are tensors the caller threads through :meth:`lookup` /
    :meth:`apply_sgd` / :meth:`apply_adam`; the updates write them in
    place.  ``num_rows`` is padded up to a multiple of the shard count;
    padded rows are never looked up and never touched by updates, and
    :meth:`state_dict` strips them.  The state lives on the mesh's device
    (the card, or the CPU where the caller built the mesh there)."""

    def __init__(self, num_rows: int, dim: int, mesh, axis: Optional[str]
                 = None, dtype="float32", capacity_factor: Optional[float]
                 = None, backend: Optional[str] = None,
                 name: str = "embedding"):
        from ..parallel.placement import as_mesh
        spec = mesh if hasattr(mesh, "mesh") else None
        self.mesh = as_mesh(mesh)
        if axis is None:
            if spec is not None:
                ep = getattr(spec, "ep_axis", None)
                if ep and self.mesh.shape.get(ep, 1) > 1:
                    axis = ep
                else:
                    axis = getattr(spec, "dp_axis", None) \
                        or self.mesh.axis_names[0]
            else:
                axis = self.mesh.axis_names[0]
        if axis not in self.mesh.axis_names:
            raise ValueError("embedding axis %r not in mesh axes %r"
                             % (axis, tuple(self.mesh.axis_names)))
        self.dtype = dtype_torch(dtype)
        if self.dtype not in _kernels._DTYPES:
            raise MXNetError("ShardedEmbedding dtype %s: the embedding "
                             "kernels take float32, bfloat16, float16 and "
                             "float64 tables" % self.dtype)
        if backend not in _kernels.BACKENDS:
            raise ValueError("unknown embedding backend %r" % (backend,))
        self.axis = axis
        self.device = self.mesh.device
        self.num_shards = int(self.mesh.shape[axis])
        self.num_rows = int(num_rows)
        self.dim = int(dim)
        S = self.num_shards
        self.rows_per_shard = -(-self.num_rows // S)
        self.padded_rows = self.rows_per_shard * S
        self.capacity_factor = capacity_factor
        self.backend = backend
        self.name = name
        _REG_SEQ[0] += 1
        _REGISTRY[_REG_SEQ[0]] = self

    # -- sizing ----------------------------------------------------------
    @property
    def table_bytes(self) -> int:
        return self.padded_rows * self.dim * self.dtype.itemsize

    def capacity(self, n_ids_global: int) -> int:
        """Per-destination bucket slots for a batch of ``n_ids_global``
        ids: ``local_batch`` (never drops) unless a ``capacity_factor``
        shrinks it (``ceil(local*factor/S)``, the MoE formula)."""
        b = n_ids_global // self.num_shards
        if self.capacity_factor is None:
            return max(1, b)
        return max(1, math.ceil(b * self.capacity_factor /
                                self.num_shards))

    def wire_model(self, n_ids_global: int) -> Dict[str, int]:
        return lookup_wire_bytes(n_ids_global, self.dim, self.num_shards,
                                 self.capacity(n_ids_global),
                                 self.dtype.itemsize)

    # -- state -----------------------------------------------------------
    def init_state(self, seed: int = 0, scale: float = 0.01):
        """The table, ``scale * N(0, 1)`` drawn on the CPU from a
        ``torch.Generator`` seeded with ``seed`` (so a seed gives the same
        table on every device; the JAX package draws from
        ``jax.random``), then moved to the mesh's device and tagged
        ``embedding`` on the memory plane."""
        gen = torch.Generator().manual_seed(int(seed))
        host = torch.randn((self.padded_rows, self.dim), generator=gen)
        table = host.mul_(scale).to(self.dtype).to(self.device)
        from ..telemetry import memory as _memory
        _memory.tag(table, "embedding", label=self.name)
        return table

    def zeros_slot(self, dtype="float32"):
        """One optimizer slot (momentum / Adam mean / var) on the table's
        device."""
        slot = torch.zeros((self.padded_rows, self.dim),
                           dtype=dtype_torch(dtype), device=self.device)
        from ..telemetry import memory as _memory
        _memory.tag(slot, "embedding", label=self.name + ".slot")
        return slot

    def _put(self, x):
        if not isinstance(x, torch.Tensor):
            return torch.tensor(np.asarray(x), device=self.device)
        return x.to(self.device)

    # -- lookup ----------------------------------------------------------
    def _lookup_plan(self, ids, C: int):
        """The half of a lookup before its gather: the routing plan and
        the local rows to gather, ``(lidx, plan)``."""
        S, rows_per, vpad = self.num_shards, self.rows_per_shard, \
            self.padded_rows
        uniq, inv, owner, pos, ok, dropped = _plan(ids, S, rows_per, C, vpad)
        send = _bucket(uniq, owner, pos, ok, S, C, vpad)
        recv = _a2a(send, self.axis, S)                  # ids asked of me
        local = recv - _axis_index(S) * rows_per
        in_range = (local >= 0) & (local < rows_per)
        lidx = local.clamp(0, rows_per - 1).reshape(-1)
        return lidx, (inv, owner, pos, ok, dropped, in_range, C)

    def _lookup_finish(self, rows, plan, with_stats: bool):
        """The half of a lookup after its gather: the gathered ``rows``
        routed back to the ids' positions."""
        inv, owner, pos, ok, dropped, in_range, C = plan
        S = self.num_shards
        rows = torch.where(in_range.reshape(-1, 1), rows, 0.0)
        back = _a2a(rows.reshape(S, C, self.dim), self.axis, S)
        got = back[owner.clamp(0, S - 1), pos.clamp(0, C - 1)]
        got = torch.where(ok[:, None], got, 0.0)
        out = got.index_select(0, inv)
        if not with_stats:
            return out
        received = in_range.sum().to(torch.int32).reshape(1)
        return out, received, dropped.reshape(1)

    def _lookup_local(self, table, ids, C: int, with_stats: bool):
        lidx, plan = self._lookup_plan(ids, C)
        rows, = gather_rows([self], [table], [lidx])
        return self._lookup_finish(rows, plan, with_stats)

    def _lookup_bytes(self, B: int) -> int:
        w = self.wire_model(B)
        return w["ids"] + w["rows"]

    def _note_lookup(self, B: int):
        from ..parallel.audit import record_collective
        record_collective("all-to-all", "%s.lookup id+row routing"
                          % self.name, bytes=self._lookup_bytes(B))

    def lookup(self, table, ids, stats: bool = False):
        """Routed lookup: ``ids`` (B,) int — B divisible by the shard
        count.  Returns (B, dim) rows; ids beyond a bucket's capacity
        return zero rows (impossible at the default capacity).
        ``stats=True`` additionally returns ``(received_per_shard (S,),
        dropped_per_shard (S,))`` for load drills."""
        B = self._check_batch("lookup", ids)
        with _span("collective/embedding_lookup", self._lookup_bytes(B)):
            res = self._lookup_local(table, self._put(ids),
                                     self.capacity(B), stats)
        self._note_lookup(B)
        return res

    # -- sparse gradient + lazy updates ----------------------------------
    def _route(self, ids, grows, C: int):
        """(ids, grad rows) -> this shard's touched rows: sorted unique
        LOCAL row ids (pads = rows_per), their f32 summed grads, and the
        mask of real rows."""
        S, rows_per, vpad = self.num_shards, self.rows_per_shard, \
            self.padded_rows
        b = ids.shape[0]
        uniq, inv, owner, pos, ok, _dropped = _plan(ids, S, rows_per, C,
                                                    vpad)
        # dedup before anything moves: duplicate ids' contributions sum
        # into one row per unique id
        g_uniq = torch.zeros((b, self.dim), dtype=torch.float32,
                             device=grows.device)
        g_uniq.index_add_(0, inv, grows.to(torch.float32))
        send_ids = _bucket(uniq, owner, pos, ok, S, C, vpad)
        send_rows = _bucket(g_uniq, owner, pos, ok, S, C, 0.0)
        recv_ids = _a2a(send_ids, self.axis, S)
        recv_rows = _a2a(send_rows, self.axis, S)
        local = recv_ids - _axis_index(S) * rows_per
        in_range = (local >= 0) & (local < rows_per)
        lids = torch.where(in_range, local, rows_per).reshape(-1)
        # cross-sender dedup at the owner: the same row can arrive from
        # several senders; one segment sum folds them
        u2, inv2 = _unique_fixed(lids, S * C, rows_per)
        g2 = torch.zeros((S * C, self.dim), dtype=torch.float32,
                         device=grows.device)
        g2.index_add_(0, inv2, recv_rows.reshape(S * C, self.dim))
        return u2, g2, u2 < rows_per

    @staticmethod
    def _prep_grad(kind, g2, w_rows, rescale, wd, clip):
        """The host lazy-SGD/Adam gradient prologue (``ndarray/sparse.py``
        of the JAX package): SGD clips BEFORE weight decay, Adam after."""
        g = g2 * rescale
        if kind == "sgd":
            if clip is not None and clip > 0:
                g = g.clamp(-clip, clip)
            g = g + wd * w_rows
        else:
            g = g + wd * w_rows
            if clip is not None and clip > 0:
                g = g.clamp(-clip, clip)
        return g

    def _scatter_set(self, buf, u2, ok2, new_rows, cur_rows):
        # pads write their CURRENT value (a no-op) for the kernel, which
        # clamps instead of dropping; u2 sorted => the kernel's contract.
        # The new rows (float32) round once to the buffer's dtype, in the
        # scatter; the current rows are exact in it.
        vals = torch.where(ok2[:, None], new_rows, cur_rows)
        return _kernels.embedding_scatter(buf, u2, vals, mode="set",
                                          backend=self.backend)

    def _check_batch(self, what, ids):
        B = int(ids.shape[0])
        if B % self.num_shards:
            raise ValueError(
                "%s batch %d is not divisible by the %r shard count "
                "%d" % (what, B, self.axis, self.num_shards))
        return B

    def _update_plan(self, ids, grad_rows):
        """The half of a lazy update before its row reads: the touched
        local rows ``(u2, g2, ok2, idx)`` (``idx`` the rows to gather)."""
        C = self.capacity(self._check_batch("update", ids))
        u2, g2, ok2 = self._route(self._put(ids), self._put(grad_rows), C)
        return u2, g2, ok2, u2.clamp(0, self.rows_per_shard - 1)

    def _sgd_finish(self, table, mom, plan, w_rows, m_rows, lr, momentum,
                    wd, rescale, clip):
        """The half of a lazy SGD after its row reads: new rows, then the
        set scatters into ``table`` (and ``mom``)."""
        u2, g2, ok2, _idx = plan
        w_rows = w_rows.float()           # the table's rows, in float32
        g = self._prep_grad("sgd", g2, w_rows, rescale, wd, clip)
        if mom is None:
            self._scatter_set(table, u2, ok2, w_rows - lr * g, w_rows)
        else:
            new_m = momentum * m_rows - lr * g
            self._scatter_set(table, u2, ok2, w_rows + new_m, w_rows)
            self._scatter_set(mom, u2, ok2, new_m, m_rows)

    def apply_sgd(self, table, mom, ids, grad_rows, lr, momentum=0.0,
                  wd=0.0, rescale_grad=1.0, clip_gradient=None):
        """Sharded lazy SGD: update ONLY the rows named by ``ids`` (B,),
        with duplicate contributions summed — the twin of the host
        ``sgd_row_sparse_update``.  ``grad_rows`` (B, dim) pairs with
        ``ids``; ``mom`` may be None (momentum-free).  Updates ``table``
        and ``mom`` in place and returns ``(table, mom)``.  The weight and
        momentum rows are read in one grouped gather."""
        B = int(ids.shape[0])
        with _span("collective/embedding_update",
                   sum(self.wire_model(B).values())):
            plan = self._update_plan(ids, grad_rows)
            bufs = [table] if mom is None else [table, mom]
            rows = gather_rows([self] * len(bufs), bufs,
                               [plan[3]] * len(bufs))
            self._sgd_finish(table, mom, plan, rows[0], rows[-1],
                             float(lr), float(momentum), float(wd),
                             float(rescale_grad), clip_gradient)
        self._note_update(B)
        return table, mom

    def apply_adam(self, table, mean, var, ids, grad_rows, lr, beta1=0.9,
                   beta2=0.999, epsilon=1e-8, wd=0.0, rescale_grad=1.0,
                   clip_gradient=None):
        """Sharded lazy Adam over touched rows only (the twin of the host
        ``adam_row_sparse_update``).  Updates the three tensors in place
        and returns ``(table, mean, var)``; their rows are read in one
        grouped gather."""
        B = int(ids.shape[0])
        lr, beta1, beta2 = float(lr), float(beta1), float(beta2)
        with _span("collective/embedding_update",
                   sum(self.wire_model(B).values())):
            plan = self._update_plan(ids, grad_rows)
            u2, g2, ok2, idx = plan
            w_rows, mean_rows, var_rows = gather_rows(
                [self] * 3, [table, mean, var], [idx] * 3)
            w_rows = w_rows.float()
            g = self._prep_grad("adam", g2, w_rows, float(rescale_grad),
                                float(wd), clip_gradient)
            m_rows = beta1 * mean_rows + (1 - beta1) * g
            v_rows = beta2 * var_rows + (1 - beta2) * g * g
            new_w = w_rows - lr * m_rows / (v_rows.sqrt() + float(epsilon))
            self._scatter_set(table, u2, ok2, new_w, w_rows)
            self._scatter_set(mean, u2, ok2, m_rows, mean_rows)
            self._scatter_set(var, u2, ok2, v_rows, var_rows)
        self._note_update(B)
        return table, mean, var

    def _note_update(self, n_ids: int):
        from ..parallel.audit import record_collective
        w = self.wire_model(n_ids)
        record_collective("all-to-all", "%s.lazy_update grad routing"
                          % self.name, bytes=w["ids"] + w["rows"])

    # -- checkpoint / elastic resharding ---------------------------------
    def state_dict(self, table, **slots) -> Dict[str, np.ndarray]:
        """Host snapshot with shard padding STRIPPED — the world-size-
        independent form a resharding restore re-pads from.  Each array
        is a copy (the live tensors change in place); a bf16 table comes
        back as float32 of the same values (numpy holds no bf16 without
        ``ml_dtypes``), which :meth:`load_array` with ``dtype=`` the
        table's rounds back to the same bits."""
        from ..convert import tensor_to_host

        def host(t):
            return tensor_to_host(t[:self.num_rows])
        out = {"table": host(table)}
        for k, v in slots.items():
            if v is not None:
                out[k] = host(v)
        return out

    def load_array(self, host_array, dtype=None):
        """Re-pad a (num_rows, dim) host array for THIS mesh's shard count
        and place it on the mesh's device — the resharding restore
        primitive.  The array keeps its dtype (float32, float16, float64,
        or bfloat16 by name, e.g. the JAX package's ``ml_dtypes`` arrays,
        bit for bit), as the JAX package's does; ``dtype`` converts it,
        and raises unless the values are exact in it (a bf16 table's
        float32 snapshot from :meth:`state_dict`)."""
        from ..convert import tensor_from_host
        host = np.asarray(host_array)
        if host.shape[0] != self.num_rows:
            raise ValueError("embedding %r: snapshot has %d rows, table "
                             "has %d" % (self.name, host.shape[0],
                                         self.num_rows))
        # a copy: the table is updated in place, and a host array may be
        # another framework's read-only buffer
        arr = tensor_from_host(host)
        if arr.dtype not in _kernels._DTYPES:
            raise MXNetError("embedding %r: snapshot is %s; tables and "
                             "slots are float32, bfloat16, float16 or "
                             "float64" % (self.name, host.dtype))
        if dtype is not None and dtype_torch(dtype) != arr.dtype:
            cast = arr.to(dtype_torch(dtype))
            if not torch.equal(cast.to(arr.dtype), arr):
                raise MXNetError("embedding %r: the %s snapshot is not "
                                 "exact in %s" % (self.name, arr.dtype,
                                                  cast.dtype))
            arr = cast
        pad = self.padded_rows - self.num_rows
        if pad:
            arr = torch.cat([arr, arr.new_zeros((pad,) + arr.shape[1:])])
        arr = arr.to(self.device)
        from ..telemetry import memory as _memory
        _memory.tag(arr, "embedding", label=self.name + ".restored")
        return arr

    def reshard(self, mesh, axis: Optional[str] = None) -> "ShardedEmbedding":
        """A sibling plane over a different mesh (the elastic
        ``reform_mesh`` path): same rows/dim/name, new shard count; move
        state across with ``state_dict`` + ``load_array``."""
        return ShardedEmbedding(
            self.num_rows, self.dim, mesh,
            axis=axis if axis is not None else self.axis,
            dtype=self.dtype, capacity_factor=self.capacity_factor,
            backend=self.backend, name=self.name)
