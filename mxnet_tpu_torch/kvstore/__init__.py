"""KVStore: parameter synchronisation inside one process (port of the
local stores of ``mxnet_tpu/kvstore/__init__.py``; reference
include/mxnet/kvstore.h, src/kvstore/kvstore_local.h,
python/mxnet/kvstore.py).

The store keeps one NDArray per key on its device (the card unless the
caller passes ``device="cpu"``).  ``push`` sums a key's values (a list
of them is one value per device), compresses the sum when
:meth:`KVStore.set_gradient_compression` is set, and then either runs
the updater on the stored value (``set_optimizer`` / ``set_updater``)
or replaces it.  ``pull`` copies the stored value into each out array.

The JAX package rebinds immutable handles; torch tensors are mutable, so
no in-place update here may reach an array a caller still holds:
``init`` stores a clone, ``pull`` copies (``out.copy_(stored)``), the
compressor writes ``q`` to a new tensor and never into the pushed
gradient, and the updater reads the pushed gradient without writing it.

With two-bit compression each dense push runs the hand-written CUDA
kernel ``ops.kernels.two_bit_compress_many`` (B7; B10 for f16, bf16 and
f64 gradients) on the card, one launch per dtype over every key of the
push; the residual of every key lives beside its gradient, in its
dtype.

Row_sparse values (the reference's sparse kvstore): ``init`` stores a
copy, ``push`` sums a key's row_sparse values with
``ndarray.sparse.merge_row_sparse`` (never densified) and hands the sum
to the updater (SGD and Adam update lazily, only its rows) or stores it,
and :meth:`KVStore.row_sparse_pull` gathers only the requested rows of a
dense or row_sparse value, into a row_sparse out or into a dense out whose
other rows become zero.  On the card its row gathers and writes run the
embedding kernels B5 and B6.

The ``dist_*`` stores (:class:`KVStoreDist`) span the processes of a
``tools/launch.py`` gang over ``torch.distributed`` (NCCL between cards,
gloo on the CPU; :func:`~mxnet_tpu_torch.parallel.init_distributed`),
one store per rank on the rank's device.  ``dist_sync`` and
``dist_device_sync`` first do the local push (the sum over the rank's
devices and its two-bit compression, one grouped B7 launch per dtype),
then sum each key over the ranks: one all-reduce per dtype over a flat
buffer of the dense keys, :func:`~mxnet_tpu_torch.parallel.
allreduce_row_sparse` for a row_sparse value; the updater then runs on
every rank alike, as MXNet's workers each pull the server's sum.
``dist_async`` (:class:`KVStoreDistAsync`) is the JAX package's
collective lane: each rank updates with its own gradients and every
``MXNET_TPU_ASYNC_AVG_INTERVAL`` pushes of a key the stored values are
averaged over the ranks.  Its parameter-server lane (``MXNET_TPU_KV_DIR``,
``kvstore/{server,client,protocol,worker}.py``) is queue A item 7's second
half, step 4, and the heartbeat lane of ``num_dead_node`` is item 8.
"""
from __future__ import annotations

import pickle
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..base import MXNetError, NotPortedYet, resolve_device
from ..ndarray import sparse as _sparse
from ..ndarray.ndarray import NDArray
from ..ndarray.sparse import RowSparseNDArray
from ..ops import kernels
from .. import telemetry

__all__ = ["KVStore", "KVStoreDist", "KVStoreDistAsync", "create"]

_LOCAL_TYPES = ("local", "local_update_cpu", "local_allreduce_cpu",
                "local_allreduce_device", "device", "nccl", "tpu")


def _key_str(key):
    return str(key)


def _rsp_copy(v: RowSparseNDArray, device) -> RowSparseNDArray:
    """A row_sparse value's own copy on ``device`` (no update of the store
    may reach an array the caller holds)."""
    return RowSparseNDArray(v._data.to(device, copy=True),
                            v._indices.to(device, copy=True), v.shape,
                            _sorted=True)


class _TwoBitCompressor:
    """Two-bit gradient compression with error feedback (reference
    src/kvstore/gradient_compression.{h,cc}): values quantised to
    {-threshold, 0, +threshold}, the quantisation error carried to the
    key's next push.  One residual per key, the size and dtype of the
    parameter's gradient, on its device, updated in place by the kernel
    (f16, bf16, f32 and f64: B7 / B10)."""

    def __init__(self, threshold=0.5):
        self.threshold = float(threshold)
        self.residual: Dict[str, torch.Tensor] = {}

    def _residual(self, key, grad):
        """The key's residual: its gradient's dtype and shape (the
        reference's ``zeros_like``), contiguous whatever the gradient's
        strides."""
        r = self.residual.get(key)
        if r is None:
            r = self.residual[key] = torch.zeros(
                grad.shape, dtype=grad.dtype, device=grad.device)
        return r

    def compress(self, key, grad: torch.Tensor) -> torch.Tensor:
        """One key's push: the counterpart of the JAX compressor's
        ``compress``."""
        q, _ = kernels.two_bit_compress(grad, self._residual(key, grad),
                                        self.threshold)
        return q

    def compress_many(self, keys, grads):
        """Every key of a push in one call of the grouped kernel
        (``kernels.two_bit_compress_many``; per device where the grads
        lie on several; the kernel launches once per dtype), creating
        the residuals that are missing.  Each
        key's ``q`` and new residual are exactly what :meth:`compress`
        gives it, since keys share nothing; a key that comes again in
        ``keys`` starts a new call, after the one that carries its first
        residual forward.  Returns the ``q`` of each key, in order."""
        out = [None] * len(keys)
        todo = list(range(len(keys)))
        while todo:
            seen, now, later = set(), [], []
            for i in todo:
                (later if keys[i] in seen else now).append(i)
                seen.add(keys[i])
            by_dev = {}
            for i in now:
                by_dev.setdefault(grads[i].device, []).append(i)
            for idx in by_dev.values():
                qs = kernels.two_bit_compress_many(
                    [grads[i] for i in idx],
                    [self._residual(keys[i], grads[i]) for i in idx],
                    self.threshold)
                for i, q in zip(idx, qs):
                    out[i] = q
            todo = later
        return out


class KVStore:
    """In-process store (reference kvstore.py:62)."""

    def __init__(self, kv_type="local", device=None):
        self.type = kv_type
        self.device = resolve_device(device)
        self._store: Dict[str, NDArray] = {}
        self._updater: Optional[Callable] = None
        self._optimizer = None
        self._compressor: Optional[_TwoBitCompressor] = None

    # -- init/push/pull ---------------------------------------------------
    def init(self, key, value):
        """Store a copy of each value under its key (a key already
        present keeps its value)."""
        keys, values = self._normalize(key, value)
        for k, v in zip(keys, values):
            if k in self._store:
                continue
            if isinstance(v, RowSparseNDArray):
                self._store[k] = _rsp_copy(v, self.device)
            else:
                self._store[k] = NDArray(v._handle.to(self.device,
                                                      copy=True))

    def push(self, key, value, priority=0):
        """Reduce value(s) into the store and run the updater if set
        (reference KVStoreLocal::PushImpl, kvstore_local.h:159).  A list
        of keys goes in three stages: every key's values are summed, all
        the sums are compressed in one :meth:`_TwoBitCompressor.
        compress_many` (one grouped kernel launch on the card), and then
        the updater (or the replace) runs key by key, in key order.  That
        equals a push of each key in turn, as the reference makes it: a
        key's sum, residual, stored value and optimizer state belong to
        that key alone, and the updater sees the keys in the same
        order.  A key's row_sparse values sum to one row_sparse value
        (:func:`~mxnet_tpu_torch.ndarray.sparse.merge_row_sparse`), which
        is not compressed; without an updater it replaces the stored
        value (a copy, as a row_sparse or dense value)."""
        with telemetry.span("kvstore/push", cat="kvstore"):
            keys, values = self._normalize_push(key, value)
            merged = [self._reduce(k, vlist) for k, vlist in zip(keys,
                                                                 values)]
            if self._compressor is not None:
                dense = [i for i, m in enumerate(merged)
                         if not isinstance(m, RowSparseNDArray)]
                qs = self._compressor.compress_many(
                    [keys[i] for i in dense], [merged[i] for i in dense])
                for i, q in zip(dense, qs):
                    merged[i] = q
            merged = self._across_ranks(keys, merged)
            for k, m in zip(keys, merged):
                stored = self._store[k]
                dev = stored._data.device \
                    if isinstance(stored, RowSparseNDArray) \
                    else stored._handle.device
                if isinstance(m, RowSparseNDArray):
                    if m._data.device != dev:
                        m = _rsp_copy(m, dev)
                elif m.device != dev:
                    m = m.to(dev)
                if self._updater is not None:
                    self._updater(self._updater_key(k),
                                  m if isinstance(m, NDArray)
                                  else NDArray(m), stored)
                elif isinstance(m, RowSparseNDArray) or \
                        isinstance(stored, RowSparseNDArray):
                    # the merged value REPLACES the stored one (reference
                    # kvstore_local.h:190 "local = merged"), a copy
                    self._store[k] = _rsp_copy(m, dev) \
                        if isinstance(m, RowSparseNDArray) \
                        else NDArray(m.clone())
                else:
                    stored._handle.copy_(m)

    def pull(self, key, out=None, priority=0, ignore_sparse=True):
        """Copy the stored value into each out array, on its own device
        (the Comm::Broadcast analog)."""
        with telemetry.span("kvstore/pull", cat="kvstore"):
            keys, outs = self._normalize_push(key, out)
            for k, olist in zip(keys, outs):
                src = self._store[k]._handle
                for o in olist:
                    if isinstance(o, RowSparseNDArray):
                        o._handle = src     # its components follow
                    else:
                        o._handle.copy_(src)

    def row_sparse_pull(self, key, out=None, priority=0, row_ids=None):
        """Pull only the requested rows of each key (reference
        PullRowSparseImpl, kvstore_dist.h:267): ``row_ids`` is one id
        array per out, one per key (for each of its outs) or one for all.
        The ids are deduplicated on the host (no host sync for host ids;
        one for ids on the card).  The rows of a row_sparse store come
        from :meth:`RowSparseNDArray.gather_rows` (zeros for absent ids),
        those of a dense store from one gather (B5 on the card).  A
        row_sparse out takes them as its components; a dense out gets the
        rows written (B6 on the card) and every other row zeroed, as the
        reference's pull into a dense array does."""
        if out is None or row_ids is None:
            raise MXNetError("row_sparse_pull needs out and row_ids")
        with telemetry.span("kvstore/row_sparse_pull", cat="kvstore"):
            keys, outs = self._normalize_push(key, out)
            rids = row_ids if isinstance(row_ids, list) else [row_ids]
            flat = [(k, o) for k, olist in zip(keys, outs) for o in olist]
            if len(rids) == len(flat):
                pair_rids = rids
            elif len(rids) == len(keys):
                pair_rids = [rids[i] for i, olist in enumerate(outs)
                             for _ in olist]
            elif len(rids) == 1:
                pair_rids = rids * len(flat)
            else:
                raise MXNetError("row_sparse_pull: %d row_ids for %d outs"
                                 % (len(rids), len(flat)))
            for (k, o), rid in zip(flat, pair_rids):
                self._pull_rows(self._store[k], o, rid)

    @staticmethod
    def _pull_rows(src, o, rid):
        if isinstance(src, RowSparseNDArray):
            pulled = src.gather_rows(rid)
            data, uniq = pulled._data, pulled._indices
        else:
            uniq_np = np.unique(_sparse._host_ids(rid))
            t = src._handle
            uniq = _sparse._dev_ids(uniq_np, t.device)
            data = _sparse._take_rows(t, uniq)
        if isinstance(o, RowSparseNDArray):
            dev = o._data.device
            o._rebind({"data": data.to(dev), "indices": uniq.to(dev)})
            return
        t = o._handle
        if o._in_graph() or not t.is_contiguous():
            t = torch.zeros_like(t, memory_format=torch.contiguous_format)
        else:
            t.zero_()
        _sparse._set_rows(t, uniq.to(t.device), data.to(t.device))
        if t is not o._handle:
            o._handle, o._recorded = t, False

    def _across_ranks(self, keys, merged):
        """The reduction across processes: none for a local store."""
        return merged

    # -- updater/optimizer ------------------------------------------------
    def set_updater(self, updater):
        self._updater = updater

    def set_optimizer(self, optimizer):
        """The updater becomes an :class:`~mxnet_tpu_torch.optimizer.
        Updater` of ``optimizer`` (the 'server' is this process)."""
        from ..optimizer import Updater
        self._optimizer = optimizer
        self._updater = Updater(optimizer)

    def set_gradient_compression(self, compression_params):
        """Two-bit compression with error feedback: every dense push is
        quantized to {-t, 0, +t} (``threshold``, default 0.5) with the
        residual carried forward.  As in the JAX package the reduced
        value stays a dense f32 tensor: the reference's packed 2-bit
        wire format saves bandwidth between workers, which a one-process
        store does not move."""
        ctype = compression_params.get("type", "2bit")
        if ctype != "2bit":
            raise MXNetError("unsupported compression type " + ctype)
        self._compressor = _TwoBitCompressor(
            compression_params.get("threshold", 0.5))

    # -- topology (one process) -------------------------------------------
    @property
    def rank(self) -> int:
        return 0

    @property
    def num_workers(self) -> int:
        return 1

    def barrier(self):
        """A local store has no peers to wait for."""

    def num_dead_node(self, node_id=0, timeout_sec=60):
        """Count of unreachable nodes (reference
        KVStore::get_num_dead_node): a local store has no peers."""
        return 0

    def save_optimizer_states(self, fname, dump_optimizer=False):
        if self._updater is None:
            raise MXNetError("no optimizer states: set_optimizer first")
        with open(fname, "wb") as f:
            f.write(self._updater.get_states(dump_optimizer))

    def load_optimizer_states(self, fname):
        if self._updater is None:
            raise MXNetError("no updater to load states into: "
                             "set_optimizer first")
        with open(fname, "rb") as f:
            self._updater.set_states(f.read())

    # -- helpers ----------------------------------------------------------
    def _updater_key(self, k):
        try:
            return int(k)
        except ValueError:
            return k

    def _reduce(self, k, vlist):
        """The sum of a key's pushed values (on the first one's device).
        The result may be the caller's own tensor (one value): it is only
        read from here on.  Row_sparse values sum to a RowSparseNDArray
        (one value: the value itself)."""
        if any(isinstance(v, RowSparseNDArray) for v in vlist):
            if len(vlist) == 1:
                return vlist[0]
            return _sparse.merge_row_sparse(vlist)
        merged = vlist[0]._handle
        if len(vlist) > 1:
            merged = merged + vlist[1]._handle.to(merged.device)
            for v in vlist[2:]:
                merged += v._handle.to(merged.device)
        return merged

    def _normalize(self, key, value):
        if isinstance(key, (str, int)):
            key, value = [key], [value]
        keys = [_key_str(k) for k in key]
        values = value if isinstance(value, list) else [value]
        return keys, values

    def _normalize_push(self, key, value):
        """Keys and a list of values for each."""
        if isinstance(key, (str, int)):
            keys = [_key_str(key)]
            if isinstance(value, (list, tuple)) and \
                    all(isinstance(v, NDArray) for v in value):
                return keys, [list(value)]
            return keys, [[value]]
        keys = [_key_str(k) for k in key]
        return keys, [list(v) if isinstance(v, (list, tuple)) else [v]
                      for v in value]


class KVStoreDist(KVStore):
    """``dist_sync`` / ``dist_device_sync`` over the ranks of a gang
    (reference kvstore_dist.h; the JAX package's ``KVStoreTPUDist``): a
    push is the local push, then the sum over the ranks.  With one
    process it is a local store."""

    def __init__(self, kv_type="dist_sync", device=None):
        from .. import parallel
        parallel.init_distributed(device=device)
        super().__init__(kv_type, device=device)

    @property
    def rank(self) -> int:
        from ..parallel import rank
        return rank()

    @property
    def num_workers(self) -> int:
        from ..parallel import world_size
        return world_size()

    def barrier(self):
        from ..parallel import barrier
        barrier()

    def num_dead_node(self, node_id=0, timeout_sec=60):
        """The coordinator probe (reference kvstore.h:338): a bounded
        write, read and delete of one per-rank key on the gang's
        ``TCPStore``; an unreachable coordinator counts as one dead node.
        No collective is issued.  The heartbeat lane that counts silent
        peers is queue A item 8."""
        if self.num_workers <= 1:
            return 0
        import datetime
        from ..parallel import store
        st = store()
        key = "mxt_dead_probe/%d" % self.rank
        saved = st.timeout
        try:
            st.set_timeout(datetime.timedelta(seconds=float(timeout_sec)))
            st.set(key, "1")
            st.get(key)
            st.delete_key(key)
        except Exception:  # noqa: BLE001 - an unreachable coordinator
            return 1
        finally:
            st.set_timeout(saved)
        return 0

    def _across_ranks(self, keys, merged):
        """Each key's value summed over the ranks: the dense ones in one
        all-reduce per dtype over a flat buffer, each row_sparse one by
        :func:`~mxnet_tpu_torch.parallel.allreduce_row_sparse`."""
        if self.num_workers <= 1:
            return merged
        from ..parallel import allreduce_many, allreduce_row_sparse
        merged = list(merged)
        dense = [i for i, m in enumerate(merged)
                 if not isinstance(m, RowSparseNDArray)]
        summed = allreduce_many([merged[i] for i in dense],
                                "KVStoreDist.push")
        for i, m in zip(dense, summed):
            merged[i] = m
        for i, m in enumerate(merged):
            if isinstance(m, RowSparseNDArray):
                merged[i] = allreduce_row_sparse(m)
        return merged


class KVStoreDistAsync(KVStoreDist):
    """``dist_async`` on collectives (the JAX package's
    ``KVStoreTPUDistAsync``; reference kvstore_dist_server.h:503 applies
    each worker's push as it arrives): a push updates with this rank's
    own gradients, no reduction across ranks and no barrier, and every
    ``MXNET_TPU_ASYNC_AVG_INTERVAL`` pushes of a key (default 16) its
    stored value is averaged over the ranks.  Between rounds the ranks
    hold different values, stale by at most the interval; every rank
    must push each key equally often.  :meth:`sync_weights` averages
    every key once (before a checkpoint)."""

    def __init__(self, kv_type="dist_async", device=None):
        import os
        super().__init__(kv_type, device=device)
        self._avg_interval = int(
            os.environ.get("MXNET_TPU_ASYNC_AVG_INTERVAL", "16"))
        self._push_counts: Dict[str, int] = {}

    def _across_ranks(self, keys, merged):
        return merged

    def push(self, key, value, priority=0):
        super().push(key, value, priority)
        if self.num_workers <= 1 or self._avg_interval <= 0:
            return
        keys, _ = self._normalize_push(key, value)
        for k in keys:
            c = self._push_counts.get(k, 0) + 1
            self._push_counts[k] = c
            if c % self._avg_interval == 0:
                self._average_key(k)

    def _average_key(self, k):
        from ..parallel import allreduce_array, allreduce_row_sparse
        stored = self._store[k]
        if isinstance(stored, RowSparseNDArray):
            # union-sum, then each row over the number of ranks that
            # hold it (a row on k < N ranks averaged over N would shrink)
            avg = allreduce_row_sparse(stored)
            ones = torch.zeros((stored.shape[0],), dtype=torch.float32,
                               device=stored._data.device)
            ones[stored._indices.long()] = 1.0
            counts = allreduce_array(ones)
            denom = counts[avg._indices.long()].clamp_min(1.0)
            self._store[k] = RowSparseNDArray(
                avg._data / denom.reshape((-1,) + (1,) * (
                    avg._data.dim() - 1)).to(avg._data.dtype),
                avg._indices, avg.shape, _sorted=True)
        else:
            stored._handle.copy_(allreduce_array(stored._handle)
                                 / self.num_workers)

    def sync_weights(self):
        """Average every stored value over the ranks once (a collective:
        every rank calls it), in insertion order, the same on every
        rank."""
        if self.num_workers <= 1:
            return
        for k in list(self._store):
            self._average_key(k)


def create(name="local", device=None) -> KVStore:
    """A store of ``name`` on ``device`` (default: the card, or in a gang
    the rank's device; a typed ``DeviceUnavailable`` without one;
    reference src/kvstore/kvstore.cc:40-75).  A ``dist_*`` type joins the
    gang (:func:`~mxnet_tpu_torch.parallel.init_distributed`);
    ``dist_async`` with ``MXNET_TPU_KV_DIR`` set (the parameter-server
    lane) raises ``NotPortedYet``."""
    if not isinstance(name, str):
        raise TypeError("name must be a string")
    if name in _LOCAL_TYPES:
        return KVStore(name, device=device)
    if name == "dist_async":
        import os
        if os.environ.get("MXNET_TPU_KV_DIR"):
            raise NotPortedYet("kvstore 'dist_async' with MXNET_TPU_KV_DIR: "
                               "the parameter-server lane (kvstore/{server,"
                               "client,protocol,worker}.py) is queue A item "
                               "7's second half, step 4")
        return KVStoreDistAsync(name, device=device)
    if name.startswith("dist"):
        return KVStoreDist(name, device=device)
    raise MXNetError("unknown KVStore type %s" % name)
