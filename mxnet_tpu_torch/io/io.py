"""Data iterators (port of ``mxnet_tpu/io/io.py``; reference
python/mxnet/io.py: DataIter :180, ResizeIter :282, PrefetchingIter
:347, NDArrayIter :544, and the C++ CSV and MNIST sources).

Data stays in host memory, as the reference's does: a batch is a list of
NDArrays on the CPU, and the Module's executor group copies it into the
arrays it bound on the card.  ``NDArrayIter`` gathers a batch through a
modular index window, so the tail's wrap-around ("pad") is one ``take``;
"discard" trims the tail up front and "roll_over" carries the tail
offset into the next epoch.  Shuffling is an index permutation (drawn
from ``seed`` when given).  Its position is global (``num_parts`` ranks
walk one order, each taking its block of every global window), so
``state_dict`` / ``load_state_dict`` resume mid-epoch exactly and
``reshard`` re-splits the rest of an epoch over another world size.

``PrefetchingIter`` reads its iterators in background threads; they
stop and are joined when it is reset, exhausted, closed or collected.
``LibSVMIter`` parses a libsvm file straight into CSR components and
yields CSR batches (padded by wrap-around, as ``NDArrayIter``'s "pad"):
no dense (rows, features) array is built, where the JAX package's
densifies every row; the batches are the same.
"""
from __future__ import annotations

import gzip
import queue
import struct
import threading
import weakref
from collections import OrderedDict, namedtuple

import numpy as np
import torch

from ..ndarray.ndarray import NDArray
from .. import telemetry

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter", "ResizeIter",
           "PrefetchingIter", "CSVIter", "LibSVMIter", "MNISTIter"]


class DataDesc(namedtuple("DataDesc", ["name", "shape"])):
    """Named tensor spec carried by iterators: (name, shape) + dtype and
    layout."""

    def __new__(cls, name, shape, dtype=np.float32, layout="NCHW"):
        ret = super().__new__(cls, name, tuple(shape))
        ret.dtype = dtype
        ret.layout = layout
        return ret

    @staticmethod
    def get_batch_axis(layout):
        return 0 if layout is None else layout.find("N")

    @staticmethod
    def get_list(shapes, types):
        dtype_of = dict(types) if types is not None else {}
        return [DataDesc(name, shape, dtype_of[name]) if name in dtype_of
                else DataDesc(name, shape) for name, shape in shapes]


class DataBatch:
    """One batch: data and label NDArray lists plus the padding count."""

    def __init__(self, data, label=None, pad=None, index=None,
                 bucket_key=None, provide_data=None, provide_label=None):
        self.data = data
        self.label = label
        self.pad = pad
        self.index = index
        self.bucket_key = bucket_key
        self.provide_data = provide_data
        self.provide_label = provide_label

    def __str__(self):
        shapes = lambda xs: [x.shape for x in xs] if xs else None  # noqa
        return "%s: data shapes: %s label shapes: %s" % (
            type(self).__name__, shapes(self.data), shapes(self.label))


class DataIter:
    """Iterator contract (reference io.py:180): ``next()`` assembles a
    DataBatch from the iter_next / getdata / getlabel / getpad hooks."""

    def __init__(self, batch_size=0):
        self.batch_size = batch_size

    def __iter__(self):
        return self

    def reset(self):
        pass

    def next(self) -> DataBatch:
        with telemetry.span("data/next", cat="io",
                            metric="data.next_seconds"):
            if not self.iter_next():
                raise StopIteration
            return DataBatch(data=self.getdata(), label=self.getlabel(),
                             pad=self.getpad(), index=self.getindex())

    def __next__(self):
        return self.next()

    def iter_next(self) -> bool:
        raise NotImplementedError

    def getdata(self):
        raise NotImplementedError

    def getlabel(self):
        raise NotImplementedError

    def getindex(self):
        return None

    def getpad(self):
        raise NotImplementedError


def _named_arrays(source, allow_empty, default_name):
    """A single array, a list of arrays (auto-named) or a dict ->
    an ordered ``[(name, host array)]`` list."""
    if source is None:
        if not allow_empty:
            raise ValueError("data source may not be None")
        return []
    if isinstance(source, (np.ndarray, NDArray)):
        source = [source]
    if isinstance(source, list):
        if not source:
            if allow_empty:
                return []
            raise ValueError("empty data source")
        if len(source) == 1:
            source = {default_name: source[0]}
        else:
            source = OrderedDict(("_%d_%s" % (i, default_name), entry)
                                 for i, entry in enumerate(source))
    if not isinstance(source, dict):
        raise TypeError("Input must be NDArray, numpy.ndarray, a list of "
                        "them or dict with them as values")
    return [(name, entry.asnumpy() if isinstance(entry, NDArray)
             else np.asarray(entry))
            for name, entry in source.items()]


def _host(arr):
    return NDArray(torch.from_numpy(np.array(arr)))


class NDArrayIter(DataIter):
    """Batch iterator over in-memory arrays (reference io.py:544); the
    batches are NDArrays on the CPU.

    With ``num_parts`` > 1 every rank walks the same global order
    (``seed`` makes the shuffle rank-identical) with a global cursor that
    advances by ``batch_size * num_parts``; rank ``part_index`` takes its
    block of each global window."""

    def __init__(self, data, label=None, batch_size=1, shuffle=False,
                 last_batch_handle="pad", data_name="data",
                 label_name="softmax_label", num_parts=1, part_index=0,
                 seed=None):
        super().__init__(batch_size)
        if last_batch_handle not in ("pad", "discard", "roll_over"):
            raise ValueError("last_batch_handle must be pad, discard or "
                             "roll_over, got %r" % (last_batch_handle,))
        self.data = _named_arrays(data, False, data_name)
        self.label = _named_arrays(label, True, label_name)
        self.last_batch_handle = last_batch_handle
        self.num_parts = int(num_parts)
        self.part_index = int(part_index)
        if not 0 <= self.part_index < self.num_parts:
            raise ValueError("part_index %d outside [0, num_parts=%d)"
                             % (self.part_index, self.num_parts))
        if self.num_parts > 1 and last_batch_handle == "roll_over":
            raise ValueError("roll_over is not defined for a sharded "
                             "iterator (num_parts > 1); use pad/discard")
        if self.num_parts > 1 and shuffle and seed is None:
            raise ValueError("sharded shuffle needs an explicit seed so "
                             "every rank draws the SAME global order")
        total = self.data[0][1].shape[0]
        self._total = total
        self.shuffle = bool(shuffle)
        self._order = None
        if shuffle:
            rng = np.random if seed is None else np.random.RandomState(seed)
            self._order = rng.permutation(total)
        if last_batch_handle == "discard":
            total -= total % self._global_batch
        if total < self._global_batch:
            raise ValueError("batch_size needs to be smaller than data size.")
        self.num_data = total
        self._pos = -self._global_batch
        self._epoch = 0

    @property
    def _global_batch(self):
        return self.batch_size * self.num_parts

    def _descs(self, sources):
        return [DataDesc(name, (self.batch_size,) + arr.shape[1:], arr.dtype)
                for name, arr in sources]

    @property
    def provide_data(self):
        return self._descs(self.data)

    @property
    def provide_label(self):
        return self._descs(self.label)

    def hard_reset(self):
        """Back to the first batch of epoch 0, with no rolled-over
        tail."""
        self._pos = -self._global_batch
        self._epoch = 0

    def reset(self):
        self._epoch += 1
        if self.last_batch_handle == "roll_over" and \
                self._pos > self.num_data:
            # keep the un-consumed tail offset for the next epoch
            carry = (self._pos % self.num_data) % self.batch_size
            self._pos = carry - self.batch_size
        else:
            self._pos = -self._global_batch

    def iter_next(self):
        self._pos += self._global_batch
        return self._pos < self.num_data

    def _window(self, sources):
        if self._pos >= self.num_data:
            raise RuntimeError("DataIter needs reset.")
        start = self._pos + self.part_index * self.batch_size
        stop = start + self.batch_size
        picks = (slice(start, stop) if stop <= self.num_data
                 else np.arange(start, stop) % self.num_data)
        if self._order is not None:
            picks = self._order[picks]
        return [_host(arr[picks]) for _, arr in sources]

    def getdata(self):
        return self._window(self.data)

    def getlabel(self):
        return self._window(self.label)

    def getpad(self):
        start = self._pos + self.part_index * self.batch_size
        overrun = start + self.batch_size - self.num_data
        if self.last_batch_handle == "pad" and overrun > 0:
            return min(overrun, self.batch_size)
        return 0

    # -- elastic reshard ----------------------------------------------------
    def reshard(self, part_index: int, num_parts: int, batch_size=None):
        """Re-split the rest of this epoch over ``num_parts`` ranks, in
        place: the next window starts where the old split stopped, so
        nothing is replayed or dropped.  ``batch_size`` defaults to the
        current global batch divided by ``num_parts``."""
        num_parts = int(num_parts)
        old_global = self._global_batch
        if batch_size is None:
            if old_global % num_parts:
                raise ValueError(
                    "global batch %d does not divide over %d parts; pass "
                    "an explicit batch_size" % (old_global, num_parts))
            batch_size = old_global // num_parts
        batch_size = int(batch_size)
        if not 0 <= int(part_index) < num_parts:
            raise ValueError("part_index %d outside [0, num_parts=%d)"
                             % (part_index, num_parts))
        new_global = batch_size * num_parts
        total = self._total
        if self.last_batch_handle == "discard":
            total -= total % new_global
        if total < new_global:
            raise ValueError("batch_size needs to be smaller than data size.")
        consumed = 0 if self._pos < 0 else min(self._pos + old_global,
                                               self.num_data)
        self.num_parts = num_parts
        self.part_index = int(part_index)
        self.batch_size = batch_size
        self.num_data = total
        self._pos = consumed - new_global
        return self

    # -- exact resume -------------------------------------------------------
    def state_dict(self):
        """The global cursor, epoch, shuffle order and world split: what
        resumes this iterator at its next unseen batch."""
        return {"kind": "NDArrayIter",
                "pos": int(self._pos),
                "epoch": int(self._epoch),
                "num_data": int(self.num_data),
                "batch_size": int(self.batch_size),
                "num_parts": int(self.num_parts),
                "last_batch_handle": self.last_batch_handle,
                "order": None if self._order is None
                else np.asarray(self._order, np.int64)}

    def load_state_dict(self, state):
        """Restore a :meth:`state_dict` of an iterator over the same data
        and the same global batch (``batch_size * num_parts``), which may
        come from another world size; this iterator keeps its own
        split."""
        if state.get("kind") != "NDArrayIter":
            raise ValueError("state is for %r, not NDArrayIter"
                             % state.get("kind"))
        saved_global = int(state["batch_size"]) * int(state.get("num_parts",
                                                                1))
        if int(state["num_data"]) != self.num_data or \
                saved_global != self._global_batch:
            raise ValueError(
                "iterator state mismatch: saved num_data=%s/batch_size=%s "
                "(global %d) vs this iterator's %d/%d (global %d): resume "
                "over the same dataset and global batch"
                % (state["num_data"], state["batch_size"], saved_global,
                   self.num_data, self.batch_size, self._global_batch))
        order = state.get("order")
        self._order = None if order is None else np.asarray(order, np.int64)
        pos = int(state["pos"])
        self._pos = -self._global_batch if pos < 0 else pos
        self._epoch = int(state["epoch"])


class ResizeIter(DataIter):
    """A fixed number of batches per epoch from an underlying iterator,
    which is reset and read again when it runs dry (reference
    io.py:282)."""

    def __init__(self, data_iter, size, reset_internal=True):
        super().__init__()
        self.data_iter = data_iter
        self.size = size
        self.reset_internal = reset_internal
        self.cur = 0
        self.current_batch = None
        self.provide_data = data_iter.provide_data
        self.provide_label = data_iter.provide_label
        self.batch_size = data_iter.batch_size
        if hasattr(data_iter, "default_bucket_key"):
            self.default_bucket_key = data_iter.default_bucket_key

    def reset(self):
        self.cur = 0
        if self.reset_internal:
            self.data_iter.reset()

    def iter_next(self):
        if self.cur == self.size:
            return False
        try:
            self.current_batch = self.data_iter.next()
        except StopIteration:
            self.data_iter.reset()
            self.current_batch = self.data_iter.next()
        self.cur += 1
        return True

    def getdata(self):
        return self.current_batch.data

    def getlabel(self):
        return self.current_batch.label

    def getindex(self):
        return self.current_batch.index

    def getpad(self):
        return self.current_batch.pad


def _prefetch(source, slots, stop):
    """A prefetch thread's loop: the source's batches into ``slots``,
    then None at its end, or the exception its ``next`` raised; it gives
    up waiting for room once ``stop`` is set.  It holds no reference to
    its PrefetchingIter, so the iterator can be collected while the
    thread runs."""
    while not stop.is_set():
        try:
            batch = source.next()
        except StopIteration:
            batch = None
        except Exception as err:     # handed to the reader, who raises it
            batch = err
        while not stop.is_set():
            try:
                slots.put(batch, timeout=0.05)
                break
            except queue.Full:
                continue
        if batch is None or isinstance(batch, Exception):
            return


def _stop_threads(stop, threads):
    stop.set()
    for t in threads:
        if t is not threading.current_thread():
            t.join()


class PrefetchingIter(DataIter):
    """Batches of one or more iterators read ahead in background threads
    (reference io.py:347).  The threads stop and are joined at
    :meth:`reset` (which starts new ones), at the end of the data, at
    :meth:`close` and when the iterator is collected."""

    def __init__(self, iters, rename_data=None, rename_label=None,
                 prefetch_depth=2):
        super().__init__()
        if not isinstance(iters, list):
            iters = [iters]
        if not iters:
            raise ValueError("PrefetchingIter needs at least one iterator")
        self.n_iter = len(iters)
        self.iters = iters
        self.rename_data = rename_data
        self.rename_label = rename_label
        self.prefetch_depth = prefetch_depth
        self.batch_size = self.provide_data[0][1][0]
        self._threads = []
        self._finalizer = None
        self._start_threads()

    def _start_threads(self):
        self._queues = [queue.Queue(maxsize=self.prefetch_depth)
                        for _ in range(self.n_iter)]
        self._stop = threading.Event()
        self._threads = [threading.Thread(target=_prefetch,
                                          args=(it, q, self._stop),
                                          daemon=True)
                         for it, q in zip(self.iters, self._queues)]
        for t in self._threads:
            t.start()
        self._finalizer = weakref.finalize(self, _stop_threads, self._stop,
                                           self._threads)

    def close(self):
        """Stop and join the prefetch threads."""
        if self._finalizer is not None:
            self._finalizer()

    @property
    def provide_data(self):
        if self.rename_data is None:
            return sum([i.provide_data for i in self.iters], [])
        return sum([[DataDesc(r[x.name], x.shape, x.dtype)
                     if isinstance(x, DataDesc) else DataDesc(*x)
                     for x in i.provide_data]
                    for r, i in zip(self.rename_data, self.iters)], [])

    @property
    def provide_label(self):
        if self.rename_label is None:
            return sum([i.provide_label for i in self.iters], [])
        return sum([[DataDesc(r[x.name], x.shape, x.dtype)
                     if isinstance(x, DataDesc) else DataDesc(*x)
                     for x in i.provide_label]
                    for r, i in zip(self.rename_label, self.iters)], [])

    def reset(self):
        self.close()
        for it in self.iters:
            it.reset()
        self._start_threads()

    def next(self):
        if self._stop.is_set():
            raise StopIteration
        batches = [q.get() for q in self._queues]
        for b in batches:
            if isinstance(b, Exception):
                self.close()
                raise b
        if any(b is None for b in batches):
            self.close()
            raise StopIteration
        if self.n_iter == 1:
            return batches[0]
        return DataBatch(data=sum([b.data for b in batches], []),
                         label=sum([b.label for b in batches], []),
                         pad=batches[0].pad)

    def iter_next(self):
        try:
            self._next_batch = self.next()
            return True
        except StopIteration:
            return False


class CSVIter(DataIter):
    """Batches of a CSV file's rows, reshaped to ``data_shape``, with a
    label file or zero labels (reference src/io/iter_csv.cc);
    ``round_batch`` rolls the tail over into the next epoch, else it is
    padded."""

    def __init__(self, data_csv, data_shape, label_csv=None,
                 label_shape=(1,), batch_size=1, round_batch=True,
                 dtype="float32", **kwargs):
        super().__init__(batch_size)
        data = np.loadtxt(data_csv, delimiter=",", dtype=dtype, ndmin=2)
        data = data.reshape((-1,) + tuple(data_shape))
        if label_csv is not None:
            label = np.loadtxt(label_csv, delimiter=",", dtype=dtype,
                               ndmin=2)
            label = label.reshape((-1,) + tuple(label_shape))
            if label.shape[-1] == 1:
                label = label.reshape(label.shape[:-1])
        else:
            label = np.zeros((data.shape[0],), dtype=dtype)
        self._inner = NDArrayIter(data, label, batch_size,
                                  last_batch_handle="roll_over"
                                  if round_batch else "pad")

    def __getattr__(self, name):
        if name == "_inner":
            raise AttributeError(name)
        return getattr(self._inner, name)

    def __next__(self):
        return self._inner.next()

    def next(self):
        return self._inner.next()

    def reset(self):
        self._inner.reset()

    @property
    def provide_data(self):
        return self._inner.provide_data

    @property
    def provide_label(self):
        return self._inner.provide_label


class LibSVMIter(DataIter):
    """LibSVM source (reference src/io/iter_libsvm.cc): CSR batches of
    ``data_shape``'s width on the CPU, float32 labels, the last batch
    padded with the first rows (``pad`` says how many).  Each row holds
    what a dense row of its ``index:value`` pairs would: a later
    duplicate index wins, zeros are dropped, indices ascend (the JAX
    package's batches), computed over the pairs alone.  ``label_libsvm``
    is not read, as in the JAX package."""

    def __init__(self, data_libsvm, data_shape, label_libsvm=None,
                 batch_size=1, **kwargs):
        super().__init__(batch_size)
        self._dim = int(np.prod(data_shape))
        self._indptr, self._cols, self._vals, labels = self._parse(
            data_libsvm, self._dim)
        self._labels = np.asarray(labels, np.float32)
        self._num = len(labels)
        self._cursor = -batch_size
        self.data_name = "data"
        self.label_name = "softmax_label"

    @staticmethod
    def _parse(path, dim):
        """``(indptr, indices, values, labels)`` of the file's rows."""
        labels, rows, cols, vals = [], [], [], []
        with open(path) as f:
            for line in f:
                parts = line.split()
                if not parts:
                    continue
                r = len(labels)
                labels.append(float(parts[0]))
                for tok in parts[1:]:
                    k, v = tok.split(":")
                    rows.append(r)
                    cols.append(int(k))
                    vals.append(float(v))
        rows = np.asarray(rows, np.int64)
        cols = np.asarray(cols, np.int64)
        vals = np.asarray(vals, np.float64).astype(np.float32)
        bad = (cols < -dim) | (cols >= dim)
        if bad.any():
            raise IndexError("LibSVMIter: feature index %d out of range "
                             "for %d features" % (cols[bad][0], dim))
        cols = np.where(cols < 0, cols + dim, cols)  # as numpy indexes
        order = np.lexsort((np.arange(len(cols)), cols, rows))
        rows, cols, vals = rows[order], cols[order], vals[order]
        last = np.ones(len(cols), bool)
        last[:-1] = (rows[1:] != rows[:-1]) | (cols[1:] != cols[:-1])
        keep = last & (vals != 0)
        rows, cols, vals = rows[keep], cols[keep], vals[keep]
        indptr = np.zeros(len(labels) + 1, np.int64)
        np.cumsum(np.bincount(rows, minlength=len(labels)), out=indptr[1:])
        return indptr, cols, vals, labels

    @property
    def provide_data(self):
        return [DataDesc(self.data_name, (self.batch_size, self._dim))]

    @property
    def provide_label(self):
        return [DataDesc(self.label_name, (self.batch_size,))]

    def reset(self):
        self._cursor = -self.batch_size

    def iter_next(self):
        self._cursor += self.batch_size
        return self._cursor < self._num

    def _rows(self, a, b):
        """Rows ``[a, b)`` as (indptr from 0, indices, values)."""
        lo, hi = self._indptr[a], self._indptr[b]
        return (self._indptr[a:b + 1] - lo, self._cols[lo:hi],
                self._vals[lo:hi])

    def next(self):
        from ..ndarray.sparse import CSRNDArray
        if not self.iter_next():
            raise StopIteration
        end = min(self._cursor + self.batch_size, self._num)
        parts = [self._rows(self._cursor, end)]
        labels = self._labels[self._cursor:end]
        pad = self.batch_size - (end - self._cursor)
        if pad:
            wrap = min(pad, self._num)
            parts.append(self._rows(0, wrap))
            labels = np.concatenate([labels, self._labels[:wrap]])
        indptr = parts[0][0]
        for p in parts[1:]:
            indptr = np.concatenate([indptr, p[0][1:] + indptr[-1]])
        data = CSRNDArray(
            torch.from_numpy(np.concatenate([p[2] for p in parts])),
            torch.from_numpy(np.concatenate([p[1] for p in parts])),
            torch.from_numpy(indptr), (len(indptr) - 1, self._dim))
        return DataBatch(data=[data], label=[_host(labels)], pad=pad)


def _read_idx(path):
    """An idx-format file (optionally gzipped) as a uint8 array."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic = struct.unpack(">I", f.read(4))[0]
        ndim = magic & 0xFF
        shape = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        return np.frombuffer(f.read(), dtype=np.uint8).reshape(shape)


class MNISTIter(DataIter):
    """MNIST's idx files as batches of images scaled to [0, 1] (reference
    src/io/iter_mnist.cc), shuffled once from ``seed``."""

    def __init__(self, image, label, batch_size=128, shuffle=True,
                 flat=False, silent=False, seed=0, **kwargs):
        super().__init__(batch_size)
        images = _read_idx(image).astype(np.float32) / 255.0
        labels = _read_idx(label).astype(np.float32)
        if flat:
            images = images.reshape(images.shape[0], -1)
        else:
            images = images.reshape(images.shape[0], 1, images.shape[1],
                                    images.shape[2])
        if shuffle:
            order = np.random.RandomState(seed).permutation(images.shape[0])
            images, labels = images[order], labels[order]
        self._inner = NDArrayIter(images, labels, batch_size)

    def next(self):
        return self._inner.next()

    def reset(self):
        self._inner.reset()

    def iter_next(self):
        return self._inner.iter_next()

    @property
    def provide_data(self):
        return self._inner.provide_data

    @property
    def provide_label(self):
        return self._inner.provide_label
