"""Data iterators (port of ``DataDesc``, ``DataBatch``, ``DataIter`` and
``NDArrayIter`` from ``mxnet_tpu/io/io.py``; reference
python/mxnet/io.py :180, :544).

Data stays in host memory, as the reference's does: a batch is a list of
NDArrays on the CPU, and the Module's executor group copies it into the
arrays it bound on the card.  ``NDArrayIter`` gathers a batch through a
modular index window, so the tail's wrap-around ("pad") is one ``take``;
"discard" trims the tail up front and "roll_over" carries the tail
offset into the next epoch.  Shuffling is an index permutation (drawn
from ``seed`` when given).

Not ported yet, each raising :class:`~mxnet_tpu_torch.base.NotPortedYet`
(ROADMAP A4): sharding over workers (``num_parts`` > 1) and the exact
resume state (``state_dict``, ``reshard``); ``ResizeIter``,
``PrefetchingIter`` and the file iterators are absent.
"""
from __future__ import annotations

from collections import OrderedDict, namedtuple

import numpy as np
import torch

from ..base import NotPortedYet
from ..ndarray.ndarray import NDArray
from .. import telemetry

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter"]


class DataDesc(namedtuple("DataDesc", ["name", "shape"])):
    """Named tensor spec carried by iterators: (name, shape) + dtype and
    layout."""

    def __new__(cls, name, shape, dtype=np.float32, layout="NCHW"):
        ret = super().__new__(cls, name, tuple(shape))
        ret.dtype = dtype
        ret.layout = layout
        return ret


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


class NDArrayIter(DataIter):
    """Batch iterator over in-memory arrays (reference io.py:544); the
    batches are NDArrays on the CPU."""

    def __init__(self, data, label=None, batch_size=1, shuffle=False,
                 last_batch_handle="pad", data_name="data",
                 label_name="softmax_label", num_parts=1, part_index=0,
                 seed=None):
        super().__init__(batch_size)
        if int(num_parts) != 1 or int(part_index) != 0:
            raise NotPortedYet("NDArrayIter sharding (num_parts > 1) needs "
                               "the distributed slice (ROADMAP A5)")
        if last_batch_handle not in ("pad", "discard", "roll_over"):
            raise ValueError("last_batch_handle must be pad, discard or "
                             "roll_over, got %r" % (last_batch_handle,))
        self.data = _named_arrays(data, False, data_name)
        self.label = _named_arrays(label, True, label_name)
        self.last_batch_handle = last_batch_handle
        total = self.data[0][1].shape[0]
        self.shuffle = bool(shuffle)
        self._order = None
        if shuffle:
            rng = np.random if seed is None else np.random.RandomState(seed)
            self._order = rng.permutation(total)
        if last_batch_handle == "discard":
            total -= total % batch_size
        if total < batch_size:
            raise ValueError("batch_size needs to be smaller than data size.")
        self.num_data = total
        self._pos = -batch_size

    def _descs(self, sources):
        return [DataDesc(name, (self.batch_size,) + arr.shape[1:], arr.dtype)
                for name, arr in sources]

    @property
    def provide_data(self):
        return self._descs(self.data)

    @property
    def provide_label(self):
        return self._descs(self.label)

    def reset(self):
        if self.last_batch_handle == "roll_over" and \
                self._pos > self.num_data:
            # keep the un-consumed tail offset for the next epoch
            self._pos = (self._pos % self.num_data) % self.batch_size \
                - self.batch_size
        else:
            self._pos = -self.batch_size

    def iter_next(self):
        self._pos += self.batch_size
        return self._pos < self.num_data

    def _window(self, sources):
        if self._pos >= self.num_data:
            raise RuntimeError("DataIter needs reset.")
        start, stop = self._pos, self._pos + self.batch_size
        picks = (slice(start, stop) if stop <= self.num_data
                 else np.arange(start, stop) % self.num_data)
        if self._order is not None:
            picks = self._order[picks]
        return [NDArray(torch.from_numpy(np.array(arr[picks])))
                for _, arr in sources]

    def getdata(self):
        return self._window(self.data)

    def getlabel(self):
        return self._window(self.label)

    def getpad(self):
        overrun = self._pos + self.batch_size - self.num_data
        if self.last_batch_handle == "pad" and overrun > 0:
            return min(overrun, self.batch_size)
        return 0
