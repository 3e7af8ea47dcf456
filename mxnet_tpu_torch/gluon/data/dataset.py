"""Dataset abstractions for the Gluon data pipeline (port of
``mxnet_tpu/gluon/data/dataset.py``; reference
python/mxnet/gluon/data/dataset.py): random-access containers with lazy
or eager transforms, array-backed and RecordIO-backed sources.
"""
from __future__ import annotations

import os

from ... import recordio
from ...ndarray.ndarray import NDArray


class Dataset:
    """Random-access collection contract: __getitem__ + __len__."""

    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError

    def transform(self, fn, lazy=True):
        """Apply ``fn`` per item — lazily by default, eagerly if not."""
        mapped = _LazyTransformDataset(self, fn)
        if lazy:
            return mapped
        return SimpleDataset([mapped[i] for i in range(len(mapped))])

    def transform_first(self, fn, lazy=True):
        """Transform only the first element of each (data, label, ...) item."""
        def on_first(head, *tail):
            return (fn(head),) + tail if tail else fn(head)
        return self.transform(on_first, lazy)


class SimpleDataset(Dataset):
    """Wrap any indexable (list, array) as a Dataset."""

    def __init__(self, data):
        self._data = data

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        return self._data[idx]


class _LazyTransformDataset(Dataset):
    """View applying ``fn`` at access time; tuples splat into fn's args."""

    def __init__(self, data, fn):
        self._data = data
        self._fn = fn

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        item = self._data[idx]
        return self._fn(*item) if isinstance(item, tuple) else self._fn(item)


class ArrayDataset(Dataset):
    """Zip one or more equal-length arrays into (a[i], b[i], ...) items."""

    def __init__(self, *arrays):
        if not arrays:
            raise ValueError("Needs at least 1 arrays")
        self._length = len(arrays[0])
        self._columns = []
        for pos, column in enumerate(arrays):
            if len(column) != self._length:
                raise ValueError(
                    "All arrays must have the same length; array[0] has "
                    "length %d while array[%d] has %d."
                    % (self._length, pos, len(column)))
            # 1-d label vectors index faster as host numpy
            if isinstance(column, NDArray) and column.ndim == 1:
                column = column.asnumpy()
            self._columns.append(column)

    def __getitem__(self, idx):
        if len(self._columns) == 1:
            return self._columns[0][idx]
        return tuple(column[idx] for column in self._columns)

    def __len__(self):
        return self._length


class RecordFileDataset(Dataset):
    """Random access into a RecordIO pack via its .idx sidecar."""

    def __init__(self, filename):
        self.filename = filename
        self.idx_file = os.path.splitext(filename)[0] + ".idx"
        self._record = recordio.MXIndexedRecordIO(self.idx_file, filename,
                                                  "r")

    def __getitem__(self, idx):
        return self._record.read_idx(self._record.keys[idx])

    def __len__(self):
        return len(self._record.keys)
