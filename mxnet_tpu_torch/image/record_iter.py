"""ImageRecordIter, the threaded RecordIO decode and augment pipeline
(port of ``mxnet_tpu/image/record_iter.py``; reference
src/io/iter_image_recordio_2.cc: ImageRecordIOParser2 :50, chunked reads
and OMP-parallel JPEG decode :138-171, shuffle :173-190, feeding
BatchLoader and PrefetcherIter).

Two backends, chosen by the JAX package's rule: the native C++ pipeline
(``io/native.py``: OpenMP libjpeg decode and a bounded prefetch queue)
when ``MXNET_TPU_NATIVE_IO`` is not ``"0"`` and the library builds here,
else the Python path, where worker threads decode with PIL (which
releases the GIL) and augment.  ``_native`` tells which was chosen.

Either way each batch is built in fresh pinned buffers
(``io/pinned.py``): the native backend writes the batch straight into
them, the Python path's threads write each image into its row.  The
batches are host arrays; the Module copies them to the card without
blocking the host.
"""
from __future__ import annotations

import os
import random
import threading

import numpy as np
import torch

from ..base import MXNetError
from ..io.io import DataBatch, DataDesc, DataIter
from ..io import pinned
from ..ndarray.ndarray import NDArray
from .. import recordio
from .image import CreateAugmenter, _np, imdecode

__all__ = ["ImageRecordIter", "ImageRecordUInt8Iter"]


class ImageRecordIter(DataIter):
    """reference io.ImageRecordIter params (subset with same names)."""

    def __init__(self, path_imgrec, data_shape, batch_size,
                 path_imgidx=None, label_width=1, shuffle=False,
                 shuffle_chunk_size=0, part_index=0, num_parts=1,
                 preprocess_threads=4, prefetch_buffer=4,
                 rand_crop=False, rand_mirror=False, mean_r=0.0, mean_g=0.0,
                 mean_b=0.0, std_r=1.0, std_g=1.0, std_b=1.0, resize=0,
                 data_name="data", label_name="softmax_label",
                 round_batch=True, seed=0, **kwargs):
        super().__init__(batch_size)
        self.data_shape = tuple(int(x) for x in data_shape)
        self.label_width = label_width
        self.data_name = data_name
        self.label_name = label_name
        mean = None
        std = None
        if mean_r or mean_g or mean_b:
            mean = np.array([mean_r, mean_g, mean_b])
        if std_r != 1 or std_g != 1 or std_b != 1:
            std = np.array([std_r, std_g, std_b])
        self.auglist = CreateAugmenter(self.data_shape, resize=resize,
                                       rand_crop=rand_crop,
                                       rand_mirror=rand_mirror,
                                       mean=mean, std=std)
        idx_path = path_imgidx or os.path.splitext(path_imgrec)[0] + ".idx"
        have_idx = os.path.isfile(idx_path)

        # Prefer the native C++ pipeline when it builds: same parameter
        # surface, decode+augment under OMP with a bounded prefetch queue.
        self._native = None
        if os.environ.get("MXNET_TPU_NATIVE_IO", "1") != "0":
            from ..io.native import NativeRecordIter, load_native
            if load_native() is not None:
                self._native = NativeRecordIter(
                    path_imgrec, self.data_shape, batch_size,
                    idx_path=idx_path if have_idx else None,
                    label_width=label_width, threads=preprocess_threads,
                    shuffle=shuffle, seed=seed, resize_short=resize,
                    rand_crop=rand_crop, rand_mirror=rand_mirror,
                    mean=None if mean is None
                    else tuple(float(v) for v in mean),
                    std=None if std is None
                    else tuple(float(v) for v in std),
                    prefetch=prefetch_buffer, part_index=part_index,
                    num_parts=num_parts if have_idx else 1)
                return

        from ..resilience.retry import call_with_retry
        if have_idx:
            self._rec = call_with_retry(
                recordio.MXIndexedRecordIO, idx_path, path_imgrec, "r",
                exceptions=(OSError,), desc="open %s" % path_imgrec)
            keys = list(self._rec.keys)
        else:
            # sequential scan to index offsets
            self._rec = call_with_retry(
                recordio.MXRecordIO, path_imgrec, "r",
                exceptions=(OSError,), desc="open %s" % path_imgrec)
            keys = None
        self._keys = keys
        if keys is not None and num_parts > 1:
            n = len(keys) // num_parts
            self._keys = keys[part_index * n:(part_index + 1) * n]
        self.shuffle = shuffle
        self._threads = preprocess_threads
        self._prefetch = prefetch_buffer
        self._rng = random.Random(seed)
        self._order = None
        self._lock = threading.Lock()
        self._epoch = -1      # reset() below brings it to 0
        self.reset()

    @property
    def provide_data(self):
        return [DataDesc(self.data_name, (self.batch_size,) +
                         self.data_shape)]

    @property
    def provide_label(self):
        shape = (self.batch_size,) if self.label_width == 1 else \
            (self.batch_size, self.label_width)
        return [DataDesc(self.label_name, shape)]

    def reset(self):
        if self._native is not None:
            self._native.reset()
            return
        self._epoch += 1
        if self._keys is not None:
            self._order = list(self._keys)
            if self.shuffle:
                self._rng.shuffle(self._order)
        else:
            self._rec.reset()
        self._cursor = 0

    # -- exact-resume state ----------------------------------------------
    def state_dict(self):
        """Checkpointable position: cursor, epoch, this epoch's shuffled
        key order, and the shuffle-RNG state (so FUTURE epochs reshuffle
        identically).  Requires the indexed pure-Python pipeline."""
        if self._native is not None:
            raise MXNetError(
                "exact-resume iterator state needs the Python RecordIO "
                "pipeline; set MXNET_TPU_NATIVE_IO=0")
        if self._order is None:
            raise MXNetError(
                "exact-resume iterator state needs an indexed record file "
                "(.idx) — the sequential-scan path has no cursor to save")
        with self._lock:
            return {"kind": "ImageRecordIter",
                    "cursor": int(self._cursor),
                    "epoch": int(self._epoch),
                    "order": np.asarray(self._order, np.int64),
                    "rng_state": self._rng.getstate()}

    def load_state_dict(self, state):
        if state.get("kind") != "ImageRecordIter":
            raise ValueError("state is for %r, not ImageRecordIter"
                             % state.get("kind"))
        if self._native is not None:
            raise MXNetError(
                "exact-resume iterator state needs the Python RecordIO "
                "pipeline; set MXNET_TPU_NATIVE_IO=0")
        order = [int(k) for k in np.asarray(state["order"])]
        missing = set(order) - set(self._keys or [])
        if missing:
            raise ValueError(
                "iterator state mismatch: %d saved record keys not in this "
                "record file (e.g. %r)" % (len(missing),
                                           sorted(missing)[:3]))
        with self._lock:
            self._order = order
            self._cursor = int(state["cursor"])
            self._epoch = int(state["epoch"])
            rng_state = state.get("rng_state")
            if rng_state is not None:
                version, internal, gauss = rng_state
                self._rng.setstate(
                    (int(version), tuple(int(v) for v in internal), gauss))

    def _read_record(self):
        """One raw record, retried with backoff on transient IO errors
        (network filesystems drop reads under load; see resilience/retry).
        The chaos ``io_error`` fault fires INSIDE the retried callable so
        fault drills prove the retry path, not a mock of it."""
        from ..resilience import chaos
        from ..resilience.retry import call_with_retry
        with self._lock:
            if self._order is not None:
                if self._cursor >= len(self._order):
                    return None
                key = self._order[self._cursor]
                self._cursor += 1

                def read_one():
                    chaos.maybe_io_error("record %s" % key)
                    return self._rec.read_idx(key)
            else:
                def read_one():
                    chaos.maybe_io_error("record stream read")
                    return self._rec.read()
            return call_with_retry(read_one, exceptions=(OSError,),
                                   desc="RecordIO read")

    def _decode_one(self, raw):
        header, img_bytes = recordio.unpack(raw)
        img = imdecode(img_bytes)
        for aug in self.auglist:
            img = aug(img)
        label = np.asarray(header.label).reshape(-1)
        return _np(img), label

    def next(self):
        from .. import telemetry
        from ..telemetry import memory as _memory
        with telemetry.span("data/next", cat="io",
                            metric="data.next_seconds"):
            batch = self._next_batch()
            # memory plane: bucket the decoded batch buffers
            _memory.tag(list(batch.data) + list(batch.label or []),
                        "batch", label="ImageRecordIter")
            return batch

    def _buffers(self):
        c, h, w = self.data_shape
        return (pinned.empty((self.batch_size, c, h, w), torch.float32),
                pinned.empty((self.batch_size, self.label_width),
                             torch.float32))

    def _batch(self, data, label, pad):
        out_label = label[:, 0] if self.label_width == 1 else label
        return DataBatch([NDArray(data)], [NDArray(out_label)], pad=pad)

    def _next_batch(self):
        if self._native is not None:
            data, label = self._buffers()
            pad = self._native.next_into(data, label)  # raises StopIteration
            return self._batch(data, label, pad)
        c, h, w = self.data_shape
        bs = self.batch_size
        raws = []
        for _ in range(bs):
            r = self._read_record()
            if r is None:
                break
            raws.append(r)
        if not raws:
            raise StopIteration
        pad = bs - len(raws)
        data_t, label_t = self._buffers()
        data, label = data_t.numpy(), label_t.numpy()
        label[...] = 0

        def put(idx):
            img, lab = self._decode_one(raws[idx])
            data[idx] = img.reshape(h, w, c).transpose(2, 0, 1)
            label[idx, :len(lab[:self.label_width])] = lab[:self.label_width]

        if self._threads > 1 and len(raws) > 1:
            errors = []

            def worker(start, step):
                try:
                    for idx in range(start, len(raws), step):
                        put(idx)
                except BaseException as e:   # re-raised by next()
                    errors.append(e)

            threads = [threading.Thread(target=worker, args=(t, self._threads))
                       for t in range(self._threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            if errors:
                raise errors[0]
        else:
            for idx in range(len(raws)):
                put(idx)

        for j in range(len(raws), bs):
            data[j] = data[j % len(raws)]
            label[j] = label[j % len(raws)]
        return self._batch(data_t, label_t, pad)


def ImageRecordUInt8Iter(*args, **kwargs):
    """uint8 variant (reference ImageRecordUInt8Iter) — same pipeline."""
    return ImageRecordIter(*args, **kwargs)
