"""Bucketed iteration over variable-length sentences (port of
``mxnet_tpu/rnn/io.py``; reference python/mxnet/rnn/io.py:
``encode_sentences``, ``BucketSentenceIter``).

Sentences are binned into length buckets and padded to the bucket's
width; each batch carries the ``bucket_key`` that a ``BucketingModule``
switches on, and its next-token labels.  The batches are NDArrays on the
CPU, as ``NDArrayIter``'s.

The order of the batches is drawn on the host with Python's global
``random.shuffle`` and numpy's global ``np.random.shuffle``, the very
calls of the reference, so that one seed of those two generators gives
both packages the same batches.  This is the one place in the port that
draws from global generators rather than a ``torch.Generator`` it owns.
"""
from __future__ import annotations

import bisect
import random

import numpy as np
import torch

from ..io.io import DataBatch, DataDesc, DataIter
from ..ndarray.ndarray import NDArray

__all__ = ["BucketSentenceIter", "encode_sentences"]


def encode_sentences(sentences, vocab=None, invalid_label=-1,
                     invalid_key="\n", start_label=0, unknown_token=None):
    """Token sequences -> id sequences and the vocabulary, which grows
    unless the caller gives one (then an unseen token maps to
    ``unknown_token`` or raises)."""
    growable = vocab is None
    if growable:
        vocab = {invalid_key: invalid_label}
    fresh_id = start_label

    encoded = []
    for sentence in sentences:
        ids = []
        for token in sentence:
            if token not in vocab:
                if not (growable or unknown_token):
                    raise KeyError("Unknown token %s" % token)
                if fresh_id == invalid_label:
                    fresh_id += 1
                if unknown_token:
                    token = unknown_token
                vocab[token] = fresh_id
                fresh_id += 1
            ids.append(vocab[token])
        encoded.append(ids)
    return encoded, vocab


def _host(rows, dtype):
    return NDArray(torch.from_numpy(np.array(rows, dtype=dtype)))


class BucketSentenceIter(DataIter):
    """Length-bucketed, padded sentence batches with bucket keys.
    ``layout`` "NT" is batch-major, "TN" time-major; the labels are the
    data shifted one step left with ``invalid_label`` in the last
    position."""

    def __init__(self, sentences, batch_size, buckets=None,
                 invalid_label=-1, data_name="data",
                 label_name="softmax_label", dtype="float32", layout="NT"):
        super().__init__()
        self.batch_size = batch_size
        self.data_name = data_name
        self.label_name = label_name
        self.dtype = dtype
        self.invalid_label = invalid_label
        self.layout = layout
        self.major_axis = layout.find("N")
        if self.major_axis not in (0, 1):
            raise ValueError("Invalid layout %s: Must by NT (batch major) "
                             "or TN (time major)" % layout)

        if not buckets:
            # every length with enough sentences to fill a batch
            counts = np.bincount([len(s) for s in sentences])
            buckets = [width for width, n in enumerate(counts)
                       if n >= batch_size]
        self.buckets = sorted(buckets)
        self.default_bucket_key = max(self.buckets)

        self.data = self._bin_and_pad(sentences)
        self.nddata = []
        self.ndlabel = []

        span = (batch_size, self.default_bucket_key)
        if self.major_axis == 1:
            span = span[::-1]
        self.provide_data = [DataDesc(name=data_name, shape=span,
                                      layout=layout)]
        self.provide_label = [DataDesc(name=label_name, shape=span,
                                       layout=layout)]

        # (bucket index, row offset) of every full batch
        self.idx = [(b, row)
                    for b, rows in enumerate(self.data)
                    for row in range(0, len(rows) - batch_size + 1,
                                     batch_size)]
        self.curr_idx = 0
        self.reset()

    def _bin_and_pad(self, sentences):
        binned = [[] for _ in self.buckets]
        dropped = 0
        for sentence in sentences:
            slot = bisect.bisect_left(self.buckets, len(sentence))
            if slot == len(self.buckets):
                dropped += 1
                continue
            padded = np.full((self.buckets[slot],), self.invalid_label,
                             dtype=self.dtype)
            padded[:len(sentence)] = sentence
            binned[slot].append(padded)
        if dropped:
            print("WARNING: discarded %d sentences longer than the largest "
                  "bucket." % dropped)
        return [np.asarray(rows, dtype=self.dtype) for rows in binned]

    def reset(self):
        self.curr_idx = 0
        random.shuffle(self.idx)
        self.nddata, self.ndlabel = [], []
        for rows in self.data:
            np.random.shuffle(rows)
            # next-token target: shifted left, the last step padded
            target = np.empty_like(rows)
            target[:, :-1] = rows[:, 1:]
            target[:, -1] = self.invalid_label
            self.nddata.append(_host(rows, self.dtype))
            self.ndlabel.append(_host(target, self.dtype))

    def _desc(self, name, shape):
        return DataDesc(name=name, shape=shape, layout=self.layout)

    def next(self):
        if self.curr_idx == len(self.idx):
            raise StopIteration
        bucket, row = self.idx[self.curr_idx]
        self.curr_idx += 1
        window = slice(row, row + self.batch_size)
        data = self.nddata[bucket][window]
        label = self.ndlabel[bucket][window]
        if self.major_axis == 1:
            data, label = data.T, label.T
        return DataBatch(
            [data], [label], pad=0, bucket_key=self.buckets[bucket],
            provide_data=[self._desc(self.data_name, data.shape)],
            provide_label=[self._desc(self.label_name, label.shape)])
