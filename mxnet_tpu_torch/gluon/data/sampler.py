"""Index samplers for the Gluon DataLoader (port of
``mxnet_tpu/gluon/data/sampler.py``; reference
python/mxnet/gluon/data/sampler.py): sequential, shuffled (numpy's
global generator, as in the JAX package), and batching with
keep/discard/rollover tail policies.
"""
from __future__ import annotations

import numpy as np

_TAIL_POLICIES = ("keep", "discard", "rollover")


class Sampler:
    """Iterable over dataset indices with a known length."""

    def __iter__(self):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class SequentialSampler(Sampler):
    """0..length-1 in order."""

    def __init__(self, length):
        self._length = length

    def __iter__(self):
        return iter(range(self._length))

    def __len__(self):
        return self._length


class RandomSampler(Sampler):
    """A fresh permutation of 0..length-1 each epoch."""

    def __init__(self, length):
        self._length = length

    def __iter__(self):
        return iter(np.random.permutation(self._length))

    def __len__(self):
        return self._length


class BatchSampler(Sampler):
    """Group a sampler's indices into batch-size lists.

    Tail policy: "keep" yields the short final batch, "discard" drops it,
    "rollover" saves it to start the next epoch.
    """

    def __init__(self, sampler, batch_size, last_batch="keep"):
        self._sampler = sampler
        self._batch_size = batch_size
        self._last_batch = last_batch
        self._prev = []

    def _check_policy(self):
        if self._last_batch not in _TAIL_POLICIES:
            raise ValueError(
                "last_batch must be one of 'keep', 'discard', or "
                "'rollover', but got %s" % self._last_batch)

    def __iter__(self):
        self._check_policy()
        pending, self._prev = self._prev, []
        for idx in self._sampler:
            pending.append(idx)
            if len(pending) == self._batch_size:
                yield pending
                pending = []
        if pending:
            if self._last_batch == "keep":
                yield pending
            elif self._last_batch == "rollover":
                self._prev = pending
            # "discard": drop the tail

    def __len__(self):
        self._check_policy()
        n = len(self._sampler)
        if self._last_batch == "keep":
            return -(-n // self._batch_size)
        if self._last_batch == "discard":
            return n // self._batch_size
        return (len(self._prev) + n) // self._batch_size
