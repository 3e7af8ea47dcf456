"""Contrib samplers (port of ``mxnet_tpu/gluon/contrib/data/sampler.py``;
reference gluon/contrib/data/sampler.py)."""
from ...data.sampler import Sampler

__all__ = ["IntervalSampler"]


class IntervalSampler(Sampler):
    """Strided sweep over [0, length): indices i, i+k, i+2k, ... for each
    start i — with rollover=True every element is visited exactly once
    (stride k then next phase); with rollover=False only phase 0 runs."""

    def __init__(self, length, interval, rollover=True):
        if interval > length:
            raise ValueError(
                "interval (%d) must not exceed length (%d)"
                % (interval, length))
        self._length = length
        self._interval = interval
        self._rollover = rollover

    def __iter__(self):
        phases = range(self._interval) if self._rollover else [0]
        for start in phases:
            yield from range(start, self._length, self._interval)

    def __len__(self):
        if self._rollover:
            return self._length
        return len(range(0, self._length, self._interval))
