"""Training-loop hooks (port of ``Speedometer`` from
``mxnet_tpu/callback.py``; reference python/mxnet/callback.py:120).

A batch hook is ``f(BatchEndParam)``, called by ``Module.fit`` after
each batch.  The fit loop reads the metric's value back from the card
every batch, so a wall-clock rate over a window of batches measures the
steps and not only their enqueue.  The checkpoint hooks wait for the
``.params`` format (ROADMAP A2).
"""
from __future__ import annotations

import logging
import time

__all__ = ["Speedometer"]


class Speedometer:
    """Samples/sec over each window of ``frequent`` batches, plus the
    running metric (reference callback.py:120).  The clock starts at the
    first batch seen and restarts when ``nbatch`` goes backwards (a new
    epoch)."""

    def __init__(self, batch_size, frequent=50, auto_reset=True):
        self.batch_size = batch_size
        self.frequent = frequent
        self.auto_reset = auto_reset
        self._window_start = None
        self._prev_nbatch = 0

    def __call__(self, param):
        n = param.nbatch
        if n < self._prev_nbatch:          # epoch rolled over
            self._window_start = None
        self._prev_nbatch = n
        if self._window_start is None:
            self._window_start = time.time()
            return
        if n % self.frequent:
            return
        elapsed = time.time() - self._window_start
        rate = self.frequent * self.batch_size / max(elapsed, 1e-12)
        pairs = (tuple(param.eval_metric.get_name_value())
                 if param.eval_metric is not None else ())
        if pairs:
            if self.auto_reset:
                param.eval_metric.reset()
            tail = "".join("\t%s=%f" % kv for kv in pairs)
            logging.info("Epoch[%d] Batch [%d]\tSpeed: %.2f samples/sec%s",
                         param.epoch, n, rate, tail)
        else:
            logging.info("Iter[%d] Batch [%d]\tSpeed: %.2f samples/sec",
                         param.epoch, n, rate)
        self._window_start = time.time()
