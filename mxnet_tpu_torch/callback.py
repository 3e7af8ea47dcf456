"""Training-loop hooks (port of ``mxnet_tpu/callback.py``; reference
python/mxnet/callback.py).

* Epoch hooks, ``f(epoch, symbol, arg_params, aux_params)`` after each
  epoch: the checkpoints (``do_checkpoint``, ``module_checkpoint``).
* Batch hooks, ``f(BatchEndParam)`` after each batch (and at the end of
  an evaluation): ``log_train_metric``, ``Speedometer``, ``ProgressBar``,
  ``LogValidationMetricsCallback``.  The fit loop reads the metric's value
  back from the card every batch, so a wall-clock rate over a window of
  batches measures the steps and not only their enqueue.
"""
from __future__ import annotations

import logging
import time

__all__ = ["module_checkpoint", "do_checkpoint", "log_train_metric",
           "Speedometer", "ProgressBar", "LogValidationMetricsCallback"]


def _metric_pairs(metric):
    """name/value pairs of a metric, or () when there is no metric."""
    return tuple(metric.get_name_value()) if metric is not None else ()


def _epoch_gate(period):
    """True on 0-indexed epochs e where e + 1 is a multiple of period."""
    period = max(1, int(period))
    return lambda epoch: (epoch + 1) % period == 0


def do_checkpoint(prefix, period=1):
    """Epoch hook: write ``prefix-symbol.json`` / ``prefix-NNNN.params``
    every ``period`` epochs (reference callback.py:55)."""
    from .model import save_checkpoint
    hit = _epoch_gate(period)

    def hook(epoch, sym, arg, aux):
        if hit(epoch):
            save_checkpoint(prefix, epoch + 1, sym, arg, aux)
    return hook


def module_checkpoint(mod, prefix, period=1, save_optimizer_states=False):
    """Epoch hook bound to a Module: checkpoint through the module, so
    the optimizer states can be saved too (reference callback.py:28)."""
    hit = _epoch_gate(period)

    def hook(epoch, sym=None, arg=None, aux=None):
        if hit(epoch):
            mod.save_checkpoint(prefix, epoch + 1, save_optimizer_states)
    return hook


def log_train_metric(period, auto_reset=False):
    """Batch hook: log the running training metric every ``period``
    batches (reference callback.py:93)."""

    def hook(param):
        if param.nbatch % period:
            return
        for name, value in _metric_pairs(param.eval_metric):
            logging.info("Iter[%d] Batch[%d] Train-%s=%f",
                         param.epoch, param.nbatch, name, value)
        if auto_reset and param.eval_metric is not None:
            param.eval_metric.reset()
    return hook


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
        pairs = _metric_pairs(param.eval_metric)
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


class ProgressBar:
    """Batch hook: an ASCII bar of the batches done out of ``total``
    (reference callback.py:187)."""

    def __init__(self, total, length=80):
        self.total = total
        self.bar_len = length

    def __call__(self, param):
        frac = param.nbatch / float(self.total)
        ticks = int(round(self.bar_len * frac))
        pct = int(-(-100.0 * frac // 1))
        logging.info("[%s] %s%%\r",
                     "=" * ticks + "-" * (self.bar_len - ticks), pct)


class LogValidationMetricsCallback:
    """Eval-end hook: log each validation metric of the epoch (reference
    callback.py:211)."""

    def __call__(self, param):
        for name, value in _metric_pairs(param.eval_metric):
            logging.info("Epoch[%d] Validation-%s=%f",
                         param.epoch, name, value)
