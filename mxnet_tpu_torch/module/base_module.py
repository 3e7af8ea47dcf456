"""The train / score / predict loops shared by modules (port of
``mxnet_tpu/module/base_module.py``; reference
python/mxnet/module/base_module.py: fit :376-465, score :205, predict
:303, forward_backward :189).

Each training step runs inside the ``train/step`` span and counts
``train.steps`` (:mod:`~mxnet_tpu_torch.telemetry`).  The JAX package
also runs every step under its hang watchdog, beats a heartbeat lane and
can inject a ``hang`` chaos fault (``base_module.py:280-305``); those
wait for ROADMAP A12, and :meth:`BaseModule.fit` raises
:class:`~mxnet_tpu_torch.base.NotPortedYet` when their knobs are set.
"""
from __future__ import annotations

import logging
import os
from collections import namedtuple

import numpy as np
import torch

from .. import metric as metric_mod
from .. import telemetry
from ..base import NotPortedYet, armed_env
from ..io.io import DataBatch
from ..ndarray.ndarray import NDArray, array as nd_array
from ..resilience import chaos as _chaos

__all__ = ["BaseModule", "BatchEndParam"]

BatchEndParam = namedtuple("BatchEndParams",
                           ["epoch", "nbatch", "eval_metric", "locals"])

_PARAM_TAGS = ("arg", "aux")

_WATCHDOG_TIMEOUTS = ("MXNET_TPU_WATCHDOG_STEP_TIMEOUT",
                      "MXNET_TPU_WATCHDOG_COLLECTIVE_TIMEOUT")


def _watchdog_knobs():
    """The knobs that arm the JAX package's step watchdog, as its
    ``resilience/watchdog.enabled`` reads them: the master switch decides
    when it is set, else either timeout being present arms it."""
    if "MXNET_TPU_WATCHDOG" in os.environ:
        return armed_env(("MXNET_TPU_WATCHDOG",))
    return [n for n in _WATCHDOG_TIMEOUTS if n in os.environ]


def _unported_fit_env():
    """The JAX fit loop's env-armed features that are set here."""
    found = ["%s (step watchdog)" % n for n in _watchdog_knobs()]
    found += ["MXNET_TPU_CHAOS=%s (training chaos drill)" % k
              for k in _chaos.armed(("hang",))]
    return found


def _as_list(obj):
    if obj is None:
        return []
    return obj if isinstance(obj, (list, tuple)) else [obj]


def _dispatch(callbacks, **fields):
    """Invoke every callback (one or a list) with a BatchEndParam."""
    if callbacks is None:
        return
    packet = BatchEndParam(**fields)
    for cb in _as_list(callbacks):
        cb(packet)


def _trim_pad(outputs, pad):
    """Drop the iterator's tail padding rows from each output."""
    return [out[0:out.shape[0] - (pad or 0)] for out in outputs]


def _as_metric(m):
    return m if isinstance(m, metric_mod.EvalMetric) else metric_mod.create(m)


def _check_input_names(symbol, names, typename, throw):
    """Validate user-declared input names against the symbol's
    arguments."""
    known = set(symbol.list_arguments())
    param_like = ("_weight", "_bias", "_gamma", "_beta")
    suggestions = [a for a in known
                   if not any(a.endswith(sfx) for sfx in param_like)]
    for missing in (n for n in names if n not in known):
        msg = ("You created Module with Module(..., %s_names=%s) but input "
               "with name '%s' is not found in symbol.list_arguments(). "
               "Did you mean one of:\n\t%s"
               % (typename, names, missing, "\n\t".join(sorted(suggestions))))
        if throw:
            raise ValueError(msg)
        logging.warning(msg)


class BaseModule:
    """The module contract plus the loops composed from it (reference
    base_module.py:66)."""

    def __init__(self, logger=logging):
        self.logger = logger
        self.binded = False
        self.for_training = False
        self.inputs_need_grad = False
        self.params_initialized = False
        self.optimizer_initialized = False
        self._symbol = None

    # -- primitives a concrete module provides ----------------------------
    def _abstract(self, what):
        raise NotImplementedError("%s does not implement %s"
                                  % (type(self).__name__, what))

    def forward(self, data_batch, is_train=None):
        self._abstract("forward")

    def backward(self, out_grads=None):
        self._abstract("backward")

    def update(self):
        self._abstract("update")

    def get_outputs(self, merge_multi_context=True):
        self._abstract("get_outputs")

    def update_metric(self, eval_metric, labels):
        self._abstract("update_metric")

    def bind(self, *args, **kwargs):
        self._abstract("bind")

    def init_params(self, *args, **kwargs):
        self._abstract("init_params")

    def init_optimizer(self, *args, **kwargs):
        self._abstract("init_optimizer")

    def get_params(self):
        self._abstract("get_params")

    def install_monitor(self, mon):
        self._abstract("install_monitor")

    def prepare(self, data_batch, sparse_row_id_fn=None):
        """Pre-forward hook (sparse modules pull rows for the batch)."""

    @property
    def symbol(self):
        return self._symbol

    # -- composed operations ----------------------------------------------
    def forward_backward(self, data_batch):
        """One train step without the update (reference
        base_module.py:189)."""
        self.forward(data_batch, is_train=True)
        self.backward()

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True, allow_extra=False):
        self.init_params(initializer=None, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init, allow_extra=allow_extra)

    def save_params(self, fname):
        """The parameters as a ``.params`` file of ``arg:``/``aux:`` keys
        (reference base_module.py:170)."""
        from ..ndarray.ndarray import save
        args, auxs = self.get_params()
        blob = {"arg:" + k: v for k, v in args.items()}
        blob.update(("aux:" + k, v) for k, v in auxs.items())
        save(fname, blob)

    def load_params(self, fname):
        """Set the parameters from a ``.params`` file (reference
        base_module.py:177)."""
        from ..ndarray.ndarray import load
        buckets = {tag: {} for tag in _PARAM_TAGS}
        for key, value in load(fname, ctx="cpu").items():
            tag, _, name = key.partition(":")
            if tag not in _PARAM_TAGS or not name:
                raise ValueError("Invalid param file " + fname)
            buckets[tag][name] = value
        self.set_params(buckets["arg"], buckets["aux"])

    # -- evaluation -------------------------------------------------------
    def score(self, eval_data, eval_metric, num_batch=None,
              batch_end_callback=None, score_end_callback=None, reset=True,
              epoch=0, sparse_row_id_fn=None):
        """Run ``eval_data`` through the net, accumulating
        ``eval_metric`` (reference base_module.py:205)."""
        if not (self.binded and self.params_initialized):
            raise RuntimeError("score needs a bound module with params")
        if reset:
            eval_data.reset()
        eval_metric = _as_metric(eval_metric)
        eval_metric.reset()
        seen = 0
        for nbatch, batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(batch, is_train=False)
            self.update_metric(eval_metric, batch.label)
            _dispatch(batch_end_callback, epoch=epoch, nbatch=nbatch,
                      eval_metric=eval_metric, locals=locals())
            seen += 1
        _dispatch(score_end_callback, epoch=epoch, nbatch=seen,
                  eval_metric=eval_metric, locals=locals())
        return eval_metric.get_name_value()

    def iter_predict(self, eval_data, num_batch=None, reset=True):
        if not (self.binded and self.params_initialized):
            raise RuntimeError("predict needs a bound module with params")
        if reset:
            eval_data.reset()
        for nbatch, batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(batch, is_train=False)
            yield (_trim_pad(self.get_outputs(), batch.pad), nbatch, batch)

    def predict(self, eval_data, num_batch=None, merge_batches=True,
                reset=True, always_output_list=False,
                sparse_row_id_fn=None):
        """Forward-only inference over an iterator (or one array)
        (reference base_module.py:303).  Merged outputs are stitched on
        the outputs' device."""
        if not (self.binded and self.params_initialized):
            raise RuntimeError("predict needs a bound module with params")
        if isinstance(eval_data, (NDArray, np.ndarray)):
            if isinstance(eval_data, np.ndarray):
                eval_data = nd_array(eval_data, ctx="cpu")
            self.forward(DataBatch([eval_data], None), is_train=False)
            return self.get_outputs()[0]
        collected = [outs for outs, _, _ in
                     self.iter_predict(eval_data, num_batch=num_batch,
                                       reset=reset)]
        if not collected or not merge_batches:
            return collected
        width = len(collected[0])
        stitched = [NDArray(torch.cat([outs[i]._handle
                                       for outs in collected]))
                    for i in range(width)]
        if width == 1 and not always_output_list:
            return stitched[0]
        return stitched

    # -- training ---------------------------------------------------------
    def _fit_setup(self, train_data, initializer, arg_params, aux_params,
                   allow_missing, force_rebind, force_init, kvstore,
                   optimizer, optimizer_params, monitor):
        """bind + init params + init optimizer, in dependency order."""
        self.bind(data_shapes=train_data.provide_data,
                  label_shapes=train_data.provide_label,
                  for_training=True, force_rebind=force_rebind)
        if monitor is not None:
            self.install_monitor(monitor)
        self.init_params(initializer=initializer, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init)
        self.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                            optimizer_params=optimizer_params)

    def _fit_epoch(self, epoch, train_data, eval_metric, monitor,
                   batch_end_callback, sparse_row_id_fn):
        """One pass over ``train_data``.  The next batch is fetched only
        after the current one has been stepped (an iterator may reuse its
        buffers) and handed to ``prepare`` before the metric update."""
        eval_metric.reset()
        nbatch = 0
        done = object()
        feed = iter(train_data)
        batch = next(feed, done)
        while batch is not done:
            self._fit_step = getattr(self, "_fit_step", 0) + 1
            with telemetry.span("train/step", cat="train",
                                metric="train.step_seconds",
                                step=self._fit_step):
                self.forward_backward(batch)
                self.update()
            telemetry.count("train.steps")
            telemetry.window_tick()
            upcoming = next(feed, done)
            if upcoming is not done:
                self.prepare(upcoming, sparse_row_id_fn=sparse_row_id_fn)
            self.update_metric(eval_metric, batch.label)
            _dispatch(batch_end_callback, epoch=epoch, nbatch=nbatch,
                      eval_metric=eval_metric, locals=locals())
            nbatch += 1
            batch = upcoming

    def fit(self, train_data, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None,
            kvstore="local", optimizer="sgd",
            optimizer_params=(("learning_rate", 0.01),),
            eval_end_callback=None, eval_batch_end_callback=None,
            initializer=None, arg_params=None,
            aux_params=None, allow_missing=False, force_rebind=False,
            force_init=False, begin_epoch=0, num_epoch=None,
            validation_metric=None, monitor=None, sparse_row_id_fn=None):
        """Train for ``num_epoch`` epochs (reference
        base_module.py:376-465)."""
        if num_epoch is None:
            raise ValueError("fit() needs num_epoch")
        found = _unported_fit_env()
        if found:
            raise NotPortedYet("not ported to Module.fit: %s"
                               % ", ".join(found))
        if monitor is not None:
            raise NotPortedYet("fit(monitor=): executor monitors are not "
                               "ported yet (ROADMAP queue A item 9, "
                               "observability)")
        if initializer is None:
            from ..initializer import Uniform
            initializer = Uniform(0.01)
        self._fit_setup(train_data, initializer, arg_params, aux_params,
                        allow_missing, force_rebind, force_init, kvstore,
                        optimizer, optimizer_params, monitor)
        validation_metric = validation_metric or eval_metric
        eval_metric = _as_metric(eval_metric)
        for epoch in range(begin_epoch, num_epoch):
            with telemetry.span("train/epoch", cat="train", timed=True,
                                metric="train.epoch_seconds",
                                epoch=epoch) as ep:
                self._fit_epoch(epoch, train_data, eval_metric, monitor,
                                batch_end_callback, sparse_row_id_fn)
            for name, val in eval_metric.get_name_value():
                self.logger.info("Epoch[%d] Train-%s=%f", epoch, name, val)
            self.logger.info("Epoch[%d] Time cost=%.3f", epoch, ep.duration)
            # re-sync the module's host params (the store may hold newer)
            snapshot = self.get_params()
            self.set_params(*snapshot)
            for cb in _as_list(epoch_end_callback):
                cb(epoch, self.symbol, *snapshot)
            if eval_data:
                scored = self.score(eval_data, validation_metric,
                                    score_end_callback=eval_end_callback,
                                    batch_end_callback=eval_batch_end_callback,
                                    epoch=epoch)
                for name, val in scored:
                    self.logger.info("Epoch[%d] Validation-%s=%f",
                                     epoch, name, val)
            train_data.reset()
