"""Evaluation metrics (port of ``EvalMetric``, ``create``,
``CompositeEvalMetric``, ``Accuracy``, ``TopKAccuracy``, ``Perplexity``
and ``CrossEntropy`` from ``mxnet_tpu/metric.py``; reference
python/mxnet/metric.py).

The values are the JAX package's; where it walks each (label, pred) pair
as numpy, these run the sums on the prediction's device and read one
scalar back per pair: the LM's per-token prediction is (N*T, vocab), a
gigabyte at the bench geometry, which must not cross to the host every
step.  The running state is the usual ``(sum_metric, num_inst)`` pair on
the host.

The JAX package's other metrics (F1, the regression family, Pearson,
Loss, custom callables) raise :class:`~mxnet_tpu_torch.base.NotPortedYet`
from :func:`create` (ROADMAP queue A item 2).
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from .base import NotPortedYet
from .ndarray.ndarray import NDArray

__all__ = ["EvalMetric", "CompositeEvalMetric", "Accuracy", "TopKAccuracy",
           "Perplexity", "CrossEntropy", "create", "register",
           "check_label_shapes"]

_METRIC_REGISTRY: Dict[str, type] = {}
# metric names of the JAX package that a later slice ports (ROADMAP queue
# A item 2)
_NOT_PORTED = ("f1", "mae",
               "mse", "rmse", "negativeloglikelihood", "nll_loss",
               "pearsoncorrelation", "pearsonr", "loss", "torch", "caffe",
               "custommetric")


def register(klass, *aliases):
    """Register under the class name plus any aliases."""
    for key in (klass.__name__,) + aliases:
        _METRIC_REGISTRY[key.lower()] = klass
    return klass


def _registered(*aliases):
    return lambda klass: register(klass, *aliases)


def create(metric, *args, **kwargs):
    """Coerce a name, a list of them or an EvalMetric into an
    EvalMetric."""
    if isinstance(metric, EvalMetric):
        return metric
    if callable(metric):
        raise NotPortedYet("custom metric callables are not ported yet "
                           "(ROADMAP queue A item 2)")
    if isinstance(metric, (list, tuple)):
        bundle = CompositeEvalMetric()
        for entry in metric:
            bundle.add(create(entry, *args, **kwargs))
        return bundle
    key = metric.lower() if isinstance(metric, str) else None
    if key in _METRIC_REGISTRY:
        return _METRIC_REGISTRY[key](*args, **kwargs)
    if key in _NOT_PORTED:
        raise NotPortedYet("metric %r is not ported yet (ROADMAP queue A "
                           "item 2)" % metric)
    raise ValueError("Metric must be callable/str/EvalMetric, got %s"
                     % (metric,))


def check_label_shapes(labels, preds, shape=False):
    measure = (lambda x: tuple(x.shape)) if shape else len
    if measure(labels) != measure(preds):
        raise ValueError("Shape of labels %s does not match shape of "
                         "predictions %s" % (measure(labels), measure(preds)))


def _tensor(x, device=None):
    """An NDArray, tensor or array-like as a tensor (on ``device``)."""
    if isinstance(x, NDArray):
        t = x._handle
    elif isinstance(x, torch.Tensor):
        t = x
    else:
        t = torch.from_numpy(np.asarray(x))
    return t if device is None else t.to(device, non_blocking=True)


class EvalMetric:
    """Named running statistic with (sum, count) state (reference
    metric.py:44).  ``output_names`` / ``label_names`` select tensors
    when fed through :meth:`update_dict`."""

    def __init__(self, name, output_names=None, label_names=None):
        self.name = str(name)
        self.output_names = output_names
        self.label_names = label_names
        self.reset()

    def __str__(self):
        return "EvalMetric: %s" % dict(self.get_name_value())

    @staticmethod
    def _select(table, wanted):
        return list(table.values()) if wanted is None \
            else [table[n] for n in wanted]

    def update_dict(self, label: Dict, pred: Dict):
        self.update(self._select(label, self.label_names),
                    self._select(pred, self.output_names))

    def update(self, labels, preds):
        raise NotImplementedError

    def reset(self):
        self.num_inst = 0
        self.sum_metric = 0.0

    def get(self):
        if not self.num_inst:
            return (self.name, float("nan"))
        return (self.name, self.sum_metric / self.num_inst)

    def get_name_value(self):
        name, value = self.get()
        names = name if isinstance(name, list) else [name]
        values = value if isinstance(value, list) else [value]
        return list(zip(names, values))


class _PairwiseMetric(EvalMetric):
    """Walks (label, pred) pairs; subclasses fill ``_accumulate`` with
    tensors on the prediction's device."""

    def _accumulate(self, label, pred):
        """(score_sum, instance_count) for one pair."""
        raise NotImplementedError

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            pred = _tensor(pred)
            score, count = self._accumulate(_tensor(label, pred.device),
                                            pred)
            self.sum_metric += score
            self.num_inst += count


@register
class CompositeEvalMetric(EvalMetric):
    """Fan updates out to child metrics; report all their values."""

    def __init__(self, metrics=None, name="composite",
                 output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)
        self.metrics = [create(m) for m in (metrics or [])]

    def add(self, metric):
        self.metrics.append(create(metric))

    def get_metric(self, index):
        return self.metrics[index]

    def update_dict(self, labels, preds):
        for child in self.metrics:
            child.update_dict(labels, preds)

    def update(self, labels, preds):
        for child in self.metrics:
            child.update(labels, preds)

    def reset(self):
        for child in getattr(self, "metrics", []):
            child.reset()

    def get(self):
        names, values = [], []
        for child in self.metrics:
            name, value = child.get()
            names.extend([name] if isinstance(name, str) else name)
            values.extend(value if isinstance(value, (list, tuple))
                          else [value])
        return (names, values)


@_registered("acc")
class Accuracy(_PairwiseMetric):
    """Fraction of argmax predictions equal to the label (reference
    metric.py:339)."""

    def __init__(self, axis=1, name="accuracy", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names)
        self.axis = axis

    def _accumulate(self, label, pred):
        if pred.dim() > label.dim():
            pred = pred.argmax(dim=self.axis)
        label = label.to(torch.int32).reshape(-1)
        decided = pred.to(torch.int32).reshape(-1)
        check_label_shapes(label, decided, shape=True)
        return int((decided == label).sum().item()), label.numel()


@_registered("top_k_accuracy", "top_k_acc")
class TopKAccuracy(_PairwiseMetric):
    """The label among the ``top_k`` highest-scoring classes (reference
    metric.py:405).  Where classes tie at the k-th score, which of them
    count is ``torch.topk``'s choice (the JAX package's is numpy's
    ``argpartition``'s)."""

    def __init__(self, top_k=1, name="top_k_accuracy", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names)
        if top_k <= 1:
            raise ValueError("Use Accuracy for top_k=1")
        self.top_k = top_k
        self.name = "%s_%d" % (self.name, top_k)

    def _accumulate(self, label, pred):
        if pred.dim() != 2:
            raise ValueError("Predictions should be 2 dims")
        label = label.to(torch.int32).reshape(-1)
        leaders = pred.float().topk(self.top_k, dim=1).indices
        hits = (leaders == label[:, None]).any(dim=1).sum()
        return int(hits.item()), label.numel()


@register
class Perplexity(EvalMetric):
    """exp(mean negative log prob of the true token) (reference
    metric.py:574).  ``ignore_label`` positions count neither toward the
    loss nor the token count."""

    def __init__(self, ignore_label=None, axis=-1, name="perplexity",
                 output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)
        self.ignore_label = ignore_label
        self.axis = axis

    def update(self, labels, preds):
        if len(labels) != len(preds):
            raise ValueError("%d labels for %d predictions"
                             % (len(labels), len(preds)))
        for label, pred in zip(labels, preds):
            pred = _tensor(pred)
            vocab = pred.shape[-1]
            tokens = _tensor(label, pred.device).reshape(-1).long()
            if tokens.numel() != pred.numel() // vocab:
                raise ValueError("%d labels for %d predicted rows"
                                 % (tokens.numel(), pred.numel() // vocab))
            true_prob = pred.reshape(-1, vocab).gather(
                1, tokens[:, None])[:, 0]
            masked = torch.zeros((), device=pred.device)
            if self.ignore_label is not None:
                drop = tokens == self.ignore_label
                true_prob = torch.where(drop, torch.ones_like(true_prob),
                                        true_prob)
                masked = drop.sum()
            logsum = torch.log(true_prob.clamp_min(1e-10)).double().sum()
            logsum, n_masked = torch.stack(
                [logsum, masked.double()]).tolist()
            self.sum_metric -= logsum
            self.num_inst += tokens.numel() - int(n_masked)

    def get(self):
        if not self.num_inst:
            return (self.name, float("nan"))
        return (self.name, math.exp(self.sum_metric / self.num_inst))


@_registered("ce")
class CrossEntropy(_PairwiseMetric):
    """Mean -log p(true class) for probability predictions."""

    def __init__(self, eps=1e-12, name="cross-entropy", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names)
        self.eps = eps

    def _accumulate(self, label, pred):
        idx = label.reshape(-1).long()
        if idx.shape[0] != pred.shape[0]:
            raise ValueError("%d labels for %d predictions"
                             % (idx.shape[0], pred.shape[0]))
        true_prob = pred.gather(1, idx[:, None])[:, 0]
        return (float(-torch.log(true_prob + self.eps).double().sum()),
                idx.shape[0])
