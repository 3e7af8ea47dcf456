"""Evaluation metrics (port of ``mxnet_tpu/metric.py``; reference
python/mxnet/metric.py).

The values are the JAX package's.  Where it walks each (label, pred) pair
as numpy, Accuracy, TopKAccuracy, Perplexity and CrossEntropy (with
NegativeLogLikelihood) run the sums on the prediction's device and read
one scalar back per pair: the LM's per-token prediction is (N*T, vocab),
a gigabyte at the bench geometry, which must not cross to the host every
step.  F1, the regression family (MAE, MSE, RMSE), PearsonCorrelation,
Loss (Torch, Caffe) and CustomMetric (``metric.np``, and a callable given
to :func:`create`) take their pairs to the host and compute as the JAX
package does, in numpy.  The running state is the usual ``(sum_metric,
num_inst)`` pair on the host; ``get_config`` gives a metric's class,
name and arguments.
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as _numpy
import torch

from .ndarray.ndarray import NDArray

__all__ = ["EvalMetric", "CompositeEvalMetric", "Accuracy", "TopKAccuracy",
           "F1", "Perplexity", "MAE", "MSE", "RMSE", "CrossEntropy",
           "NegativeLogLikelihood", "PearsonCorrelation", "Loss", "Torch",
           "Caffe", "CustomMetric", "np", "create", "register",
           "check_label_shapes"]

_METRIC_REGISTRY: Dict[str, type] = {}


def register(klass, *aliases):
    """Register under the class name plus any aliases."""
    for key in (klass.__name__,) + aliases:
        _METRIC_REGISTRY[key.lower()] = klass
    return klass


def _registered(*aliases):
    return lambda klass: register(klass, *aliases)


def create(metric, *args, **kwargs):
    """Coerce a name, a callable ``feval(label, pred)``, a list of them or
    an EvalMetric into an EvalMetric."""
    if isinstance(metric, EvalMetric):
        return metric
    if callable(metric):
        return CustomMetric(metric, *args, **kwargs)
    if isinstance(metric, (list, tuple)):
        bundle = CompositeEvalMetric()
        for entry in metric:
            bundle.add(create(entry, *args, **kwargs))
        return bundle
    key = metric.lower() if isinstance(metric, str) else None
    if key in _METRIC_REGISTRY:
        return _METRIC_REGISTRY[key](*args, **kwargs)
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
        t = torch.from_numpy(_numpy.asarray(x))
    return t if device is None else t.to(device, non_blocking=True)


def _as_np(x):
    """An NDArray, tensor or array-like as a host numpy array."""
    if isinstance(x, NDArray):
        return x.asnumpy()
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return _numpy.asarray(x)


class EvalMetric:
    """Named running statistic with (sum, count) state (reference
    metric.py:44).  ``output_names`` / ``label_names`` select tensors
    when fed through :meth:`update_dict`; the keyword arguments are what
    :meth:`get_config` reports."""

    def __init__(self, name, output_names=None, label_names=None,
                 **kwargs):
        self.name = str(name)
        self.output_names = output_names
        self.label_names = label_names
        self._kwargs = kwargs
        self.reset()

    def __str__(self):
        return "EvalMetric: %s" % dict(self.get_name_value())

    def get_config(self):
        """The metric's class name, name, output and label names and
        constructor arguments (reference metric.py:86)."""
        return dict(self._kwargs, metric=type(self).__name__,
                    name=self.name, output_names=self.output_names,
                    label_names=self.label_names)

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
        super().__init__(name, output_names, label_names, axis=axis)
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
        super().__init__(name, output_names, label_names, top_k=top_k)
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
        super().__init__(name, output_names, label_names,
                         ignore_label=ignore_label, axis=axis)
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
        super().__init__(name, output_names, label_names, eps=eps)
        self.eps = eps

    def _accumulate(self, label, pred):
        idx = label.reshape(-1).long()
        if idx.shape[0] != pred.shape[0]:
            raise ValueError("%d labels for %d predictions"
                             % (idx.shape[0], pred.shape[0]))
        true_prob = pred.gather(1, idx[:, None])[:, 0]
        return (float(-torch.log(true_prob + self.eps).double().sum()),
                idx.shape[0])


@_registered("nll_loss")
class NegativeLogLikelihood(CrossEntropy):
    def __init__(self, eps=1e-12, name="nll-loss", output_names=None,
                 label_names=None):
        super().__init__(eps=eps, name=name, output_names=output_names,
                         label_names=label_names)


class _HostPairwiseMetric(EvalMetric):
    """Walks (label, pred) pairs as host numpy arrays, as the JAX
    package's pairwise metrics do."""

    def _accumulate(self, label, pred):
        raise NotImplementedError

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            score, count = self._accumulate(_as_np(label), _as_np(pred))
            self.sum_metric += score
            self.num_inst += count


@register
class F1(_HostPairwiseMetric):
    """Binary F1 of the argmax predictions, averaged over the updates
    (reference metric.py:479)."""

    def __init__(self, name="f1", output_names=None, label_names=None,
                 average="macro"):
        self.average = average
        super().__init__(name, output_names, label_names)

    def _accumulate(self, label, pred):
        label = label.astype("int32")
        if label.max() > 1:
            raise ValueError("F1 currently only supports binary "
                             "classification.")
        decided = _numpy.argmax(pred, axis=1)
        tp = int(((decided == 1) & (label == 1)).sum())
        fp = int(((decided == 1) & (label == 0)).sum())
        fn = int(((decided == 0) & (label == 1)).sum())
        precision = tp / (tp + fp) if tp + fp else 0.0
        recall = tp / (tp + fn) if tp + fn else 0.0
        f1 = (2 * precision * recall / (precision + recall)
              if precision + recall else 0.0)
        return f1, 1


class _RegressionMetric(_HostPairwiseMetric):
    """Elementwise residuals of column-aligned labels and predictions,
    one score per update."""

    def _score(self, err):
        raise NotImplementedError

    def _accumulate(self, label, pred):
        if label.ndim == 1:
            label = label[:, None]
        if pred.ndim == 1:
            pred = pred[:, None]
        return self._score(label - pred), 1


@register
class MAE(_RegressionMetric):
    def __init__(self, name="mae", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def _score(self, err):
        return _numpy.abs(err).mean()


@register
class MSE(_RegressionMetric):
    def __init__(self, name="mse", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def _score(self, err):
        return (err ** 2.0).mean()


@register
class RMSE(_RegressionMetric):
    def __init__(self, name="rmse", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def _score(self, err):
        return _numpy.sqrt((err ** 2.0).mean())


@_registered("pearsonr")
class PearsonCorrelation(_HostPairwiseMetric):
    def __init__(self, name="pearsonr", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def _accumulate(self, label, pred):
        return _numpy.corrcoef(pred.ravel(), label.ravel())[0, 1], 1


@register
class Loss(EvalMetric):
    """Mean of the outputs (for symbols whose outputs are losses); the
    labels are ignored."""

    def __init__(self, name="loss", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, _, preds):
        for pred in preds:
            host = _as_np(pred)
            self.sum_metric += host.sum()
            self.num_inst += host.size


@register
class Torch(Loss):
    def __init__(self, name="torch", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)


@register
class Caffe(Loss):
    def __init__(self, name="caffe", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)


@register
class CustomMetric(EvalMetric):
    """A user's ``feval(label, pred)`` of host numpy arrays, returning a
    score or ``(score_sum, count)``."""

    def __init__(self, feval, name=None, allow_extra_outputs=False,
                 output_names=None, label_names=None):
        if name is None:
            name = feval.__name__
            if "<" in name:
                name = "custom(%s)" % name
        super().__init__(name, output_names, label_names, feval=feval,
                         allow_extra_outputs=allow_extra_outputs)
        self._feval = feval
        self._allow_extra_outputs = allow_extra_outputs

    def update(self, labels, preds):
        if not self._allow_extra_outputs:
            check_label_shapes(labels, preds)
        for pred, label in zip(preds, labels):
            verdict = self._feval(_as_np(label), _as_np(pred))
            if isinstance(verdict, tuple):
                score, count = verdict
            else:
                score, count = verdict, 1
            self.sum_metric += score
            self.num_inst += count


def np(numpy_feval, name=None, allow_extra_outputs=False):
    """A CustomMetric over a plain numpy function (reference
    ``metric.np``)."""

    def feval(label, pred):
        return numpy_feval(label, pred)

    feval.__name__ = name if name is not None else numpy_feval.__name__
    return CustomMetric(feval, name, allow_extra_outputs)
