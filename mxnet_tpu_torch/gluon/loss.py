"""Gluon loss blocks (port of ``mxnet_tpu/gluon/loss.py``, unchanged over
the port's ops; ``CTCLoss`` runs the port's CTC op).

Capability parity with the reference's gluon losses
(python/mxnet/gluon/loss.py) with a different organisation: the base
``Loss`` owns the whole pipeline — align label shape, compute a
pointwise penalty, apply weight/sample_weight, reduce over the
non-batch axes — and each concrete loss only supplies its pointwise
term via ``_penalty``.  Losses with non-elementwise structure (CTC,
Triplet) override ``hybrid_forward`` wholesale.
"""
from __future__ import annotations

from .block import HybridBlock

__all__ = ["Loss", "L2Loss", "L1Loss", "SigmoidBinaryCrossEntropyLoss",
           "SigmoidBCELoss", "SoftmaxCrossEntropyLoss", "SoftmaxCELoss",
           "KLDivLoss", "CTCLoss", "HuberLoss", "HingeLoss",
           "SquaredHingeLoss", "LogisticLoss", "TripletLoss"]


def _stable_bce(F, z, target):
    """-log sigmoid(z)*t - log(1-sigmoid(z))*(1-t), overflow-safe.

    Uses the max(z,0) - z*t + log1p(exp(-|z|)) identity (softrelu of
    -|z| is exactly that log1p term).
    """
    return F.relu(z) - z * target + F.Activation(-F.abs(z),
                                                 act_type="softrelu")


class Loss(HybridBlock):
    """Base class: pointwise penalty -> weighting -> per-sample mean.

    ``weight`` is a global scalar multiplier; ``batch_axis`` is the axis
    kept by the reduction (per-sample losses come out, Gluon convention).
    Subclasses implement ``_penalty(F, pred, label)``; set
    ``ALIGN_LABEL = False`` to skip reshaping label to pred's shape.
    """

    ALIGN_LABEL = True

    def __init__(self, weight, batch_axis, **kwargs):
        super().__init__(**kwargs)
        self._weight = weight
        self._batch_axis = batch_axis

    def __repr__(self):
        return "%s(batch_axis=%s, w=%s)" % (
            type(self).__name__, self._batch_axis, self._weight)

    # pipeline stages ---------------------------------------------------

    def _scaled(self, F, loss, sample_weight, weight=None):
        """Apply per-element sample_weight then the global scalar weight."""
        if sample_weight is not None:
            loss = F.broadcast_mul(loss, sample_weight)
        w = self._weight if weight is None else weight
        if w is not None:
            if not isinstance(w, (int, float)):
                raise TypeError("loss weight must be a scalar, got %r" % (w,))
            loss = loss * w
        return loss

    def _per_sample(self, F, loss):
        return F.mean(loss, axis=self._batch_axis, exclude=True)

    def _penalty(self, F, pred, label):
        raise NotImplementedError

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        if self.ALIGN_LABEL:
            label = F.reshape(label, pred.shape)
        loss = self._penalty(F, pred, label)
        return self._per_sample(F, self._scaled(F, loss, sample_weight))


class L2Loss(Loss):
    """0.5 * weight * (pred - label)^2, averaged per sample."""

    def __init__(self, weight=1., batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)

    def _scaled(self, F, loss, sample_weight, weight=None):
        return super()._scaled(F, loss, sample_weight, self._weight / 2)

    def _penalty(self, F, pred, label):
        return F.square(pred - label)


class L1Loss(Loss):
    """|pred - label|, averaged per sample."""

    def __init__(self, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)

    def _penalty(self, F, pred, label):
        return F.abs(pred - label)


class SigmoidBinaryCrossEntropyLoss(Loss):
    """BCE on logits (default) or on probabilities (from_sigmoid=True)."""

    def __init__(self, from_sigmoid=False, weight=None, batch_axis=0,
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_sigmoid = from_sigmoid

    def _penalty(self, F, pred, label):
        if self._from_sigmoid:
            eps = 1e-12
            return -(label * F.log(pred + eps)
                     + (1. - label) * F.log(1. - pred + eps))
        return _stable_bce(F, pred, label)


SigmoidBCELoss = SigmoidBinaryCrossEntropyLoss


class SoftmaxCrossEntropyLoss(Loss):
    """Cross entropy over ``axis``; sparse (index) or dense labels."""

    ALIGN_LABEL = False

    def __init__(self, axis=-1, sparse_label=True, from_logits=False,
                 weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._axis = axis
        self._sparse_label = sparse_label
        self._from_logits = from_logits

    def _penalty(self, F, pred, label):
        logp = pred if self._from_logits else F.log_softmax(pred,
                                                            axis=self._axis)
        if self._sparse_label:
            return -F.pick(logp, label, axis=self._axis, keepdims=True)
        label = F.reshape(label, logp.shape)
        return -F.sum(logp * label, axis=self._axis, keepdims=True)


SoftmaxCELoss = SoftmaxCrossEntropyLoss


class KLDivLoss(Loss):
    """label * (log label - log pred); pred is log-prob if from_logits."""

    ALIGN_LABEL = False

    def __init__(self, from_logits=True, axis=-1, weight=None, batch_axis=0,
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_logits = from_logits
        self._axis = axis

    def _penalty(self, F, pred, label):
        logp = pred if self._from_logits else F.log_softmax(pred, self._axis)
        return label * (F.log(label + 1e-12) - logp)


class HuberLoss(Loss):
    """Quadratic inside rho, linear outside (smoothed L1)."""

    def __init__(self, rho=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._rho = rho

    def _penalty(self, F, pred, label):
        err = F.abs(pred - label)
        quad = F.square(err) * (0.5 / self._rho)
        lin = err - 0.5 * self._rho
        return F.where(err > self._rho, lin, quad)


class HingeLoss(Loss):
    """max(0, margin - pred*label) for signed labels."""

    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def _penalty(self, F, pred, label):
        return F.relu(self._margin - pred * label)


class SquaredHingeLoss(HingeLoss):
    """Hinge penalty, squared."""

    def _penalty(self, F, pred, label):
        return F.square(super()._penalty(F, pred, label))


class LogisticLoss(Loss):
    """BCE over {-1,1} ("signed") or {0,1} ("binary") labels."""

    def __init__(self, weight=None, batch_axis=0, label_format="signed",
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        if label_format not in ("signed", "binary"):
            raise ValueError("label_format must be 'signed' or 'binary', "
                             "got %s" % label_format)
        self._label_format = label_format

    def _penalty(self, F, pred, label):
        if self._label_format == "signed":
            label = (label + 1.0) / 2.0     # map {-1,1} -> {0,1}
        return _stable_bce(F, pred, label)


class CTCLoss(Loss):
    """Connectionist temporal classification (wraps the CTCLoss op).

    ``layout``/``label_layout`` follow the reference convention; the op
    itself consumes TNC + NT, so axes are swapped on the way in.
    """

    def __init__(self, layout="NTC", label_layout="NT", weight=None,
                 **kwargs):
        if layout not in ("NTC", "TNC"):
            raise ValueError("layout must be NTC or TNC, got %s" % layout)
        if label_layout not in ("NT", "TN"):
            raise ValueError("label_layout must be NT or TN, got %s"
                             % label_layout)
        self._layout = layout
        self._label_layout = label_layout
        super().__init__(weight, label_layout.find("N"), **kwargs)

    def hybrid_forward(self, F, pred, label, pred_lengths=None,
                       label_lengths=None, sample_weight=None):
        if self._layout == "NTC":
            pred = F.swapaxes(pred, dim1=0, dim2=1)
        if self._label_layout == "TN":
            label = F.swapaxes(label, dim1=0, dim2=1)
        return self._scaled(F, F.CTCLoss(pred, label), sample_weight)


class TripletLoss(Loss):
    """max(0, margin + d(pred, positive) - d(pred, negative))."""

    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def hybrid_forward(self, F, pred, positive, negative):
        positive = F.reshape(positive, pred.shape)
        negative = F.reshape(negative, pred.shape)
        gap = F.square(pred - positive) - F.square(pred - negative)
        loss = F.relu(F.sum(gap, axis=self._batch_axis, exclude=True)
                      + self._margin)
        return self._scaled(F, loss, None)
