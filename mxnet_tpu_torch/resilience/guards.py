"""Non-finite gradient guard and dynamic loss scaling (port of the
trainer half of ``mxnet_tpu/resilience/guards.py``).

:func:`all_finite` reduces ``isfinite`` over the loss and every gradient
on the device; :func:`scale_update` is the loss-scale automaton (grow
after N consecutive good steps, halve on a bad one).  The JAX package
traces both into its compiled step; here the step reads the verdict once
on the host and applies the automaton there.  The host-side
``GradientGuard`` of the imperative Module/gluon paths waits for those
slices (ROADMAP).
"""
from __future__ import annotations

import os

from ..base import MXNetError

__all__ = ["NonFiniteError", "all_finite", "scale_update",
           "default_budget", "GROWTH_FACTOR", "BACKOFF_FACTOR", "MIN_SCALE",
           "MAX_SCALE"]

GROWTH_FACTOR = 2.0
BACKOFF_FACTOR = 0.5
MIN_SCALE = 1.0
MAX_SCALE = float(2 ** 24)


def default_budget() -> int:
    """Consecutive non-finite steps tolerated before aborting
    (``MXNET_TPU_NONFINITE_BUDGET``, default 20)."""
    return int(os.environ.get("MXNET_TPU_NONFINITE_BUDGET", "20"))


class NonFiniteError(MXNetError):
    """Training aborted: the non-finite step budget was exhausted."""

    def __init__(self, message, diagnostics=None):
        super().__init__(message)
        self.diagnostics = dict(diagnostics or {})


def all_finite(loss, grads):
    """0-d bool tensor on the loss's device: the loss and every gradient
    are finite (no host sync)."""
    import torch
    flags = [torch.isfinite(loss).all()]
    flags += [torch.isfinite(g).all() for g in grads]
    return torch.stack(flags).all()


def scale_update(scale, good, ok, growth_interval, dynamic=True):
    """One transition of the loss-scale automaton on host scalars.

    Good step: ``good + 1``, doubling ``scale`` (capped at MAX_SCALE) and
    resetting the streak once it reaches ``growth_interval``.  Bad step:
    halve ``scale`` (floored at MIN_SCALE), streak to 0.  With
    ``dynamic=False`` the scale is constant and only the streak moves.
    Returns ``(scale, good)``."""
    good2 = good + 1 if ok else 0
    if not dynamic:
        return scale, good2
    if not ok:
        return max(scale * BACKOFF_FACTOR, MIN_SCALE), good2
    if good2 >= growth_interval:
        return min(scale * GROWTH_FACTOR, MAX_SCALE), 0
    return scale, good2
