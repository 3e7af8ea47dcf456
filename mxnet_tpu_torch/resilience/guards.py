"""Non-finite gradient guard and dynamic loss scaling (port of the
trainer half of ``mxnet_tpu/resilience/guards.py``).

:func:`all_finite` reduces ``isfinite`` over the loss and every gradient
on the device; :func:`scale_update` is the loss-scale automaton (grow
after N consecutive good steps, halve on a bad one), also on the device.
The JAX package traces both into its compiled step; here the trainer's
step runs them eagerly without reading the verdict on the host (its
caller reads it once, for the non-finite budget).  The host-side
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
    """One transition of the loss-scale automaton, on the device (no host
    sync): ``scale`` f32 and ``good`` int32 0-d tensors, ``ok`` the 0-d
    bool verdict of :func:`all_finite` (host scalars are taken as 0-d
    tensors).

    Good step: ``good + 1``, doubling ``scale`` (capped at MAX_SCALE) and
    resetting the streak once it reaches ``growth_interval``.  Bad step:
    halve ``scale`` (floored at MIN_SCALE), streak to 0.  With
    ``dynamic=False`` the scale is constant and only the streak moves.
    Returns ``(scale, good)`` as new tensors."""
    import torch
    scale = torch.as_tensor(scale, dtype=torch.float32)
    good = torch.as_tensor(good, dtype=torch.int32, device=scale.device)
    ok = torch.as_tensor(ok, device=scale.device)
    good2 = torch.where(ok, good + 1, torch.zeros_like(good))
    if not dynamic:
        return scale.clone(), good2
    grow = ok & (good2 >= growth_interval)
    scale2 = torch.where(
        ok, torch.where(grow, (scale * GROWTH_FACTOR).clamp(max=MAX_SCALE),
                        scale),
        (scale * BACKOFF_FACTOR).clamp(min=MIN_SCALE))
    good2 = torch.where(grow, torch.zeros_like(good2), good2)
    return scale2, good2
