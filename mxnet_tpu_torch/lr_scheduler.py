"""Learning-rate schedules (port of ``mxnet_tpu/lr_scheduler.py``, whole;
reference python/mxnet/lr_scheduler.py).

Every class computes ``lr(t)`` directly from the global update count
``t`` instead of mutating an internal learning rate as calls arrive, as
the JAX package's do: a pure ``lr(t)`` can be re-evaluated after a
checkpoint resume at any ``t`` without replaying the call history, and
``base_lr`` stays what the user set (the optimizer sets it to its
``learning_rate``).  Class and keyword names and the decay boundaries are
the reference's; ``CosineScheduler`` and ``WarmupScheduler`` are the JAX
package's additions.  The optimizer calls the schedule with its
``num_update`` (:meth:`mxnet_tpu_torch.optimizer.Optimizer._get_lr`).
"""
from __future__ import annotations

import bisect
import logging
import math

__all__ = ["LRScheduler", "FactorScheduler", "MultiFactorScheduler",
           "PolyScheduler", "CosineScheduler", "WarmupScheduler"]


class LRScheduler:
    """Base: callable mapping update count -> learning rate."""

    # discrete schedules announce decay events; continuous ones (poly,
    # cosine, warmup ramps) change every update and stay quiet
    _announce_changes = False

    def __init__(self, base_lr=0.01):
        self.base_lr = base_lr
        self._announced = None   # last lr logged, to report changes once

    def _rate(self, t):
        raise NotImplementedError()

    def __call__(self, num_update):
        lr = self._rate(int(num_update))
        if self._announce_changes and self._announced is not None \
                and lr != self._announced:
            logging.info("Update[%d]: learning rate is now %0.5e",
                         num_update, lr)
        self._announced = lr
        return lr


def _check_decay_factor(factor):
    if factor > 1.0:
        raise ValueError("decay factor %g would grow the learning rate; "
                         "it must be <= 1" % factor)


class FactorScheduler(LRScheduler):
    """Geometric decay: ``lr(t) = base_lr * factor**floor((t-1)/step)``,
    floored at `stop_factor_lr`.  Boundary matches the reference
    FactorScheduler: the k-th decay lands at update ``k*step + 1``."""

    _announce_changes = True

    def __init__(self, step, factor=1, stop_factor_lr=1e-8):
        super().__init__()
        if step < 1:
            raise ValueError("step must be a positive update count")
        _check_decay_factor(factor)
        self.step = step
        self.factor = factor
        self.stop_factor_lr = stop_factor_lr

    def _rate(self, t):
        n_decays = max(0, t - 1) // self.step
        return max(self.base_lr * self.factor ** n_decays,
                   self.stop_factor_lr)


class MultiFactorScheduler(LRScheduler):
    """Decay by `factor` as `t` passes each boundary in the sorted list
    `step` (reference MultiFactorScheduler boundaries: decay k applies
    for ``t > step[k-1]``)."""

    _announce_changes = True

    def __init__(self, step, factor=1):
        super().__init__()
        if not isinstance(step, list) or not step:
            raise ValueError("step must be a non-empty list of boundaries")
        if any(s < 1 for s in step):
            raise ValueError("boundaries must be positive update counts")
        if any(b <= a for a, b in zip(step, step[1:])):
            raise ValueError("boundaries must be strictly increasing")
        _check_decay_factor(factor)
        self.step = step
        self.factor = factor

    def _rate(self, t):
        # number of boundaries strictly below t  ==  decays applied
        n_decays = bisect.bisect_left(self.step, t)
        return self.base_lr * self.factor ** n_decays


class PolyScheduler(LRScheduler):
    """``lr(t) = base_lr * (1 - t/max_update)**pwr`` until `max_update`,
    then 0 (reference PolyScheduler)."""

    def __init__(self, max_update, base_lr=0.01, pwr=2):
        super().__init__(base_lr)
        if not isinstance(max_update, int) or max_update < 1:
            raise ValueError("max_update must be a positive int")
        self.max_update = max_update
        self.power = pwr

    def _rate(self, t):
        frac = min(t, self.max_update) / float(self.max_update)
        return self.base_lr * (1.0 - frac) ** self.power


class CosineScheduler(LRScheduler):
    """Half-cosine from `base_lr` down to `final_lr` over `max_update`
    steps (beyond-reference; the standard TPU recipe)."""

    def __init__(self, max_update, base_lr=0.01, final_lr=0.0):
        super().__init__(base_lr)
        self.max_update = max_update
        self.final_lr = final_lr

    def _rate(self, t):
        frac = min(t, self.max_update) / float(self.max_update)
        blend = 0.5 * (1.0 + math.cos(math.pi * frac))
        return self.final_lr + (self.base_lr - self.final_lr) * blend


class WarmupScheduler(LRScheduler):
    """Linear ramp over `warmup_steps` updates into a wrapped schedule,
    whose clock starts when the ramp ends (beyond-reference)."""

    def __init__(self, warmup_steps, scheduler: LRScheduler):
        super().__init__(scheduler.base_lr)
        self.warmup_steps = warmup_steps
        self.scheduler = scheduler

    def _rate(self, t):
        if t < self.warmup_steps:
            return self.scheduler.base_lr * t / max(1, self.warmup_steps)
        return self.scheduler(t - self.warmup_steps)
