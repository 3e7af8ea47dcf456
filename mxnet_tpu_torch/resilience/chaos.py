"""Chaos harness: deterministic fault injection for the serving drills.

Port of the serving half of ``mxnet_tpu/resilience/chaos.py``: the hooks
the decode step calls inside its dispatch region, with the same fault
names, the same ``MXNET_TPU_CHAOS`` grammar and the same parameters, so a
drill written for the JAX package arms the same faults here.

* ``exec_error``    — the executor call raises ``RuntimeError``.
* ``slow_exec``     — the executor call sleeps (``seconds`` param or
  ``MXNET_TPU_CHAOS_SLOW_EXEC_SECONDS``, default 0.5).
* ``replica_crash`` — the process SIGKILLs itself mid-batch.
* ``hedge_lag``     — the executor sleeps on every firing (``seconds`` or
  ``MXNET_TPU_CHAOS_HEDGE_LAG_SECONDS``, default 0.3).
* ``bad_swap``      — consumed by the runtime's swap canary via
  :func:`fire`.

* ``io_error``      — an IO read raises ``OSError`` (the data-IO
  iterators' record reads, inside their retry).

* ``nan_grad``      — ``ShardedTrainer.step`` poisons the batch of the
  step it fires on (the non-finite guard skips it).

The other training-side faults (preempt, hang, oom, corrupt_ckpt) wait
for the resilience slice (ROADMAP queue A item 8).

Faults are armed with :func:`inject` (tests) or ``MXNET_TPU_CHAOS``, a
comma list of ``kind[@step][xcount]``.  ``MXNET_TPU_CHAOS_RANKS`` pins
faults to worker ranks, resolved from ``MXNET_TPU_CHAOS_RANK`` /
``MXNET_TPU_KV_RANK`` / ``DMLC_WORKER_ID`` or an initialised
``torch.distributed`` group.  The hot-path cost when no fault is armed is
one falsy check.
"""
from __future__ import annotations

import os
import sys
import time
from typing import List, Optional

__all__ = ["inject", "fire", "armed", "maybe_slow_exec", "maybe_exec_error",
           "maybe_replica_crash", "maybe_hedge_lag", "maybe_io_error",
           "reset"]


class _Fault:
    __slots__ = ("kind", "at_step", "remaining", "params")

    def __init__(self, kind, at_step=None, count=1, **params):
        self.kind = kind
        self.at_step = None if at_step is None else int(at_step)
        self.remaining = int(count)
        self.params = params

    def __repr__(self):
        return "_Fault(%s, at_step=%s, remaining=%d)" % (
            self.kind, self.at_step, self.remaining)


_FAULTS: List[_Fault] = []
_ENV_PARSED = False
_RANKS_GATE: Optional[bool] = None     # cached MXNET_TPU_CHAOS_RANKS verdict


def _current_rank() -> Optional[int]:
    for var in ("MXNET_TPU_CHAOS_RANK", "MXNET_TPU_KV_RANK",
                "DMLC_WORKER_ID"):
        v = os.environ.get(var, "").strip()
        if v.lstrip("-").isdigit():
            return int(v)
    dist = sys.modules.get("torch.distributed")
    if dist is not None and dist.is_available() and dist.is_initialized():
        return int(dist.get_rank())
    return None


def _ranks_allow() -> bool:
    global _RANKS_GATE
    if _RANKS_GATE is not None:
        return _RANKS_GATE
    spec = os.environ.get("MXNET_TPU_CHAOS_RANKS", "").strip()
    if not spec:
        _RANKS_GATE = True
        return True
    try:
        ranks = {int(t) for t in spec.split(",") if t.strip()}
    except ValueError:
        _RANKS_GATE = True
        return True
    r = _current_rank()
    _RANKS_GATE = r is not None and r in ranks
    return _RANKS_GATE


def _parse_env():
    global _ENV_PARSED
    if _ENV_PARSED:
        return
    _ENV_PARSED = True
    spec = os.environ.get("MXNET_TPU_CHAOS", "").strip()
    for tok in spec.split(","):
        tok = tok.strip()
        if not tok:
            continue
        count = 1
        # only a trailing "xN" with digit N is a count — fault KINDS may
        # themselves contain "x" (slow_exec, exec_error)
        base, _, c = tok.rpartition("x")
        if base and c.isdigit():
            tok, count = base, int(c)
        kind, _, step = tok.partition("@")
        _FAULTS.append(_Fault(kind, at_step=step or None, count=count))


def reset():
    """Drop every armed fault (tests) and re-read the env next time."""
    global _ENV_PARSED, _RANKS_GATE
    del _FAULTS[:]
    _ENV_PARSED = False
    _RANKS_GATE = None


class inject:
    """Context manager arming one fault::

        with chaos.inject("exec_error", count=3):
            engine.submit(...)
    """

    def __init__(self, kind, at_step=None, count=1, **params):
        self._fault = _Fault(kind, at_step=at_step, count=count, **params)

    def __enter__(self):
        _parse_env()
        _FAULTS.append(self._fault)
        return self._fault

    def __exit__(self, *exc):
        try:
            _FAULTS.remove(self._fault)
        except ValueError:
            pass
        return False


def fire(kind: str, step: Optional[int] = None) -> Optional[dict]:
    """Consume one firing of ``kind`` if armed for this ``step``; returns
    the fault's params dict (possibly empty) or None.  Cheap when idle."""
    if not _FAULTS and _ENV_PARSED:
        return None
    _parse_env()
    if _FAULTS and not _ranks_allow():
        return None
    for f in _FAULTS:
        if f.kind != kind or f.remaining <= 0:
            continue
        if f.at_step is not None and step != f.at_step:
            continue
        f.remaining -= 1
        from .. import telemetry
        telemetry.count("chaos.faults_injected", kind=kind)
        return dict(f.params)
    return None


def armed(kinds) -> List[str]:
    """The kinds among ``kinds`` that have a firing left: a caller that
    has not ported a fault refuses to run with it armed."""
    _parse_env()
    return sorted({f.kind for f in _FAULTS
                   if f.kind in kinds and f.remaining > 0})


def _sleep_fault(kind, step, env, default):
    params = fire(kind, step)
    if params is not None:
        time.sleep(float(params.get("seconds",
                                    os.environ.get(env, default))))


def maybe_slow_exec(step: Optional[int] = None):
    """Sleep inside the executor call if a ``slow_exec`` fault fires."""
    _sleep_fault("slow_exec", step, "MXNET_TPU_CHAOS_SLOW_EXEC_SECONDS",
                 "0.5")


def maybe_hedge_lag(step: Optional[int] = None):
    """Sleep inside the executor call if a ``hedge_lag`` fault fires."""
    _sleep_fault("hedge_lag", step, "MXNET_TPU_CHAOS_HEDGE_LAG_SECONDS",
                 "0.3")


def maybe_exec_error(step: Optional[int] = None):
    """Raise RuntimeError from the executor call if an ``exec_error``
    fault fires now."""
    if fire("exec_error", step) is not None:
        raise RuntimeError(
            "chaos: injected executor failure at batch %s" % step)


def maybe_replica_crash(step: Optional[int] = None):
    """SIGKILL the calling process if a ``replica_crash`` fault fires."""
    if fire("replica_crash", step) is not None:
        import signal
        print("chaos: replica SIGKILLing itself at batch %s" % step,
              flush=True)
        os.kill(os.getpid(), signal.SIGKILL)


def maybe_io_error(desc: str = ""):
    """Raise OSError if an ``io_error`` fault fires now (inside retried
    IO callables, so the retry path absorbs it)."""
    if fire("io_error") is not None:
        raise OSError("chaos: injected transient IO failure (%s)" % desc)
