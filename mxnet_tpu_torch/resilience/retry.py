"""Retry with exponential backoff + wall-clock timeout.

Port of ``mxnet_tpu/resilience/retry.py``.  In this slice the serving
runtime is its one caller: it absorbs transient executor errors with it,
bounded by the batch's deadline margin.

Env knobs (the same names as the JAX package, docs/robustness.md):

* ``MXNET_TPU_RETRY_MAX``      — attempts including the first (default 3)
* ``MXNET_TPU_RETRY_BACKOFF``  — first sleep in seconds, doubled per retry
  and capped at 30s (default 0.05)
* ``MXNET_TPU_RETRY_TIMEOUT``  — total wall-clock budget in seconds across
  all attempts (default 60); on expiry the last error is re-raised even if
  attempts remain
"""
from __future__ import annotations

import logging
import os
import time
from typing import Callable, Tuple, Type

__all__ = ["retry_config", "call_with_retry"]

_MAX_BACKOFF = 30.0


def retry_config():
    """(max_tries, first_backoff_s, timeout_s) from the environment."""
    return (max(1, int(os.environ.get("MXNET_TPU_RETRY_MAX", "3"))),
            float(os.environ.get("MXNET_TPU_RETRY_BACKOFF", "0.05")),
            float(os.environ.get("MXNET_TPU_RETRY_TIMEOUT", "60")))


def call_with_retry(fn: Callable, *args,
                    exceptions: Tuple[Type[BaseException], ...] = (OSError,),
                    max_tries: int = None, backoff: float = None,
                    timeout: float = None, desc: str = "", **kwargs):
    """Call ``fn(*args, **kwargs)``; on one of ``exceptions`` sleep and
    retry with doubling backoff until tries or the timeout budget run out,
    then re-raise the last error."""
    env_tries, env_backoff, env_timeout = retry_config()
    max_tries = env_tries if max_tries is None else max(1, int(max_tries))
    delay = env_backoff if backoff is None else float(backoff)
    timeout = env_timeout if timeout is None else float(timeout)
    deadline = time.monotonic() + timeout
    desc = desc or getattr(fn, "__name__", "call")
    for attempt in range(1, max_tries + 1):
        try:
            result = fn(*args, **kwargs)
            if attempt > 1:
                from .. import telemetry
                telemetry.count("retry.absorbed", desc=desc)
            return result
        except exceptions as e:
            now = time.monotonic()
            if attempt >= max_tries or now >= deadline:
                raise
            sleep = min(delay, _MAX_BACKOFF, max(0.0, deadline - now))
            logging.warning(
                "%s failed (attempt %d/%d): %s — retrying in %.2fs",
                desc, attempt, max_tries, e, sleep)
            time.sleep(sleep)
            delay *= 2.0
    raise AssertionError("unreachable")   # pragma: no cover
