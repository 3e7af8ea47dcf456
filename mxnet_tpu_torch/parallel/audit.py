"""The runtime collective trail (port of the dynamic half of
``mxnet_tpu/parallel/audit.py``).

Every collective entry point records a completion event here, in a
bounded thread-safe deque, so a post-mortem can say which collective
last finished.  When telemetry is armed each record also counts into the
registry: ``parallel.collectives{kind}`` and
``parallel.collective_bytes{kind}``.  The HLO-text accounting of the
reference (payloads parsed from compiled programs) has no counterpart
until NCCL collectives land (ROADMAP queue A item 7).
"""
from __future__ import annotations

import threading
import time
from collections import deque

from .. import telemetry

__all__ = ["record_collective", "last_collective", "collective_log",
           "clear_collective_log"]

_RUNTIME_LOG: "deque" = deque(maxlen=128)
_RUNTIME_LOCK = threading.Lock()


def record_collective(kind: str, tag: str = "", step=None, bytes=None):
    """Note a completed collective (``kind`` = all-to-all/psum/...,
    ``tag`` = call-site label, ``bytes`` = operand payload when the entry
    point knows it)."""
    with _RUNTIME_LOCK:
        _RUNTIME_LOG.append({"time": time.time(), "kind": kind,
                             "tag": tag, "step": step, "bytes": bytes})
    if telemetry.is_armed():
        telemetry.count("parallel.collectives", kind=kind)
        if bytes:
            telemetry.count("parallel.collective_bytes", float(bytes),
                            kind=kind)


def last_collective():
    """The most recent completed-collective event, or None."""
    with _RUNTIME_LOCK:
        return dict(_RUNTIME_LOG[-1]) if _RUNTIME_LOG else None


def collective_log(n: int = None):
    """The newest ``n`` (default: all retained) collective events."""
    with _RUNTIME_LOCK:
        items = [dict(e) for e in _RUNTIME_LOG]
    return items[-n:] if n else items


def clear_collective_log():
    with _RUNTIME_LOCK:
        _RUNTIME_LOG.clear()
