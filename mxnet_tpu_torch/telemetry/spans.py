"""Structured spans: timed regions, metrics and a bounded event log.

Port of ``mxnet_tpu/telemetry/spans.py``.  ``span("serve/decode_step")``
times a region; when telemetry is armed a span that names a ``metric``
observes its duration into that registry histogram, and every completed
span (and every retrospective :func:`record_span`) is appended to a
bounded in-process event log that :func:`recent_spans` reads.  The JAX
package merges spans into its profiler's Chrome trace; the port has no
profiler yet (ROADMAP queue A13), so the log is where they go.

Cost when nothing is armed: one cached-bool check on enter; ``timed=True``
adds the two clock reads a caller needs for ``.duration`` (the serving
exec EWMA).
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import List, Optional

from . import registry as _registry

__all__ = ["span", "spans_active", "record_span", "recent_spans"]

_EVENTS: deque = deque(maxlen=4096)
_EVENTS_LOCK = threading.Lock()


def spans_active() -> bool:
    """True when spans record anywhere — the single hot-path gate."""
    return _registry.is_armed()


def _log(name, cat, start_s, dur_s, tid, pid, attrs):
    with _EVENTS_LOCK:
        _EVENTS.append({"name": name, "cat": cat, "start": start_s,
                        "dur": dur_s, "tid": tid, "pid": pid,
                        "attrs": attrs})


class span:
    """Context manager timing one region (see module docstring)."""

    __slots__ = ("name", "cat", "metric", "attrs", "timed", "active",
                 "duration", "_t0", "_start")

    def __init__(self, name: str, cat: str = "span",
                 metric: Optional[str] = None, timed: bool = False,
                 **attrs):
        self.name = name
        self.cat = cat
        self.metric = metric
        self.attrs = attrs
        self.timed = timed
        self.active = False
        self.duration = None
        self._t0 = None
        self._start = None

    def __enter__(self):
        self.active = spans_active()
        if self.active or self.timed:
            self._start = time.time()
            self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self._t0 is not None:
            self.duration = time.perf_counter() - self._t0
        if not self.active:
            return False
        if self.metric is not None:
            _registry.observe(self.metric, self.duration)
        _log(self.name, self.cat, self._start, self.duration,
             threading.get_ident(), 0, self.attrs)
        return False


def record_span(name: str, start_s: float, dur_s: float, cat: str = "span",
                tid: Optional[int] = None, pid: int = 0, **attrs):
    """Record a RETROSPECTIVE span (explicit start + duration, seconds),
    e.g. a request's queue-wait and exec phases reconstructed after
    delivery; ``tid``/``pid`` place it on a virtual lane."""
    if not spans_active():
        return
    _log(name, cat, start_s, max(0.0, dur_s), tid, pid, attrs)


def recent_spans(name: Optional[str] = None) -> List[dict]:
    """The logged spans, oldest first (optionally only ``name``)."""
    with _EVENTS_LOCK:
        evs = list(_EVENTS)
    return [e for e in evs if name is None or e["name"] == name]


def reset():
    with _EVENTS_LOCK:
        _EVENTS.clear()
