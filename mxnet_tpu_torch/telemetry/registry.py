"""Metrics registry: process-global counters, gauges and histograms.

Port of the core of ``mxnet_tpu/telemetry/registry.py`` with the same
metric names, the same zero-cost disarmed path and the same master switch
(``MXNET_TPU_TELEMETRY=1`` or :func:`arm`).  The exporters (JSONL,
Prometheus text, snapshot deltas) wait for ROADMAP queue A13.
"""
from __future__ import annotations

import bisect
import os
import threading
import time
from collections import deque
from typing import Dict, Iterable, Optional, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "arm", "disarm", "is_armed",
           "count", "observe", "set_gauge", "snapshot", "window_tick",
           "reset_metrics", "DEFAULT_BUCKETS"]

# seconds-oriented latency buckets: 0.5 ms .. 60 s
DEFAULT_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                   0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)

_LOCK = threading.Lock()                 # registry structure only
_METRICS: Dict[str, "_Metric"] = {}
_ARMED: Optional[bool] = None            # None -> read env on first check

# rolling window of (time, snapshot) for post-mortems / throughput math
_WINDOW: deque = deque(maxlen=128)
_WINDOW_LAST = [0.0]


def is_armed() -> bool:
    """Cheap cached master-switch check (the hot-path gate)."""
    global _ARMED
    if _ARMED is None:
        _ARMED = os.environ.get("MXNET_TPU_TELEMETRY", "") not in (
            "", "0", "false", "off")
    return _ARMED


def arm():
    global _ARMED
    _ARMED = True


def disarm():
    global _ARMED
    _ARMED = False


def reset_metrics():
    """Drop every metric + cached arm state (tests)."""
    global _ARMED
    with _LOCK:
        _METRICS.clear()
    _WINDOW.clear()
    _WINDOW_LAST[0] = 0.0
    _ARMED = None


def _label_key(labels: dict) -> Tuple:
    return tuple(sorted(labels.items()))


class _Metric:
    kind = "?"

    def __init__(self, name: str, help: str = "", registered: bool = True,
                 always: bool = False):
        self.name = name
        self.help = help
        self.always = bool(always)
        self._lock = threading.Lock()
        self._series: Dict[Tuple, object] = {}
        if registered:
            with _LOCK:
                existing = _METRICS.get(name)
                if existing is not None and type(existing) is not type(self):
                    raise TypeError(
                        "metric %r already registered as %s, not %s"
                        % (name, existing.kind, self.kind))
                _METRICS[name] = self

    def _on(self) -> bool:
        return self.always or is_armed()

    def _series_dicts(self):
        return [{"labels": dict(k), "value": v}
                for k, v in sorted(self._series.items())]

    def describe(self) -> dict:
        with self._lock:
            return {"kind": self.kind, "help": self.help,
                    "series": self._series_dicts()}


class Counter(_Metric):
    """Monotonic labeled counter."""

    kind = "counter"

    def inc(self, value: float = 1.0, **labels):
        if not self._on():
            return
        key = _label_key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + value

    def value(self, **labels) -> float:
        with self._lock:
            return float(self._series.get(_label_key(labels), 0.0))


class Gauge(_Metric):
    """Last-write-wins labeled gauge."""

    kind = "gauge"

    def set(self, value: float, **labels):
        if not self._on():
            return
        with self._lock:
            self._series[_label_key(labels)] = float(value)


class _HistSeries:
    __slots__ = ("counts", "count", "sum", "min", "max", "reservoir")

    def __init__(self, n_buckets, reservoir):
        self.counts = [0] * (n_buckets + 1)   # +1: overflow bucket
        self.count = 0
        self.sum = 0.0
        self.min = None
        self.max = None
        self.reservoir = deque(maxlen=reservoir)


class Histogram(_Metric):
    """Fixed-bucket labeled histogram + a bounded sample reservoir that
    gives exact percentiles (the serving runtime's latency and step-time
    distributions)."""

    kind = "histogram"

    def __init__(self, name, help="", buckets: Iterable[float] = None,
                 reservoir: int = 2048, registered=True, always=False):
        super().__init__(name, help, registered, always)
        self.buckets = tuple(sorted(buckets or DEFAULT_BUCKETS))
        self.reservoir_size = int(reservoir)

    def observe(self, value: float, **labels):
        if not self._on():
            return
        value = float(value)
        key = _label_key(labels)
        with self._lock:
            s = self._series.get(key)
            if s is None:
                s = self._series[key] = _HistSeries(len(self.buckets),
                                                    self.reservoir_size)
            s.counts[bisect.bisect_left(self.buckets, value)] += 1
            s.count += 1
            s.sum += value
            s.min = value if s.min is None else min(s.min, value)
            s.max = value if s.max is None else max(s.max, value)
            s.reservoir.append(value)

    def percentiles(self, ps=(0.5, 0.95, 0.99), **labels) -> dict:
        """Exact percentiles over the reservoir: {p: value}.  Empty dict
        when nothing was observed."""
        with self._lock:
            s = self._series.get(_label_key(labels))
            xs = sorted(s.reservoir) if s is not None else []
        if not xs:
            return {}
        return {p: xs[min(len(xs) - 1, int(p * (len(xs) - 1)))] for p in ps}

    def summary(self, **labels) -> dict:
        with self._lock:
            s = self._series.get(_label_key(labels))
            if s is None:
                return {"count": 0, "sum": 0.0, "mean": None, "min": None,
                        "max": None}
            out = {"count": s.count, "sum": s.sum,
                   "mean": s.sum / s.count if s.count else None,
                   "min": s.min, "max": s.max}
        out.update({"p%g" % (100 * p): v
                    for p, v in self.percentiles(**labels).items()})
        return out

    def _series_dicts(self):
        return [{"labels": dict(k), "count": s.count, "sum": s.sum,
                 "min": s.min, "max": s.max}
                for k, s in sorted(self._series.items(),
                                   key=lambda kv: kv[0])]


def _get_or_create(cls, name):
    with _LOCK:
        m = _METRICS.get(name)
    if m is not None:
        if not isinstance(m, cls):
            raise TypeError("metric %r is a %s, not a %s"
                            % (name, m.kind, cls.kind))
        return m
    return cls(name)


def count(name, value=1.0, **labels):
    """Increment a counter — no-op (one bool check) when disarmed."""
    if not is_armed():
        return
    _get_or_create(Counter, name).inc(value, **labels)


def observe(name, value, **labels):
    """Record one histogram observation — no-op when disarmed."""
    if not is_armed():
        return
    _get_or_create(Histogram, name).observe(value, **labels)


def set_gauge(name, value, **labels):
    if not is_armed():
        return
    _get_or_create(Gauge, name).set(value, **labels)


def snapshot() -> dict:
    """One self-contained dict of every registered metric."""
    with _LOCK:
        metrics = dict(_METRICS)
    return {"time": time.time(),
            "metrics": {name: m.describe()
                        for name, m in sorted(metrics.items())}}


def window_tick(min_interval: float = 1.0):
    """Append a timestamped snapshot to the rolling window, throttled.
    Called from step seams; no-op when disarmed."""
    if not is_armed():
        return
    now = time.time()
    if now - _WINDOW_LAST[0] < min_interval:
        return
    _WINDOW_LAST[0] = now
    _WINDOW.append((now, snapshot()))

