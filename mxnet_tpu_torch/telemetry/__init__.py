"""Telemetry the serving slice reports into (port of
``mxnet_tpu/telemetry``): the metrics registry, spans, the compile-event
log and the memory hooks, under the JAX package's metric names and
knobs.  Digests, the attribution plane and distributed tracing wait for
ROADMAP queue A13."""
from .registry import (DEFAULT_BUCKETS, Counter, Gauge, Histogram, arm,
                       count, disarm, is_armed, observe, reset_metrics,
                       set_gauge, snapshot, window_tick)
from .spans import recent_spans, record_span, span, spans_active
from . import memory
from . import spans as _spans
from . import tracing

__all__ = [
    "DEFAULT_BUCKETS", "Counter", "Gauge", "Histogram", "arm", "count",
    "disarm", "is_armed", "observe", "reset_metrics", "set_gauge",
    "snapshot", "window_tick",
    "record_span", "recent_spans", "span", "spans_active",
    "memory", "tracing", "reset",
]


def reset():
    """Full test reset: metrics, span log, memory tags, compile log."""
    reset_metrics()
    _spans.reset()
    memory.reset()
    tracing.reset()
