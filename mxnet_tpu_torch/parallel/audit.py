"""The runtime collective trail and the wire models (port of
``mxnet_tpu/parallel/audit.py``'s runtime half and analytic models).

Every collective of the port goes through :func:`collective`, which runs
it and records a completion event (kind, call-site tag, group, payload
bytes) in a bounded thread-safe deque, so a post-mortem can say which
collective last finished and a test can sum a step's bytes.  When
telemetry is armed each record also counts into the registry:
``parallel.collectives{kind}`` and ``parallel.collective_bytes{kind}``.
The payload conventions are the JAX package's: a reduce-scatter's payload
is its 1/n output shard, an all-gather's the gathered whole.

The HLO-text accounting of the JAX package (``collective_accounting``,
``AxisLabeler``, ``audit_report``: payloads parsed from compiled
programs) becomes an FX rule with the rest of the graph checks (ROADMAP
queue A item 9).
"""
from __future__ import annotations

import threading
import time
from collections import deque

from .. import telemetry

__all__ = ["record_collective", "last_collective", "collective_log",
           "clear_collective_log", "collective", "ring_allreduce_wire_bytes",
           "collective_wire_bytes", "zero_update_model_bytes",
           "grad_payload_bytes"]

_RUNTIME_LOG: "deque" = deque(maxlen=128)
_RUNTIME_LOCK = threading.Lock()


def record_collective(kind: str, tag: str = "", step=None, bytes=None,
                      group=None):
    """Note a completed collective (``kind`` = all-to-all/psum/...,
    ``tag`` = call-site label, ``bytes`` = operand payload when the entry
    point knows it, ``group`` = the process group's label)."""
    with _RUNTIME_LOCK:
        _RUNTIME_LOG.append({"time": time.time(), "kind": kind,
                             "tag": tag, "step": step, "bytes": bytes,
                             "group": group})
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


def collective(kind: str, tag: str, fn, nbytes=None, step=None):
    """Run one collective (``fn()``) over the default group, then record
    it (group "world"): the one door every collective of the port goes
    through.  Returns what ``fn`` returns."""
    out = fn()
    record_collective(kind, tag, step=step, bytes=nbytes, group="world")
    return out


def ring_allreduce_wire_bytes(payload_bytes, n_devices):
    """Per-device bytes on the wire for a ring all-reduce of ``payload``."""
    return 2 * (n_devices - 1) * payload_bytes // max(1, n_devices)


def collective_wire_bytes(kind, payload_bytes, n_devices):
    """Per-device wire bytes for one collective, per the payload
    conventions above (reduce-scatter payload is the 1/n output shard;
    all-gather payload is the gathered result): ring models in all
    cases."""
    n = max(1, n_devices)
    if kind == "all-reduce":
        return ring_allreduce_wire_bytes(payload_bytes, n)
    if kind == "reduce-scatter":
        return (n - 1) * payload_bytes
    if kind == "all-gather":
        return (n - 1) * payload_bytes // n
    return payload_bytes


def zero_update_model_bytes(shardable_bytes, residual_bytes, dp):
    """Per-step collective payloads of the ZeRO sharded weight update at
    dp degree ``dp``: the shardable grads reduce-scatter into 1/dp shards,
    the updated weights all-gather back whole, and parameters with no
    dp-divisible dim keep a plain all-reduce."""
    return {"reduce-scatter": shardable_bytes // max(1, dp),
            "all-gather": shardable_bytes,
            "all-reduce": residual_bytes}


def grad_payload_bytes(params, grad_dtype_bytes=4):
    """The dp all-reduce payload: every gradient, in f32."""
    total = 0
    for p in params:
        n = 1
        for d in p.shape:
            n *= int(d)
        total += n * grad_dtype_bytes
    return total
