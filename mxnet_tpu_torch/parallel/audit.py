"""The runtime collective trail and the wire models (port of
``mxnet_tpu/parallel/audit.py``'s runtime half and analytic models).

Every collective of the port goes through :func:`collective`, which runs
it and records a completion event (kind, call-site tag, the mesh axis
whose process group ran it, payload bytes) in a bounded thread-safe
deque, so a post-mortem can say which
collective last finished and a test can sum a step's bytes by axis and
kind (:func:`bytes_by_axis`).  When
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
           "clear_collective_log", "collective", "bytes_by_axis", "ring_allreduce_wire_bytes",
           "collective_wire_bytes", "zero_update_model_bytes",
           "hierarchical_allreduce_model_bytes", "grad_payload_bytes"]

# a tp step of a 12-layer LM records ~150 collectives: keep a few steps
_RUNTIME_LOG: "deque" = deque(maxlen=4096)
_RUNTIME_LOCK = threading.Lock()


def record_collective(kind: str, tag: str = "", step=None, bytes=None,
                      group=None):
    """Note a completed collective (``kind`` = all-to-all/psum/...,
    ``tag`` = call-site label, ``bytes`` = operand payload when the entry
    point knows it, ``group`` = the mesh axis whose group ran it, or
    "world" for the default group); ``axis`` in the record is the same
    label."""
    with _RUNTIME_LOCK:
        _RUNTIME_LOG.append({"time": time.time(), "kind": kind,
                             "tag": tag, "step": step, "bytes": bytes,
                             "group": group, "axis": group})
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


def collective(kind: str, tag: str, fn, nbytes=None, step=None,
               axis="world"):
    """Run one collective (``fn()``, over the process group of mesh axis
    ``axis``, or the default group for "world"), then record it under
    that axis: the one door every collective of the port goes through.
    Returns what ``fn`` returns."""
    out = fn()
    record_collective(kind, tag, step=step, bytes=nbytes, group=axis)
    return out


def bytes_by_axis(events=None, step=None):
    """``{axis: {kind: payload bytes}}`` summed over ``events`` (default:
    the whole retained log), only those of ``step`` when given."""
    out = {}
    for e in collective_log() if events is None else events:
        if step is not None and e.get("step") != step:
            continue
        kinds = out.setdefault(e.get("axis") or e.get("group"), {})
        kinds[e["kind"]] = kinds.get(e["kind"], 0) + (e["bytes"] or 0)
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


def hierarchical_allreduce_model_bytes(payload_bytes, islands, per_island,
                                       elem_bytes=4):
    """Per-rank collective payloads of the two-tier all-reduce
    (:mod:`.hierarchy`) of a ``payload``-byte tensor on an ``islands`` x
    ``per_island`` mesh, in the payload conventions above:
    ``reduce-scatter`` (fast tier) the 1/k output shard, ``all-reduce``
    (slow tier) that shard, ``all-gather`` (fast tier) the gathered whole;
    and the two wire numbers: ``slow_wire``, the bytes a rank sends over
    the slow tier (a ring all-reduce of its shard over the m islands), and
    ``flat_wire``, what a flat ring over all m*k ranks pushes through each
    link, the slow tier's included."""
    m = max(1, islands)
    k = max(1, per_island)
    # the scatter pads in ELEMENTS to a multiple of k, so the shard is
    # ceil(elems/k) elements, not ceil(bytes/k) bytes
    elems = -(-payload_bytes // elem_bytes)
    shard = -(-elems // k) * elem_bytes
    return {
        "reduce-scatter": shard,
        "all-reduce": shard,
        "all-gather": shard * k,
        "slow_wire": ring_allreduce_wire_bytes(shard, m),
        "flat_wire": ring_allreduce_wire_bytes(payload_bytes, m * k),
    }


def grad_payload_bytes(params, grad_dtype_bytes=4):
    """The dp all-reduce payload: every gradient, in f32."""
    total = 0
    for p in params:
        n = 1
        for d in p.shape:
            n *= int(d)
        total += n * grad_dtype_bytes
    return total
