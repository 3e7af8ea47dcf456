"""Memory observability: tagged device-memory accounting + OOM forensics.

Port of the serving hooks of ``mxnet_tpu/telemetry/memory.py`` over
PyTorch's CUDA caching allocator:

* :func:`tag` labels tensors with a taxonomy tag (``served``,
  ``kv_cache``, ...), weakly, so :func:`live_bytes_by_tag` can bucket the
  live bytes the way the JAX package buckets ``jax.live_arrays()``;
* :func:`note_step` samples ``torch.cuda.memory_allocated`` into the
  ``mem.device_bytes_in_use`` gauge and the peak, throttled;
* :func:`oom_guard` wraps a dispatch region: a
  ``torch.cuda.OutOfMemoryError`` (or any error whose text carries an
  allocator-exhaustion marker) is counted as ``mem.oom`` and logged with
  the tagged bytes and the allocator's own numbers before it re-raises;
  with ``MXNET_TPU_WATCHDOG_DIR`` set the report is also written there
  as JSON.

Every hook checks one cached gate (``MXNET_TPU_MEMWATCH`` when set, else
the telemetry master switch) and returns at once when disarmed.  The
sampler thread, the per-program breakdowns and the leak watchdog wait for
ROADMAP queue A item 9.
"""
from __future__ import annotations

import json
import logging
import os
import threading
import time
import weakref
from contextlib import contextmanager
from typing import Dict

from . import registry as _registry

__all__ = ["TAGS", "enabled", "tag", "live_bytes_by_tag", "note_step",
           "is_oom", "oom_guard", "reset"]

TAGS = ("params", "optimizer", "activations", "batch", "served",
        "checkpoint", "embedding", "kv_cache", "untagged")

_UNSET = object()
_ENV_GATE = _UNSET
_TAG_LOCK = threading.Lock()
_TAGGED: Dict[int, tuple] = {}          # id(tensor) -> (weakref, tag, label)
_PEAK = [0.0]
_LAST_SAMPLE = [0.0]

_OOM_MARKERS = ("RESOURCE_EXHAUSTED", "Out of memory", "out of memory",
                "CUDA out of memory")


def enabled() -> bool:
    global _ENV_GATE
    if _ENV_GATE is _UNSET:
        flag = os.environ.get("MXNET_TPU_MEMWATCH")
        _ENV_GATE = None if flag is None else flag not in (
            "", "0", "false", "off")
    if _ENV_GATE is not None:
        return _ENV_GATE
    return _registry.is_armed()


def reset():
    global _ENV_GATE
    with _TAG_LOCK:
        _TAGGED.clear()
    _PEAK[0] = 0.0
    _LAST_SAMPLE[0] = 0.0
    _ENV_GATE = _UNSET


def _tensors(tree):
    out, stack = [], [tree]
    while stack:
        obj = stack.pop()
        if isinstance(obj, dict):
            stack.extend(obj.values())
        elif isinstance(obj, (list, tuple)):
            stack.extend(obj)
        elif hasattr(obj, "untyped_storage") and hasattr(obj, "nbytes"):
            out.append(obj)
    return out


def tag(tree, tag: str, label: str = ""):
    """Label every tensor in ``tree`` with ``tag`` (weakly — tagging never
    extends a tensor's lifetime).  Returns ``tree`` unchanged."""
    if not enabled():
        return tree
    with _TAG_LOCK:
        for t in _tensors(tree):
            _TAGGED[id(t)] = (weakref.ref(t), str(tag), str(label))
        dead = [k for k, (ref, *_r) in _TAGGED.items() if ref() is None]
        for k in dead:
            del _TAGGED[k]
    return tree


def live_bytes_by_tag() -> Dict[str, int]:
    """Bytes of the live tagged tensors per tag."""
    out: Dict[str, int] = {}
    with _TAG_LOCK:
        entries = list(_TAGGED.values())
    for ref, tg, _label in entries:
        t = ref()
        if t is not None:
            out[tg] = out.get(tg, 0) + int(t.nbytes)
    return out


def _device_bytes() -> float:
    import torch
    if not torch.cuda.is_available() or not torch.cuda.is_initialized():
        return float(sum(live_bytes_by_tag().values()))
    return float(torch.cuda.memory_allocated())


def note_step(step=None, min_interval: float = 0.25):
    """Sample device bytes in use into the gauge and the peak (throttled);
    one cached-bool check when disarmed."""
    if not enabled():
        return
    now = time.monotonic()
    if now - _LAST_SAMPLE[0] < min_interval:
        return
    _LAST_SAMPLE[0] = now
    used = _device_bytes()
    _PEAK[0] = max(_PEAK[0], used)
    _registry.set_gauge("mem.device_bytes_in_use", used)
    _registry.set_gauge("mem.peak_live_bytes", _PEAK[0])


def is_oom(exc: BaseException) -> bool:
    """Does this exception look like a device allocator failure?"""
    import torch
    if isinstance(exc, (MemoryError, torch.cuda.OutOfMemoryError)):
        return True
    text = "%s: %s" % (type(exc).__name__, exc)
    return any(m in text for m in _OOM_MARKERS)


def _oom_report(tag_name, exc, program, step) -> dict:
    import torch
    report = {"kind": "oom_postmortem", "tag": tag_name, "step": step,
              "program": program, "pid": os.getpid(), "time": time.time(),
              "error": "%s: %s" % (type(exc).__name__, exc),
              "live_bytes_by_tag": live_bytes_by_tag()}
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        report["allocated_bytes"] = torch.cuda.memory_allocated()
        report["reserved_bytes"] = torch.cuda.memory_reserved()
        report["max_allocated_bytes"] = torch.cuda.max_memory_allocated()
    return report


@contextmanager
def oom_guard(tag_name: str, program=None, step=None):
    """Wrap a dispatch region so an allocator failure is reported before
    it re-raises.  Hot-path cost: one try/except frame."""
    try:
        yield
    except BaseException as e:
        if is_oom(e):
            _registry.count("mem.oom", tag=tag_name)
            report = _oom_report(tag_name, e, program, step)
            logging.error("memwatch: device OOM in %s: %s", tag_name,
                          json.dumps(report, default=repr))
            d = os.environ.get("MXNET_TPU_WATCHDOG_DIR")
            if d:
                os.makedirs(d, exist_ok=True)
                path = os.path.join(d, "oom-postmortem-%d-%d.json"
                                    % (os.getpid(), int(time.time())))
                with open(path, "w") as f:
                    json.dump(report, f, indent=2, default=repr)
        raise
