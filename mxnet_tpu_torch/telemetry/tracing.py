"""Compile-event log (port of the ``note_compile`` / ``compile_summary``
pair of ``mxnet_tpu/telemetry/tracing.py``).

The port does not jit: its "compile" of a decode program is building and
loading the CUDA kernels plus one warm-up step.  That event is still
recorded here under the ``compile/*`` family, so "nothing was built while
serving" is provable the same way it is in the JAX package.  Distributed
request tracing waits for ROADMAP queue A item 9.
"""
from __future__ import annotations

import threading
import time

from . import registry as _registry

__all__ = ["note_compile", "compile_summary", "reset"]

_COMPILES = []
_LOCK = threading.Lock()


def note_compile(name: str, seconds: float, **attrs):
    """Record one compile event; feeds the ``compile.seconds`` histogram
    when telemetry is armed and an always-on bounded in-process log."""
    seconds = float(seconds or 0.0)
    with _LOCK:
        _COMPILES.append({"name": name, "seconds": seconds,
                          "time": time.time(), **attrs})
        del _COMPILES[:-256]
    _registry.observe("compile.seconds", seconds, what=name)


def compile_summary() -> dict:
    """``{"count", "total_seconds", "by_name": {name: seconds}}`` over
    every compile event this process has seen."""
    with _LOCK:
        events = list(_COMPILES)
    by_name = {}
    for e in events:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["seconds"]
    return {"count": len(events),
            "total_seconds": sum(e["seconds"] for e in events),
            "by_name": by_name}


def reset():
    with _LOCK:
        del _COMPILES[:]
