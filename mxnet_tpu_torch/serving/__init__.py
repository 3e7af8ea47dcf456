"""Serving on the card (port of ``mxnet_tpu/serving``): the resilient
runtime — admission queue, deadline-aware batcher, circuit breaker,
one-shot request futures, swap with canary — and, on top of it, the
paged-KV continuous-batching decode engine.  The fleet tier (wire,
replica, router, fleet) waits for a later slice (ROADMAP queue A item 10).

Quick start::

    from mxnet_tpu_torch.models.transformer import get_decode_step
    from mxnet_tpu_torch.serving import DecodeEngine
    prog = get_decode_step(arg_params, vocab_size=V, seq_len=T, ...)
    with DecodeEngine(prog) as eng:
        ids = eng.generate(prompt, max_new_tokens=32)
"""
from .admission import AdmissionQueue
from .batcher import collect_batch, normalize_inputs, pack, unpack
from .breaker import BROKEN, DEGRADED, HEALTH_NAMES, SERVING, CircuitBreaker
from .errors import (Cancelled, CircuitOpen, DeadlineExceeded, ExecFailed,
                     Overloaded, QuotaExceeded, ReplicaUnavailable,
                     ServingError, SwapFailed, TopologyMismatch)
from .request import Request
from .runtime import ServingRuntime
from .decode import (DecodeConfig, DecodeEngine, DecodeProgram,
                     DecodeRequest, PagePool, init_decode_params)

__all__ = [
    "ServingRuntime", "Request", "AdmissionQueue", "CircuitBreaker",
    "SERVING", "DEGRADED", "BROKEN", "HEALTH_NAMES",
    "ServingError", "Overloaded", "DeadlineExceeded", "CircuitOpen",
    "ExecFailed", "SwapFailed", "TopologyMismatch", "QuotaExceeded",
    "ReplicaUnavailable", "Cancelled",
    "DecodeConfig", "DecodeEngine", "DecodeProgram", "DecodeRequest",
    "PagePool", "init_decode_params",
    "normalize_inputs", "collect_batch", "pack", "unpack",
]
