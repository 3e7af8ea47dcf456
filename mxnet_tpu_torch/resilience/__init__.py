"""Fault tolerance pieces the ported slices need (port of
``mxnet_tpu/resilience``): the byte-compatible artifact container, retry
with backoff, the serving-path chaos hooks, and the trainer's non-finite
guard and loss-scale automaton.  Checkpointing, the watchdog and elastic
training wait for ROADMAP queue A item 8."""
from .container import CorruptContainer, read_container, write_container
from .retry import call_with_retry, retry_config
from . import chaos, guards

__all__ = ["CorruptContainer", "write_container", "read_container",
           "call_with_retry", "retry_config", "chaos", "guards"]
