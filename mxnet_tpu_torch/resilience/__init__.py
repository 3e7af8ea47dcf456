"""Fault tolerance pieces the serving slice needs (port of
``mxnet_tpu/resilience``): the byte-compatible artifact container, retry
with backoff, and the serving-path chaos hooks.  Checkpointing, guards,
the watchdog and elastic training wait for ROADMAP queue A12."""
from .container import CorruptContainer, read_container, write_container
from .retry import call_with_retry, retry_config
from . import chaos

__all__ = ["CorruptContainer", "write_container", "read_container",
           "call_with_retry", "retry_config", "chaos"]
