"""Core shared utilities for mxnet_tpu_torch: the error types, the
environment-knob helpers, and device resolution.

Counterpart of ``mxnet_tpu/base.py``.  The port keeps its own copy of what
it needs instead of importing the JAX package (whose ``__init__`` imports
jax and changes global jax config).
"""
from __future__ import annotations

import os

__all__ = ["MXNetError", "DeviceUnavailable", "NotPortedYet", "env_int",
           "env_float", "resolve_device"]


class MXNetError(Exception):
    """Error raised by mxnet_tpu_torch (parity with the reference's
    MXNetError)."""


class DeviceUnavailable(MXNetError):
    """An entry point was asked to run on the card (the default) but the
    process sees no CUDA device.  Nothing falls back to the CPU: pass
    ``device="cpu"`` to run the plain PyTorch versions on purpose."""


class NotPortedYet(MXNetError):
    """A feature of the JAX package that a later slice of the port brings
    over (ROADMAP.md names the queue entry); raised instead of silently
    ignoring the request."""


def env_int(name, default):
    try:
        return int(os.environ[name])
    except (KeyError, ValueError):
        return default


def env_float(name, default):
    try:
        return float(os.environ[name])
    except (KeyError, ValueError):
        return default


def resolve_device(device=None):
    """``None`` means the card: ``cuda`` if the process sees one, else a
    typed :class:`DeviceUnavailable`.  An explicit device is taken as
    given (tests pass ``"cpu"``)."""
    import torch
    if device is None:
        if not torch.cuda.is_available():
            raise DeviceUnavailable(
                "no CUDA device is visible; the port runs on the card "
                "unless the caller passes device='cpu'")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        if not torch.cuda.is_available():
            raise DeviceUnavailable("device %r requested but no CUDA "
                                    "device is visible" % (device,))
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
