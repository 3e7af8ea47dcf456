"""Device topology of deploy artifacts (port of the topology half of
``mxnet_tpu/deploy.py``).

An artifact records the ``platform``, ``device_kind`` and
``device_count`` it was exported on, and files its payload under
:func:`device_fingerprint`.  On the card the platform is ``"gpu"`` and the
kind is ``torch.cuda.get_device_name``.  The serialized-executable
``ServedProgram`` path has no counterpart in this slice (the port does not
AOT-compile); the decode artifact (``serving/decode.py``) is weights-only
in both packages.
"""
from __future__ import annotations

from .base import MXNetError

__all__ = ["TopologyMismatch", "current_topology", "device_fingerprint"]


class TopologyMismatch(MXNetError):
    """An artifact was built for different hardware than the loading
    process sees (platform / device kind / device count)."""


def current_topology(device=None):
    """``(platform, device_kind, device_count)`` of ``device`` (a
    ``torch.device``; None means the card when one is visible)."""
    import torch
    dev = None if device is None else torch.device(device)
    if (dev is None and torch.cuda.is_available()) or \
            (dev is not None and dev.type == "cuda"):
        idx = 0 if dev is None or dev.index is None else dev.index
        return ("gpu", torch.cuda.get_device_name(idx),
                torch.cuda.device_count())
    return ("cpu", "cpu", 1)


def device_fingerprint(topology=None) -> str:
    """``platform|device_kind|device_count`` — the key an artifact's
    payload is filed under (the JAX package's convention)."""
    platform, kind, count = topology or current_topology()
    return "%s|%s|%d" % (platform, kind, int(count))
