"""Device context (port of ``mxnet_tpu/context.py``; reference
include/mxnet/base.h:142-247).

A :class:`Context` names a torch device: ``gpu(i)`` is
``torch.device("cuda", i)`` and ``cpu()`` the host.

Stated deviation from the JAX package: there the default context is the
CPU (``context.py:98-100``); here :func:`current_context` outside any
``with ctx:`` scope is the card (``base.resolve_device``), and without one
it raises :class:`~mxnet_tpu_torch.base.DeviceUnavailable`.  Tests ask for
the CPU with ``cpu()``.  ``cpu_pinned()`` names page-locked host
memory: an array made there (``nd.array(x, ctx=cpu_pinned())``, a batch
of the data-IO iterators) is ``is_pinned()`` when a CUDA device is
visible and reports ``cpu_pinned`` as its context, and its copy to the
card does not block the host (``io/pinned.py``).  Without a CUDA device
there is nothing to pin for, and such arrays are ordinary host memory.
:func:`num_gpus` counts the visible CUDA devices.
"""
from __future__ import annotations

import threading
from typing import Optional

from .base import resolve_device

__all__ = ["Context", "cpu", "gpu", "cpu_pinned", "current_context",
           "num_gpus", "context_of", "as_torch_device", "wants_pinned"]


class Context:
    """Named device: devtype 'cpu' | 'gpu' | 'cpu_pinned' | 'cpu_shared'
    and an index, with the JAX package's type ids.  Its 'tpu' names no
    device of the port and is refused."""

    devtype2id = {"cpu": 1, "gpu": 2, "cpu_pinned": 3, "cpu_shared": 5}
    devid2type = {v: k for k, v in devtype2id.items()}
    _default_ctx = threading.local()

    def __init__(self, device_type, device_id: int = 0):
        if isinstance(device_type, Context):
            device_type, device_id = (device_type.device_type,
                                      device_type.device_id)
        if isinstance(device_type, int):
            device_type = Context.devid2type.get(device_type, device_type)
        if device_type not in Context.devtype2id:
            raise ValueError("unknown device type %r" % (device_type,))
        self.device_type = device_type
        self.device_id = int(device_id)
        self._old_ctx: Optional[Context] = None

    @property
    def device_typeid(self) -> int:
        return Context.devtype2id[self.device_type]

    @property
    def torch_device(self):
        """The torch device this context names (``cuda:i`` for gpu, the
        host for the cpu types; a missing card raises
        ``DeviceUnavailable``)."""
        import torch
        if self.device_type != "gpu":
            return torch.device("cpu")
        return resolve_device(torch.device("cuda", self.device_id))

    def empty_cache(self):
        """Release the cached blocks of the card's allocator (reference
        Context.empty_cache); a host context has none."""
        if self.device_type == "gpu":
            import torch
            with torch.cuda.device(self.torch_device):
                torch.cuda.empty_cache()

    def __eq__(self, other):
        return (isinstance(other, Context)
                and self.device_type == other.device_type
                and self.device_id == other.device_id)

    def __hash__(self):
        return hash((self.device_type, self.device_id))

    def __repr__(self):
        return "%s(%d)" % (self.device_type, self.device_id)

    __str__ = __repr__

    def __enter__(self):
        self._old_ctx = getattr(Context._default_ctx, "value", None)
        Context._default_ctx.value = self
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        Context._default_ctx.value = self._old_ctx

    @classmethod
    def default_ctx(cls) -> "Context":
        """The innermost ``with ctx:`` scope, else the card."""
        ctx = getattr(cls._default_ctx, "value", None)
        if ctx is not None:
            return ctx
        return Context("gpu", resolve_device(None).index)


def cpu(device_id: int = 0) -> Context:
    return Context("cpu", device_id)


def gpu(device_id: int = 0) -> Context:
    return Context("gpu", device_id)


def cpu_pinned(device_id: int = 0) -> Context:
    return Context("cpu_pinned", device_id)


def num_gpus() -> int:
    """The number of CUDA devices this process sees."""
    import torch
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def current_context() -> Context:
    return Context.default_ctx()


def context_of(obj) -> Context:
    """The Context of a torch tensor or device (``cpu_pinned`` for a
    page-locked host tensor).  Only a process that has initialised CUDA
    can have pinned memory of its own, so no other queries CUDA: a
    forked data worker never touches it."""
    dev = getattr(obj, "device", obj)
    if dev.type == "cuda":
        return gpu(dev.index or 0)
    if dev is not obj:
        import torch
        if torch.cuda.is_initialized() and obj.is_pinned():
            return cpu_pinned()
    return cpu()


def wants_pinned(ctx) -> bool:
    """True when ``ctx`` is ``cpu_pinned`` and a CUDA device is visible,
    i.e. when an array made there is page-locked."""
    if not (isinstance(ctx, Context) and ctx.device_type == "cpu_pinned"):
        return False
    import torch
    return torch.cuda.is_available()


def as_torch_device(ctx):
    """A Context, its string form (``"gpu(0)"``, as an op's ``ctx`` attr
    holds it), a torch device, a device string or None (the current
    context) -> ``torch.device``."""
    import torch
    if ctx is None:
        ctx = current_context()
    if isinstance(ctx, str) and ctx.endswith(")"):
        kind, _, idx = ctx[:-1].partition("(")
        ctx = Context(kind, int(idx or 0))
    if isinstance(ctx, Context):
        return ctx.torch_device
    return resolve_device(torch.device(ctx))
