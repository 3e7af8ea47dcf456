"""Pinned host staging for the data feed (MXNet's ``cpu_pinned``).

The data-IO iterators of the port (``ImageRecordIter`` on both
backends, ``ImageIter``, ``ImageDetIter`` and ``gluon.data.DataLoader``)
build each batch in host buffers of its own, page-locked when a CUDA
device is visible, so that the copy to the card runs without blocking
the host (``copy_(..., non_blocking=True)``) and the batch is never
pinned again on its way there.

The buffers come from PyTorch's caching host allocator
(``torch.empty(..., pin_memory=True)``): once its cache is warm a step
allocates no new page-locked memory, and it hands a freed buffer out
again only after every non-blocking copy that read it has run (each such
copy records an event on the buffer).  So a batch is the caller's to
keep, as MXNet's are.

Without a CUDA device the buffers are ordinary host memory.  Nothing
here touches CUDA unless a device is visible, so forked data workers,
which must never initialise CUDA, may import it.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["pinning", "empty", "stage"]


def pinning() -> bool:
    """True when host buffers can be page-locked (a CUDA device is
    visible)."""
    return torch.cuda.is_available()


def empty(shape, dtype) -> torch.Tensor:
    """A fresh host buffer of ``shape`` and ``dtype``, page-locked where
    :func:`pinning`; its contents are undefined."""
    return torch.empty(tuple(int(s) for s in shape), dtype=dtype,
                       pin_memory=pinning())


def stage(arrays):
    """Copies of the numpy ``arrays`` in fresh buffers, as tensors of the
    same shapes and dtypes (a transposed view is copied in its new
    layout)."""
    out = []
    for a in arrays:
        a = np.asarray(a)
        buf = empty(a.shape, torch.from_numpy(np.empty(0, a.dtype)).dtype)
        buf.numpy()[...] = a
        out.append(buf)
    return out
