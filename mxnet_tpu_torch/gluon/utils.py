"""Gluon helpers (port of ``mxnet_tpu/gluon/utils.py``; reference
python/mxnet/gluon/utils.py): ``split_data``, ``split_and_load`` (several
contexts are ROADMAP queue A item 7, distribution), ``clip_global_norm``
and ``check_sha1``.  ``download`` raises, as the JAX package's does: the
environment has no network."""
from __future__ import annotations

import hashlib
import math
import warnings

import numpy as np

from ..base import NotPortedYet
from ..ndarray.ndarray import array as nd_array

__all__ = ["split_data", "split_and_load", "clip_global_norm",
           "check_sha1", "download"]


def split_data(data, num_slice, batch_axis=0, even_split=True):
    """Cut ``data`` into ``num_slice`` chunks along ``batch_axis`` (with
    ``even_split`` the batch must divide exactly; otherwise the last chunk
    takes the remainder)."""
    extent = data.shape[batch_axis]
    if extent < num_slice:
        raise ValueError(
            "Too many slices for data with shape %s. Arguments are "
            "num_slice=%d and batch_axis=%d."
            % (data.shape, num_slice, batch_axis))
    if even_split and extent % num_slice:
        raise ValueError(
            "data with shape %s cannot be evenly split into %d slices "
            "along axis %d. Use a batch size that's multiple of %d or set "
            "even_split=False to allow uneven partitioning of data."
            % (data.shape, num_slice, batch_axis, num_slice))
    stride = extent // num_slice
    bounds = [i * stride for i in range(num_slice)] + [extent]
    if batch_axis == 0:
        return [data[lo:hi] for lo, hi in zip(bounds, bounds[1:])]
    from .. import ndarray as ndm
    return [ndm.slice_axis(data, axis=batch_axis, begin=lo, end=hi)
            for lo, hi in zip(bounds, bounds[1:])]


def split_and_load(data, ctx_list, batch_axis=0, even_split=True):
    """``data`` (an NDArray or numpy) on the one context of
    ``ctx_list``.  A batch in pinned host memory (a data loader's) goes
    to the card without blocking the host and without being pinned
    again (``NDArray.as_in_context``)."""
    if len(ctx_list) != 1:
        raise NotPortedYet("split_and_load over several contexts is not "
                           "ported yet (ROADMAP queue A item 7, "
                           "distribution)")
    if isinstance(data, np.ndarray):
        return [nd_array(data, ctx=ctx_list[0])]
    return [data.as_in_context(ctx_list[0])]


def clip_global_norm(arrays, max_norm):
    """Scale ``arrays`` in place so that their joint L2 norm is at most
    ``max_norm``; returns the norm before scaling."""
    if not arrays:
        raise ValueError("clip_global_norm needs at least one array")
    sq_sum = sum(float((a * a).sum().asscalar()) for a in arrays)
    global_norm = math.sqrt(sq_sum)
    if not np.isfinite(global_norm):
        warnings.warn(UserWarning("nan or inf is detected. Clipping results "
                                  "will be undefined."), stacklevel=2)
    ratio = max_norm / (global_norm + 1e-8)
    if ratio < 1.0:
        for a in arrays:
            a *= ratio
    return global_norm


def check_sha1(filename, sha1_hash):
    """True when the file's SHA-1 digest equals ``sha1_hash``."""
    digest = hashlib.sha1()
    with open(filename, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            digest.update(block)
    return digest.hexdigest() == sha1_hash


def download(url, path=None, overwrite=False, sha1_hash=None):
    raise RuntimeError("network access is not available in this environment; "
                       "place files locally and pass the path instead")
