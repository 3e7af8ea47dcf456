"""Creation ops, no tensor inputs (port of ``mxnet_tpu/ops/init_ops.py``;
reference src/operator/tensor/init_op.{cc,h}).  Each creates its output
on :func:`~.registry.device_of` (the ``ctx`` given, else the card)."""
from __future__ import annotations

import math

import torch

from ..base import (Param, attr_dtype, attr_float, attr_int, attr_shape,
                    attr_str, dtype_torch)
from .registry import device_of, register

_CREATE_PARAMS = dict(shape=attr_shape(()), ctx=attr_str(None),
                      dtype=attr_dtype("float32"))


@register("_zeros", inputs=(), params=dict(_CREATE_PARAMS))
def _zeros(attrs):
    return torch.zeros(attrs.shape, dtype=dtype_torch(attrs.dtype),
                       device=device_of(attrs))


@register("_ones", inputs=(), params=dict(_CREATE_PARAMS))
def _ones(attrs):
    return torch.ones(attrs.shape, dtype=dtype_torch(attrs.dtype),
                      device=device_of(attrs))


@register("_full", inputs=(),
          params=dict(_CREATE_PARAMS, value=attr_float(required=True)))
def _full(attrs):
    return torch.full(attrs.shape, attrs.value,
                      dtype=dtype_torch(attrs.dtype), device=device_of(attrs))


@register("_arange", inputs=(),
          params=dict(start=attr_float(0.0), stop=attr_float(None),
                      step=attr_float(1.0), repeat=attr_int(1),
                      infer_range=Param(bool, False),
                      ctx=attr_str(None), dtype=attr_dtype("float32")))
def _arange(attrs):
    """``start, start+step, ...`` below ``stop`` (``[0, start)`` without a
    stop), each value repeated ``repeat`` times.  As numpy (and so
    ``jnp.arange``) does, the values are ``first + i * delta`` in the
    output dtype, with ``first = dtype(start)`` and ``delta =
    dtype(start + step) - first``."""
    start, stop, step = attrs.start, attrs.stop, attrs.step
    if stop is None:
        start, stop = 0.0, start
    dt = dtype_torch(attrs.dtype)
    dev = device_of(attrs)
    n = max(0, math.ceil((stop - start) / step))
    first = torch.tensor(start, dtype=torch.float64).to(dt)
    delta = torch.tensor(start + step, dtype=torch.float64).to(dt) - first
    out = first.to(dev) + torch.arange(n, device=dev).to(dt) * delta.to(dev)
    if attrs.repeat != 1:
        out = torch.repeat_interleave(out, attrs.repeat)
    return out


@register("_eye", inputs=(),
          params=dict(N=attr_int(required=True), M=attr_int(0), k=attr_int(0),
                      ctx=attr_str(None), dtype=attr_dtype("float32")))
def _eye(attrs):
    n, m = attrs.N, attrs.M if attrs.M > 0 else attrs.N
    rows = torch.arange(n, device=device_of(attrs)).unsqueeze(1)
    cols = torch.arange(m, device=rows.device).unsqueeze(0)
    return (cols - rows == attrs.k).to(dtype_torch(attrs.dtype))
