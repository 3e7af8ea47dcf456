"""Carrying weights across from the JAX package.

The JAX package's decode program and its artifacts hold parameters under
the training graph's names (``tok_embed_weight``, ``l0_q_weight``,
``l0_ln1_gamma``, ...) as host arrays, with quantized matmul weights
split into ``<name>#q`` (int8, or uint8 packed int4) and
``<name>#scale`` (f32) entries.  The port keeps the same names, so a
trained module's ``arg_params`` or an exported artifact maps onto the
port one to one; only the array type changes.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np

from .base import MXNetError

__all__ = ["from_jax_params", "is_quantized"]

# dtypes a decode parameter may have: f32 everywhere except the quantized
# payloads
_Q_DTYPES = ("int8", "uint8")


def is_quantized(params: Mapping) -> bool:
    return any(k.endswith("#q") for k in params)


def from_jax_params(params: Mapping, device) -> Dict[str, "object"]:
    """JAX-package parameter dict (name -> host array, training-graph
    names, quantized ``#q`` / ``#scale`` entries included) -> the port's
    parameter dict: the same names, torch tensors on ``device``.

    Values that are already torch tensors are moved as they are.  f32
    entries stay f32, ``#q`` payloads keep their int8/uint8 bytes;
    any other dtype (a float64 or bf16 weight, a wrongly typed payload)
    is refused rather than silently cast."""
    import torch
    out = {}
    for name, value in params.items():
        if isinstance(value, torch.Tensor):
            t = value.detach()
            dtype = str(t.dtype).replace("torch.", "")
        else:
            host = np.asarray(value.asnumpy() if hasattr(value, "asnumpy")
                              else value)
            dtype = host.dtype.name
            t = None if dtype not in _Q_DTYPES + ("float32",) else \
                torch.from_numpy(np.ascontiguousarray(host))
        if name.endswith("#q"):
            if dtype not in _Q_DTYPES:
                raise MXNetError("%s: quantized payload must be int8 or "
                                 "uint8, got %s" % (name, dtype))
        elif dtype != "float32":
            raise MXNetError("%s: decode parameters are f32, got %s"
                             % (name, dtype))
        out[name] = t.to(device).contiguous()
    return out
