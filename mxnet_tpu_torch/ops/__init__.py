"""The port's operators: the registry and the ops of the LM graph
(:mod:`.registry`, :mod:`.matrix`, :mod:`.broadcast_reduce`, :mod:`.nn`,
with the parameter-shape hooks of :mod:`.shape_hints`), the SGD updates
(:mod:`.optimizer_ops`), and the
hand-written CUDA kernels (:mod:`.kernels`) with their build
(:mod:`.build`)."""
from . import build, kernels
from . import registry, matrix, broadcast_reduce, nn, shape_hints
from . import optimizer_ops
from .kernels import (LAUNCHES, decode_attention, flash_attention,
                      quant_matmul, quantize_weight)

__all__ = ["build", "kernels", "registry", "matrix", "broadcast_reduce",
           "nn", "shape_hints", "optimizer_ops", "LAUNCHES", "decode_attention",
           "flash_attention", "quant_matmul", "quantize_weight"]
