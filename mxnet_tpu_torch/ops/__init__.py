"""The port's operators: the registry and the ops of the LM graph
(:mod:`.registry`, :mod:`.matrix`, :mod:`.broadcast_reduce`, :mod:`.nn`,
with the parameter-shape hooks of :mod:`.shape_hints`), and the
hand-written CUDA kernels (:mod:`.kernels`) with their build
(:mod:`.build`)."""
from . import build, kernels
from . import registry, matrix, broadcast_reduce, nn, shape_hints
from .kernels import (LAUNCHES, decode_attention, flash_attention,
                      quant_matmul, quantize_weight)

__all__ = ["build", "kernels", "registry", "matrix", "broadcast_reduce",
           "nn", "shape_hints", "LAUNCHES", "decode_attention",
           "flash_attention", "quant_matmul", "quantize_weight"]
