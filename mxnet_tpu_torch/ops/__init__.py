"""The port's operators: the registry (:mod:`.registry`), the general ops
of the imperative API and the LM graph (:mod:`.init_ops`,
:mod:`.elemwise`, :mod:`.broadcast_reduce`, :mod:`.matrix`,
:mod:`.random_ops`, :mod:`.nn`, with the parameter-shape hooks of
:mod:`.shape_hints`), the SGD updates (:mod:`.optimizer_ops`), and the
hand-written CUDA kernels (:mod:`.kernels`) with their build
(:mod:`.build`)."""
from . import build, kernels
from . import registry, init_ops, elemwise, broadcast_reduce, matrix
from . import random_ops, nn, shape_hints, optimizer_ops
from .kernels import (LAUNCHES, decode_attention, flash_attention,
                      quant_matmul, quantize_weight)

__all__ = ["build", "kernels", "registry", "init_ops", "elemwise",
           "broadcast_reduce", "matrix", "random_ops", "nn", "shape_hints",
           "optimizer_ops", "LAUNCHES", "decode_attention",
           "flash_attention", "quant_matmul", "quantize_weight"]
