"""The port's operators: the hand-written CUDA kernels of the decode path
(:mod:`.kernels`) and their build (:mod:`.build`)."""
from . import build, kernels
from .kernels import (LAUNCHES, decode_attention, quant_matmul,
                      quantize_weight)

__all__ = ["build", "kernels", "LAUNCHES", "decode_attention",
           "quant_matmul", "quantize_weight"]
