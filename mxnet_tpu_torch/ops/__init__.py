"""The port's operators: the registry (:mod:`.registry`), the general ops
of the imperative API and the LM graph (:mod:`.init_ops`,
:mod:`.elemwise`, :mod:`.broadcast_reduce`, :mod:`.matrix`,
:mod:`.random_ops`, :mod:`.nn`, the fused ``RNN`` op of :mod:`.rnn` on
cuDNN, :mod:`.linalg`, the spatial ops of :mod:`.spatial` and the
contrib and detection ops of :mod:`.contrib`, the dense semantics of
the sparse-storage ops (:mod:`.sparse_storage`), with the parameter-shape
hooks of :mod:`.shape_hints`), the SGD updates (:mod:`.optimizer_ops`), the
``Custom`` op of :mod:`mxnet_tpu_torch.operator`, and the
hand-written CUDA kernels (:mod:`.kernels`) with their build
(:mod:`.build`).

Importing the package sets one process-wide cuBLAS policy, before any op
runs: bf16 and f16 matrix products (``FullyConnected``, ``dot``,
``batch_dot``, the attention's einsums) accumulate in f32 to the end, as
the reference's do, with no split-K reduction in the input's precision
(``torch.backends.cuda.matmul.allow_{bf16,fp16}_reduced_precision_
reduction = False``).  Every low-precision product of the port, and the
caller's own, then rounds one way whatever ran before it; a caller who
sets the flags back after the import gets ATen's rounding everywhere."""
import torch as _torch

from . import build, kernels
from . import registry, init_ops, elemwise, broadcast_reduce, matrix
from . import random_ops, nn, rnn, linalg, spatial, contrib, sparse_storage
from . import shape_hints, optimizer_ops
from .kernels import (LAUNCHES, decode_attention, flash_attention,
                      greedy_nms, quant_matmul, quantize_weight)

from .. import operator as _operator  # noqa: E402,F401  (the Custom op)

_torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
_torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction = False

__all__ = ["build", "kernels", "registry", "init_ops", "elemwise",
           "broadcast_reduce", "matrix", "random_ops", "nn", "rnn", "linalg",
           "spatial", "contrib", "shape_hints",
           "optimizer_ops", "LAUNCHES", "decode_attention",
           "flash_attention", "greedy_nms", "quant_matmul",
           "quantize_weight"]
