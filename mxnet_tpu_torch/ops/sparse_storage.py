"""Sparse-storage operators as registry ops (port of
``mxnet_tpu/ops/sparse_storage.py``; reference
src/operator/tensor/cast_storage.cc:33, sparse_retain.cc:33,
square_sum.cc:50, indexing_op.cc:249 ``_contrib_SparseEmbedding``).

Inside a graph every tensor is dense, as in the JAX package: these ops
compute the dense semantics of each sparse op, so symbolic graphs
compose, and carry a storage-type rule (``Operator.stype_rule``) with
which :func:`mxnet_tpu_torch.executor.infer_storage_types` marks the
edges that are logically sparse.  The row_sparse and CSR arrays
themselves live at the host boundary (:mod:`mxnet_tpu_torch.ndarray.
sparse`): the kvstore, the lazy optimizer updates and ``nd.save``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..base import attr_bool, attr_dtype, attr_int, attr_str
from .broadcast_reduce import _RED_PARAMS, _norm_axes, _x64_int
from .matrix import _fill, _in_range
from .registry import get_op, register

_STYPES = ("default", "row_sparse", "csr")


@register("cast_storage", inputs=("data",),
          params=dict(stype=attr_str(required=True)))
def _cast_storage(attrs, x):
    """Storage conversion (reference cast_storage-inl.h): the identity on
    the values; the stype rule re-tags the edge."""
    if attrs.stype not in _STYPES:
        raise ValueError("unknown storage type %r" % (attrs.stype,))
    return x


@register("_sparse_retain", inputs=("data", "indices"),
          aliases=("sparse_retain",))
def _sparse_retain(attrs, data, indices):
    """Keep the rows named in ``indices`` (reference sparse_retain.cc:33);
    every other row becomes zero, what densifying the reference's
    row_sparse result gives.  Ids outside ``[0, rows)`` are dropped, as
    the JAX op's ``mode="drop"``."""
    ids = indices.to(torch.int64)
    ids = ids[(ids >= 0) & (ids < data.shape[0])]
    keep = torch.zeros(data.shape[0], dtype=torch.bool, device=data.device)
    keep[ids] = True
    return torch.where(keep.reshape((-1,) + (1,) * (data.dim() - 1)),
                       data, torch.zeros((), dtype=data.dtype,
                                         device=data.device))


@register("_square_sum", inputs=("data",), params=dict(_RED_PARAMS),
          aliases=("square_sum",))
def _square_sum(attrs, x):
    """``sum(x * x)`` over the axes (reference square_sum.cc:50, a fused
    kernel for row_sparse data there); a uint8 sum is uint64 (C27)."""
    return _x64_int(lambda t, a, k: torch.sum(t * t, a, keepdim=k))(
        x, _norm_axes(attrs, x.dim()), attrs.keepdims)


@register("_contrib_SparseEmbedding", inputs=("data", "weight"),
          params=dict(input_dim=attr_int(required=True),
                      output_dim=attr_int(required=True),
                      dtype=attr_dtype("float32"),
                      deterministic=attr_bool(False)))
def _sparse_embedding(attrs, idx, weight):
    """An Embedding whose weight gradient is logically row_sparse
    (reference indexing_op.cc:249).  The forward is a dense gather, as
    the JAX op's ``take``; the row_sparse gradient is made at the kvstore
    boundary (``nd.sparse.embedding_grad``).  An id out of range gives a
    NaN row, as ``Embedding``'s does."""
    i, ok = _in_range(idx.long(), weight.shape[0])
    return _fill(F.embedding(i, weight), ok.unsqueeze(-1))


# -- storage-type rules ------------------------------------------------------
# rule(attrs, in_stypes) -> out_stypes.  An op without a rule is a dense
# producer: a sparse input densifies at its edge (the reference's dense
# fallback in FInferStorageType) and its outputs are "default".

def install_stype_rules():
    get_op("cast_storage").stype_rule = lambda attrs, ins: (attrs.stype,)
    get_op("_sparse_retain").stype_rule = \
        lambda attrs, ins: ("row_sparse",)
    # a reduction of a sparse input is dense
    get_op("_square_sum").stype_rule = lambda attrs, ins: ("default",)
    get_op("_contrib_SparseEmbedding").stype_rule = \
        lambda attrs, ins: ("default",)
    # dot(csr, dense) is dense
    get_op("dot").stype_rule = lambda attrs, ins: ("default",)


install_stype_rules()
