"""``mx.nd`` namespace (port of ``mxnet_tpu/ndarray``): the NDArray, the
creation and I/O functions, every registered op as a function
(``populate_module``), ``maximum`` ... ``power``, ``mx.nd.random`` and
``mx.nd.contrib`` (the ``_contrib_*`` ops), ``mx.nd.linalg`` and
``mx.nd.sparse`` (row_sparse and CSR arrays, with the eager
``cast_storage`` and ``sparse_retain``)."""
import sys as _sys

from .. import ops as _ops  # noqa: F401  (registers the ops)
from .ndarray import (NDArray, arange, array, concatenate,  # noqa: F401
                      empty, eye, full, imperative_invoke,
                      invoke_with_arrays, load, moveaxis, ones,
                      populate_module, save, stack_nd, waitall, zeros)

populate_module(_sys.modules[__name__])

from . import random  # noqa: E402,F401
from . import contrib  # noqa: E402,F401
from . import linalg  # noqa: E402,F401
from . import sparse  # noqa: E402,F401
from .sparse import (BaseSparseNDArray, CSRNDArray,  # noqa: E402,F401
                     RowSparseNDArray, csr_matrix, row_sparse_array)


def cast_storage(data, stype):
    """Eager storage conversion: a real CSR, row_sparse or dense NDArray
    (the registry op of the same name is the identity inside a graph;
    see ``ops/sparse_storage.py``)."""
    return sparse.cast_storage(data, stype)


def sparse_retain(data, indices):
    """Eager ``sparse_retain``: O(nnz) on a RowSparseNDArray, the
    registry op's masked dense semantics otherwise."""
    if isinstance(data, RowSparseNDArray):
        return data.retain(indices)
    return invoke_with_arrays("_sparse_retain", [data, indices], {})


def _pair(lhs, rhs, same, bcast, scalar):
    if isinstance(lhs, NDArray) and isinstance(rhs, NDArray):
        name = same if lhs.shape == rhs.shape else bcast
        return invoke_with_arrays(name, [lhs, rhs], {})
    if isinstance(lhs, NDArray):
        return invoke_with_arrays(scalar, [lhs], dict(scalar=float(rhs)))
    return invoke_with_arrays(scalar, [rhs], dict(scalar=float(lhs)))


def maximum(lhs, rhs):
    return _pair(lhs, rhs, "_maximum", "broadcast_maximum",
                 "_maximum_scalar")


def minimum(lhs, rhs):
    return _pair(lhs, rhs, "_minimum", "broadcast_minimum",
                 "_minimum_scalar")


def add(lhs, rhs):
    return lhs + rhs


def subtract(lhs, rhs):
    return lhs - rhs


def multiply(lhs, rhs):
    return lhs * rhs


def divide(lhs, rhs):
    return lhs / rhs


def power(lhs, rhs):
    return lhs ** rhs
