"""``mx.nd`` namespace (port of ``mxnet_tpu/ndarray``): the NDArray, the
creation and I/O functions, every registered op as a function
(``populate_module``), ``maximum`` ... ``power``, ``mx.nd.random`` and
``mx.nd.contrib`` (the ported ``_contrib_*`` ops) and ``mx.nd.linalg``.
``sparse`` raises :class:`~mxnet_tpu_torch.base.NotPortedYet` when asked
for (ROADMAP queue A item 5, sparse storage)."""
import sys as _sys

from .. import ops as _ops  # noqa: F401  (registers the ops)
from ..base import NotPortedYet as _NotPortedYet
from .ndarray import (NDArray, arange, array, concatenate,  # noqa: F401
                      empty, eye, full, imperative_invoke,
                      invoke_with_arrays, load, moveaxis, ones,
                      populate_module, save, stack_nd, waitall, zeros)

populate_module(_sys.modules[__name__])

from . import random  # noqa: E402,F401
from . import contrib  # noqa: E402,F401
from . import linalg  # noqa: E402,F401


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


def __getattr__(name):
    if name in ("sparse", "cast_storage", "sparse_retain", "csr_matrix",
                "row_sparse_array", "BaseSparseNDArray", "CSRNDArray",
                "RowSparseNDArray"):
        raise _NotPortedYet("mx.nd.%s is not ported yet (ROADMAP queue A "
                            "item 5, sparse storage)" % name)
    raise AttributeError("module %r has no attribute %r" % (__name__, name))
