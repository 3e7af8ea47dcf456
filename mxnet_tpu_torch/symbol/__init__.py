"""``sym`` namespace (port of ``mxnet_tpu/symbol``): Symbol and every
registered op of the port as a graph constructor, with ``sym.random``,
``sym.contrib`` and ``sym.linalg``."""
import sys as _sys

from .. import ops as _ops  # noqa: F401  (registers the ops)
from ..base import MXNetError as _MXNetError
from ..ops.registry import get_op as _get_op, list_ops as _list_ops
from .symbol import (Group, Symbol, Variable, arange, create, load,
                     load_json, ones, var, zeros)


def _make_sym_wrapper(op_name):
    op = _get_op(op_name)

    def wrapper(*args, **kwargs):
        input_syms = [a for a in args if isinstance(a, Symbol)]
        extra = [a for a in args if not isinstance(a, Symbol)]
        if extra:
            raise _MXNetError("sym.%s: positional args must be Symbols, got "
                              "%r" % (op_name, extra))
        return create(op_name, input_syms, kwargs)

    wrapper.__name__ = op_name
    wrapper.__doc__ = op.doc
    return wrapper


for _name in _list_ops():
    setattr(_sys.modules[__name__], _name, _make_sym_wrapper(_name))

from . import random  # noqa: E402,F401
from . import contrib  # noqa: E402,F401
from . import linalg  # noqa: E402,F401
