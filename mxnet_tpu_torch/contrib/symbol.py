"""``mx.contrib.symbol`` (port of ``mxnet_tpu/contrib/symbol.py``): every
registered op of the port as a Symbol constructor."""
import sys as _sys

from ..ops.registry import list_ops as _list_ops
from ..symbol import _make_sym_wrapper

for _name in _list_ops():
    setattr(_sys.modules[__name__], _name, _make_sym_wrapper(_name))
