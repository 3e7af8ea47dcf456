"""``sym.contrib`` namespace (port of ``mxnet_tpu/symbol/contrib.py``):
every ``_contrib_*`` op as a symbolic constructor under its short name."""
import sys as _sys

from ..ops.registry import get_op as _get_op, list_ops as _list_ops
from . import _make_sym_wrapper

_seen = {}
for _name in _list_ops():
    if not _name.startswith("_contrib_"):
        continue
    _short = _name[len("_contrib_"):]
    if _short not in _seen or _seen[_short] is not _get_op(_name):
        setattr(_sys.modules[__name__], _short, _make_sym_wrapper(_name))
        _seen[_short] = _get_op(_name)
