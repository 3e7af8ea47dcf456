"""``mx.nd.contrib`` namespace (port of ``mxnet_tpu/ndarray/contrib.py``;
reference python/mxnet/ndarray/contrib.py): every registered
``_contrib_*`` op of the port under its short name, so both spellings
work, ``mx.nd.contrib.fused_attention(...)`` and
``mx.nd._contrib_fused_attention(...)``, the contrib and detection ops
of ``ops/contrib.py`` and ``SparseEmbedding`` of
``ops/sparse_storage.py`` among them."""
import sys as _sys

from ..ops.registry import get_op as _get_op, list_ops as _list_ops
from .ndarray import _make_wrapper


def _populate(mod, make_wrapper):
    """Set ``make_wrapper(name)`` on ``mod`` under each ``_contrib_*``
    name's short form (one op under several spellings keeps the first)."""
    seen = {}
    for name in _list_ops():
        if not name.startswith("_contrib_"):
            continue
        short = name[len("_contrib_"):]
        if short not in seen or seen[short] is not _get_op(name):
            setattr(mod, short, make_wrapper(name))
            seen[short] = _get_op(name)


_populate(_sys.modules[__name__], lambda name: _make_wrapper(_get_op(name)))
