"""``mx.contrib`` (port of ``mxnet_tpu/contrib``; reference
python/mxnet/contrib/): the legacy autograd API (:mod:`.autograd`), the
contrib op namespaces (:mod:`.ndarray`, :mod:`.symbol`) and the text
utilities (:mod:`.text`).  ``tensorboard`` (ROADMAP queue A item 9,
observability) raises ``NotPortedYet`` when asked for."""
from ..base import NotPortedYet as _NotPortedYet
from . import autograd, ndarray, symbol, text  # noqa: F401

_UNPORTED = {"tensorboard": "item 9, observability"}


def __getattr__(name):
    if name in _UNPORTED:
        raise _NotPortedYet("mx.contrib.%s is not ported yet (ROADMAP "
                            "queue A %s)" % (name, _UNPORTED[name]))
    raise AttributeError("module %r has no attribute %r" % (__name__, name))
