"""``mx.gluon.contrib.data`` (port of ``mxnet_tpu/gluon/contrib/data``):
not ported yet (ROADMAP queue A item 6, data IO).  Every name raises
``NotPortedYet``."""
from ....base import NotPortedYet as _NotPortedYet


def __getattr__(name):
    if name.startswith("__"):
        raise AttributeError(name)
    raise _NotPortedYet("mx.gluon.contrib.data.%s is not ported yet "
                        "(ROADMAP queue A item 6, data IO)" % name)
