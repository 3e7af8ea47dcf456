"""``mx.gluon.contrib.rnn`` (port of ``mxnet_tpu/gluon/contrib/rnn``): not
ported yet, it needs the ``RNN`` op (ROADMAP queue A item 4, the rest of
the ops).  Every name raises ``NotPortedYet``."""
from ....base import NotPortedYet as _NotPortedYet


def __getattr__(name):
    if name.startswith("__"):
        raise AttributeError(name)
    raise _NotPortedYet("mx.gluon.contrib.rnn.%s is not ported yet "
                        "(ROADMAP queue A item 4, the rest of the ops: the "
                        "RNN op)" % name)
