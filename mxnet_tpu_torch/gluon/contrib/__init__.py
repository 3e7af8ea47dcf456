"""Gluon contrib (port of ``mxnet_tpu/gluon/contrib``): ``nn``
(``Concurrent``, ``HybridConcurrent``, ``Identity``) and ``rnn``
(``Conv2DLSTMCell``); ``data`` raises ``NotPortedYet``."""
from . import data, nn, rnn  # noqa: F401
