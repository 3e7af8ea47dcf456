"""Gluon contrib (port of ``mxnet_tpu/gluon/contrib``): ``nn``
(``Concurrent``, ``HybridConcurrent``, ``Identity``); ``rnn`` and
``data`` raise ``NotPortedYet``."""
from . import data, nn, rnn  # noqa: F401
