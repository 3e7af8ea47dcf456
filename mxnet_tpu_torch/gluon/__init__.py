"""Gluon (port of ``mxnet_tpu/gluon``; reference python/mxnet/gluon/):
``Block``, ``HybridBlock`` and ``SymbolBlock`` over the port's autograd
and graph program, ``Parameter``/``ParameterDict``, ``Trainer``, the
``nn`` layers, the losses, ``utils``, the vision model zoo and
``contrib.nn``.

``gluon.rnn`` (the ``RNN`` op: ROADMAP queue A item 4, the rest of the
ops) and ``gluon.data`` (item 6, data IO) raise ``NotPortedYet`` when
used."""
from .block import Block, HybridBlock, SymbolBlock  # noqa: F401
from .parameter import Constant, Parameter, ParameterDict  # noqa: F401
from .trainer import Trainer  # noqa: F401
from . import nn, loss, utils, model_zoo, contrib  # noqa: F401
from . import rnn, data  # noqa: F401
