"""Gluon (port of ``mxnet_tpu/gluon``; reference python/mxnet/gluon/):
``Block``, ``HybridBlock`` and ``SymbolBlock`` over the port's autograd
and graph program, ``Parameter``/``ParameterDict``, ``Trainer``, the
``nn`` layers, the recurrent layers and cells of ``rnn`` (the ``RNN`` op,
cuDNN on the card), the losses, ``utils``, the vision model zoo,
``contrib.nn`` and ``contrib.rnn``.

``gluon.data`` (ROADMAP queue A item 6, data IO) raises ``NotPortedYet``
when used."""
from .block import Block, HybridBlock, SymbolBlock  # noqa: F401
from .parameter import Constant, Parameter, ParameterDict  # noqa: F401
from .trainer import Trainer  # noqa: F401
from . import nn, loss, utils, model_zoo, contrib  # noqa: F401
from . import rnn, data  # noqa: F401
