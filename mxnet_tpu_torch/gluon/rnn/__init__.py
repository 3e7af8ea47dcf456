"""Gluon recurrent layers and cells (port of ``mxnet_tpu/gluon/rnn``;
reference python/mxnet/gluon/rnn/)."""
from .rnn_cell import (BidirectionalCell, DropoutCell, GRUCell,
                       HybridRecurrentCell, LSTMCell, ModifierCell,
                       RecurrentCell, ResidualCell, RNNCell,
                       SequentialRNNCell, ZoneoutCell)
from .rnn_layer import GRU, LSTM, RNN
