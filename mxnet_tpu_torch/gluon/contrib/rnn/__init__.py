"""Gluon contrib recurrent cells (port of
``mxnet_tpu/gluon/contrib/rnn``): ``Conv2DLSTMCell``."""
from .conv_rnn_cell import Conv2DLSTMCell
