"""``mx.rnn`` (port of ``mxnet_tpu/rnn``; reference python/mxnet/rnn/):
the symbolic cells (``FusedRNNCell`` over the ``RNN`` op, cuDNN on the
card), the fused-weight-aware checkpoint helpers and the bucketed
sentence iterator."""
from .rnn_cell import (BaseRNNCell, BidirectionalCell, DropoutCell,
                       FusedRNNCell, GRUCell, LSTMCell, ModifierCell,
                       ResidualCell, RNNCell, RNNParams, SequentialRNNCell,
                       ZoneoutCell)
from .rnn import (do_rnn_checkpoint, load_rnn_checkpoint,
                  save_rnn_checkpoint)
from .io import BucketSentenceIter, encode_sentences

__all__ = ["BaseRNNCell", "BidirectionalCell", "DropoutCell",
           "FusedRNNCell", "GRUCell", "LSTMCell", "ModifierCell",
           "ResidualCell", "RNNCell", "RNNParams", "SequentialRNNCell",
           "ZoneoutCell", "do_rnn_checkpoint", "load_rnn_checkpoint",
           "save_rnn_checkpoint", "BucketSentenceIter", "encode_sentences"]
