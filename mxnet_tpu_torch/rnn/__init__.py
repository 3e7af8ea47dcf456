"""``mx.rnn`` (port of ``mxnet_tpu/rnn``): the bucketed sentence iterator.
The recurrent cells and ``rnn.rnn``'s checkpoint helpers wait for ROADMAP
queue A item 4 (the rest of the ops and their namespaces) and raise
:class:`~mxnet_tpu_torch.base.NotPortedYet`."""
from ..base import NotPortedYet
from .io import BucketSentenceIter, encode_sentences

__all__ = ["BucketSentenceIter", "encode_sentences"]

_LATER = ("BaseRNNCell", "BidirectionalCell", "DropoutCell", "FusedRNNCell",
          "GRUCell", "LSTMCell", "ModifierCell", "ResidualCell", "RNNCell",
          "RNNParams", "SequentialRNNCell", "ZoneoutCell",
          "do_rnn_checkpoint", "load_rnn_checkpoint", "save_rnn_checkpoint")


def __getattr__(name):
    if name in _LATER:
        raise NotPortedYet("mx.rnn.%s is not ported yet (ROADMAP queue A "
                           "item 4, the rest of the ops and their "
                           "namespaces)" % name)
    raise AttributeError("module %r has no attribute %r" % (__name__, name))
