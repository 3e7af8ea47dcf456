"""Text utilities: token counting, vocabulary indexing, token embeddings
(port of ``mxnet_tpu/contrib/text``; reference
python/mxnet/contrib/text/)."""
from . import embedding
from . import utils
from . import vocab
from .vocab import Vocabulary
