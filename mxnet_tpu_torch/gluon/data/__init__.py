"""``mx.gluon.data`` (port of ``mxnet_tpu/gluon/data``; reference
python/mxnet/gluon/data/): datasets, samplers, the ``DataLoader`` and the
vision datasets and transforms.  Samples and batches are host arrays;
the loader's batches are in pinned memory."""
from .dataset import (ArrayDataset, Dataset, RecordFileDataset,  # noqa: F401
                      SimpleDataset)
from .dataloader import DataLoader  # noqa: F401
from .sampler import (BatchSampler, RandomSampler, Sampler,  # noqa: F401
                      SequentialSampler)
from . import vision  # noqa: F401
