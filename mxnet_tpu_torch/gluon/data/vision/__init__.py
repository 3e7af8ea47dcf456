"""Vision datasets and transforms (port of
``mxnet_tpu/gluon/data/vision``; reference
python/mxnet/gluon/data/vision/)."""
from .datasets import (MNIST, FashionMNIST, CIFAR10, CIFAR100,  # noqa: F401
                       ImageRecordDataset, ImageFolderDataset)
from . import transforms  # noqa: F401
