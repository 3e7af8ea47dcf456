"""``mx.io`` namespace (port of ``mxnet_tpu/io``): the in-memory, file
and decorating iterators and their batch types."""
from .io import (CSVIter, DataBatch, DataDesc, DataIter, LibSVMIter,
                 MNISTIter, NDArrayIter, PrefetchingIter, ResizeIter)

__all__ = ["CSVIter", "DataBatch", "DataDesc", "DataIter", "LibSVMIter",
           "MNISTIter", "NDArrayIter", "PrefetchingIter", "ResizeIter"]
