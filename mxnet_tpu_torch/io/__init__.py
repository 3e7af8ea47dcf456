"""``mx.io`` namespace (port of ``mxnet_tpu/io``): the in-memory
iterator and its batch types."""
from .io import DataBatch, DataDesc, DataIter, NDArrayIter

__all__ = ["DataBatch", "DataDesc", "DataIter", "NDArrayIter"]
