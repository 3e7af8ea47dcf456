"""``mx.io`` namespace (port of ``mxnet_tpu/io``): the in-memory, file
and decorating iterators and their batch types, and the image record
iterators of ``mx.image`` (loaded on first use)."""
from .io import (CSVIter, DataBatch, DataDesc, DataIter, LibSVMIter,
                 MNISTIter, NDArrayIter, PrefetchingIter, ResizeIter)

__all__ = ["CSVIter", "DataBatch", "DataDesc", "DataIter", "LibSVMIter",
           "MNISTIter", "NDArrayIter", "PrefetchingIter", "ResizeIter",
           "ImageRecordIter", "ImageRecordUInt8Iter"]


def ImageRecordIter(*args, **kwargs):  # noqa: N802 (reference name)
    """``mx.image.ImageRecordIter`` (reference iter_image_recordio_2.cc)."""
    from ..image.record_iter import ImageRecordIter as _IRI
    return _IRI(*args, **kwargs)


def ImageRecordUInt8Iter(*args, **kwargs):  # noqa: N802 (reference name)
    """``mx.image.ImageRecordUInt8Iter``: the same pipeline."""
    from ..image.record_iter import ImageRecordUInt8Iter as _IRI
    return _IRI(*args, **kwargs)
