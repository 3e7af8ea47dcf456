"""``mx.contrib.ndarray`` (port of ``mxnet_tpu/contrib/ndarray.py``):
every registered op of the port as an NDArray function."""
import sys as _sys

from ..ndarray.ndarray import populate_module as _populate

_populate(_sys.modules[__name__])
