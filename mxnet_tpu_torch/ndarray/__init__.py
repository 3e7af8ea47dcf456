"""``mx.nd`` namespace (port of ``mxnet_tpu/ndarray``): the NDArray and
the creation functions the Module/KVStore path needs.  The JAX package's
other names (``ones``, ``full``, ``arange``, ``save``, ``load``, the op
wrappers, ``sparse``, ...) raise
:class:`~mxnet_tpu_torch.base.NotPortedYet` when asked for (ROADMAP A2)."""
from ..base import NotPortedYet as _NotPortedYet
from .ndarray import NDArray, array, empty, invoke_with_arrays, zeros

__all__ = ["NDArray", "array", "empty", "invoke_with_arrays", "zeros"]


def __getattr__(name):
    if name.startswith("__"):
        raise AttributeError(name)
    raise _NotPortedYet("mx.nd.%s is not ported yet (ROADMAP A2)" % name)
