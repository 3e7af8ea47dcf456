"""Engine controls (port of ``mxnet_tpu/engine.py``; reference
python/mxnet/engine.py).

The reference bundles small engine ops to cut dispatch overhead
(MXEngineSetBulkSize).  PyTorch runs each op eagerly on the card's
stream and has no engine queue to bundle, so, as in the JAX package, the
size is recorded (:func:`current_bulk_size`) and is advisory: scripts
with ``with mx.engine.bulk(n):`` run unchanged.
"""
__all__ = ["set_bulk_size", "bulk", "current_bulk_size"]

_bulk_size = 15   # the reference default (MXNET_ENGINE_BULK_SIZE)


def set_bulk_size(size):
    """Record the bulk-size hint; returns the previous value (reference
    engine.py:26)."""
    global _bulk_size
    prev, _bulk_size = _bulk_size, int(size)
    return prev


def current_bulk_size():
    return _bulk_size


class _BulkScope:
    def __init__(self, size):
        self._size = size
        self._old = None

    def __enter__(self):
        self._old = set_bulk_size(self._size)
        return self

    def __exit__(self, *a):
        set_bulk_size(self._old)


def bulk(size):
    """Scope form: ``with mx.engine.bulk(16): ...`` (reference
    engine.py:63)."""
    return _BulkScope(size)
