"""Attribute scoping (port of ``mxnet_tpu/attribute.py``; reference
python/mxnet/attribute.py): :class:`AttrScope` lives in :mod:`.base`."""
from .base import AttrScope  # noqa: F401

__all__ = ["AttrScope"]
