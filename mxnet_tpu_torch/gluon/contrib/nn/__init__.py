"""Contrib layers (port of ``mxnet_tpu/gluon/contrib/nn``)."""
from .basic_layers import Concurrent, HybridConcurrent, Identity  # noqa: F401
