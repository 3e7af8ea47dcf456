"""``mx.gluon.contrib.data`` (port of ``mxnet_tpu/gluon/contrib/data``;
reference gluon/contrib/data)."""
from .sampler import IntervalSampler  # noqa: F401
