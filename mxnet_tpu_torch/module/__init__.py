"""``mx.mod`` namespace (port of ``mxnet_tpu/module``): ``Module`` over
one card.  ``BucketingModule``, ``SequentialModule`` and the Python
modules wait (ROADMAP A4)."""
from .base_module import BaseModule
from .executor_group import DataParallelExecutorGroup
from .module import Module

__all__ = ["BaseModule", "DataParallelExecutorGroup", "Module"]
