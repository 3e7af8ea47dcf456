"""``mx.mod`` namespace (port of ``mxnet_tpu/module``): ``Module`` over
one card, ``BucketingModule`` over shared parameters,
``SequentialModule`` and the Python modules."""
from .base_module import BaseModule
from .bucketing_module import BucketingModule
from .executor_group import DataParallelExecutorGroup
from .module import Module
from .python_module import PythonLossModule, PythonModule
from .sequential_module import SequentialModule

__all__ = ["BaseModule", "BucketingModule", "DataParallelExecutorGroup",
           "Module", "PythonLossModule", "PythonModule", "SequentialModule"]
