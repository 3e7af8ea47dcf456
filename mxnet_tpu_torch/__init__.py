"""mxnet_tpu_torch: the PyTorch/CUDA port of ``mxnet_tpu``, for NVIDIA
Hopper (H100) cards.

The JAX package ``mxnet_tpu`` stays the reference; this package mirrors
its module paths (``mxnet_tpu_torch/serving/decode.py`` is the
counterpart of ``mxnet_tpu/serving/decode.py``, and so on), imports
``torch`` and numpy, and never imports ``jax`` or ``mxnet_tpu``.  Every
Pallas kernel of the JAX package on a ported path becomes a CUDA kernel
written by hand for ``sm_90a`` (``csrc/``), with a plain PyTorch version
beside it that the tests hold it against.

Ported so far (ROADMAP.md), slice by slice:

* serving -- paged-KV continuous-batching decode of the transformer LM
  (``models.transformer.get_decode_step`` -> ``serving.decode.
  DecodeProgram`` -> ``DecodeEngine``) with the decode-attention and
  int8/int4 quantized-matmul kernels;
* training -- the LM's Symbol graph on one card (``get_symbol`` ->
  ``parallel.ShardedTrainer`` -> ``init_state`` -> ``step``) with the
  flash-attention forward, dQ and dK/dV kernels;
* the recommender over the sparse embedding plane
  (``sparse.ShardedEmbedding`` -> ``recommender_state`` ->
  ``make_recommender_step``) with the embedding gather and scatter
  kernels, on f32, bf16, f16 and f64 tables;
* the classic API: ``mx.mod.Module`` over ``mx.io.NDArrayIter`` and
  ``mx.kv.create("device")`` with the two-bit compression kernel (f32,
  f16, bf16, f64), every optimizer, ``lr_scheduler``, initializer and
  metric, checkpoints, ``BucketingModule`` over length buckets
  (``mx.rnn.BucketSentenceIter``), ``SequentialModule``, the Python
  modules, ``FeedForward``, the file and prefetching iterators, and
  remat (``set_backward_mirror``);
* the imperative API -- ``mx.nd`` arrays and the general op modules,
  ``mx.random``, ``mx.engine``, ``nd.save`` / ``nd.load`` in the
  reference's byte format, and ``mx.rtc.CudaModule``, which compiles a
  user's CUDA source with NVRTC for ``sm_90a``;
* conv nets -- the rest of ``ops/nn.py`` and the model zoo's conv nets
  (ResNet-50 on cuDNN) through ``ShardedTrainer`` and ``Module.fit``;
* bench.py's bf16 configuration and MXNet's float16 recipe
  (``param_dtype``, ``sgd_step_fn``, ``build_step_auto_layout``, the
  flash kernels in bf16 and f16);
* autograd and Gluon -- ``mx.autograd`` (``record``, ``backward``,
  ``Function``), ``mx.nd.contrib``, ``mx.contrib.autograd``, CustomOp
  (``mx.operator``), ``mx.gluon`` (blocks and ``hybridize``, parameters,
  ``Trainer``, the layers, losses and the vision model zoo) and
  ``mx.test_utils``;
* data IO -- ``mx.recordio``, ``mx.image`` (``ImageIter``,
  ``ImageRecordIter`` on the native libjpeg pipeline or PIL threads,
  ``ImageDetIter``), ``mx.gluon.data`` (datasets, samplers, vision
  transforms, ``DataLoader`` with worker processes) and
  ``mx.contrib.text``; batches are built in pinned host memory and go
  to the card without blocking the host.

Entry points run on the card unless the caller passes ``device="cpu"``
(``context=mx.cpu()`` for a Module).  The MXNet namespaces (``mx.nd``,
``mx.sym``, ``mx.kv``, ``mx.io``, ``mx.mod``, ``mx.metric``, ``mx.init``,
``mx.optimizer``, ``mx.lr_scheduler``, ``mx.callback``, ``mx.random``,
``mx.rtc``, ``mx.engine``, ``mx.autograd``, ``mx.gluon``,
``mx.contrib``, ``mx.operator``, ``mx.test_utils``, ``mx.image``,
``mx.recordio``, ``mx.cpu`` / ``mx.gpu``) are loaded on
first use, so ``import mxnet_tpu_torch`` imports no torch.
"""
import importlib as _importlib

from .base import DeviceUnavailable, MXNetError, NotPortedYet

__all__ = ["MXNetError", "DeviceUnavailable", "NotPortedYet", "nd", "sym",
           "kv", "io", "mod", "metric", "init", "optimizer", "lr_scheduler",
           "callback", "model", "random", "rtc", "engine", "cpu", "gpu",
           "cpu_pinned", "num_gpus", "Context", "current_context", "seed",
           "AttrScope", "Symbol", "Executor", "KVStore", "Optimizer",
           "FeedForward", "DataParallelExecutorManager",
           "set_backward_mirror", "backward_mirror_policy", "name",
           "attribute", "executor", "executor_manager", "rnn", "parallel",
           "sparse", "serving", "resilience", "telemetry", "autograd",
           "gluon", "contrib", "operator", "test_utils", "image",
           "recordio"]

# attribute -> (module, name in it or None for the module itself)
_LAZY = {"nd": ("ndarray", None), "ndarray": ("ndarray", None),
         "sym": ("symbol", None), "symbol": ("symbol", None),
         "kv": ("kvstore", None), "kvstore": ("kvstore", None),
         "io": ("io", None), "mod": ("module", None),
         "module": ("module", None), "metric": ("metric", None),
         "init": ("initializer", None), "initializer": ("initializer", None),
         "optimizer": ("optimizer", None),
         "lr_scheduler": ("lr_scheduler", None),
         "callback": ("callback", None),
         "model": ("model", None), "context": ("context", None),
         "random": ("random", None), "rtc": ("rtc", None),
         "engine": ("engine", None),
         "cpu": ("context", "cpu"), "gpu": ("context", "gpu"),
         "cpu_pinned": ("context", "cpu_pinned"),
         "num_gpus": ("context", "num_gpus"),
         "Context": ("context", "Context"),
         "current_context": ("context", "current_context"),
         "seed": ("rng", "seed"), "AttrScope": ("base", "AttrScope"),
         "Symbol": ("symbol", "Symbol"), "Executor": ("executor", "Executor"),
         "KVStore": ("kvstore", "KVStore"),
         "Optimizer": ("optimizer", "Optimizer"),
         "FeedForward": ("model", "FeedForward"),
         "DataParallelExecutorManager": ("executor_manager",
                                         "DataParallelExecutorManager"),
         "set_backward_mirror": ("executor", "set_backward_mirror"),
         "backward_mirror_policy": ("executor", "backward_mirror_policy"),
         "name": ("name", None), "attribute": ("attribute", None),
         "executor": ("executor", None),
         "executor_manager": ("executor_manager", None),
         "rnn": ("rnn", None), "parallel": ("parallel", None),
         "sparse": ("sparse", None), "serving": ("serving", None),
         "resilience": ("resilience", None),
         "telemetry": ("telemetry", None),
         "autograd": ("autograd", None), "gluon": ("gluon", None),
         "contrib": ("contrib", None), "operator": ("operator", None),
         "test_utils": ("test_utils", None),
         "image": ("image", None), "recordio": ("recordio", None)}


def __getattr__(name):
    if name not in _LAZY:
        raise AttributeError("module %r has no attribute %r"
                             % (__name__, name))
    mod_name, attr = _LAZY[name]
    mod = _importlib.import_module("." + mod_name, __name__)
    return mod if attr is None else getattr(mod, attr)
