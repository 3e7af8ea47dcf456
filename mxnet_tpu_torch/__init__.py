"""mxnet_tpu_torch: the PyTorch/CUDA port of ``mxnet_tpu``, for NVIDIA
Hopper (H100) cards.

The JAX package ``mxnet_tpu`` stays the reference; this package mirrors
its module paths (``mxnet_tpu_torch/serving/decode.py`` is the
counterpart of ``mxnet_tpu/serving/decode.py``, and so on), imports
``torch`` and numpy, and never imports ``jax`` or ``mxnet_tpu``.  Every
Pallas kernel of the JAX package on a ported path becomes a CUDA kernel
written by hand for ``sm_90a`` (``csrc/``), with a plain PyTorch version
beside it that the tests hold it against.

Ported so far (ROADMAP.md):

* the serving slice — paged-KV continuous-batching decode of the
  transformer LM (``models.transformer.get_decode_step`` ->
  ``serving.decode.DecodeProgram`` -> ``serving.decode.DecodeEngine``)
  with the decode-attention and int8/int4 quantized-matmul kernels;
* the training slice — the LM's Symbol graph trained on one card
  (``models.transformer.get_symbol`` -> ``parallel.ShardedTrainer`` ->
  ``init_state`` -> ``step``) with the flash-attention forward, dQ and
  dK/dV kernels;
* the recommender slice — the DLRM-style click predictor trained over the
  sparse embedding plane on one card (``sparse.ShardedEmbedding`` ->
  ``sparse.recommender_state`` -> ``sparse.make_recommender_step``) with
  the embedding gather and sorted-id scatter kernels;
* the Module slice — the classic MXNet API (``mx.mod.Module(net,
  compression_params=...)``, ``mx.io.NDArrayIter``,
  ``mx.kv.create("device")``, ``Module.fit``) training the LM on one card,
  with the kvstore's two-bit gradient compression kernel;
* the imperative slice -- ``mx.nd`` arrays and the general op modules
  (creation, elementwise, broadcast and reduce, matrix, random),
  ``mx.random``, ``mx.engine``, ``nd.save`` / ``nd.load`` in the
  reference's byte format, and ``mx.rtc.CudaModule``, which compiles a
  user's CUDA source with NVRTC for ``sm_90a`` and launches its kernels
  over NDArrays.

Entry points run on the card unless the caller passes ``device="cpu"``
(``context=mx.cpu()`` for a Module).  The MXNet namespaces (``mx.nd``,
``mx.sym``, ``mx.kv``, ``mx.io``, ``mx.mod``, ``mx.metric``, ``mx.init``,
``mx.optimizer``, ``mx.lr_scheduler``, ``mx.callback``, ``mx.random``,
``mx.rtc``, ``mx.engine``, ``mx.cpu`` / ``mx.gpu``) are loaded on
first use, so ``import mxnet_tpu_torch`` imports no torch.
"""
import importlib as _importlib

from .base import DeviceUnavailable, MXNetError, NotPortedYet

__all__ = ["MXNetError", "DeviceUnavailable", "NotPortedYet", "nd", "sym",
           "kv", "io", "mod", "metric", "init", "optimizer", "lr_scheduler",
           "callback",
           "model", "random", "rtc", "engine", "cpu", "gpu", "Context",
           "current_context"]

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
         "Context": ("context", "Context"),
         "current_context": ("context", "current_context")}


def __getattr__(name):
    if name not in _LAZY:
        raise AttributeError("module %r has no attribute %r"
                             % (__name__, name))
    mod_name, attr = _LAZY[name]
    mod = _importlib.import_module("." + mod_name, __name__)
    return mod if attr is None else getattr(mod, attr)
