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
  the embedding gather and sorted-id scatter kernels.

Entry points run on the card unless the caller passes ``device="cpu"``.
"""
from .base import DeviceUnavailable, MXNetError, NotPortedYet

__all__ = ["MXNetError", "DeviceUnavailable", "NotPortedYet"]
