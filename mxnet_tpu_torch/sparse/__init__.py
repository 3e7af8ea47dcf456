"""The sparse plane (port of ``mxnet_tpu/sparse``): embedding tables over
a mesh axis, touched-rows compute.

Lookups are owner-shard routing, gradients are deduped and applied by
lazy SGD/Adam that touch only the routed rows; the shard-local halves are
the hand-written CUDA gather (B5) and sorted-id scatter (B6) kernels
(``csrc/embedding.cu``).  Over a dp mesh of several ranks the routing
crosses processes through ``all_to_all_single``
(:func:`~mxnet_tpu_torch.sparse.embedding._a2a`).
"""
from .embedding import (ShardedEmbedding, live_tables, lookup_wire_bytes,
                        step_alltoall_model_bytes)
from .kernels import (embed_backend, embedding_gather, embedding_scatter,
                      tune_embedding)
from .step import (init_mlp, lower_step, make_recommender_step,
                   recommender_state)

__all__ = ["ShardedEmbedding", "live_tables", "lookup_wire_bytes",
           "step_alltoall_model_bytes", "embed_backend",
           "embedding_gather", "embedding_scatter", "tune_embedding",
           "init_mlp", "lower_step", "make_recommender_step",
           "recommender_state"]
