"""The sparse plane (port of ``mxnet_tpu/sparse``): embedding tables over
a mesh axis, touched-rows compute.

Lookups are owner-shard routing, gradients are deduped and applied by
lazy SGD/Adam that touch only the routed rows; the shard-local halves are
the hand-written CUDA gather (B5) and sorted-id scatter (B6) kernels
(``csrc/embedding.cu``).  On one device so far: routing across devices
waits for NCCL collectives (ROADMAP queue A11).
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
