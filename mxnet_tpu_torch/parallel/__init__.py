"""Training over a device mesh (port of ``mxnet_tpu/parallel``): so far a
one-device mesh (:mod:`.mesh`), the single-program trainer
(:mod:`.trainer`), ``as_mesh`` (:mod:`.placement`) and the runtime
collective trail (:mod:`.audit`).  Meshes of more than one device (dp
over NCCL, tp) are ROADMAP queue A5."""
from .mesh import MeshSpec, make_mesh
from .trainer import ShardedTrainer

__all__ = ["MeshSpec", "make_mesh", "ShardedTrainer"]
