"""Training over a device mesh (port of ``mxnet_tpu/parallel``): so far a
one-device mesh (:mod:`.mesh`), the single-program trainer
(:mod:`.trainer`), ``as_mesh`` (:mod:`.placement`), the runtime
collective trail (:mod:`.audit`) and ``allreduce_row_sparse`` in one
process.  Meshes of more than one device (dp over NCCL, tp) and the
collectives across processes are ROADMAP queue A item 7."""
from .mesh import MeshSpec, make_mesh
from .trainer import ShardedTrainer

__all__ = ["MeshSpec", "make_mesh", "ShardedTrainer", "allreduce_row_sparse"]


def allreduce_row_sparse(rs):
    """The union-sum of a RowSparseNDArray over the processes (reference
    kvstore_dist_server.h:223): in one process ``rs`` itself, as in the
    JAX package; across processes it raises ``NotPortedYet`` (queue A
    item 7, distribution)."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized() and \
            dist.get_world_size() > 1:
        from ..base import NotPortedYet
        raise NotPortedYet("allreduce_row_sparse across %d processes: the "
                           "collectives are ROADMAP queue A item 7, "
                           "distribution" % dist.get_world_size())
    return rs
