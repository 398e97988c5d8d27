"""Multi-rank sharding: rank meshes and the sharded MPPI solvers over
``torch.distributed`` (port of ``autorally_tpu/parallel``)."""

from autorally_tpu_torch.parallel.mesh import make_mesh, rollout_mesh
from autorally_tpu_torch.parallel.sharded import ShardedMPPISolver
from autorally_tpu_torch.parallel.ensemble_sharded import \
    EnsembleShardedMPPISolver

__all__ = ["make_mesh", "rollout_mesh", "ShardedMPPISolver",
           "EnsembleShardedMPPISolver"]
