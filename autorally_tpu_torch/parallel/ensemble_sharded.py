"""Ensemble-sharded MPPI: a 2-D (ensemble, rollouts) mesh of ranks (port of
``autorally_tpu/parallel/ensemble_sharded.py``).

The M ensemble members' parameter sets shard across the ``ensemble`` axis:
rank (e, r) evaluates member e alone, and only member e's weights are
packed for its kernels (``rk.pack_member``).  Each member's share of the
rollouts shards further across the ``rollouts`` axis.  Globally the K
rollouts are M contiguous member blocks, as
:class:`~autorally_tpu_torch.models.ensemble.EnsembleDynamics` lays them
out on one device, so rank (e, r) runs rollouts from
``k_offset = e*K/M + r*K_local`` and the noise-free rollout and the
pure-noise band keep their global meaning.  Its noise is
``fold_in(fold_in(subkey, e), r)``.

The reductions are the 1-D solver's (a MIN, then one SUM), over both
axes: the MPPI update is a flat importance-weighted average whichever
member produced a rollout.  The nominal trajectory runs under member 0 on
every rank.  Host noise only, as in the JAX package.
"""

from __future__ import annotations

import types

from autorally_tpu_torch.config import MPPIConfig
from autorally_tpu_torch.costs.mppi_cost import MPPICost
from autorally_tpu_torch.models.ensemble import member_params
from autorally_tpu_torch.ops import kernel_rng
from autorally_tpu_torch.ops import rollout_kernel as rk
from autorally_tpu_torch.parallel.mesh import Mesh
from autorally_tpu_torch.parallel.sharded import ShardedMPPISolver
from autorally_tpu_torch.solver.mppi import MPPISolver

ENSEMBLE_AXIS = "ensemble"
ROLLOUT_AXIS = "rollouts"


class EnsembleShardedMPPISolver(ShardedMPPISolver):
    """MPPI over an M-member ensemble on a 2-D mesh.

    ``model`` is the base (single-member) model; ``solve`` takes the
    stacked params (leading axis M).  Member m evaluates rollouts
    [m*K/M, (m+1)*K/M); member 0 owns the noise-free rollout and the
    nominal trajectory."""

    def __init__(self, model, cost: MPPICost, cfg: MPPIConfig, mesh: Mesh,
                 ensemble_axis: str = ENSEMBLE_AXIS,
                 rollout_axis: str = ROLLOUT_AXIS, device=None):
        self.mesh = mesh
        self.ensemble_axis = ensemble_axis
        self.rollout_axis = rollout_axis
        self.num_members = mesh.shape[ensemble_axis]
        self.n_rollout_shards = mesh.shape[rollout_axis]
        n_total = self.num_members * self.n_rollout_shards
        if cfg.num_rollouts % n_total:
            raise ValueError(
                f"num_rollouts {cfg.num_rollouts} not divisible by "
                f"{n_total} (= {self.num_members} members x "
                f"{self.n_rollout_shards} rollout shards)")
        self.n_shards = n_total
        self._inline_body = not mesh.has_collectives
        self._reduce_axes = (ensemble_axis, rollout_axis)
        # the one-slot weight packs: this rank's member, and member 0's for
        # the nominal trajectory
        self._member_owner = types.SimpleNamespace()
        self._nominal_owner = types.SimpleNamespace()
        MPPISolver.__init__(self, model, cost, cfg, device=device)

    def _coords(self):
        """(e, r): this rank's member and rollout shard."""
        if self._inline_body:
            return 0, 0
        return (self.mesh.index(self.ensemble_axis),
                self.mesh.index(self.rollout_axis))

    def _k_offset(self) -> int:
        e, r = self._coords()
        return (e * (self.cfg.num_rollouts // self.num_members)
                + r * self._local_rollouts())

    def _shard_key(self, sub):
        e, r = self._coords()
        return kernel_rng.fold_in(kernel_rng.fold_in(sub, e), r)

    def _member_pack(self, stacked_params, m: int, owner):
        """Member m's kernel weights (None without a kernel form)."""
        if not self.kernel_form:
            return None
        return rk.pack_member(self.model, stacked_params, m, owner)

    def _shard_params(self, stacked_params):
        e, _ = self._coords()
        return (member_params(stacked_params, e),
                self._member_pack(stacked_params, e, self._member_owner))

    def _use_kernel_rng(self, costmap) -> bool:
        return False

    def nominal_trajectory(self, stacked_params, state, U,
                           packed_weights=None):
        """Re-rollout under the canonical member (member 0)."""
        return super().nominal_trajectory(
            member_params(stacked_params, 0), state, U,
            packed_weights=self._member_pack(stacked_params, 0,
                                             self._nominal_owner))
