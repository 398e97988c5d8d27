"""Single-device M-member ensemble MPPI through the base model's kernels
(port of ``autorally_tpu/solver/ensemble.py``).

:class:`~autorally_tpu_torch.models.ensemble.EnsembleDynamics` evaluates
the K rollouts in M contiguous member blocks, but it has no in-kernel form
(``KERNEL_KIND`` is ``None``), so an ``MPPISolver`` over it runs the plain
chain.  :class:`EnsembleMPPISolver` keeps the block semantics and
decomposes the rollouts at the launcher: member m's K/M block runs through
the base model's fused kernel (kernel 1 on the exact ``Costmap``, kernel 3
on a field; with a cost subclass, kernel 2 and the cost epilogue) with
member m's weights and ``k_offset = m*K/M``, and the per-member results
concatenate before the softmax update.  A solve is M launches and the
nominal trajectory's one, with no host round trip, so that the episode and
the async tick capture it as they capture ``MPPISolver``'s.  This is the
single-device row of BASELINE config #5 (the 8-model ensemble).

The members' weights are packed once per stacked set into one (M, 1,412)
buffer (``rk.pack_members``, kept on the solver's ``EnsembleDynamics``),
and member m's launches take its row: the kernels' one-slot pack cache on
the base model would otherwise repack at every launch.

Global numbering is the reference protocol's: rollout 0 (member 0's first)
is noise-free and the last 1% of the *global* K are pure noise
(``mppi_controller.cu:130-155``), because ``cfg.num_rollouts`` stays the
global K and each member call takes the true global ``k_offset``.  The JAX
package's ``_MemberSolver`` exists to key the TPU kernels' lane-alignment
choice off K/M; the CUDA kernels take any K, so the members run through a
plain ``MPPISolver`` of the base model.
"""

from __future__ import annotations

from typing import Tuple

import torch

from autorally_tpu_torch.config import CostParams, MPPIConfig
from autorally_tpu_torch.costs.mppi_cost import MPPICost
from autorally_tpu_torch.models.ensemble import (EnsembleDynamics,
                                                 member_params)
from autorally_tpu_torch.ops import rollout_kernel as rk
from autorally_tpu_torch.solver.mppi import MPPISolver


class EnsembleMPPISolver(MPPISolver):
    """MPPI over M stacked parameter sets, one kernel launch a member.

    ``solve`` takes the stacked params (leading axis M,
    :func:`~autorally_tpu_torch.models.ensemble.stack_params`).  Member m
    evaluates rollouts [m*K/M, (m+1)*K/M); the nominal trajectory and the
    constraint ranges use member 0, as :class:`EnsembleDynamics` does."""

    def __init__(self, base, cost: MPPICost, cfg: MPPIConfig,
                 num_members: int, device=None):
        if cfg.num_rollouts % num_members:
            raise ValueError(
                f"num_rollouts {cfg.num_rollouts} not divisible by "
                f"ensemble size {num_members}")
        self.num_members = int(num_members)
        self._base_solver = MPPISolver(base, cost, cfg, device=device)
        super().__init__(EnsembleDynamics(base, num_members), cost, cfg,
                         device=device)

    def _member_packs(self, stacked_params):
        """Each member's weight buffer (rows of one pack, kept on the
        ensemble model), or None each without a kernel form."""
        base = self._base_solver
        if not base.kernel_form:
            return [None] * self.num_members
        return rk.pack_members(base.model, stacked_params, owner=self.model)

    def rollout_costs(self, stacked_params, cost_params: CostParams, costmap,
                      state: torch.Tensor, U: torch.Tensor,
                      eps: torch.Tensor, k_offset=0, packed_weights=None
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """:meth:`MPPISolver.rollout_costs` member block by member block,
        concatenated along K: (costs (K,), u_seq (C, T, K), crash (K,))."""
        M = self.num_members
        K = eps.shape[1]
        if K % M:
            raise ValueError(f"batch {K} not divisible by ensemble {M}")
        K_m = K // M
        packs = self._member_packs(stacked_params)
        totals, u_seqs, crashes = zip(*(
            self._base_solver.rollout_costs(
                member_params(stacked_params, m), cost_params, costmap,
                state, U, eps[:, m * K_m:(m + 1) * K_m].contiguous(),
                k_offset=k_offset + m * K_m, packed_weights=packs[m])
            for m in range(M)))
        return (torch.cat(totals), torch.cat(u_seqs, dim=2),
                torch.cat(crashes))

    def nominal_trajectory(self, stacked_params, state: torch.Tensor,
                           U: torch.Tensor, packed_weights=None):
        """Re-rollout under the canonical member (member 0)."""
        return self._base_solver.nominal_trajectory(
            member_params(stacked_params, 0), state, U,
            packed_weights=self._member_packs(stacked_params)[0])
