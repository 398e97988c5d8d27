"""Multi-rank MPPI: rollouts sharded over the ranks of a process group (port
of ``autorally_tpu/parallel/sharded.py``).

The scalable axis of MPPI is K (samples): embarrassingly parallel except
for the reductions of each iteration.  Each rank:

1. draws its own noise by folding its shard index into the iteration's
   subkey (``kernel_rng.fold_in``): in the host-noise mode the PyTorch
   generator seeded with those 64 bits, (T, K_local, C); in the capacity
   mode the kernels' key;
2. runs the same kernels as the single-device solver on its K/N shard, at
   the global ``k_offset = idx * K_local``, so that rollout 0 and the
   pure-noise band follow the global numbering (the kernels'
   ``_pure_thresh(cfg, k_offset)`` takes the global K);
3. joins two all-reduces: a MIN for the cost baseline, then one SUM of a
   packed buffer (4 + T*C floats): eta, sum w^2, sum of the costs, the
   crash count and the (T, C) weighted-control numerator (in the capacity
   mode pass 2's, summed before the division by the global eta).

``mean_cost`` and ``crash_frac`` divide by the global K.  Savitzky-Golay
and the nominal trajectory run on every rank from the same reduced U, so
every rank holds the same controller state.  On a one-rank mesh, unless
``force_collectives`` is set, the body runs inline with identity
reductions, as the JAX package runs it without ``shard_map``: the shard
key is still ``fold_in(subkey, 0)``, and the result equals the
collectives' bit for bit.

The split of a solve into ``_draw`` and ``_solve_drawn`` is
``MPPISolver``'s, so that a sharded solve can later be captured as a CUDA
graph on NCCL.

Collectives run over whatever backend the process group was created with:
NCCL where each rank has a card of its own, gloo for CPU ranks and for
ranks that share one card (``parallel/launch.py`` holds that rule).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from autorally_tpu_torch.config import CostParams, MPPIConfig, effective_gamma
from autorally_tpu_torch.costs.mppi_cost import MPPICost
from autorally_tpu_torch.ops import kernel_rng
from autorally_tpu_torch.ops import rollout_kernel as rk
from autorally_tpu_torch.parallel.mesh import ROLLOUT_AXIS, Mesh, rollout_mesh
from autorally_tpu_torch.solver.mppi import MPPISolver, SolveStats


class ShardedMPPISolver(MPPISolver):
    """MPPI with rollouts sharded across one mesh axis of ranks.

    Drop-in replacement for :class:`MPPISolver` on every rank: the same
    ``solve``/``slide`` API and semantics, K/N rollouts a rank."""

    def __init__(self, model, cost: MPPICost, cfg: MPPIConfig,
                 mesh: Optional[Mesh] = None, axis_name: str = ROLLOUT_AXIS,
                 force_collectives: bool = False, device=None):
        self.mesh = rollout_mesh() if mesh is None else mesh
        self.axis_name = axis_name
        self.n_shards = self.mesh.shape[axis_name]
        if cfg.num_rollouts % self.n_shards:
            raise ValueError(
                f"num_rollouts {cfg.num_rollouts} not divisible by "
                f"{self.n_shards} shards")
        if force_collectives and not self.mesh.has_collectives:
            raise ValueError("force_collectives needs a mesh over an "
                             "initialised process group")
        # One shard needs no collective; force_collectives keeps them
        # reachable for the tools' overhead forensics (scaling_bench).
        self._inline_body = self.n_shards == 1 and not force_collectives
        self._reduce_axes = (axis_name,)
        super().__init__(model, cost, cfg, device=device)

    # ------------------------------------------------------------------
    # this rank's shard
    # ------------------------------------------------------------------

    def _local_rollouts(self) -> int:
        return self.cfg.num_rollouts // self.n_shards

    def _shard_index(self) -> int:
        return 0 if self._inline_body else self.mesh.index(self.axis_name)

    def _k_offset(self) -> int:
        """The global index of this shard's first rollout."""
        return self._shard_index() * self._local_rollouts()

    def _shard_key(self, sub: np.ndarray) -> np.ndarray:
        """This shard's key of the iteration's subkey ``sub``."""
        return kernel_rng.fold_in(sub, self._shard_index())

    def _shard_ops(self):
        """(pmin, psum) over the mesh: the identity on the inline path."""
        if self._inline_body:
            return (lambda x: x), (lambda x: x)
        axes = self._reduce_axes
        return (lambda x: self.mesh.all_reduce(x, "min", axes),
                lambda x: self.mesh.all_reduce(x, "sum", axes))

    def _shard_params(self, model_params):
        """(params, packed weights) of this shard's launches."""
        return model_params, None

    # ------------------------------------------------------------------
    # one iteration
    # ------------------------------------------------------------------

    def _draw(self, costmap, sub: np.ndarray):
        """This shard's randomness of the subkey ``sub``: the kernels' key
        in the capacity mode, else the shard's noise (T, K_local, C)."""
        if self._use_kernel_rng(costmap):
            return self._device_key(self._shard_key(sub))
        return self._shard_noise(sub)

    def _shard_noise(self, sub: np.ndarray) -> torch.Tensor:
        """This shard's host noise (T, K_local, C): the generator seeded
        with the shard's key."""
        return self._sample_noise(
            self._noise_generator(self._shard_key(sub)),
            (self.cfg.num_timesteps, self._local_rollouts(),
             self.model.CONTROL_DIM))

    def _iterate_drawn(self, model_params, cost_params: CostParams, costmap,
                       state: torch.Tensor, U: torch.Tensor, draw
                       ) -> Tuple[torch.Tensor, SolveStats]:
        if self._use_kernel_rng(costmap):
            rollouts = self._shard_rng_rollouts
        else:
            rollouts = self._shard_rollouts
        total, crash, numer = rollouts(model_params, cost_params, costmap,
                                       state, U, draw)
        return self._combine(cost_params, total, crash, numer)

    def _sharded_iterate(self, model_params, cost_params: CostParams,
                         costmap, state: torch.Tensor, U: torch.Tensor,
                         key: np.ndarray) -> Tuple[torch.Tensor, SolveStats]:
        """One host-noise iteration keyed by the subkey ``key``: (U_new
        (T, C), stats), equal on every rank."""
        total, crash, numer = self._shard_rollouts(
            model_params, cost_params, costmap, state, U,
            self._shard_noise(key))
        return self._combine(cost_params, total, crash, numer)

    def _sharded_rng_iterate(self, model_params, cost_params: CostParams,
                             costmap, state: torch.Tensor, U: torch.Tensor,
                             key: np.ndarray
                             ) -> Tuple[torch.Tensor, SolveStats]:
        """One capacity-mode iteration keyed by the subkey ``key``: each
        rank's passes draw the stream of its folded key at its
        ``k_offset``."""
        total, crash, numer = self._shard_rng_rollouts(
            model_params, cost_params, costmap, state, U,
            self._device_key(self._shard_key(key)))
        return self._combine(cost_params, total, crash, numer)

    def _shard_rollouts(self, model_params, cost_params, costmap, state, U,
                        eps):
        """This shard's (costs (K_local,), crash, numer) from its noise,
        ``numer(w)`` the (T, C) weighted sum of its controls."""
        params, packed = self._shard_params(model_params)
        total, u_seq, crash = self.rollout_costs(
            params, cost_params, costmap, state, U, eps,
            k_offset=self._k_offset(), packed_weights=packed)
        return total, crash, lambda w: torch.einsum("k,ctk->tc", w, u_seq)

    def _shard_rng_rollouts(self, model_params, cost_params, costmap, state,
                            U, key):
        """Pass 1 on this shard's slice; ``numer(w)`` is pass 2's (T, C)."""
        total, crash, ctx = rk.fused_rng_costs(
            self.model, model_params, self.cfg, cost_params, costmap, state,
            U, key, l1_cost=self.cost.l1_cost, k_offset=self._k_offset(),
            K_local=self._local_rollouts(),
            **self._obstacle_kwargs(cost_params))
        return total, crash, lambda w: rk.fused_rng_numer(ctx, w).T

    def _combine(self, cost_params: CostParams, total: torch.Tensor,
                 crash: torch.Tensor, numer
                 ) -> Tuple[torch.Tensor, SolveStats]:
        """The softmax update across shards: the baseline a MIN, then eta,
        sum w^2, the costs' sum, the crash count and the numerator in one
        SUM.  At one shard each value is ``MPPISolver.iterate``'s, bit for
        bit."""
        pmin, psum = self._shard_ops()
        baseline = pmin(torch.min(total).reshape(1))[0]
        w = torch.exp(-effective_gamma(self.cfg, cost_params)
                      * (total - baseline))
        local = numer(w)                                       # (T, C)
        sums = psum(torch.cat([
            torch.stack([torch.sum(w), torch.sum(w * w), torch.sum(total),
                         torch.sum(crash.to(torch.float32))]),
            local.reshape(-1)]))
        eta, sum_w2, sum_total, n_crash = sums[0], sums[1], sums[2], sums[3]
        K = self.cfg.num_rollouts
        U_new = sums[4:].reshape(local.shape) / eta
        return U_new, SolveStats(
            baseline=baseline, normalizer=eta,
            trajectory_cost=sum_w2 / eta, ess=(eta * eta) / sum_w2,
            mean_cost=sum_total / K, crash_frac=n_crash / K)
