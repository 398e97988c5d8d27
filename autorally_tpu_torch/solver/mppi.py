"""Single-device MPPI solver (port of ``autorally_tpu/solver/mppi.py``).

One replan (``MPPIController::computeControl``, ``mppi_controller.cu:600-675``)
is: draw the noise, run the K rollouts with their costs (one launch of the
fused CUDA kernel), softmax-weight the sampled controls, smooth with the
Savitzky-Golay filter and re-roll the nominal trajectory (one launch of the
chain kernel).  Everything stays on the device; nothing in a solve waits
for the host.

The track surface is the exact ``Costmap`` (fused kernel A) or a
``NeuralCostmap`` field (fused kernel 3), as the JAX package dispatches
them.  A model with a kernel form (``KERNEL_KIND``: the MLP
``NeuralNetDynamics`` or the basis-function model
``BasisFunctionDynamics``, or a subclass that overrides none of what the
kernels replace, :func:`_kernel_form_consistent`) and the cost
``MPPICost`` or ``ObstacleCost``, whose circles (``CostParams.obstacles``
when set, else its own) the fused kernels price on every solve, take the
fused kernel, as the JAX package's ``_fusable_cost`` / ``_obstacle_kwargs``
route them.  The general path takes the rest, as the JAX package's
``rollout_costs`` does: the dynamics chain (kernel 2 at K for a model with
a kernel form, else the solver's plain PyTorch chain, the JAX package's
``lax.scan``), then a batched cost epilogue over (T-1, K) that dispatches
through the cost object, so that any ``MPPICost`` subclass prices its
rollouts.  ``cfg.use_pallas_rollout=True`` forces the kernel form for a
model whose ``KERNEL_KIND`` is set (the kernels then evaluate the declaring
class's math); ``None`` and ``False`` leave the choice to the model and
the cost.

``cfg.matmul_precision`` reaches the kernels that evaluate the dynamics of
the rollouts, as the JAX solver passes it to its Pallas kernels: kernel 1
or 3, kernel 2 at K on the general path and pass 1 (``"highest"`` and
``"high"`` in float32, ``"default"`` with bf16 operands in the products,
the instances of their own, ``ops/rollout_kernel.py``); the nominal
trajectory and the plain chain of a model without a kernel form stay
float32, as the JAX package's ``nominal_trajectory_pallas`` call and its
``lax.scan`` do.

With ``kernel_rng=True`` (the capacity mode) an iteration draws only a key
and runs the two kernel-RNG passes (``rk.fused_rng_solve_iteration``): the
noise is drawn inside the kernels, so neither eps nor u_seq (T x K x C
each) reaches device memory.  The dispatch (:meth:`MPPISolver._use_kernel_rng`)
keeps the JAX package's semantic gates: a model with a kernel form
(whatever its layer spec: on the card pass 1 runs from the spec's own
library, and raises for what it is not built for, never falling back to
host noise),
white or OU noise with theta in (0, 2), ``MPPICost`` or ``ObstacleCost``,
and a ``NeuralCostmap`` or the exact ``Costmap`` with ``exact_fused``;
anything else takes the host-noise path.
It drops the TPU-only gate of the VMEM budget of the exact map
(``exact_map_fits``), as the host-noise path dropped ``K % 128``: the CUDA
kernels take any K and read the map from device memory.  A cost subclass or
a model without a kernel form takes host noise, as in the JAX package.

Semantics follow the JAX package:

- rollout 0 is noise-free; the last 1% of rollouts are pure noise; the
  first ``optimization_stride`` timesteps are frozen
  (``mppi_controller.cu:130-155``);
- the weighted average uses the *unclamped* perturbed controls;
- the running-average cost starts at t=1 and the crash latch persists;
- weights ``exp(-gamma (c - min c))`` and the sum w^2 / eta trajectory cost;
- Savitzky-Golay smoothing with the 2-step control history and the
  receding-horizon slide (``mppi_controller.cu:469-568``);
- the ``ControllerState`` carries the JAX package's key (two uint32
  words); each iteration splits it as ``jax.random.split`` does, bit for
  bit, and the new key goes into the new state, so a solve leaves its
  input state as it was and one state replays one solve.  The capacity
  mode's kernels are keyed by the subkey that the JAX solve from the same
  state passes to its kernels; the host-noise mode seeds a PyTorch
  generator with it.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from autorally_tpu_torch.config import (CostParams, MPPIConfig,
                                        bf16_operands, cost_params_lanes,
                                        effective_gamma, lane_cost_params,
                                        resolve_device)
from autorally_tpu_torch.costs.costmap import Costmap
from autorally_tpu_torch.costs.mppi_cost import MPPICost
from autorally_tpu_torch.costs.neural_costmap import NeuralCostmap
from autorally_tpu_torch.costs.obstacles import ObstacleCost
from autorally_tpu_torch.ops import kernel_rng
from autorally_tpu_torch.ops import rollout_kernel as rk
from autorally_tpu_torch.ops.sampling import make_sampler

# 5-tap Savitzky-Golay coefficients (mppi_controller.cu:475-476).
SAVGOL_FILTER = np.array([-3.0, 12.0, 17.0, 12.0, -3.0],
                         dtype=np.float32) / 35.0


class SolveStats(NamedTuple):
    """Per-solve telemetry (scalar tensors, on the device until read)."""

    baseline: torch.Tensor          # min sampled cost
    normalizer: torch.Tensor        # eta = sum of weights
    trajectory_cost: torch.Tensor   # sum w^2 / eta  (mppi_controller.cu:646-652)
    ess: torch.Tensor               # effective sample size (sum w)^2 / sum w^2
    mean_cost: torch.Tensor         # mean sampled rollout cost
    crash_frac: torch.Tensor        # fraction of rollouts that crashed


class ControllerState(NamedTuple):
    """Everything the controller carries between replans."""

    U: torch.Tensor                 # (T, C) current control plan
    control_hist: torch.Tensor      # (2, C) executed-control history for SG
    state_solution: torch.Tensor    # (T, S) nominal trajectory
    control_solution: torch.Tensor  # (T, C) clamped executed plan
    key: np.ndarray                 # (2,) uint32: the JAX package's key data


def _kernel_form_consistent(model) -> bool:
    """True when the class that declared ``KERNEL_KIND`` also owns every
    method the in-kernel evaluator replaces.  A subclass that overrides
    ``dynamics``/``state_deriv``/etc. below the declaring class would have
    the kernels silently evaluate the BASE model's math, so it takes the
    plain chain (it can re-declare ``KERNEL_KIND`` and ``kernel_weights`` to
    opt back in, or force the kernels with ``cfg.use_pallas_rollout``)."""
    mro = type(model).__mro__
    kind_idx = next(i for i, c in enumerate(mro) if "KERNEL_KIND" in vars(c))
    for meth in ("dynamics", "state_deriv", "kinematics",
                 "enforce_constraints", "step", "kernel_weights",
                 "kernel_spec"):
        idx = next((i for i, c in enumerate(mro) if meth in vars(c)),
                   kind_idx)
        if idx < kind_idx:
            return False
    return True


def validate_tube_pair(solver, solver_predicted) -> None:
    """The asymmetric-tube contract: the predicted-state solver may differ
    from ``solver`` only in ``num_rollouts``.  Raises ``ValueError``."""
    if solver_predicted is None or solver_predicted is solver:
        return
    if solver_predicted.model is not solver.model:
        raise ValueError("asymmetric tube: both solvers must share the model")
    if type(solver_predicted.cost) is not type(solver.cost):
        raise ValueError(
            "asymmetric tube: both solvers must share the cost type "
            f"({type(solver.cost).__name__} vs "
            f"{type(solver_predicted.cost).__name__})")
    if solver_predicted.cfg.num_timesteps != solver.cfg.num_timesteps:
        raise ValueError(
            "asymmetric tube: both solvers must share the horizon "
            f"(actual T={solver.cfg.num_timesteps}, predicted "
            f"T={solver_predicted.cfg.num_timesteps})")
    aligned = solver_predicted.cfg.replace(num_rollouts=solver.cfg.num_rollouts)
    if aligned != solver.cfg:
        diffs = [f.name for f in dataclasses.fields(solver.cfg)
                 if getattr(aligned, f.name) != getattr(solver.cfg, f.name)]
        raise ValueError(
            "asymmetric tube: solvers may differ only in num_rollouts; "
            f"these configs also differ in {diffs}")


class MPPISolver:
    """MPPI replans for a (model, cost, config) on one device (``cuda``
    unless ``device`` says otherwise), the rollouts' dynamics at
    ``cfg.matmul_precision`` (``"highest"``, ``"high"`` or ``"default"``;
    another name raises ``ValueError``)."""

    def __init__(self, model, cost: MPPICost, cfg: MPPIConfig, device=None):
        self.device = resolve_device(device)
        bf16_operands(cfg.matmul_precision)
        if model.device != self.device:
            raise ValueError(f"model is on {model.device}, solver on "
                             f"{self.device}")
        self.model = model
        self.cost = cost
        self.cfg = cfg
        # the kernels evaluate the model (the JAX package's _decide_pallas)
        self.kernel_form = rk.kernel_form_applies(model, cfg)
        self.nu = torch.tensor(cfg.exploration_std, dtype=torch.float32,
                               device=self.device)
        self.init_u = torch.tensor(cfg.init_u, dtype=torch.float32,
                                   device=self.device)
        self._sample_noise = make_sampler(cfg.noise_sampler, cfg.noise_param)
        # the lane scalars of the last stacked CostParams solved:
        # (host rows, device tensor); a captured episode holds the tensor
        self._lane_pack = None

    # ------------------------------------------------------------------
    # construction helpers
    # ------------------------------------------------------------------

    def init_state(self, seed: Optional[int] = None) -> ControllerState:
        cfg = self.cfg
        T, C, S = cfg.num_timesteps, self.model.CONTROL_DIM, self.model.STATE_DIM
        zeros = lambda *shape: torch.zeros(shape, dtype=torch.float32,
                                           device=self.device)
        return ControllerState(
            U=self.init_u.expand(T, C).clone(), control_hist=zeros(2, C),
            state_solution=zeros(T, S), control_solution=zeros(T, C),
            key=kernel_rng.prng_key(cfg.seed if seed is None else seed))

    def reset_controls(self, cs: ControllerState) -> ControllerState:
        """``resetControls`` (mppi_controller.cu:447-457)."""
        return cs._replace(
            U=self.init_u.expand(self.cfg.num_timesteps, -1).clone())

    def with_rollouts(self, num_rollouts: int) -> "MPPISolver":
        """A sibling solver sharing this model and cost with another rollout
        budget (the asymmetric-tube helper); ``self`` when it matches.
        Refuses subclasses rather than downgrading them."""
        if num_rollouts == self.cfg.num_rollouts:
            return self
        if type(self) is not MPPISolver:
            raise NotImplementedError(
                f"with_rollouts would downgrade {type(self).__name__} to "
                f"a plain MPPISolver — construct the resized "
                f"{type(self).__name__} explicitly")
        return MPPISolver(self.model, self.cost,
                          self.cfg.replace(num_rollouts=num_rollouts),
                          device=self.device)

    # ------------------------------------------------------------------
    # one optimization iteration given explicit noise
    # ------------------------------------------------------------------

    def _fusable_cost(self) -> bool:
        """The costs the fused kernels evaluate: ``MPPICost`` and
        ``ObstacleCost``.  Any other subclass takes the chain and the
        batched epilogue, which dispatches through it."""
        return type(self.cost) in (MPPICost, ObstacleCost)

    def _obstacle_kwargs(self, cost_params: CostParams) -> dict:
        """The fused kernels' obstacle arguments: an ``ObstacleCost``'s
        circles (the live ``cost_params.obstacles`` when set) and
        coefficients, none for ``MPPICost``."""
        if type(self.cost) is ObstacleCost:
            return self.cost.kernel_kwargs(cost_params)
        return {}

    def rollout_costs(self, model_params, cost_params: CostParams,
                      costmap: Costmap, state: torch.Tensor, U: torch.Tensor,
                      eps: torch.Tensor, k_offset=0, packed_weights=None
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """K noise-perturbed rollouts and their costs (``rolloutKernel``,
        ``mppi_controller.cu:72-184``).  A model with a kernel form and a
        fusable cost take the fused kernel of the surface: kernel A on the
        exact ``Costmap``, kernel 3 on a ``NeuralCostmap``; with an
        ``ObstacleCost`` the kernel prices its circles too.  Anything else
        takes the dynamics chain (kernel 2, or :meth:`_plain_chain` for a
        model without a kernel form) and :meth:`_cost_epilogue`.

        ``eps``: (T, K, C) standard normal; ``k_offset`` is the global index
        of this batch's first rollout; ``packed_weights``: the kernels'
        weight buffer when the caller packed it
        (``rk.pack_members``).  Returns (costs (K,), u_seq (C, T, K)
        pre-clamp perturbed controls, crash (K,))."""
        fused = {Costmap: rk.fused_exact_rollout_cost,
                 NeuralCostmap: rk.fused_rollout_cost}.get(type(costmap))
        if fused is None:
            raise NotImplementedError(
                f"{type(costmap).__name__} is not ported: the port samples "
                "a Costmap or a NeuralCostmap (ROADMAP.md, Queue 1)")
        if self.kernel_form and self._fusable_cost():
            return fused(self.model, model_params, self.cfg, cost_params,
                         costmap, state, U, eps, l1_cost=self.cost.l1_cost,
                         k_offset=k_offset, packed_weights=packed_weights,
                         **self._obstacle_kwargs(cost_params))
        if self.kernel_form:
            states, u_seq = rk.dynamics_chain(
                self.model, model_params, self.cfg, state, U, eps,
                k_offset=k_offset, packed_weights=packed_weights)
        else:
            states, u_seq = self._plain_chain(model_params, state, U, eps,
                                              k_offset)
        total, crash = self._cost_epilogue(model_params, cost_params,
                                           costmap, eps, states, u_seq,
                                           k_offset)
        return total, u_seq, crash

    def rollout_costs_lanes(self, model_params, cost_params: CostParams,
                            costmap, state: torch.Tensor, U: torch.Tensor,
                            eps: torch.Tensor, k_offset=0
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
        """:meth:`rollout_costs` for the L lanes of a stacked
        ``cost_params`` (``config.cost_params_lanes``): lane l from
        ``state[l]`` (L, S) and ``U[l]`` (L, T, C), all lanes on the same
        ``eps`` (T, K, C).  The fused path is one launch of the lane form of
        the surface's kernel (kernel 1 on the exact ``Costmap``, kernel 3
        on a ``NeuralCostmap``), which with an ``ObstacleCost`` prices each
        lane's circles (the stacked ``cost_params.obstacles`` (L, N, 3),
        lane l's its row) or the circles every lane shares (its own, or an
        unstacked (N, 3)); the general path kernel 2's lane form (or the
        plain chain lane by lane), then :meth:`_cost_epilogue` with each
        lane's cost params.  Returns (costs (L, K), u_seq (L, C, T, K),
        crash (L, K))."""
        fused = {Costmap: rk.fused_exact_rollout_cost_lanes,
                 NeuralCostmap: rk.fused_rollout_cost_lanes}.get(
                     type(costmap))
        if fused is None:
            raise NotImplementedError(
                f"{type(costmap).__name__} is not ported: the port samples "
                "a Costmap or a NeuralCostmap (ROADMAP.md, Queue 1)")
        if self.kernel_form and self._fusable_cost():
            return fused(
                self.model, model_params, self.cfg, cost_params, costmap,
                state, U, eps, l1_cost=self.cost.l1_cost, k_offset=k_offset,
                lane_fsc=self._lane_scalars(cost_params, costmap, k_offset),
                **self._obstacle_kwargs(cost_params))
        if self.kernel_form:
            states, u_seq = rk.dynamics_chain_lanes(
                self.model, model_params, self.cfg, state, U, eps,
                k_offset=k_offset)
        else:
            chains = [self._plain_chain(model_params, s, u, eps, k_offset)
                      for s, u in zip(state, U)]
            states, u_seq = (torch.stack(o) for o in zip(*chains))
        outs = [self._cost_epilogue(model_params, cp, costmap, eps, states[i],
                                    u_seq[i], k_offset)
                for i, cp in enumerate(lane_cost_params(cost_params))]
        total, crash = (torch.stack(o) for o in zip(*outs))
        return total, u_seq, crash

    def _lane_scalars(self, cost_params: CostParams, costmap,
                      k_offset=0) -> torch.Tensor:
        """The lane scalars of a stacked ``cost_params`` on the solver's
        device (``rk.lane_scalars``, with an ``ObstacleCost``'s
        coefficients), packed again only when their values change, so that
        a captured tick, whose eager warm-up tick packed them, copies
        nothing from the host."""
        coeffs = {k: v for k, v in self._obstacle_kwargs(cost_params).items()
                  if k != "obstacles"}
        rows = rk.lane_scalar_rows(self.model, self.cfg, cost_params,
                                   costmap, k_offset, **coeffs)
        if self._lane_pack is None or self._lane_pack[0] != rows:
            self._lane_pack = (rows, torch.tensor(
                rows, dtype=torch.float32, device=self.device))
        return self._lane_pack[1]

    def _rollout_ids(self, K: int, k_offset, device) -> torch.Tensor:
        """The global indices (K,) of a batch's rollouts."""
        return int(k_offset) + torch.arange(K, device=device)

    def _plain_chain(self, model_params, state: torch.Tensor,
                     U: torch.Tensor, eps: torch.Tensor, k_offset=0):
        """The dynamics chain of a model without a kernel form (the JAX
        package's ``lax.scan``): perturb, store ``u`` pre-clamp, clamp,
        Euler step, through the model's own methods.  Returns (states
        (S, T, K), ``states[:, t]`` after t+1 steps; u_seq (C, T, K))."""
        cfg, model = self.cfg, self.model
        T, K, C = eps.shape
        dev = eps.device
        k_idx = self._rollout_ids(K, k_offset, dev)
        zero_rollout = (k_idx == 0)[:, None]
        pure_noise = (k_idx >= cfg.pure_noise_frac * cfg.num_rollouts)[:, None]
        s = state.to(dev, torch.float32).expand(K, model.STATE_DIM)
        states = torch.empty((model.STATE_DIM, T, K), dtype=torch.float32,
                             device=dev)
        u_seq = torch.empty((C, T, K), dtype=torch.float32, device=dev)
        for t in range(T):
            du = eps[t] * self.nu
            u = (U[t].expand(K, C) if t < cfg.optimization_stride
                 else torch.where(zero_rollout, U[t],
                                  torch.where(pure_noise, du, U[t] + du)))
            u_seq[:, t] = u.T
            u_cl = model.enforce_constraints(model_params, u)
            s = s + model.state_deriv(model_params, s, u_cl) * model.dt
            states[:, t] = s.T
        return states, u_seq

    def _cost_epilogue(self, model_params, cost_params: CostParams, costmap,
                       eps: torch.Tensor, states: torch.Tensor,
                       u_seq: torch.Tensor, k_offset=0
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The batched cost over (T-1, K) along a chain's ``states``
        (S, T, K) and ``u_seq`` (C, T, K), through the cost object's terms
        (the JAX package's phase 2, ``solver/mppi.py:343-376``): cost step
        t = 1..T-1 prices s_t with the controls of step t, clamped to the
        last two rows of ``control_rngs``; the crash latch is a running max
        over the steps; each step's cost is clamped at 1e12 (NaN too) and
        the total is their mean plus ``terminal_cost`` of the last state.
        Returns (costs (K,), crash (K,) int32)."""
        cfg, cost, nu = self.cfg, self.cost, self.nu
        T, K, _ = eps.shape
        dev = eps.device
        s_c = lambda i: states[i, :-1, :]                       # (T-1, K)
        u_c = lambda j: u_seq[j, 1:, :]
        eps_c = lambda j: eps[1:, :, j]
        s_last = states[:self.model.STATE_DIM, -1, :].T         # (K, S)

        rngs = model_params["control_rngs"].reshape(-1, 2)[-2:]
        zero_rollout = self._rollout_ids(K, k_offset, dev) == 0
        frozen_cost = (zero_rollout[None, :]
                       | (torch.arange(1, T, device=dev)[:, None]
                          < cfg.optimization_stride))
        du0 = torch.where(frozen_cost, 0.0, eps_c(0) * nu[0])
        du1 = torch.where(frozen_cost, 0.0, eps_c(1) * nu[1])
        u0 = torch.clamp(u_c(0), rngs[0, 0], rngs[0, 1])
        u1 = torch.clamp(u_c(1), rngs[1, 0], rngs[1, 1])

        control_c = cost.control_cost_c(cost_params, u0, u1, du0, du1, nu)
        speed_c = cost.speed_cost_c(cost_params, s_c(4))
        stab_c = cost.stabilizing_cost_c(cost_params, s_c(4), s_c(5))
        zeros = torch.zeros(control_c.shape, dtype=torch.int32, device=dev)
        track_c, boundary = cost.track_cost_c(
            cost_params, costmap, s_c(0), s_c(1), s_c(2), zeros)
        # the boundary latch of cost step j and the roll latch at the end of
        # step j-1 both first count in cost step j, and the latch persists
        roll_flag = (torch.abs(s_c(3)) > 1.57).to(torch.int32)
        crash = torch.cummax(torch.maximum(boundary, roll_flag), dim=0).values
        crash_c = (1.0 - cost_params.discount) * cost.crash_cost(cost_params,
                                                                 crash)
        c = control_c + speed_c + crash_c + track_c + stab_c    # (T-1, K)
        c = torch.where((c > 1e12) | torch.isnan(c), 1e12, c)
        # the running average (mppi_controller.cu:162-165) telescopes to the
        # mean of cost steps 1..T-1
        total = torch.mean(c, dim=0) + cost.terminal_cost(s_last)
        return total, crash[-1]

    def iterate(self, model_params, cost_params: CostParams, costmap: Costmap,
                state: torch.Tensor, U: torch.Tensor, eps: torch.Tensor
                ) -> Tuple[torch.Tensor, SolveStats]:
        """One MPPI iteration: (state (S,), U (T, C), eps (T, K, C)) ->
        (U_new (T, C), stats) (``mppi_controller.cu:609-667``).  With a
        stacked ``cost_params`` (L lanes), state (L, S) and U (L, T, C) ->
        U_new (L, T, C) and stats of shape (L,), every lane on ``eps``
        (the JAX package's vmap over the cost params)."""
        if cost_params_lanes(cost_params) is not None:
            total, u_seq, crash = self.rollout_costs_lanes(
                model_params, cost_params, costmap, state, U, eps)
            stats, w = self._stats_lanes(cost_params, total, crash)
            # a contraction a lane, as the solo iteration takes it (a
            # batched one may add in another order)
            U_new = (torch.stack([torch.einsum("k,ctk->tc", w_l, u_l)
                                  for w_l, u_l in zip(w, u_seq)])
                     / stats.normalizer[:, None, None])
            return U_new, stats
        total, u_seq, crash = self.rollout_costs(
            model_params, cost_params, costmap, state, U, eps)
        stats, w = self._stats(cost_params, total, crash)
        U_new = torch.einsum("k,ctk->tc", w, u_seq) / stats.normalizer
        return U_new, stats

    def _stats(self, cost_params: CostParams, total: torch.Tensor,
               crash: torch.Tensor) -> Tuple[SolveStats, torch.Tensor]:
        """The softmax weights ``exp(-gamma (c - min c))`` (K,) of the
        costs ``total`` and the solve's stats."""
        baseline = torch.min(total)
        w = torch.exp(-effective_gamma(self.cfg, cost_params)
                      * (total - baseline))                    # (K,)
        eta = torch.sum(w)
        sum_w2 = torch.sum(w * w)
        # the means as sums over K, as jnp.mean and the sharded solver
        # (parallel/sharded.py) take them: CUDA's torch.mean multiplies by
        # 1/K instead
        K = total.shape[0]
        return SolveStats(
            baseline=baseline,
            normalizer=eta,
            trajectory_cost=sum_w2 / eta,
            ess=(eta * eta) / sum_w2,
            mean_cost=torch.sum(total) / K,
            crash_frac=torch.sum(crash.to(torch.float32)) / K,
        ), w

    def _stats_lanes(self, cost_params: CostParams, total: torch.Tensor,
                     crash: torch.Tensor) -> Tuple[SolveStats, torch.Tensor]:
        """:meth:`_stats` of L lanes, total and crash (L, K), each lane at
        its own gamma (the stacked gamma (L,), or the config's;
        ``rk.lane_weights``): the weights (L, K) and stats of shape (L,).
        Each sum is one reduction a lane (``rk.lane_sums``), as the solo
        solve takes it."""
        w = rk.lane_weights(self.cfg, cost_params, total)        # (L, K)
        eta = rk.lane_sums(w)
        sum_w2 = rk.lane_sums(w * w)
        K = total.shape[-1]
        return SolveStats(
            baseline=torch.amin(total, dim=-1),
            normalizer=eta,
            trajectory_cost=sum_w2 / eta,
            ess=(eta * eta) / sum_w2,
            mean_cost=rk.lane_sums(total) / K,
            crash_frac=rk.lane_sums(crash.to(torch.float32)) / K,
        ), w

    def _iterate_kernel_rng(self, model_params, cost_params: CostParams,
                            costmap: Costmap, state: torch.Tensor,
                            U: torch.Tensor, key: torch.Tensor
                            ) -> Tuple[torch.Tensor, SolveStats]:
        """One capacity-mode iteration on the stream of ``key`` (int64
        (2,)): (U_new (T, C), stats), the stats from the costs as the JAX
        package's ``_solve`` takes them.  With a stacked ``cost_params`` (L
        lanes), state (L, S) and U (L, T, C) -> U_new (L, T, C) and stats
        of shape (L,), every lane on the stream of ``key``: the passes'
        lane forms (the lane scalars packed as :meth:`rollout_costs_lanes`
        packs them), the weights and stats a lane (:meth:`_stats_lanes`)."""
        if cost_params_lanes(cost_params) is not None:
            U_new, total, crash = rk.fused_rng_solve_iteration_lanes(
                self.model, model_params, self.cfg, cost_params, costmap,
                state, U, key, l1_cost=self.cost.l1_cost,
                lane_fsc=self._lane_scalars(cost_params, costmap),
                **self._obstacle_kwargs(cost_params))
            return U_new, self._stats_lanes(cost_params, total, crash)[0]
        U_new, total, crash = rk.fused_rng_solve_iteration(
            self.model, model_params, self.cfg, cost_params, costmap, state,
            U, key, l1_cost=self.cost.l1_cost,
            **self._obstacle_kwargs(cost_params))
        return U_new, self._stats(cost_params, total, crash)[0]

    def _use_kernel_rng(self, costmap) -> bool:
        """Whether a solve runs the capacity mode (see the module
        docstring for the gates and the TPU-only ones dropped)."""
        cfg = self.cfg
        # white draws stream one step at a time, OU's AR(1) recursion too
        # for theta in (0, 2); DFT-shaped colored noise needs the whole
        # horizon at once and stays on the host-noise path
        sampler_ok = (cfg.noise_sampler == "gaussian"
                      or (cfg.noise_sampler == "ou"
                          and 0.0 < cfg.noise_param < 2.0))
        # a field qualifies without exact_fused, as in the JAX package
        surface_ok = (type(costmap) is NeuralCostmap
                      or (type(costmap) is Costmap and cfg.exact_fused))
        # any model with a kernel form, whatever its spec, as in the JAX
        # package: on the card pass 1 refuses what it is not built for
        return bool(cfg.kernel_rng and rk.kernel_form_applies(self.model, cfg)
                    and sampler_ok
                    and type(self.cost) in (MPPICost, ObstacleCost)
                    and surface_ok)

    # ------------------------------------------------------------------
    # full solve: iterations + smoothing + nominal trajectory
    # ------------------------------------------------------------------

    def _solve(self, model_params, cost_params: CostParams, costmap: Costmap,
               state: torch.Tensor, cs: ControllerState
               ) -> Tuple[ControllerState, SolveStats]:
        key = cs.key
        draws = []
        for _ in range(self.cfg.num_iters):                  # usually 1
            key, sub = kernel_rng.split(key)
            draws.append(self._draw(costmap, sub))
        cs, stats = self._solve_drawn(model_params, cost_params, costmap,
                                      state, cs, draws)
        return cs._replace(key=key), stats

    def _draw(self, costmap, sub: np.ndarray) -> torch.Tensor:
        """One iteration's randomness from the subkey ``sub``: the kernels'
        key (int64 (2,)) in the capacity mode, else the noise eps (T, K, C)
        of the host-noise generator seeded with it."""
        if self._use_kernel_rng(costmap):
            return self._device_key(sub)
        cfg = self.cfg
        return self._sample_noise(
            self._noise_generator(sub),
            (cfg.num_timesteps, cfg.num_rollouts, self.model.CONTROL_DIM))

    def _solve_drawn(self, model_params, cost_params: CostParams,
                     costmap: Costmap, state: torch.Tensor,
                     cs: ControllerState, draws
                     ) -> Tuple[ControllerState, SolveStats]:
        """The solve from given draws, one an iteration (:meth:`_draw`'s
        noise, or the capacity mode's device key): the iterations, the
        smoothing and the nominal trajectory.  Reads nothing from the host
        and keeps ``cs.key``, so that a CUDA graph can capture it
        (``runtime/episode.py``)."""
        U = cs.U
        stats = None
        for draw in draws:
            U, stats = self._iterate_drawn(model_params, cost_params, costmap,
                                           state, U, draw)
        U = savitzky_golay(U, cs.control_hist)
        states_sol, controls_sol = self.nominal_trajectory(model_params,
                                                           state, U)
        return cs._replace(U=U, state_solution=states_sol,
                           control_solution=controls_sol), stats

    def _iterate_drawn(self, model_params, cost_params: CostParams,
                       costmap: Costmap, state: torch.Tensor,
                       U: torch.Tensor, draw
                       ) -> Tuple[torch.Tensor, SolveStats]:
        """One iteration from one of :meth:`_draw`'s draws."""
        if self._use_kernel_rng(costmap):
            return self._iterate_kernel_rng(model_params, cost_params,
                                            costmap, state, U, draw)
        return self.iterate(model_params, cost_params, costmap, state, U,
                            draw)

    def _device_key(self, sub: np.ndarray) -> torch.Tensor:
        """The capacity mode's kernel key: ``sub`` as an int64 (2,) tensor
        on the solver's device, copied from pinned memory without waiting
        for the device."""
        host = torch.from_numpy(sub.astype(np.int64))
        if self.device.type != "cuda":
            return host.to(self.device)
        return host.pin_memory().to(self.device, non_blocking=True)

    def _noise_generator(self, sub: np.ndarray) -> torch.Generator:
        """The host-noise mode's generator for one iteration, seeded with
        ``sub``'s 64 bits.  The draws are PyTorch's, which cannot match
        ``jax.random.normal``'s bits; the stream is a function of the key
        alone, so one state replays its solve."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(sub[0]) << 32 | int(sub[1]))
        return gen

    def solve(self, model_params, cost_params, costmap, state,
              cs: ControllerState) -> Tuple[ControllerState, SolveStats]:
        """One replan from ``state`` (S,) (array or tensor)."""
        state = torch.as_tensor(np.asarray(state, dtype=np.float32)
                                if not torch.is_tensor(state) else state,
                                dtype=torch.float32, device=self.device)
        return self._solve(model_params, cost_params, costmap, state, cs)

    def nominal_trajectory(self, model_params, state: torch.Tensor,
                           U: torch.Tensor, packed_weights=None):
        """Re-rollout of the solution (``computeNominalTraj``,
        ``mppi_controller.cu:501-519``): (state_solution (T, S),
        control_solution (T, C)), each state before its update and the
        clamped controls; through the chain kernel at K = 1 for a model with
        a kernel form, else step by step through the model's methods; in
        float32 at every ``matmul_precision``, as the JAX solver's.  Lanes
        (state (L, S), U (L, T, C)) take kernel 2's lane form, or the plain
        steps lane by lane."""
        if state.dim() == 2:
            if self.kernel_form:
                return rk.nominal_trajectory_lanes(
                    self.model, model_params, self.cfg, state, U,
                    packed_weights=packed_weights)
            outs = [self.nominal_trajectory(model_params, s, u)
                    for s, u in zip(state, U)]
            return tuple(torch.stack(o) for o in zip(*outs))
        if self.kernel_form:
            return rk.nominal_trajectory(self.model, model_params, self.cfg,
                                         state, U,
                                         packed_weights=packed_weights)
        model = self.model
        s = state.to(U.device, torch.float32)
        states, controls = [], []
        for u_t in U:
            u_cl = model.enforce_constraints(model_params, u_t)
            states.append(s)
            controls.append(u_cl)
            s = s + model.state_deriv(model_params, s, u_cl) * model.dt
        return torch.stack(states), torch.stack(controls)

    # ------------------------------------------------------------------
    # receding-horizon slide
    # ------------------------------------------------------------------

    def _slide(self, cs: ControllerState, stride: int) -> ControllerState:
        """``slideControlAndStateSeq`` (mppi_controller.cu:521-568).

        Control-history quirk preserved: for stride >= 2 the history is read
        from the flattened control array at float offset ``stride - 2``
        (mppi_controller.cu:536-541), which for odd strides straddles
        timesteps exactly as the reference does.  A state whose carries
        have a leading lane axis (U (L, T, C)) slides every lane."""
        T, C = self.cfg.num_timesteps, self.model.CONTROL_DIM
        lead = tuple(cs.U.shape[:-2])
        stride = int(stride)
        if stride < 0:
            raise ValueError(f"stride must be >= 0, got {stride}")
        if stride == 0:
            new_hist = cs.control_hist
        else:
            ext = torch.cat([cs.control_hist.reshape(*lead, -1),
                             cs.U.reshape(*lead, -1)], dim=-1)
            # stride==1 -> ext[2:6] = [hist[1], U[0]]; stride>=2 ->
            # U_flat[s-2:s+2]; the start clamps like lax.dynamic_slice
            start = min(stride + 1 if stride == 1 else stride + 2,
                        ext.shape[-1] - 2 * C)
            new_hist = ext[..., start:start + 2 * C].reshape(*lead, 2, C)
        s = min(stride, T)
        new_U = torch.cat([cs.U[..., s:, :], self.init_u.expand(*lead, s, C)],
                          dim=-2)
        # slideStateSeq: shifts, the tail keeps its old values (the next
        # nominal-trajectory pass overwrites it)
        ss = cs.state_solution
        new_ss = torch.cat([ss[..., s:, :], ss[..., T - s:, :]], dim=-2)
        return cs._replace(U=new_U, control_hist=new_hist, state_solution=new_ss)

    def _slide_device(self, cs: ControllerState, stride: torch.Tensor
                      ) -> ControllerState:
        """:meth:`_slide` with the stride a 0-d int64 tensor on the device,
        bit for bit the same (gathers and selects copy values), for any
        stride >= 0; reads nothing from the host, so that one captured
        graph serves every stride (``runtime/async_loop.py``)."""
        T, C = self.cfg.num_timesteps, self.model.CONTROL_DIM
        s = torch.clamp(stride, max=T)
        src = torch.arange(T, device=self.device) + s
        kept = (src < T)[:, None]
        src = torch.clamp(src, max=T - 1)
        new_U = torch.where(kept, cs.U[src], self.init_u)
        # the tail keeps its old values, as cat([ss[s:], ss[T - s:]])
        new_ss = torch.where(kept, cs.state_solution[src], cs.state_solution)
        ext = torch.cat([cs.control_hist.reshape(-1), cs.U.reshape(-1)])
        start = torch.where(
            stride == 0, 0, torch.where(
                stride == 1, 2, torch.clamp(stride + 2,
                                            max=ext.numel() - 2 * C)))
        new_hist = ext[start + torch.arange(2 * C, device=self.device)]
        return cs._replace(U=new_U, control_hist=new_hist.reshape(2, C),
                           state_solution=new_ss)

    def slide(self, cs: ControllerState, stride) -> ControllerState:
        return self._slide(cs, stride)


def savitzky_golay(U: torch.Tensor, control_hist: torch.Tensor) -> torch.Tensor:
    """5-tap SG smoothing with the 2-step executed-control history
    (``savitskyGolay``, mppi_controller.cu:469-499).

    Window layout: [hist0, hist1, U0..U(T-1), U(T-1), U(T-1)]; output
    U'[i] = filter . window[i:i+5].  Leading (lane) axes are batched."""
    T = U.shape[-2]
    last = U[..., -1:, :]
    padded = torch.cat([control_hist, U,
                        last.expand(*last.shape[:-2], 2, -1)],
                       dim=-2)                                   # (T+4, C)
    out = padded[..., 0:T, :] * float(SAVGOL_FILTER[0])
    for j in range(1, 5):
        out = out + padded[..., j:j + T, :] * float(SAVGOL_FILTER[j])
    return out
