"""Single-device MPPI solver (port of ``autorally_tpu/solver/mppi.py``).

One replan (``MPPIController::computeControl``, ``mppi_controller.cu:600-675``)
is: draw the noise, run the K rollouts with their costs (one launch of the
fused CUDA kernel), softmax-weight the sampled controls, smooth with the
Savitzky-Golay filter and re-roll the nominal trajectory (one launch of the
chain kernel).  Everything stays on the device; nothing in a solve waits
for the host.

The track surface is the exact ``Costmap`` (fused kernel A) or a
``NeuralCostmap`` field (fused kernel 3), as the JAX package dispatches
them.  The model is the MLP (``NeuralNetDynamics``) or the basis-function
model (``BasisFunctionDynamics``); the cost ``MPPICost`` or
``ObstacleCost``, whose circles (``CostParams.obstacles`` when set, else
its own) the fused kernels price on every solve, as the JAX package's
``_fusable_cost`` / ``_obstacle_kwargs`` route them.

With ``kernel_rng=True`` (the capacity mode) an iteration draws only a key
and runs the two kernel-RNG passes (``rk.fused_rng_solve_iteration``): the
noise is drawn inside the kernels, so neither eps nor u_seq (T x K x C
each) reaches device memory.  The dispatch (:meth:`MPPISolver._use_kernel_rng`)
keeps the JAX package's semantic gates: a model with a kernel form, white
or OU noise with theta in (0, 2), ``MPPICost`` or ``ObstacleCost``, and a
``NeuralCostmap`` or the exact ``Costmap`` with ``exact_fused``; anything
else takes the host-noise path.
It drops the TPU-only gates, ``use_pallas_rollout`` and the VMEM budget of
the exact map (``exact_map_fits``), as the host-noise path dropped
``K % 128``: the CUDA kernels take any K and read the map from device
memory.

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
                                        effective_gamma, resolve_device)
from autorally_tpu_torch.costs.costmap import Costmap
from autorally_tpu_torch.costs.mppi_cost import MPPICost
from autorally_tpu_torch.costs.neural_costmap import NeuralCostmap
from autorally_tpu_torch.costs.obstacles import ObstacleCost
from autorally_tpu_torch.models.basis_function import BasisFunctionDynamics
from autorally_tpu_torch.models.neural_net import NeuralNetDynamics
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
    unless ``device`` says otherwise)."""

    def __init__(self, model, cost: MPPICost, cfg: MPPIConfig, device=None):
        self.device = resolve_device(device)
        if type(model) not in (NeuralNetDynamics, BasisFunctionDynamics):
            raise NotImplementedError(
                f"{type(model).__name__} is not ported: the port solves with "
                "NeuralNetDynamics or BasisFunctionDynamics (ROADMAP.md, "
                "Queue 1)")
        if type(cost) not in (MPPICost, ObstacleCost):
            raise NotImplementedError(
                f"{type(cost).__name__} is not ported: the port solves with "
                "MPPICost or ObstacleCost, the costs its fused kernels "
                "evaluate (ROADMAP.md, Queue 1)")
        if cfg.matmul_precision != "highest":
            raise NotImplementedError(
                "the port computes the dynamics in full fp32 only "
                "(matmul_precision='highest'); reduced precision is not "
                "ported (ROADMAP.md, Queue 2)")
        if model.device != self.device:
            raise ValueError(f"model is on {model.device}, solver on "
                             f"{self.device}")
        self.model = model
        self.cost = cost
        self.cfg = cfg
        self.nu = torch.tensor(cfg.exploration_std, dtype=torch.float32,
                               device=self.device)
        self.init_u = torch.tensor(cfg.init_u, dtype=torch.float32,
                                   device=self.device)
        self._sample_noise = make_sampler(cfg.noise_sampler, cfg.noise_param)

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

    def _obstacle_kwargs(self, cost_params: CostParams) -> dict:
        """The fused kernels' obstacle arguments: an ``ObstacleCost``'s
        circles (the live ``cost_params.obstacles`` when set) and
        coefficients, none for ``MPPICost``."""
        if type(self.cost) is ObstacleCost:
            return self.cost.kernel_kwargs(cost_params)
        return {}

    def rollout_costs(self, model_params, cost_params: CostParams,
                      costmap: Costmap, state: torch.Tensor, U: torch.Tensor,
                      eps: torch.Tensor, k_offset=0
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """K noise-perturbed rollouts and their costs (``rolloutKernel``,
        ``mppi_controller.cu:72-184``) through the fused kernel of the
        surface: kernel A on the exact ``Costmap``, kernel 3 on a
        ``NeuralCostmap``; with an ``ObstacleCost`` the kernel prices its
        circles too.

        ``eps``: (T, K, C) standard normal.  Returns (costs (K,), u_seq
        (C, T, K) pre-clamp perturbed controls, crash (K,))."""
        fused = {Costmap: rk.fused_exact_rollout_cost,
                 NeuralCostmap: rk.fused_rollout_cost}.get(type(costmap))
        if fused is None:
            raise NotImplementedError(
                f"{type(costmap).__name__} is not ported: the port samples "
                "a Costmap or a NeuralCostmap (ROADMAP.md, Queue 1)")
        return fused(self.model, model_params, self.cfg, cost_params,
                     costmap, state, U, eps, l1_cost=self.cost.l1_cost,
                     k_offset=k_offset, **self._obstacle_kwargs(cost_params))

    def iterate(self, model_params, cost_params: CostParams, costmap: Costmap,
                state: torch.Tensor, U: torch.Tensor, eps: torch.Tensor
                ) -> Tuple[torch.Tensor, SolveStats]:
        """One MPPI iteration: (state (S,), U (T, C), eps (T, K, C)) ->
        (U_new (T, C), stats) (``mppi_controller.cu:609-667``)."""
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
        return SolveStats(
            baseline=baseline,
            normalizer=eta,
            trajectory_cost=sum_w2 / eta,
            ess=(eta * eta) / sum_w2,
            mean_cost=torch.mean(total),
            crash_frac=torch.mean(crash.to(torch.float32)),
        ), w

    def _iterate_kernel_rng(self, model_params, cost_params: CostParams,
                            costmap: Costmap, state: torch.Tensor,
                            U: torch.Tensor, key: torch.Tensor
                            ) -> Tuple[torch.Tensor, SolveStats]:
        """One capacity-mode iteration on the stream of ``key`` (int64
        (2,)): (U_new (T, C), stats), the stats from the costs as the JAX
        package's ``_solve`` takes them."""
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
        return bool(cfg.kernel_rng and rk.has_kernel_form(self.model)
                    and sampler_ok
                    and type(self.cost) in (MPPICost, ObstacleCost)
                    and surface_ok)

    # ------------------------------------------------------------------
    # full solve: iterations + smoothing + nominal trajectory
    # ------------------------------------------------------------------

    def _solve(self, model_params, cost_params: CostParams, costmap: Costmap,
               state: torch.Tensor, cs: ControllerState
               ) -> Tuple[ControllerState, SolveStats]:
        cfg = self.cfg
        shape = (cfg.num_timesteps, cfg.num_rollouts, self.model.CONTROL_DIM)
        U = cs.U
        key = cs.key
        stats = None
        capacity = self._use_kernel_rng(costmap)
        for _ in range(cfg.num_iters):                         # usually 1
            key, sub = kernel_rng.split(key)
            if capacity:
                U, stats = self._iterate_kernel_rng(
                    model_params, cost_params, costmap, state, U,
                    self._device_key(sub))
            else:
                eps = self._sample_noise(self._noise_generator(sub), shape)
                U, stats = self.iterate(model_params, cost_params, costmap,
                                        state, U, eps)
        U = savitzky_golay(U, cs.control_hist)
        states_sol, controls_sol = self.nominal_trajectory(model_params,
                                                           state, U)
        return cs._replace(U=U, state_solution=states_sol,
                           control_solution=controls_sol, key=key), stats

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
                           U: torch.Tensor):
        """Re-rollout of the solution (``computeNominalTraj``) through the
        chain kernel: (state_solution (T, S), control_solution (T, C))."""
        return rk.nominal_trajectory(self.model, model_params, self.cfg,
                                     state, U)

    # ------------------------------------------------------------------
    # receding-horizon slide
    # ------------------------------------------------------------------

    def _slide(self, cs: ControllerState, stride: int) -> ControllerState:
        """``slideControlAndStateSeq`` (mppi_controller.cu:521-568).

        Control-history quirk preserved: for stride >= 2 the history is read
        from the flattened control array at float offset ``stride - 2``
        (mppi_controller.cu:536-541), which for odd strides straddles
        timesteps exactly as the reference does."""
        T, C = self.cfg.num_timesteps, self.model.CONTROL_DIM
        stride = int(stride)
        if stride < 0:
            raise ValueError(f"stride must be >= 0, got {stride}")
        if stride == 0:
            new_hist = cs.control_hist
        else:
            ext = torch.cat([cs.control_hist.reshape(-1), cs.U.reshape(-1)])
            # stride==1 -> ext[2:6] = [hist[1], U[0]]; stride>=2 ->
            # U_flat[s-2:s+2]; the start clamps like lax.dynamic_slice
            start = min(stride + 1 if stride == 1 else stride + 2,
                        ext.numel() - 2 * C)
            new_hist = ext[start:start + 2 * C].reshape(2, C)
        s = min(stride, T)
        new_U = torch.cat([cs.U[s:], self.init_u.expand(s, C)])
        # slideStateSeq: shifts, the tail keeps its old values (the next
        # nominal-trajectory pass overwrites it)
        ss = cs.state_solution
        new_ss = torch.cat([ss[s:], ss[T - s:]])
        return cs._replace(U=new_U, control_hist=new_hist, state_solution=new_ss)

    def slide(self, cs: ControllerState, stride) -> ControllerState:
        return self._slide(cs, stride)


def savitzky_golay(U: torch.Tensor, control_hist: torch.Tensor) -> torch.Tensor:
    """5-tap SG smoothing with the 2-step executed-control history
    (``savitskyGolay``, mppi_controller.cu:469-499).

    Window layout: [hist0, hist1, U0..U(T-1), U(T-1), U(T-1)]; output
    U'[i] = filter . window[i:i+5]."""
    T = U.shape[0]
    padded = torch.cat([control_hist, U, U[-1:].expand(2, -1)])  # (T+4, C)
    out = padded[0:T] * float(SAVGOL_FILTER[0])
    for j in range(1, 5):
        out = out + padded[j:j + T] * float(SAVGOL_FILTER[j])
    return out
