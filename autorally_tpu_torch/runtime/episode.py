"""Closed-loop episode runner: tube-MPPI against a simulated plant at the
device's speed (port of ``autorally_tpu/runtime/episode.py``).

The reference evaluates its controller by closing the loop through Gazebo
at wall-clock rates; its ``debug_mode`` self-propagates the state inside
the controller instead (``run_control_loop.cuh:296-302``).  Here a whole
control tick — the receding-horizon slide of both controllers, the
actual-state and predicted-state solves, the arbitration by trajectory
cost with the predicted controller's resync, the DDP feedback gains and
the plant's integration under a (possibly different) true model — runs on
the device, and the per-tick telemetry stays there as ``(n_ticks, ...)``
tensors until the episode ends.

On the card the tick is captured once as one ``torch.cuda.CUDAGraph`` and
replayed ``n_ticks`` times; a tick's only host work is to draw the
host-noise mode's noise into the buffers the graph reads and to launch the
replay.  What the graph freezes is kept out of the tick or checked:

- the controllers' keys are split on the host for every solve of the
  episode before it starts (the JAX package's ``init_state(seed_a)`` /
  ``(seed_p)`` chains); the host-noise mode draws each solve's noise with
  the solver's own generator (``MPPISolver._draw``) into static buffers,
  so the captured tick equals the eager one bit for bit; the capacity
  mode's kernels read their keys from a device buffer of the episode's
  keys, indexed by a tick counter on the device;
- the moving obstacles are a device buffer of the episode's circles,
  indexed the same way;
- gamma is a device tensor, the ESS law's carry (0-d, or a lane's own);
- the kernels' host scalars (cost coefficients, the costmap's transform)
  and the packed weights are frozen: a run whose weights, cost params
  (gamma aside), costmap or circles differ from the captured run's, or
  were changed in place, captures again;
- the controllers' carries, the plant state and gamma live in static
  buffers that the tick writes back after everything that reads them.

The tick is warmed up once eagerly on a side stream before the capture
(the kernels' build, the packs and the geometry caches), and Python's
cyclic collector is off during the capture.  A capture error is raised,
never answered with an eager run.  On the CPU (``device="cpu"``) and with
``run(..., eager=True)`` the same tick runs eagerly in a Python loop.

With ``use_feedback_gains=True`` the executed control follows the plant's
pipeline (``autorally_plant.cpp:215-250``): the solution interpolated at
the pose rate, plus the interpolated DDP gain times the state error,
clamped, with the NaN-feedback fallback to the feedforward.
``pose_substeps`` plant steps a control tick: the true model's ``dt`` must
be ``cfg.dt / pose_substeps``.
"""

from __future__ import annotations

import dataclasses
import gc
from typing import NamedTuple, Optional

import numpy as np
import torch

from autorally_tpu_torch.config import (CostParams, cost_params_lanes,
                                        effective_gamma)
from autorally_tpu_torch.costs.obstacles import ObstacleCost
from autorally_tpu_torch.ops import kernel_rng
from autorally_tpu_torch.runtime.ess_tuner import gamma_step_traced
from autorally_tpu_torch.solver.ddp import DDPSolver
from autorally_tpu_torch.solver.mppi import MPPISolver, validate_tube_pair


# The ControllerState fields a tick carries to the next (the key does not
# travel: every solve's subkey is split before the episode).
_CARRIED = ("U", "control_hist", "state_solution", "control_solution")


class EpisodeResult(NamedTuple):
    """Per-tick telemetry; a run of L lanes (a stacked ``CostParams``)
    gives each field a leading L."""

    states: torch.Tensor           # (n_ticks, S) true plant states
    controls: torch.Tensor         # (n_ticks, C) executed controls (substep 0)
    used_actual: torch.Tensor      # (n_ticks,) bool: actual-state ctrl won
    trajectory_cost: torch.Tensor  # (n_ticks,)
    ess: torch.Tensor              # (n_ticks,)
    crash_frac: torch.Tensor       # (n_ticks,)
    gamma: torch.Tensor            # (n_ticks,) softmax temperature used


class TubeSolve(NamedTuple):
    """One tube tick's solves (:func:`tube_solve`), on the device."""

    cs_a: object                   # the actual-state controller's new state
    cs_p: object                   # the predicted one's, resynced
    st_a: object                   # their SolveStats
    st_p: object
    use_actual: torch.Tensor       # () bool (L,): the actual-state plan won
    control: torch.Tensor          # (T, C) the chosen clamped plan
    states: torch.Tensor           # (T, S) the chosen nominal trajectory
    gains: Optional[torch.Tensor]  # (T, C, S) DDP gains, or None

    def stat(self, name: str) -> torch.Tensor:
        """The winning solve's ``SolveStats`` field ``name``."""
        return torch.where(self.use_actual, getattr(self.st_a, name),
                           getattr(self.st_p, name))


def tube_solve(solvers, ddp: Optional[DDPSolver], params, cost_params,
               costmap, state, cs_a, cs_p, draws_a, draws_p) -> TubeSolve:
    """The tube tick between the slide and the plant, shared by the episode
    and the async loop (``runtime/async_loop.py``): the actual-state solve
    from ``state`` and the predicted-state one from its own first nominal
    state (``run_control_loop.cuh:218-219``), each from its draws; the
    arbitration by computed trajectory cost on the device (``:246-286``);
    the predicted controller's resync when the actual one wins
    (``:263-266``); and with a ``ddp``, its gains around the chosen plan
    (``computeFeedbackGains``, ``mppi_controller.cu:427-439``), run
    uncaptured (the caller's graph holds it).  Reads nothing from the
    host.  With a stacked ``cost_params`` every lane (state (L, S), the
    carries with a leading L) is solved, arbitrated and resynced on its
    own, the DDP run lane by lane."""
    solver, solver_p = solvers
    cs_a, st_a = solver._solve_drawn(params, cost_params, costmap, state,
                                     cs_a, draws_a)
    cs_p, st_p = solver_p._solve_drawn(params, cost_params, costmap,
                                       cs_p.state_solution[..., 0, :], cs_p,
                                       draws_p)
    use_actual = st_a.trajectory_cost < st_p.trajectory_cost

    def pick(a, p):
        lanes = use_actual.shape + (1,) * (a.dim() - use_actual.dim())
        return torch.where(use_actual.reshape(lanes), a, p)

    chosen_ctrl = pick(cs_a.control_solution, cs_p.control_solution)
    chosen_states = pick(cs_a.state_solution, cs_p.state_solution)
    chosen_U = pick(cs_a.U, cs_p.U)
    cs_p = cs_p._replace(state_solution=chosen_states,
                         control_solution=chosen_ctrl, U=chosen_U)
    gains = None
    if ddp is not None:
        rngs = params["control_rngs"].reshape(-1, 2)[-2:]
        run = lambda *a: ddp._run(params, *a, rngs[:, 0],
                                  rngs[:, 1]).feedback_gain
        gains = (run(state, chosen_U, chosen_states, chosen_ctrl)
                 if use_actual.dim() == 0 else torch.stack(
                     [run(*a) for a in zip(state, chosen_U, chosen_states,
                                           chosen_ctrl)]))
    return TubeSolve(cs_a, cs_p, st_a, st_p, use_actual, chosen_ctrl,
                     chosen_states, gains)


def _signature(obj, keep: list):
    """A comparable description of ``obj`` (params trees, dataclasses,
    tensors by identity and version); the tensors are appended to
    ``keep``, which holds them so that their ids stay theirs."""
    if torch.is_tensor(obj):
        keep.append(obj)
        return ("tensor", id(obj), obj._version)
    if isinstance(obj, dict):
        return tuple((k, _signature(v, keep)) for k, v in sorted(obj.items()))
    if isinstance(obj, (list, tuple)):
        return tuple(_signature(v, keep) for v in obj)
    if dataclasses.is_dataclass(obj):
        return (type(obj).__name__,) + tuple(
            (f.name, _signature(getattr(obj, f.name), keep))
            for f in dataclasses.fields(obj))
    if isinstance(obj, np.ndarray):
        return ("array", obj.dtype.str, obj.shape, obj.tobytes())
    return obj


class _Plan:
    """One episode's device buffers, and on the card its captured tick: the
    two controllers' carries, the plant state, gamma, the draws, the staged
    keys and circles, the tick counter and the per-tick result rows; with
    ``lanes``, the carries, the state, gamma and each row with a leading
    lane axis (the draws are shared)."""

    def __init__(self, runner: "EpisodeRunner", capacity: bool,
                 n_circles: Optional[int], lanes: Optional[int] = None):
        dev, n = runner.device, runner.n_ticks
        f32 = dict(dtype=torch.float32, device=dev)
        solvers = (runner.solver, runner.solver_predicted)
        lead = () if lanes is None else (lanes,)
        self.lanes = lanes
        self.carries = [s.init_state(0) for s in solvers]
        if lanes is not None:
            self.carries = [cs._replace(**{
                name: getattr(cs, name).expand(*lead, *getattr(
                    cs, name).shape).clone() for name in _CARRIED})
                for cs in self.carries]
        S = runner.solver.model.STATE_DIM
        C = runner.solver.model.CONTROL_DIM
        self.state = torch.zeros(*lead, S, **f32)
        # gamma and the ESS law's band, a lane's own each
        self.gamma = torch.zeros(lead, **f32)
        self.g_lo = torch.zeros(lead, **f32)
        self.g_hi = torch.zeros(lead, **f32)
        self.tick = torch.zeros(1, dtype=torch.int64, device=dev)
        iters = runner.solver.cfg.num_iters
        # the capacity mode's keys, (n_ticks, iters * 2) a controller, or
        # the host-noise mode's eps, one (T, K, C) an iteration
        self.keys = ([torch.zeros((n, iters * 2), dtype=torch.int64,
                                  device=dev) for _ in solvers]
                     if capacity else None)
        self.eps = (None if capacity else
                    [[torch.zeros((s.cfg.num_timesteps, s.cfg.num_rollouts,
                                   C), **f32) for _ in range(iters)]
                     for s in solvers])
        self.circles = (None if n_circles is None
                        else torch.zeros((n, n_circles, 3), **f32))
        # a row a tick (a lane): state (S), control (C), used_actual,
        # trajectory_cost, ess, crash_frac, gamma
        self.out = torch.zeros((n, *lead, S + C + 5), **f32)
        self.graph = None
        self.signature = None
        self.keep = []

    def draws(self, c: int):
        """Controller c's draws for this tick, as ``_solve_drawn`` takes
        them."""
        if self.keys is None:
            return self.eps[c]
        keys = torch.index_select(self.keys[c], 0, self.tick)[0]
        return [keys[2 * j:2 * j + 2] for j in range(keys.numel() // 2)]

    def result(self, S: int, C: int) -> EpisodeResult:
        o = self.out if self.lanes is None else self.out.transpose(0, 1)
        copy = lambda t: t.clone(memory_format=torch.contiguous_format)
        col = lambda j: copy(o[..., j])
        return EpisodeResult(states=copy(o[..., :S]),
                             controls=copy(o[..., S:S + C]),
                             used_actual=o[..., S + C] > 0.5,
                             trajectory_cost=col(S + C + 1),
                             ess=col(S + C + 2), crash_frac=col(S + C + 3),
                             gamma=col(S + C + 4))


class EpisodeRunner:
    """Tube-MPPI closed loop against a simulated plant on the solver's
    device (``cuda`` unless the solver was built for the CPU)."""

    def __init__(self, solver: MPPISolver, true_model=None,
                 n_ticks: int = 1000, use_feedback_gains: bool = False,
                 pose_substeps: int = 1, throttle_max: float = 0.65,
                 ess_target_frac: Optional[float] = None,
                 ess_alpha: float = 0.25, ess_headroom: float = 8.0,
                 solver_predicted: Optional[MPPISolver] = None):
        """``ess_target_frac``: carry the ``EssTuner`` law through the
        episode (a multiplicative step on the measured ESS a tick, clamped
        to ``gamma/headroom .. gamma*headroom`` around the effective
        starting gamma), on the device.  The target is sized from the
        actual solver's K; the winning solve's ESS drives the shared gamma.

        ``solver_predicted``: an asymmetric tube, whose predicted-state
        half runs this solver (it may differ from ``solver`` only in
        ``num_rollouts``)."""
        validate_tube_pair(solver, solver_predicted)
        self.solver = solver
        self.solver_predicted = solver_predicted or solver
        self.device = solver.device
        self.true_model = true_model or solver.model
        if self.true_model.device != self.device:
            raise ValueError(f"true_model is on {self.true_model.device}, "
                             f"the solver on {self.device}")
        self.n_ticks = int(n_ticks)
        self.use_feedback_gains = bool(use_feedback_gains)
        self.pose_substeps = int(pose_substeps)
        self.throttle_max = float(throttle_max)
        self._ess_target = None
        if ess_target_frac is not None:
            if not (0.0 < ess_target_frac <= 1.0):
                raise ValueError(
                    f"ess_target_frac in (0, 1]: {ess_target_frac}")
            self._ess_target = float(ess_target_frac) * solver.cfg.num_rollouts
            if self._ess_target > self.solver_predicted.cfg.num_rollouts:
                # the predicted half could never reach it and would drag
                # the shared gamma to the lower clamp whenever it wins
                raise ValueError(
                    f"ess target {self._ess_target:.0f} (frac of the "
                    f"actual solver's K={solver.cfg.num_rollouts}) "
                    f"exceeds the predicted solver's "
                    f"K={self.solver_predicted.cfg.num_rollouts} — "
                    f"unreachable whenever the predicted controller "
                    f"wins; lower the frac or raise K_pred")
            self._ess_alpha = float(ess_alpha)
            self._ess_headroom = float(ess_headroom)
        if solver.cfg.optimization_stride < 1 or self.pose_substeps < 1:
            raise ValueError(
                "the episode advances the plant optimization_stride x "
                "pose_substeps steps a tick, both at least 1: got "
                f"{solver.cfg.optimization_stride} x {self.pose_substeps}")
        expected_dt = solver.cfg.dt / self.pose_substeps
        if abs(self.true_model.dt - expected_dt) > 1e-9:
            raise ValueError(
                f"true_model.dt={self.true_model.dt} must equal "
                f"cfg.dt/pose_substeps={expected_dt}")
        self.ddp = (DDPSolver(solver.model, solver.cfg.dt,
                              solver.cfg.num_timesteps, device=self.device)
                    if self.use_feedback_gains else None)
        f32 = dict(dtype=torch.float32, device=self.device)
        self._u_lo = torch.tensor([-0.99, -0.99], **f32)
        self._u_hi = torch.tensor([0.99, self.throttle_max], **f32)
        self._captured: Optional[_Plan] = None

    @property
    def captures(self) -> bool:
        """Whether :meth:`run` captures the tick and replays it: on a CUDA
        device (unless a run asks for ``eager``)."""
        return self.device.type == "cuda"

    # -- one tick ------------------------------------------------------------

    def _executed_control(self, j: int, state, chosen_ctrl, chosen_states,
                          gains):
        """The control published at plant substep ``j`` (pose time tau = j
        dt / pose_substeps after the solve; ``autorally_plant.cpp:
        215-250``): the alpha-interpolated feedforward, with gains plus the
        interpolated feedback, clamped; a NaN feedback falls back to the
        feedforward.  tau, the interpolation index and alpha are the JAX
        package's float32 values, computed on the host.  Lanes (state (L,
        S), the plans with a leading L) take the feedforward together and
        their gains lane by lane."""
        if state.dim() == 2 and gains is not None:
            return torch.stack([self._executed_control(j, *lane)
                                for lane in zip(state, chosen_ctrl,
                                                chosen_states, gains)])
        cfg = self.solver.cfg
        T = cfg.num_timesteps
        tau = np.float32(j) * np.float32(cfg.dt / self.pose_substeps)
        r = np.float32(tau / np.float32(cfg.dt))
        lo = int(np.clip(np.floor(r), 0, T - 1))
        hi = min(lo + 1, T - 1)
        alpha = np.float32(r - np.float32(lo))
        a0, a1 = float(np.float32(1) - alpha), float(alpha)
        u_ff = a0 * chosen_ctrl[..., lo, :] + a1 * chosen_ctrl[..., hi, :]
        if gains is None:
            return u_ff
        x_des = a0 * chosen_states[lo] + a1 * chosen_states[hi]
        K = a0 * gains[lo] + a1 * gains[hi]                   # (C, S)
        dU = torch.mv(K, state - x_des)
        u_fb = torch.clamp(u_ff + dU, self._u_lo, self._u_hi)
        return torch.where(torch.isnan(dU).any(), u_ff, u_fb)

    def _tick(self, plan: _Plan, params_ctrl, params_true, cost_params,
              costmap) -> None:
        """One control tick on ``plan``'s buffers; reads nothing from the
        host, so that it can be captured."""
        solvers = (self.solver, self.solver_predicted)
        cfg = self.solver.cfg
        cp = cost_params.replace(gamma=plan.gamma)
        if plan.circles is not None:
            cp = cp.replace(obstacles=torch.index_select(
                plan.circles, 0, plan.tick)[0])
        # receding-horizon slide (run_control_loop.cuh:206-215)
        cs_a, cs_p = (s._slide(c, cfg.optimization_stride)
                      for s, c in zip(solvers, plan.carries))
        ts = tube_solve(solvers, self.ddp, params_ctrl, cp, costmap,
                        plan.state, cs_a, cs_p, plan.draws(0), plan.draws(1))
        chosen_ctrl, chosen_states, gains = ts.control, ts.states, ts.gains
        # the plant under the true model at the pose rate (debug-mode
        # self-propagation through the plant's pipeline)
        state, u0 = plan.state, None
        for j in range(cfg.optimization_stride * self.pose_substeps):
            u = self._executed_control(j, state, chosen_ctrl, chosen_states,
                                       gains)
            state, _ = self.true_model.update_state(params_true, state, u)
            u0 = u if u0 is None else u0
        ess = ts.stat("ess")
        row = torch.cat([state, u0,
                         ts.use_actual.to(torch.float32)[..., None],
                         ts.stat("trajectory_cost")[..., None],
                         ess[..., None], ts.stat("crash_frac")[..., None],
                         plan.gamma[..., None]], dim=-1)
        plan.out.index_copy_(0, plan.tick, row[None])
        # the carries, after everything that reads them
        if self._ess_target is not None:
            plan.gamma.copy_(gamma_step_traced(
                plan.gamma, ess, self._ess_target, self._ess_alpha,
                plan.g_lo, plan.g_hi))
        for carry, new in zip(plan.carries, (ts.cs_a, ts.cs_p)):
            for name in _CARRIED:
                getattr(carry, name).copy_(getattr(new, name))
        plan.state.copy_(state)
        plan.tick += 1

    # -- the run ---------------------------------------------------------------

    def _stage(self, plan: _Plan, cost_params, state0, subkeys,
               obstacle_traj) -> None:
        """The run's initial carries (``init_state`` with the start state
        as the first nominal state), gamma and its band, the capacity
        mode's keys and the circles, into ``plan``'s buffers."""
        cfg = self.solver.cfg
        for carry, s in zip(plan.carries,
                            (self.solver, self.solver_predicted)):
            init = s.init_state(0)
            for name in _CARRIED:
                getattr(carry, name).copy_(getattr(init, name))
            carry.state_solution[..., 0, :] = state0
        plan.state.copy_(state0)
        gamma0 = effective_gamma(cfg, cost_params)
        # a gamma a lane where the stacked CostParams carries one
        gamma0 = np.asarray(gamma0.detach().cpu() if torch.is_tensor(gamma0)
                            else gamma0, np.float32)

        def fill(buf, value):
            buf.copy_(torch.from_numpy(np.broadcast_to(
                np.asarray(value, np.float32), buf.shape).copy()))

        fill(plan.gamma, gamma0)
        if self._ess_target is not None:
            # the band is centered on the EFFECTIVE starting gamma (a
            # lane's own), so that an override outside the cfg-based band
            # is not clipped back
            headroom = np.float32(self._ess_headroom)
            fill(plan.g_lo, gamma0 / headroom)
            fill(plan.g_hi, gamma0 * headroom)
        if plan.keys is not None:
            for buf, subs in zip(plan.keys, subkeys):
                buf.copy_(torch.from_numpy(
                    subs.reshape(self.n_ticks, -1).astype(np.int64)))
        if plan.circles is not None:
            plan.circles.copy_(obstacle_traj)
        plan.tick.zero_()
        plan.out.zero_()

    def _subkeys(self, seed_a: int, seed_p: int) -> list:
        """Each controller's subkeys for every solve of the episode,
        (n_ticks, num_iters, 2) uint32: its key's chain of splits, as its
        solves would take them."""
        iters = self.solver.cfg.num_iters
        out = []
        for seed in (seed_a, seed_p):
            key = kernel_rng.prng_key(seed)
            subs = np.empty((self.n_ticks, iters, 2), np.uint32)
            for i in range(self.n_ticks):
                for j in range(iters):
                    key, subs[i, j] = kernel_rng.split(key)
            out.append(subs)
        return out

    def _capture(self, plan: _Plan, args) -> None:
        """Capture :meth:`_tick` on ``plan`` after one eager tick on a side
        stream, with Python's cyclic collector off."""
        if self.ddp is not None and (self.ddp.cfg.num_iterations != 1
                                     or self.ddp.cfg.use_boxqp):
            raise ValueError(
                "the episode captures the DDP's default configuration only "
                f"(one iteration, no box QP), got {self.ddp.cfg}")
        dev = self.device
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self._tick(plan, *args)
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        # an older graph freed mid-capture would invalidate this one
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph):
                self._tick(plan, *args)
        finally:
            if collecting:
                gc.enable()
        plan.graph = graph

    def run(self, params_ctrl, cost_params: CostParams, costmap, state0,
            params_true=None, seed_a: int = 0, seed_p: int = 1,
            obstacle_traj=None, eager: bool = False) -> EpisodeResult:
        """Run the episode; returns the per-tick telemetry, on the device.

        ``obstacle_traj``: optional (n_ticks, capacity, 3) per-tick circles
        (the solver's cost must be an ``ObstacleCost``): moving obstacles,
        evaluated on the device.  On the card the tick is captured (again
        when the weights, cost params, costmap or circles' capacity differ
        from the last capture's) and replayed, unless ``eager``.

        A stacked ``cost_params`` (``tools/param_sweep.stack_cost_params``:
        L lanes) runs L episodes from ``state0`` in one tick (the JAX
        package's vmap of its episode over the cost params): every solve
        draws its noise once for all lanes, each lane keeps its own
        carries, gamma and plant state, and the result's fields gain a
        leading L.  With ``ess_target_frac`` each lane carries its own
        gamma through the ESS law, stepped by its own winning solve's ESS in
        the band about its own starting gamma; ``obstacle_traj``'s circles
        of a tick are staged once and priced by every lane (the JAX vmap
        takes them unbatched), and a stacked ``cost_params.obstacles`` (L,
        N, 3) gives each lane its own circles."""
        dev = self.device
        lanes = cost_params_lanes(cost_params)
        if obstacle_traj is not None:
            if not isinstance(self.solver.cost, ObstacleCost):
                raise TypeError(
                    "obstacle_traj requires the solver's cost to be an "
                    "ObstacleCost — nothing else reads CostParams."
                    f"obstacles (got {type(self.solver.cost).__name__})")
            obstacle_traj = torch.as_tensor(
                np.asarray(obstacle_traj, np.float32)
                if not torch.is_tensor(obstacle_traj) else obstacle_traj,
                dtype=torch.float32).to(dev)
            if obstacle_traj.shape[0] != self.n_ticks:
                raise ValueError(
                    f"obstacle_traj has {obstacle_traj.shape[0]} ticks, "
                    f"episode has {self.n_ticks}")
        params_true = params_ctrl if params_true is None else params_true
        state0 = torch.as_tensor(np.asarray(state0, np.float32)
                                 if not torch.is_tensor(state0) else state0,
                                 dtype=torch.float32).to(dev)
        capacity = self.solver._use_kernel_rng(costmap)
        n_circles = (None if obstacle_traj is None
                     else obstacle_traj.shape[1])
        subkeys = self._subkeys(seed_a, seed_p)
        # what a captured tick freezes: gamma comes from its buffer, and
        # the circles from theirs when the episode moves them
        frozen = cost_params.replace(gamma=None)
        if obstacle_traj is not None:
            frozen = frozen.replace(obstacles=None)
        keep = []
        signature = _signature((params_ctrl, params_true, frozen, costmap,
                                self.solver.cost.__dict__, capacity,
                                n_circles), keep)
        circles = cost_params.obstacles
        if torch.is_tensor(circles) and circles.device != dev:
            # the tick reads the circles on the device (a stacked
            # CostParams holds them on the host); a captured tick reads
            # this copy, which ``keep`` holds
            cost_params = cost_params.replace(obstacles=circles.to(dev))
            keep.append(cost_params.obstacles)
        args = (params_ctrl, params_true, cost_params, costmap)
        graph = self.captures and not eager
        plan = self._captured if graph else None
        if plan is None or plan.signature != signature:
            if graph:
                self._captured = None         # the stale graph goes first
            plan = _Plan(self, capacity, n_circles, lanes)
            if graph:
                self._stage(plan, cost_params, state0, subkeys,
                            obstacle_traj)
                self._capture(plan, args)
                # the kernels read the packed weights (ops/rollout_kernel's
                # cache, on the model and a field) and the lane scalars (the
                # solvers') by address: a later solve on other values must
                # not free the captured ones
                keep += [getattr(o, "_kernel_pack", None)
                         for o in (self.solver.model, costmap)]
                keep += [s._lane_pack for s in (self.solver,
                                                self.solver_predicted)]
                plan.signature, plan.keep = signature, keep
                self._captured = plan
        self._stage(plan, cost_params, state0, subkeys, obstacle_traj)
        for i in range(self.n_ticks):
            if plan.eps is not None:
                for c, s in enumerate((self.solver, self.solver_predicted)):
                    for buf, sub in zip(plan.eps[c], subkeys[c][i]):
                        buf.copy_(s._draw(costmap, sub))
            if plan.graph is not None:
                plan.graph.replay()
            else:
                self._tick(plan, *args)
        model = self.solver.model
        return plan.result(model.STATE_DIM, model.CONTROL_DIM)
