"""Stateful controller facade over the solvers (port of
``autorally_tpu/runtime/controller.py``).

Mirrors the host-side API of ``MPPIController``
(``mppi_controller.cuh:52-217``), the object the control loop drives.  Hot
updates (cost params, costmap, model weights, throttle cut) replace what
the next solve reads; nothing is rebuilt.

The JAX package's arrays are immutable and PyTorch's tensors are not, so
the injections copy what they are given onto the device and the accessors
return host copies (as ``np.asarray`` of a device array does there): after
a resync the two controllers of the tube share no storage.

On a GPU each controller runs its DDP on a CUDA stream of its own, and
``compute_feedback_gains`` returns once the run is enqueued: the two
controllers' runs of a tick overlap, and ``ddp_result`` (which the gains'
accessor reads) waits for its controller's run.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from autorally_tpu_torch.config import CostParams, resolve_device
from autorally_tpu_torch.costs.costmap import Costmap
from autorally_tpu_torch.costs.mppi_cost import MPPICost
from autorally_tpu_torch.solver.ddp import DDPResult, DDPSolver
from autorally_tpu_torch.solver.mppi import (ControllerState, MPPISolver,
                                             SolveStats)


def stats_degenerate(ess: float, crash_frac: float, num_rollouts: int,
                     crash_thresh: float = 0.9,
                     ess_mult: float = 5.0,
                     position_track_cost: Optional[float] = None,
                     boundary_threshold: Optional[float] = None,
                     speed: Optional[float] = None,
                     speed_gate: Optional[float] = None) -> bool:
    """The degeneracy test on raw telemetry scalars, shared by
    :meth:`Controller.plan_degenerate` (and the JAX package's async
    loop's harvest guard).  See :meth:`Controller.plan_degenerate` for the
    rationale.

    ``position_track_cost``/``boundary_threshold`` gate the trigger on
    the vehicle's OWN position being on/over the track boundary (the
    max of the front/back channel-0 samples the crash latch uses).
    The flat-softmax statistics alone cannot discriminate: a small-K /
    short-horizon solve lapping an oval shows the same (crash~1,
    ESS~0.6K) signature as genuinely degenerate off-track seeds, since
    all rollouts eventually latch over a short noisy horizon even though
    the latched costs still rank the futures and the car drives fine.
    What separates the failing cases is the car itself being off-track
    while the weights are flat, so that is the condition the brake
    requires.  Callers that cannot evaluate their position pass ``None``
    and get the stats-only rule.

    ``speed``/``speed_gate`` additionally release the brake below a
    longitudinal-speed floor: the hazard the guard exists for is driving
    AT SPEED on a no-preference plan; a slow or stationary car off the
    boundary must be allowed to act on its plan or the brake deadlocks
    recovery (once braked to a stop it would hold a crashed car there
    forever).
    """
    if crash_frac <= crash_thresh:
        return False
    if not ess > ess_mult * (1.0 - crash_frac) * num_rollouts:
        return False
    if speed is not None and speed_gate is not None \
            and abs(speed) <= speed_gate:
        return False
    if position_track_cost is None or boundary_threshold is None:
        return True
    return position_track_cost >= boundary_threshold


def _host(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t`` that shares no storage with it."""
    return t.detach().to("cpu", copy=True).numpy()


class Controller:
    """One MPPI controller instance (the loop runs two for tube-MPPI), on
    its solver's device."""

    def __init__(self, solver: MPPISolver, model_params,
                 cost_params: CostParams, costmap: Costmap,
                 ddp: Optional[DDPSolver] = None, seed: Optional[int] = None):
        self.device = resolve_device(solver.device)
        if ddp is not None and ddp.device != self.device:
            raise ValueError(f"DDP solver is on {ddp.device}, MPPI solver "
                             f"on {self.device}")
        self.solver = solver
        self.model = solver.model
        self.cfg = solver.cfg
        self.model_params = model_params
        self.cost_params = cost_params
        self.costmap = costmap
        self.ddp = ddp
        self.cs: ControllerState = solver.init_state(seed)
        self.stats: Optional[SolveStats] = None
        self._ddp_result: Optional[DDPResult] = None
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" and ddp is not None
                        else None)
        self._traj_cost = float("inf")
        self._last_solve_state: Optional[np.ndarray] = None

    def _device(self, a) -> torch.Tensor:
        """A float32 copy of ``a`` (array or tensor) on the device."""
        if torch.is_tensor(a):
            return a.detach().to(self.device, torch.float32, copy=True)
        return torch.tensor(np.asarray(a, dtype=np.float32),
                            device=self.device)

    # -- the loop's verbs (run_control_loop.cuh:206-225) --------------------

    def slide_control_and_state_seq(self, stride: int) -> None:
        self.cs = self.solver.slide(self.cs, int(stride))

    def compute_control(self, state: np.ndarray) -> None:
        """Replan from the given (actual) state."""
        self.cs, self.stats = self.solver.solve(
            self.model_params, self.cost_params, self.costmap, state, self.cs)
        self._traj_cost = float(self.stats.trajectory_cost)
        self._last_solve_state = np.array(state, dtype=np.float32)

    def compute_control_predicted(self) -> None:
        """Replan from the controller's own predicted state: the first
        entry of its state solution (``computeControl()``,
        mppi_controller.cu:588-598)."""
        self.compute_control(_host(self.cs.state_solution[0]))

    def compute_feedback_gains(self, state: np.ndarray) -> None:
        """Tube-tracking gains around the current solution
        (``computeFeedbackGains``, mppi_controller.cu:427-439): the plan U
        as the DDP's controls, the state and control solutions as its
        targets, ``control_rngs`` as its limits."""
        if self.ddp is None:
            return
        rngs = self.model_params["control_rngs"]
        self._ddp_result = self.ddp.run(
            self.model_params, state, self.cs.U, self.cs.state_solution,
            self.cs.control_solution, rngs[:, 0], rngs[:, 1],
            stream=self._stream)

    @property
    def ddp_result(self) -> Optional[DDPResult]:
        """The latest DDP run's result, ready on the current stream."""
        if self._ddp_result is not None and self._stream is not None:
            torch.cuda.current_stream(self.device).wait_stream(self._stream)
        return self._ddp_result

    # -- accessors (mppi_controller.cu:677-693): host copies ----------------

    def get_control_seq(self) -> np.ndarray:
        return _host(self.cs.control_solution)

    def get_state_seq(self) -> np.ndarray:
        return _host(self.cs.state_solution)

    def get_feedback_gains(self) -> Optional[np.ndarray]:
        res = self.ddp_result
        return None if res is None else _host(res.feedback_gain)

    def get_computed_trajectory_cost(self) -> float:
        return self._traj_cost

    def plan_degenerate(self, crash_thresh: float = 0.9,
                        ess_mult: float = 5.0,
                        speed_gate: float = 2.0,
                        state: Optional[np.ndarray] = None) -> bool:
        """True when the latest solve carries no preference: nearly all
        rollouts crash-latched AND the importance-weight mass is NOT on
        the few survivors.

        When every sampled trajectory hits the crash penalty, the costs
        equalize, the weights go uniform, and the weighted update is a
        plain average of noise: a plan that barely steers.  The
        discriminator is relative to the surviving fraction: with S =
        (1-crash)*K non-crashed rollouts, a healthy near-wall recovery
        concentrates its weights on those S (ESS of order S), while a
        degenerate flat softmax has ESS >> S.  The loop's guard brakes on
        it: the NaN-control zero-command philosophy
        (``autorally_plant.cpp:353-375``) applied to flat-softmax plans.

        The flat-softmax statistics are gated on the vehicle's OWN
        position being on/over the track boundary AND on it moving faster
        than ``speed_gate`` (see :func:`stats_degenerate`); the position
        lookup runs only once the cheap scalar tests pass.

        ``state`` is the MEASURED vehicle state the gates evaluate at; it
        defaults to the state this controller last solved from, which is
        right only for the actual-state controller: the predicted-state
        controller solves from where it BELIEVES the car is, so a loop
        arbitrating between the two passes the measured state."""
        if self.stats is None:
            return False
        if state is None:
            state = self._last_solve_state
        speed = None if state is None else float(state[4])
        if not stats_degenerate(float(self.stats.ess),
                                float(self.stats.crash_frac),
                                self.cfg.num_rollouts,
                                crash_thresh, ess_mult,
                                speed=speed, speed_gate=speed_gate):
            return False
        pos_cost = self.position_track_cost(state)
        if pos_cost is None:
            return True
        return pos_cost >= float(self.cost_params.boundary_threshold)

    def position_track_cost(self, state: Optional[np.ndarray] = None
                            ) -> Optional[float]:
        """Channel-0 track cost at the vehicle footprint of ``state``
        (default: the last solved state): the max of the same front/back
        samples the crash latch uses (``getTrackCost``, costs.cu:359-393).
        None before any solve."""
        if state is None:
            state = self._last_solve_state
        if state is None:
            return None
        x, y, yaw = self._device(np.asarray(state, dtype=np.float32)[:3])
        return float(MPPICost.footprint_track_cost(self.costmap, x, y, yaw))

    # -- state injection (tube resync, run_control_loop.cuh:263-266) ---------

    def set_state(self, state: np.ndarray) -> None:
        ss = self.cs.state_solution.clone()
        ss[0] = self._device(state)
        self.cs = self.cs._replace(state_solution=ss)

    def set_state_sequence(self, seq: np.ndarray) -> None:
        self.cs = self.cs._replace(state_solution=self._device(seq))

    def set_control_sequence(self, seq: np.ndarray) -> None:
        self.cs = self.cs._replace(control_solution=self._device(seq),
                                   U=self._device(seq))

    def reset_controls(self) -> None:
        self.cs = self.solver.reset_controls(self.cs)

    # -- hot updates (run_control_loop.cuh:182-204) ---------------------------

    def update_cost_params(self, cost_params: CostParams) -> None:
        self.cost_params = cost_params

    def update_costmap(self, costmap: Costmap) -> None:
        self.costmap = costmap

    def update_model_params(self, model_params) -> None:
        self.model_params = model_params

    def cut_throttle(self) -> None:
        """Emergency stop (``cutThrottle``, mppi_controller.cu:459-466):
        desired speed -> 0 and max throttle -> 0, as parameter updates."""
        self.cost_params = self.cost_params.replace(desired_speed=0.0)
        rngs = self._device(self.model_params["control_rngs"])
        rngs[1, 1] = 0.0
        self.model_params = {**self.model_params, "control_rngs": rngs}
