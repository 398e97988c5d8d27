"""The real-time control loop with tube-MPPI dual-controller arbitration
(port of ``autorally_tpu/runtime/control_loop.py``).

Port of ``runControlLoop`` (``run_control_loop.cuh:84-321``): two
controllers run every tick — one solving from the *actual* (estimated)
state, one from its own *predicted* state — and the solution with the lower
computed trajectory cost wins; when the actual-state controller wins, the
predicted-state controller is resynchronized to it (the robust/tube-MPPI
scheme, run_control_loop.cuh:246-286).

Two execution modes:

- ``lockstep`` (default): each loop tick advances a :class:`SyntheticPlant`
  by ``optimization_stride`` control periods — deterministic, testable, and
  equivalent to the reference's ``debug_mode`` self-propagation
  (run_control_loop.cuh:296-302) but through the full plant pipeline
  (interpolation + feedback application).
- ``realtime``: wall-clock paced to ``optimization_stride / hz`` with the
  plant fed externally (a live pose stream), matching the reference's
  paced-sleep behavior (run_control_loop.cuh:304-312) with ``time.sleep``
  (the JAX package's native absolute-deadline pacer waits for the port of
  ``runtime/native.py``, ROADMAP.md Queue 1 item 11).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

from autorally_tpu_torch.runtime.controller import Controller
from autorally_tpu_torch.runtime.plant import BasePlant
from autorally_tpu_torch.runtime.telemetry import StatusMonitor, TimingStats


@dataclasses.dataclass
class ControlLoopConfig:
    hz: int = 50
    num_timesteps: int = 100
    optimization_stride: int = 1
    use_feedback_gains: bool = True
    max_iter: Optional[int] = None          # profiler_max_iter equivalent
    use_only_actual: bool = False
    use_only_predicted: bool = False
    realtime: bool = False
    # Degeneracy guard (from the JAX package's ensemble A/B evaluation,
    # EVAL.md): when the winning solve's rollouts nearly ALL crash-latch
    # and the weight
    # mass is not on the survivors (ESS >> (1-crash)*K — a flat softmax
    # over crashed futures), the plan is an average of noise — publish
    # it with the throttle clamped to brake and without feedback gains
    # (computed around a meaningless solution), instead of driving at
    # speed on no preference.  The trigger is additionally gated on the
    # MEASURED vehicle state: the car's own footprint must be on/over
    # the track boundary and moving faster than
    # ``degenerate_speed_gate`` (a braked-to-a-stop car must stay free
    # to crawl back to the track).  OPT-IN (default off): at
    # deployment scale (K>=32K, T=100, reference cost params) the
    # trigger was only ever observed in the genuinely-degenerate
    # off-track A/B seeds, but small-K / short-horizon configs
    # legitimately drive with all rollouts latching and footprint
    # costs over the boundary (the JAX package's K=96/T=24 estimator
    # loop laps with median footprint cost 1.68 and crash_frac 1.0), so no
    # scalar signature separates the regimes robustly — enable it on
    # deployment configs, leave it off for small studies
    # (see runtime/controller.py::stats_degenerate).
    degeneracy_guard: bool = False
    degenerate_crash_thresh: float = 0.9
    degenerate_ess_mult: float = 5.0
    degenerate_speed_gate: float = 2.0


def run_control_loop(predicted: Controller, actual: Controller,
                     plant: BasePlant, cfg: ControlLoopConfig,
                     is_alive: Optional[Callable[[], bool]] = None,
                     monitor: Optional[StatusMonitor] = None,
                     on_tick: Optional[Callable] = None,
                     timing: Optional[TimingStats] = None) -> TimingStats:
    """Drive the dual controllers against the plant until ``max_iter`` ticks
    or ``is_alive()`` goes false.  Returns the accumulated timing stats
    (pass ``timing`` to observe them live, e.g. from a telemetry tick)."""
    alive = is_alive or (lambda: True)
    timing = TimingStats() if timing is None else timing
    stride_default = cfg.optimization_stride
    period = stride_default / cfg.hz

    # -- initialization (run_control_loop.cuh:146-155) -----------------------
    state = plant.get_state().to_vector()
    actual.set_state(state)
    predicted.set_state(state)
    actual.reset_controls()
    predicted.reset_controls()
    if cfg.use_feedback_gains:
        actual.compute_feedback_gains(state)
        predicted.compute_feedback_gains(state)

    last_pose_time = plant.get_last_pose_time()
    loop_time = period
    status = 1
    num_iter = 0
    degenerate_ticks = 0
    max_iter = cfg.max_iter if cfg.max_iter is not None else 2 ** 31

    while alive() and num_iter < max_iter and not plant.shutdown:
        tick_start = time.perf_counter()
        num_iter += 1

        # state update (run_control_loop.cuh:176-181)
        t_pose = plant.get_last_pose_time()
        if t_pose != last_pose_time:
            loop_time = t_pose - last_pose_time
            last_pose_time = t_pose
            state = plant.get_state().to_vector()

        # hot updates: cost params / costmap / model weights, applied to
        # both controllers between solves (run_control_loop.cuh:182-204)
        new_cost, new_map, new_model = plant.take_updates()
        for ctrl in (actual, predicted):
            if new_cost is not None:
                ctrl.update_cost_params(new_cost)
            if new_map is not None:
                ctrl.update_costmap(new_map)
            if new_model is not None:
                ctrl.update_model_params(new_model)

        # stride (run_control_loop.cuh:206-215)
        stride = int(round(loop_time * cfg.hz))
        if status != 0:
            stride = stride_default
        if 0 <= stride < cfg.num_timesteps:
            actual.slide_control_and_state_seq(stride)
            predicted.slide_control_and_state_seq(stride)

        # the two solves (run_control_loop.cuh:218-225)
        actual.compute_control(state)
        predicted.compute_control_predicted()
        if cfg.use_feedback_gains:
            actual.compute_feedback_gains(state)
            predicted.compute_feedback_gains(state)

        # arbitration (run_control_loop.cuh:246-286)
        if cfg.use_only_actual and not cfg.use_only_predicted:
            chosen, used = actual, "actual"
        elif cfg.use_only_predicted and not cfg.use_only_actual:
            chosen, used = predicted, "predicted"
        else:
            if (actual.get_computed_trajectory_cost()
                    < predicted.get_computed_trajectory_cost()):
                chosen, used = actual, "actual"
                predicted.set_state_sequence(actual.get_state_seq())
                predicted.set_control_sequence(actual.get_control_seq())
            else:
                chosen, used = predicted, "predicted"

        gains = chosen.get_feedback_gains() if cfg.use_feedback_gains else None
        ctrl_seq = chosen.get_control_seq()
        if cfg.degeneracy_guard and chosen.plan_degenerate(
                cfg.degenerate_crash_thresh, cfg.degenerate_ess_mult,
                cfg.degenerate_speed_gate, state=state):
            # no-preference plan: keep steering, brake the throttle, drop
            # the gains (see ControlLoopConfig.degeneracy_guard)
            ctrl_seq = ctrl_seq.copy()
            ctrl_seq[:, 1] = min(0.0, float(ctrl_seq[:, 1].min()))
            gains = None
            degenerate_ticks += 1
        plant.set_solution(chosen.get_state_seq(), ctrl_seq,
                           gains, last_pose_time, used)

        # realtime: staleness against the receive-side wall clock (pose
        # stamps ride the producer's clock); lockstep: the pose stream
        # advances with the loop, so pose-time staleness is the check
        status = (plant.check_status_wall() if cfg.realtime
                  else plant.check_status(plant.get_last_pose_time()))
        if monitor is not None:
            monitor.heartbeat(plant.get_last_pose_time(), status,
                              f"controller={used}")
        if on_tick is not None:
            on_tick(num_iter, chosen, used, state)

        tick_s = time.perf_counter() - tick_start

        # advance / pace: any plant exposing step_sim (SyntheticPlant,
        # the physics SimVehiclePlant) advances in lockstep
        missed = 0
        if not cfg.realtime and hasattr(plant, "step_sim"):
            plant.step_sim(stride_default)       # lockstep sim advance
            last_sleep = 0.0
        else:
            remaining = period - tick_s
            last_sleep = max(0.0, remaining)
            if remaining > 0:
                time.sleep(remaining)
            else:
                missed = int(tick_s / period)    # budget overrun periods

        timing.update(loop_time * 1000.0, tick_s * 1000.0,
                      last_sleep * 1000.0, missed=missed)
        plant.set_timing_info(timing.avg_loop_ms, timing.avg_tick_ms,
                              timing.avg_sleep_ms)
    timing.degenerate_ticks = degenerate_ticks    # guard telemetry
    return timing
