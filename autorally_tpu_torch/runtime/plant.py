"""Plant interfaces, the system under control (port of
``autorally_tpu/runtime/plant.py``).

``BasePlant`` is the framework's ``AutorallyPlant``
(``autorally_plant.h:94-303`` / ``.cpp``) without ROS: it owns the current
vehicle state, receives the controller's solution, and at pose rate
interpolates that solution — optionally adding the DDP feedback term
``K (x - x_des)`` — into the control actually applied
(``poseCall``, autorally_plant.cpp:215-250).  Safety semantics are kept:
NaN control publishes a zero command and flags shutdown
(``pubControl``, autorally_plant.cpp:353-375), a runstop forces zero
throttle, and ``check_status`` reports the 0/1/2 state machine
(``checkStatus``, autorally_plant.cpp:443-459).

Implementations:

- :class:`SyntheticPlant` — integrates a "true" dynamics model (which may
  differ from the controller's model: model-mismatch experiments), the
  role Gazebo plays for the reference; the model steps on its own device
  (``cuda`` unless it was built for the CPU).
- :class:`ReplayPlant` — replays a logged pose stream (CSV), the rosbag
  workflow.
"""

from __future__ import annotations

import dataclasses
import math
import threading
import time
from typing import List, Optional, Tuple

import numpy as np

import torch

from autorally_tpu_torch.config import resolve_device
from autorally_tpu_torch.runtime.pose import (HeadingUnwrapper,
                                              quat_to_euler_123,
                                              world_to_body_velocity)

TIMEOUT = 0.5  # pose staleness threshold (autorally_plant.h:269)


@dataclasses.dataclass
class FullState:
    """Mirror of ``AutorallyPlant::FullState`` (autorally_plant.h:99-131)."""

    x_pos: float = 0.0
    y_pos: float = 0.0
    z_pos: float = 0.0
    roll: float = 0.0
    pitch: float = 0.0
    yaw: float = 0.0
    u_x: float = 0.0
    u_y: float = 0.0
    yaw_mder: float = 0.0
    steering: float = 0.0
    throttle: float = 0.0

    def to_vector(self) -> np.ndarray:
        """The controller's 7-state [x, y, yaw, roll, u_x, u_y, yaw_mder]
        (run_control_loop.cuh:148-149)."""
        return np.array([self.x_pos, self.y_pos, self.yaw, self.roll,
                         self.u_x, self.u_y, self.yaw_mder], dtype=np.float32)


class BasePlant:
    """Thread-safe state/solution exchange + control publication."""

    def __init__(self, dt: float, num_timesteps: int,
                 use_feedback_gains: bool = True, throttle_max: float = 0.65):
        self.dt = float(dt)
        self.num_timesteps = int(num_timesteps)
        self.use_feedback_gains = use_feedback_gains
        self.throttle_max = float(throttle_max)

        self._lock = threading.RLock()
        self.full_state = FullState()
        self.last_pose_time: float = -1.0
        self.last_pose_mono: float = -1.0   # receive-side wall clock
        self.pose_count = 0
        self.dropped_poses = 0              # out-of-order/duplicate drops
        self.activated = False
        self.runstop = False
        self.shutdown = False
        self._unwrap = HeadingUnwrapper()

        # current solution
        self.solution_received = False
        self.state_sequence: Optional[np.ndarray] = None     # (T, 7)
        self.control_sequence: Optional[np.ndarray] = None   # (T, 2)
        self.feedback_gains: Optional[np.ndarray] = None     # (T, 2, 7)
        self.solution_ts: float = 0.0
        self.controller_type: str = "none"
        self.timing = (0.0, 0.0, 0.0)
        self.published: List[Tuple[float, float, float]] = []  # (t, steer, thr)

        # pending hot updates for the optimizer loop (the reference's
        # dynamic_reconfigure / costmap / model message queues,
        # autorally_plant.cpp:262-309, run_control_loop.cuh:182-204)
        self._pending_cost_params = None
        self._pending_costmap = None
        self._pending_model_params = None

    # -- hot-update queue (publisher side: any thread) -----------------------

    def push_cost_params(self, cost_params) -> None:
        """Queue new cost parameters (the dynamic_reconfigure path)."""
        with self._lock:
            self._pending_cost_params = cost_params

    def push_costmap(self, costmap) -> None:
        """Queue a new costmap (the map-update path)."""
        with self._lock:
            self._pending_costmap = costmap

    def push_model_params(self, model_params) -> None:
        """Queue new dynamics weights (the live neuralNetModel push,
        autorally_plant.cpp:262-301)."""
        with self._lock:
            self._pending_model_params = model_params

    def take_updates(self):
        """Drain pending updates (consumer side: the optimizer loop).
        Returns (cost_params | None, costmap | None, model_params | None)."""
        with self._lock:
            out = (self._pending_cost_params, self._pending_costmap,
                   self._pending_model_params)
            self._pending_cost_params = None
            self._pending_costmap = None
            self._pending_model_params = None
            return out

    # -- state in ------------------------------------------------------------

    def receive_pose(self, t: float, x: float, y: float, z: float,
                     quat: Tuple[float, float, float, float],
                     world_vel: Tuple[float, float, float],
                     yaw_rate: float) -> Optional[Tuple[float, float]]:
        """Odometry in -> control out (``poseCall``).  Returns the published
        (steering, throttle) or None if no valid solution yet.

        Out-of-order or duplicate poses (possible over UDP; ROS TCP gave
        the reference ordering for free) are dropped: a regressed
        ``last_pose_time`` would corrupt the loop's stride computation
        and the staleness watchdog.  Drops are counted in
        ``dropped_poses`` (surfaced by :meth:`pose_stream_diagnostic`);
        a pose source that restarts with a reset clock must call
        :meth:`reset_pose_clock` or every new pose is time-regressed."""
        with self._lock:
            if t <= self.last_pose_time:
                self.dropped_poses += 1
                return None
            self.last_pose_time = t
            self.last_pose_mono = time.monotonic()
            self.pose_count += 1
            self.activated = True
            fs = self.full_state
            fs.x_pos, fs.y_pos, fs.z_pos = x, y, z
            roll, pitch, yaw = quat_to_euler_123(*quat)
            fs.roll, fs.pitch = roll, pitch
            fs.yaw = self._unwrap(yaw)
            fs.u_x, fs.u_y = world_to_body_velocity(
                fs.yaw, world_vel[0], world_vel[1])
            fs.yaw_mder = -yaw_rate   # (autorally_plant.cpp:212)
            return self._interp_and_publish(t)

    def receive_state_vector(self, t: float, s: np.ndarray
                             ) -> Optional[Tuple[float, float]]:
        """Direct 7-state injection (synthetic plants / replays that log the
        state vector instead of raw odometry).  Drops out-of-order /
        duplicate poses like :meth:`receive_pose`."""
        with self._lock:
            if t <= self.last_pose_time:
                self.dropped_poses += 1
                return None
            self.last_pose_time = t
            self.last_pose_mono = time.monotonic()
            self.pose_count += 1
            self.activated = True
            fs = self.full_state
            (fs.x_pos, fs.y_pos, fs.yaw, fs.roll,
             fs.u_x, fs.u_y, fs.yaw_mder) = (float(v) for v in s)
            return self._interp_and_publish(t)

    # -- control out ---------------------------------------------------------

    def _interp_and_publish(self, t: float) -> Optional[Tuple[float, float]]:
        """Solution interpolation + feedback application
        (autorally_plant.cpp:215-250)."""
        if not self.solution_received:
            return None
        dt_opt = t - self.solution_ts
        if not (0 < dt_opt < (self.num_timesteps - 1) * self.dt):
            return None
        lo = int(dt_opt / self.dt)
        hi = lo + 1
        alpha = (dt_opt - lo * self.dt) / self.dt
        u_ff = ((1 - alpha) * self.control_sequence[lo]
                + alpha * self.control_sequence[hi])
        steering, throttle = float(u_ff[0]), float(u_ff[1])

        if self.use_feedback_gains and self.feedback_gains is not None:
            x = self.full_state.to_vector()
            x_des = ((1 - alpha) * self.state_sequence[lo]
                     + alpha * self.state_sequence[hi])
            K = ((1 - alpha) * self.feedback_gains[lo]
                 + alpha * self.feedback_gains[hi])
            dU = K @ (x - x_des)
            if not (math.isnan(dU[0]) or math.isnan(dU[1])):
                steering = min(0.99, max(-0.99, steering + float(dU[0])))
                throttle = min(self.throttle_max,
                               max(-0.99, throttle + float(dU[1])))
        return self.publish_control(t, steering, throttle)

    def publish_control(self, t: float, steering: float, throttle: float
                        ) -> Tuple[float, float]:
        """``pubControl`` (autorally_plant.cpp:353-375): NaN -> zero
        steering + active braking (throttle -0.99) + shutdown; runstop ->
        zero throttle."""
        if math.isnan(steering) or math.isnan(throttle):
            steering, throttle = 0.0, -0.99
            self.shutdown = True
        if self.runstop:
            throttle = min(throttle, 0.0)
        self.full_state.steering = steering
        self.full_state.throttle = throttle
        self.published.append((t, steering, throttle))
        self.on_control(t, steering, throttle)
        return steering, throttle

    def on_control(self, t: float, steering: float, throttle: float) -> None:
        """Hook for subclasses (actuation)."""

    # -- solution handoff (``setSolution``, autorally_plant.cpp:107-126) ------

    def set_solution(self, state_seq: np.ndarray, control_seq: np.ndarray,
                     feedback_gains: Optional[np.ndarray], ts: float,
                     controller_type: str = "none") -> None:
        with self._lock:
            self.state_sequence = np.asarray(state_seq)
            self.control_sequence = np.asarray(control_seq)
            self.feedback_gains = (None if feedback_gains is None
                                   else np.asarray(feedback_gains))
            self.solution_ts = ts
            self.controller_type = controller_type
            self.solution_received = True

    def set_timing_info(self, loop_ms: float, tick_ms: float,
                        sleep_ms: float) -> None:
        self.timing = (loop_ms, tick_ms, sleep_ms)

    # -- status (``checkStatus``, autorally_plant.cpp:443-459) ----------------

    def get_state(self) -> FullState:
        with self._lock:
            return dataclasses.replace(self.full_state)

    def get_last_pose_time(self) -> float:
        with self._lock:
            return self.last_pose_time

    def check_status(self, now: float) -> int:
        """Status against ``now`` on the POSE-STAMP clock (the caller
        supplies a time comparable to the producer's stamps — lockstep
        sims and replays, where producer and consumer share a clock)."""
        with self._lock:
            if not self.activated:
                return 1          # not activated yet
            if now - self.last_pose_time > TIMEOUT:
                return 2          # stale pose
            return 0

    def check_status_wall(self) -> int:
        """Status against the RECEIVE-side wall clock — the realtime
        loops' staleness check.  Pose stamps come from the producer's
        clock (e.g. the sim node's sim-time over UDP), which need not be
        comparable to this host's; what a live deployment can actually
        observe is how long ago the last pose *arrived*
        (checkStatus, autorally_plant.cpp:443-459, where ros::Time::now()
        and the stamps share a clock — here they don't)."""
        with self._lock:
            if not self.activated:
                return 1
            if time.monotonic() - self.last_pose_mono > TIMEOUT:
                return 2
            return 0

    def set_runstop(self, engaged: bool) -> None:
        with self._lock:
            self.runstop = engaged

    # -- pose-stream observability / recovery ----------------------------------

    def reset_pose_clock(self) -> None:
        """Accept a pose source whose clock restarted (looped replay, sim
        restart): clear the monotonic-pose guard and heading unwrap so the
        next pose is taken at face value.  Without this, a time-regressed
        stream is silently dropped forever (round-3 advisor finding) —
        the drops are at least counted in ``dropped_poses``.  The drop
        counter is zeroed too: the diagnostic must describe the stream
        SINCE the operator's recovery, not keep re-raising the error the
        reset just addressed."""
        with self._lock:
            self.last_pose_time = -1.0
            self.last_pose_mono = -1.0
            self.activated = False
            self.dropped_poses = 0
            self._poses_at_reset = self.pose_count
            self._unwrap = HeadingUnwrapper()

    def pose_stream_diagnostic(self) -> dict:
        """-> {'level', 'message', 'dropped', 'received'} for the
        diagnostics rollup: WARN once out-of-order/duplicate drops appear,
        ERROR when the stream is dropping more than it delivers (the
        reset-clock signature).  Both counters describe the stream SINCE
        the last :meth:`reset_pose_clock` — a long healthy pre-reset
        history must not mask a still-regressed source after recovery."""
        with self._lock:
            dropped = self.dropped_poses
            received = self.pose_count - getattr(self, "_poses_at_reset", 0)
        if dropped == 0:
            level, msg = "ok", f"{received} poses"
        elif dropped < max(1, received):
            level = "warn"
            msg = (f"{dropped} out-of-order/duplicate poses dropped "
                   f"({received} accepted)")
        else:
            level = "error"
            msg = (f"pose stream mostly time-regressed: {dropped} dropped"
                   f" vs {received} accepted — source clock reset? "
                   "(call reset_pose_clock())")
        return {"level": level, "message": msg,
                "dropped": dropped, "received": received}


class SyntheticPlant(BasePlant):
    """Plant simulated with a (possibly different) dynamics model.

    Plays Gazebo's role: integrates the true dynamics at ``sim_rate`` using
    the last published control, and emits pose updates back into the plant
    pipeline.  Call :meth:`step_sim` to advance simulated time (lockstep
    with the control loop, or from a thread for realtime mode).  The model
    steps on its device (``model.update_state``), and the state is read
    back to the host once a period.
    """

    def __init__(self, model, model_params, init_state: np.ndarray,
                 dt: float, num_timesteps: int, **kw):
        super().__init__(dt, num_timesteps, **kw)
        self.device = resolve_device(model.device)
        self.model = model
        self.model_params = model_params
        self.true_state = np.asarray(init_state, dtype=np.float32).copy()
        self.sim_time = 0.0

    def step_sim(self, n_steps: int = 1) -> None:
        """Advance the true state n control periods; each period re-runs the
        pose pipeline (interpolation + feedback) like a 50 Hz pose stream."""
        for _ in range(n_steps):
            u = torch.tensor([self.full_state.steering,
                              self.full_state.throttle],
                             dtype=torch.float32, device=self.device)
            s = torch.from_numpy(self.true_state).to(self.device)
            s_next, _ = self.model.update_state(self.model_params, s, u)
            self.true_state = s_next.cpu().numpy()
            self.sim_time += self.dt
            self.receive_state_vector(self.sim_time, self.true_state)


class ReplayPlant(BasePlant):
    """Replays a logged pose stream: rows of
    (t, x, y, yaw, roll, u_x, u_y, yaw_mder)."""

    def __init__(self, log: np.ndarray, dt: float, num_timesteps: int, **kw):
        super().__init__(dt, num_timesteps, **kw)
        self.log = np.asarray(log, dtype=np.float32)
        self.cursor = 0

    @classmethod
    def from_csv(cls, path: str, dt: float, num_timesteps: int, **kw):
        log = np.loadtxt(path, delimiter=",", skiprows=1)
        return cls(log, dt, num_timesteps, **kw)

    def advance(self) -> bool:
        """Feed the next logged pose; False when exhausted."""
        if self.cursor >= len(self.log):
            return False
        row = self.log[self.cursor]
        self.cursor += 1
        self.receive_state_vector(float(row[0]), row[1:8])
        return True

    @property
    def exhausted(self) -> bool:
        return self.cursor >= len(self.log)
