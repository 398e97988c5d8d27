"""Sim-side actuation semantics, the Gazebo controller node's logic (port of
``autorally_tpu/sim/actuation.py``, numpy only).

Ports the command plumbing of
``autorally_gazebo/nodes/autorally_controller.py``:

- priority-ordered chassis-command arbitration with per-commander 0.2 s
  staleness windows and validity checks (``spin``, :345-396)
- runstop gating: ALL registered runstop publishers must enable motion,
  and a runstop zeroes throttle only (:434-441, :345-349)
- command timeout: no commands for ``cmd_timeout`` seconds stops the
  vehicle (:327-335)
- Ackermann left/right steering angles (``_ctrl_steering``, :497-523)
- per-wheel speed report (``wheelSpeedsCb``, :569-587: published speeds
  are absolute values, mimicking the physical platform's sensors)

The physics these commands drive lives in
:mod:`autorally_tpu_torch.sim.vehicle`.
"""

from __future__ import annotations

import dataclasses
import math
import threading
from typing import Dict, List, Tuple

import numpy as np

from autorally_tpu_torch.sim.vehicle import SimState, VehicleParams

STALE_S = 0.2                     # per-commander staleness (node :355)


@dataclasses.dataclass
class SimCommand:
    """One commander's chassis command (``chassisCommand.msg`` role)."""

    sender: str
    steering: float = 0.0
    throttle: float = 0.0
    front_brake: float = -1.0     # <0: not commanding the brake
    stamp: float = 0.0


@dataclasses.dataclass(frozen=True)
class ActuationLimits:
    cmd_timeout: float = 0.5      # _DEF_CMD_TIMEOUT


class SimCommandArbiter:
    """Priority arbitration of chassis commands (node ``spin``, :345-396).

    Commanders are registered in priority order (lowest number wins, like
    the ``chassisCommandProirities`` param).  Each actuator (steering,
    throttle, front brake) is claimed independently by the
    highest-priority commander with a fresh, in-range value.
    """

    def __init__(self, priorities: List[str],
                 limits: ActuationLimits = ActuationLimits()):
        self.priorities = list(priorities)
        self.limits = limits
        # reentrant: arbitrate() calls motion_enabled() under the lock
        self._lock = threading.RLock()
        self._cmds: Dict[str, SimCommand] = {}
        self._runstops: Dict[str, bool] = {}
        self._last_cmd_time = 0.0

    def put_command(self, cmd: SimCommand) -> None:
        with self._lock:
            self._cmds[cmd.sender] = cmd
            self._last_cmd_time = max(self._last_cmd_time, cmd.stamp)

    def put_runstop(self, sender: str, motion_enabled: bool) -> None:
        with self._lock:
            self._runstops[sender] = bool(motion_enabled)

    def motion_enabled(self) -> bool:
        """AND over every runstop publisher (node ``getrunstop``)."""
        with self._lock:
            ok = True
            for v in self._runstops.values():
                ok &= v
            return ok

    def arbitrate(self, now: float) -> Tuple[float, float, float, Dict]:
        """Resolve (steering, throttle, front_brake) at time ``now``.

        Returns the actuator values plus a chassisState-style dict naming
        which commander won each actuator (node :352-396).
        """
        with self._lock:
            info = {"runstopMotionEnabled": self.motion_enabled(),
                    "steeringCommander": "", "throttleCommander": "",
                    "frontBrakeCommander": ""}
            steering = throttle = 0.0
            front_brake = 0.0
            found_s = found_t = found_b = False

            if not info["runstopMotionEnabled"]:
                info["throttleCommander"] = "runstop"
                found_t = True           # throttle claimed at zero

            timeout = self.limits.cmd_timeout
            if timeout > 0 and now - self._last_cmd_time > timeout:
                # stop the vehicle (node :327-335)
                return 0.0, 0.0, 0.0, info

            for sender in self.priorities:
                c = self._cmds.get(sender)
                if c is None:
                    continue
                fresh = (now - c.stamp) < STALE_S
                if not found_s and fresh and abs(c.steering) <= 1.0:
                    steering = c.steering
                    info["steeringCommander"] = sender
                    found_s = True
                if not found_t and fresh and abs(c.throttle) <= 1.0:
                    throttle = c.throttle
                    info["throttleCommander"] = sender
                    found_t = True
                if not found_b and fresh and 0.0 <= c.front_brake <= 1.0:
                    front_brake = c.front_brake
                    info["frontBrakeCommander"] = sender
                    found_b = True
            return steering, throttle, front_brake, info


def ackermann_angles(params: VehicleParams, steer_cmd: float
                     ) -> Tuple[float, float]:
    """Left/right steering joint angles for a chassis steering command
    (``_ctrl_steering`` + ``_get_steer_ang``, node :497-523, :645-649)."""
    theta = params.steer_sign * params.max_steer * max(-1.0, min(1.0, steer_cmd))
    if abs(theta) < 1e-4:
        return theta, theta
    center_y = params.wheelbase * math.tan(math.pi / 2 - theta)
    left = _steer_ang(math.atan((center_y - params.track / 2)
                                / params.wheelbase))
    right = _steer_ang(math.atan((center_y + params.track / 2)
                                 / params.wheelbase))
    return left, right


def _steer_ang(phi: float) -> float:
    # node ``_get_steer_ang`` (:645-649)
    if phi >= 0.0:
        return math.pi / 2 - phi
    return -math.pi / 2 - phi


def wheel_speeds(params: VehicleParams, s: SimState) -> np.ndarray:
    """Reported wheel linear speeds [lf, rf, lb, rb], absolute values
    like the platform's sensors (node :578-585), of a state on the host
    (``sim_state_to_numpy``'s; the plant passes its host copy)."""
    v = np.asarray(s.omega) * params.wheel_radius
    return np.abs(v).astype(np.float32)
