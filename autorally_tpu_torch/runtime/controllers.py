"""Secondary / fallback controllers and the SafeSpeed governor.

The reference stack layers simple baseline commanders under MPPI, all
publishing ``chassisCommand`` into the chassis arbiter:

- ``ConstantSpeedController`` (``ConstantSpeedController.cpp:109-157``):
  wheel-speed PI + throttle-calibration feedforward that holds a speed
  setpoint; commands throttle only (steering sentinel -5).
- ``gpsWaypoint`` follower (``gpsWaypoint.cpp:108-185``): cyclic waypoint
  list, P-control on bearing error; commands steering only.
- ``JoystickControl`` (``JoystickControl.cpp:104-145``): axis mapping
  with damping and enable buttons; negative throttle becomes front brake.
- ``SafeSpeed`` governor (``SafeSpeed.cpp:97-197``): min over published
  safe speeds; lets the commanded throttle through while the vehicle is
  below that speed, cuts it (and latches control) above.

These are host-side control-rate components (10-100 Hz scalar math), so
they are plain Python feeding :class:`~autorally_tpu_torch.runtime.chassis.
CommandArbiter` — the card is for the sampling controller, not for PI
loops.  Senders use the arbiter's priority list; the per-actuator -5.0
"not commanding" sentinel is preserved.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from autorally_tpu_torch.runtime.chassis import ChassisCommand

NOT_COMMANDED = -5.0


class ThrottleCalibration:
    """Sorted (speed -> throttle) linear interpolation map — the role of
    the reference's ``RingBuffer<double>::interpolateKey`` throttle
    calibration (``ConstantSpeedController.cpp:177-198``)."""

    def __init__(self, points: Sequence[Tuple[float, float]]):
        if len(points) < 2:
            raise ValueError("need at least 2 calibration points")
        self.points = sorted((float(k), float(v)) for k, v in points)

    def interpolate(self, speed: float) -> Optional[float]:
        """Linear interpolation; None outside the calibrated range (the
        reference's ``interpolateKey`` false branch)."""
        pts = self.points
        if speed < pts[0][0] or speed > pts[-1][0]:
            return None
        for (k0, v0), (k1, v1) in zip(pts, pts[1:]):
            if k0 <= speed <= k1:
                if k1 == k0:
                    return v0
                a = (speed - k0) / (k1 - k0)
                return (1 - a) * v0 + a * v1
        return None


# default calibration: the autorally platform's throttle curve shape
# (params/ccrf_gazebo_actuator_calibration.yaml role) — roughly linear
# 0.12 throttle per 3 m/s with a small static offset
DEFAULT_CALIBRATION = ThrottleCalibration(
    [(0.0, 0.0), (2.0, 0.10), (4.0, 0.17), (6.0, 0.24), (8.0, 0.31),
     (10.0, 0.40), (12.0, 0.52)])


class ConstantSpeedController:
    """Wheel-speed PI + calibration feedforward (``ConstantSpeedController
    .cpp:109-157``).  Call :meth:`wheel_speeds` per wheelSpeeds message;
    it returns the chassisCommand to submit (throttle-only)."""

    def __init__(self, kp: float = 0.2, ki: float = 0.02,
                 integral_max: float = 1.0,
                 calibration: ThrottleCalibration = DEFAULT_CALIBRATION,
                 sender: str = "constantSpeedController"):
        self.kp = kp
        self.ki = ki
        self.integral_max = integral_max
        self.calibration = calibration
        self.sender = sender
        self.speed_setpoint = 0.0
        self.integral_error = 0.0

    def set_speed(self, setpoint: float) -> None:
        """speedCallback (:100-107)."""
        self.speed_setpoint = float(setpoint)

    def wheel_speeds(self, lf: float, rf: float, lb: float, rb: float,
                     stamp: float) -> ChassisCommand:
        front = 0.5 * (lf + rf)
        steering = NOT_COMMANDED
        front_brake = 0.0
        if self.speed_setpoint > 0.1:
            p = self.calibration.interpolate(self.speed_setpoint)
            if p is None:
                throttle = 0.0                      # :145-149
            else:
                err = self.speed_setpoint - front
                self.integral_error += err
                cap = self.integral_max / self.ki if self.ki else 0.0
                self.integral_error = max(-cap, min(cap,
                                                    self.integral_error))
                throttle = (p + self.kp * err
                            + self.ki * self.integral_error)
                throttle = max(0.0, min(1.0, throttle))
        else:
            throttle = 0.0
        return ChassisCommand(sender=self.sender, stamp=stamp,
                              steering=steering, throttle=throttle,
                              front_brake=front_brake)


class GpsWaypointController:
    """Cyclic waypoint follower: P-control on bearing error
    (``gpsWaypoint.cpp:108-185``).  Commands steering only."""

    def __init__(self, waypoints: Sequence[Tuple[float, float]],
                 radius: float = 1.5, heading_p: float = 2.0,
                 use_theta_gps: bool = True, sender: str = "waypointFollower"):
        if not waypoints:
            raise ValueError("empty waypoint list")
        self.wpts: List[Tuple[float, float]] = [
            (float(x), float(y)) for x, y in waypoints]
        self.radius = radius
        self.heading_p = heading_p
        self.use_theta_gps = use_theta_gps
        self.sender = sender
        self._prev_xy: Optional[Tuple[float, float]] = None

    @staticmethod
    def _angle_diff(a: float, b: float) -> float:
        """AngleDiff (:199-206): wrap a-b to (-pi, pi]."""
        d = math.fmod(a - b + math.pi, 2.0 * math.pi)
        if d < 0:
            d += 2.0 * math.pi
        return d - math.pi

    def odometry(self, x: float, y: float, yaw: float,
                 stamp: float) -> ChassisCommand:
        # heading source: GPS displacement vector or the pose yaw (:129-132)
        if self.use_theta_gps and self._prev_xy is not None:
            dx = x - self._prev_xy[0]
            dy = y - self._prev_xy[1]
            theta = math.atan2(dy, dx)
        else:
            theta = yaw
        self._prev_xy = (x, y)

        # advance past reached waypoints (cyclic, :135-145), at most one
        # full cycle: if every waypoint is within ``radius`` the rotation
        # can never exit, so steer for the current front instead of
        # spinning the control thread forever
        xn, yn = self.wpts[0]
        for _ in range(len(self.wpts)):
            if math.hypot(x - xn, y - yn) >= self.radius:
                break
            self.wpts.append(self.wpts.pop(0))
            xn, yn = self.wpts[0]

        bearing = math.atan2(yn - y, xn - x)
        error = self._angle_diff(bearing, theta)
        steering = max(-1.0, min(1.0, self.heading_p * error))
        return ChassisCommand(sender=self.sender, stamp=stamp,
                              steering=steering, throttle=NOT_COMMANDED,
                              front_brake=NOT_COMMANDED)

    @property
    def next_waypoint(self) -> Tuple[float, float]:
        return self.wpts[0]


class JoystickController:
    """Axis -> command mapping (``JoystickControl.cpp:104-145``):
    damped axes, per-channel enable, negative throttle = front brake."""

    def __init__(self, steering_damping: float = 0.6,
                 throttle_damping: float = 0.5,
                 steering_axis: int = 0, throttle_axis: int = 1,
                 sender: str = "joystick"):
        self.steering_damping = steering_damping
        self.throttle_damping = throttle_damping
        self.steering_axis = steering_axis
        self.throttle_axis = throttle_axis
        self.steering_enabled = True
        self.throttle_enabled = True
        self.sender = sender

    def joy(self, axes: Sequence[float], stamp: float) -> ChassisCommand:
        if self.steering_enabled:
            steering = -self.steering_damping * axes[self.steering_axis]
        else:
            steering = -10.0                        # :120
        if self.throttle_enabled:
            throttle = self.throttle_damping * axes[self.throttle_axis]
            if throttle < 0.0:                      # :128-133
                front_brake = abs(throttle)
                throttle = 0.0
            else:
                front_brake = 0.0
        else:
            throttle = -10.0                        # :137-138
            front_brake = -10.0
        return ChassisCommand(sender=self.sender, stamp=stamp,
                              steering=steering, throttle=throttle,
                              front_brake=front_brake)


@dataclass
class _SafeSpeedRecord:
    safe_speed: float
    stamp: float


class SafeSpeedGovernor:
    """Max-safe-speed throttle governor (``SafeSpeed.cpp:97-197``).

    Nodes publish their notion of the maximum safe speed; the effective
    limit is the minimum unexpired one (clamped by the global max).  The
    commanded throttle passes through while the vehicle is slower than
    that; once it exceeds the limit the governor takes control and cuts
    throttle, releasing only when the incoming command drops below the
    last passed-through value (the reference's latch, :144-148)."""

    def __init__(self, max_speed: float = 10.0, timeout: float = 5.0):
        self.max_speed = float(max_speed)
        self.timeout = float(timeout)
        self.records: Dict[str, _SafeSpeedRecord] = {}
        self.in_control = False
        self._prev_good_throttle = 0.0

    def submit_safe_speed(self, sender: str, safe_speed: float,
                          stamp: float) -> None:
        """safeSpeedCallback (:79-95)."""
        self.records[sender] = _SafeSpeedRecord(float(safe_speed),
                                                float(stamp))

    def get_safe_speed(self, now: float) -> float:
        """Minimum unexpired safe speed, capped at the global max
        (``getSafeSpeed``, :199-218)."""
        speed = self.max_speed
        for rec in self.records.values():
            if now - rec.stamp < self.timeout:
                speed = min(speed, rec.safe_speed)
        return speed

    def safe_throttle(self, throttle_command: float, vehicle_speed: float,
                      now: float) -> float:
        """``safeThrottle`` (:136-197)."""
        safe_speed = self.get_safe_speed(now)
        if safe_speed <= 0.0:
            return 0.0
        # release the latch when the commander backs off (:144-148)
        if self.in_control and throttle_command < self._prev_good_throttle:
            self.in_control = False
        if not self.in_control:
            if vehicle_speed < safe_speed:
                return throttle_command
            self._prev_good_throttle = throttle_command
            self.in_control = True
        return 0.0                                   # govern: cut throttle
