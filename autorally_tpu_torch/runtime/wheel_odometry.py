"""Wheel-speed dead-reckoning odometry.

Port of ``WheelOdometry`` (``autorally_core/src/WheelOdometry/
wheel_odometry.cpp``): bicycle-model pose integration from front-wheel
speeds and the commanded steering servo value, with the reference's
hand-fit variance model for downstream fusion:

- steering servo -> wheel angle: ``angle = ALPHA * servo + BETA`` deg
  (real vehicle) or ``-21 * servo`` (simulator ideal) (``:101-121``)
- turn-radius kinematics with left/right front-wheel velocity estimates
  and their disagreement as the yaw-rate error metric (``:138-222``)
- variance model: x-velocity variance constant 0.569 * error + beta;
  yaw-rate variance ``-3.199 * exp(-5.1233 e) + 3.7705`` (``:226-228``)
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

# Reference constants (wheel_odometry.h:70-77)
MAX_SERVO_VAL = 0.65
STEERING_ALPHA = -21.0832
STEERING_BETA = -0.1235
VELOCITY_X_ALPHA = 0.0
VELOCITY_X_BETA = 0.569
VELOCITY_THETA_ALPHA = -3.199
VELOCITY_THETA_BETA = -5.1233
VELOCITY_THETA_GAMMA = 3.7705


@dataclasses.dataclass
class WheelOdomEstimate:
    x: float
    y: float
    yaw: float                  # radians
    v_x: float                  # body-frame forward velocity (m/s)
    v_y: float
    yaw_rate: float             # rad/s
    velocity_x_var: float
    yaw_rate_var: float


class WheelOdometry:
    def __init__(self, wheel_base: float = 0.57, vehicle_width: float = 0.245,
                 using_sim: bool = False):
        self.length = wheel_base
        self.width = vehicle_width
        self.using_sim = using_sim
        self.steering_angle_deg = 0.0
        self.x = 0.0
        self.y = 0.0
        self.theta_deg = 0.0
        self._prev_t: Optional[float] = None

    def set_pose(self, x: float, y: float, yaw: float) -> None:
        """Initialize pose from the state estimator (``:92-98``)."""
        self.x, self.y, self.theta_deg = x, y, math.degrees(yaw)

    def update_steering(self, servo_val: float) -> None:
        """``servoCallback`` (``:101-121``)."""
        if not self.using_sim:
            v = max(-MAX_SERVO_VAL, min(MAX_SERVO_VAL, servo_val))
            self.steering_angle_deg = STEERING_ALPHA * v + STEERING_BETA
        else:
            self.steering_angle_deg = -21.0 * servo_val

    def update_wheel_speeds(self, t: float, lf: float, rf: float,
                            lb: float, rb: float) -> WheelOdomEstimate:
        """``speedCallback`` (``:123-290``): integrate one step, return the
        odometry estimate with variances."""
        dt = 0.02 if self._prev_t is None else max(t - self._prev_t, 1e-6)
        self._prev_t = t
        avg_speed = (lf + rf) / 2.0
        ang = self.steering_angle_deg

        if abs(ang) < 1e-6:
            delta_x = avg_speed * dt
            delta_y = 0.0
            delta_theta_deg = 0.0
            turn_radius = math.inf
        else:
            turn_radius = self.length / math.sin(abs(ang) * math.pi / 180.0)
            phi = avg_speed * dt / turn_radius
            delta_x = turn_radius * math.sin(phi)
            dy = turn_radius - turn_radius * math.cos(phi)
            delta_y = dy if ang > 0 else -dy
            delta_theta_deg = (avg_speed / self.length
                               * math.sin(ang * math.pi / 180.0)
                               * 180.0 / math.pi * dt)

        th = math.radians(self.theta_deg)
        self.x += delta_x * math.cos(th) - delta_y * math.sin(th)
        self.y += delta_x * math.sin(th) + delta_y * math.cos(th)
        self.theta_deg = math.fmod(self.theta_deg + delta_theta_deg, 360.0)

        # left/right front-wheel velocity estimates (``:195-222``)
        if abs(ang) >= 1e-6:
            if ang > 0:
                phi_1 = lf / (turn_radius - self.width / 2)
                phi_2 = rf / (turn_radius + self.width / 2)
            else:
                phi_1 = rf / (turn_radius - self.width / 2)
                phi_2 = lf / (turn_radius + self.width / 2)
            v1 = turn_radius * phi_1
            v2 = turn_radius * phi_2
        else:
            v1, v2 = lf, rf

        err_vx = 0.5 * abs(lf - lb) + 0.5 * abs(rf - rb)
        err_vtheta = abs(v1 - v2)
        velocity_x_var = VELOCITY_X_ALPHA * err_vx + VELOCITY_X_BETA
        yaw_rate_var = (VELOCITY_THETA_ALPHA
                        * math.exp(VELOCITY_THETA_BETA * err_vtheta)
                        + VELOCITY_THETA_GAMMA)

        return WheelOdomEstimate(
            x=self.x, y=self.y, yaw=math.radians(self.theta_deg),
            v_x=delta_x / dt, v_y=delta_y / dt,
            yaw_rate=math.radians(delta_theta_deg) / dt,
            velocity_x_var=velocity_x_var, yaw_rate_var=yaw_rate_var)
