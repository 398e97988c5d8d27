"""Pose-estimate processing: quaternion -> Euler, heading unwrap, body-frame
velocity (the port's copy of ``autorally_tpu/runtime/pose.py``, plain
Python math).

Exact port of the reference pose pipeline in ``AutorallyPlant::poseCall``
(``autorally_plant.cpp:164-212``): 1-2-3 Euler convention, a heading
multiplier that prevents yaw wrap-around, and world->body velocity rotation.
These feed the 7-state vector [x, y, yaw, roll, u_x, u_y, -yaw_rate].
"""

from __future__ import annotations

import math
from typing import Tuple

TWO_PI = 2 * 3.14159265359  # reference constant (autorally_plant.cpp:197)


def quat_to_euler_123(q0: float, q1: float, q2: float, q3: float
                      ) -> Tuple[float, float, float]:
    """(w, x, y, z) -> (roll, pitch, yaw), 1-2-3 convention
    (autorally_plant.cpp:184-187)."""
    roll = math.atan2(2 * q2 * q3 + 2 * q0 * q1,
                      q3 * q3 - q2 * q2 - q1 * q1 + q0 * q0)
    pitch = -math.asin(max(-1.0, min(1.0, 2 * q1 * q3 - 2 * q0 * q2)))
    yaw = math.atan2(2 * q1 * q2 + 2 * q0 * q3,
                     q1 * q1 + q0 * q0 - q3 * q3 - q2 * q2)
    return roll, pitch, yaw


class HeadingUnwrapper:
    """Continuous heading tracker (autorally_plant.cpp:190-197)."""

    def __init__(self):
        self.last_heading = 0.0
        self.multiplier = 0

    def __call__(self, yaw: float) -> float:
        if self.last_heading > 3.0 and yaw < -3.0:
            self.multiplier += 1
        elif self.last_heading < -3.0 and yaw > 3.0:
            self.multiplier -= 1
        self.last_heading = yaw
        return yaw + self.multiplier * TWO_PI


def world_to_body_velocity(yaw: float, x_vel: float, y_vel: float
                           ) -> Tuple[float, float]:
    """World-frame -> body-frame (u_x, u_y) (autorally_plant.cpp:208-210)."""
    u_x = math.cos(yaw) * x_vel + math.sin(yaw) * y_vel
    u_y = -math.sin(yaw) * x_vel + math.cos(yaw) * y_vel
    return u_x, u_y


def euler_123_to_quat(roll: float, pitch: float, yaw: float
                      ) -> Tuple[float, float, float, float]:
    """Inverse of :func:`quat_to_euler_123` (for synthetic plants/logs)."""
    cr, sr = math.cos(roll / 2), math.sin(roll / 2)
    cp, sp = math.cos(pitch / 2), math.sin(pitch / 2)
    cy, sy = math.cos(yaw / 2), math.sin(yaw / 2)
    q0 = cr * cp * cy + sr * sp * sy
    q1 = sr * cp * cy - cr * sp * sy
    q2 = cr * sp * cy + sr * cp * sy
    q3 = cr * cp * sy - sr * sp * cy
    return q0, q1, q2, q3
