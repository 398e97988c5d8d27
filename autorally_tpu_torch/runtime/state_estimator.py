"""GPS + IMU state estimation, the ``/pose_estimate`` producer (port of
``autorally_tpu/runtime/state_estimator.py``, numpy only).

The reference runs a GTSAM ISAM2 factor graph (IMU preintegration + GPS
factors + wheel-odometry between-factors) on a dedicated optimizer thread
(``autorally_core/src/StateEstimator/StateEstimator.cpp:217-642``) and
publishes IMU-rate pose predictions.  This re-design uses an error-state
EKF: IMU measurements propagate the nominal state at sensor rate (the
200 Hz prediction path), GPS fixes and wheel-odometry velocities apply
corrections.  Same interface role (sensors in, high-rate Odometry out,
bias estimates), deliberately not a factor graph: the smoothing window
ISAM2 buys matters for mapping, not for feeding a 50 Hz MPC with a
<100 ms-latency pose, and an EKF is a few small host-side matrix ops per
tick.

Frames: world ENU, body FLU.  State: position p (3), velocity v (3),
orientation quaternion q (wxyz, body->world), accel bias b_a (3), gyro
bias b_g (3).  Error state: 15.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

GRAVITY = np.array([0.0, 0.0, -9.80665])


def _quat_mult(a, b):
    w1, x1, y1, z1 = a
    w2, x2, y2, z2 = b
    return np.array([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ])


def _quat_to_rot(q):
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def _small_angle_quat(dtheta):
    half = 0.5 * dtheta
    return np.concatenate([[1.0], half]) / np.sqrt(1.0 + half @ half)


def _skew(v):
    return np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])


@dataclasses.dataclass
class EstimatorConfig:
    # continuous-time noise densities (typical MEMS IMU)
    accel_noise: float = 0.2          # m/s^2 / sqrt(Hz)
    gyro_noise: float = 0.02          # rad/s / sqrt(Hz)
    accel_bias_walk: float = 0.01
    gyro_bias_walk: float = 0.001
    gps_pos_noise: float = 0.15       # m (RTK-ish, StateEstimator gpsSigma)
    vel_meas_noise: float = 0.3       # m/s (wheel odometry)
    init_pos_var: float = 1.0
    init_vel_var: float = 1.0
    init_att_var: float = 0.1
    init_bias_var: float = 0.01


class ErrorStateEKF:
    """IMU-propagated, GPS/velocity-corrected error-state EKF."""

    def __init__(self, cfg: EstimatorConfig = EstimatorConfig()):
        self.cfg = cfg
        self.p = np.zeros(3)
        self.v = np.zeros(3)
        self.q = np.array([1.0, 0, 0, 0])
        self.b_a = np.zeros(3)
        self.b_g = np.zeros(3)
        self.P = np.diag(
            [cfg.init_pos_var] * 3 + [cfg.init_vel_var] * 3
            + [cfg.init_att_var] * 3 + [cfg.init_bias_var] * 6).astype(float)
        self.t: Optional[float] = None
        self.initialized = False

    # -- initialization ------------------------------------------------------

    def initialize(self, t: float, pos, yaw: float = 0.0) -> None:
        self.p = np.asarray(pos, dtype=float)
        self.q = np.array([np.cos(yaw / 2), 0, 0, np.sin(yaw / 2)])
        self.t = t
        self.initialized = True

    # -- IMU propagation (the 200 Hz prediction path) ------------------------

    def imu_update(self, t: float, accel, gyro) -> None:
        """Propagate nominal state + covariance with one IMU sample."""
        if not self.initialized:
            return
        dt = 0.0 if self.t is None else t - self.t
        self.t = t
        if dt <= 0 or dt > 0.5:
            return
        a = np.asarray(accel, dtype=float) - self.b_a
        w = np.asarray(gyro, dtype=float) - self.b_g
        R = _quat_to_rot(self.q)

        # nominal propagation
        acc_world = R @ a + GRAVITY
        self.p = self.p + self.v * dt + 0.5 * acc_world * dt * dt
        self.v = self.v + acc_world * dt
        self.q = _quat_mult(self.q, _small_angle_quat(w * dt))
        self.q /= np.linalg.norm(self.q)

        # error-state covariance: F = I + A dt
        F = np.eye(15)
        F[0:3, 3:6] = np.eye(3) * dt
        F[3:6, 6:9] = -R @ _skew(a) * dt
        F[3:6, 9:12] = -R * dt
        F[6:9, 6:9] = np.eye(3) - _skew(w) * dt
        F[6:9, 12:15] = -np.eye(3) * dt

        c = self.cfg
        Q = np.zeros((15, 15))
        Q[3:6, 3:6] = np.eye(3) * (c.accel_noise ** 2 * dt)
        Q[6:9, 6:9] = np.eye(3) * (c.gyro_noise ** 2 * dt)
        Q[9:12, 9:12] = np.eye(3) * (c.accel_bias_walk ** 2 * dt)
        Q[12:15, 12:15] = np.eye(3) * (c.gyro_bias_walk ** 2 * dt)
        self.P = F @ self.P @ F.T + Q

    # -- corrections ---------------------------------------------------------

    def _apply_correction(self, H: np.ndarray, r: np.ndarray,
                          Rm: np.ndarray) -> None:
        S = H @ self.P @ H.T + Rm
        K = self.P @ H.T @ np.linalg.inv(S)
        dx = K @ r
        self.p += dx[0:3]
        self.v += dx[3:6]
        self.q = _quat_mult(self.q, _small_angle_quat(dx[6:9]))
        self.q /= np.linalg.norm(self.q)
        self.b_a += dx[9:12]
        self.b_g += dx[12:15]
        I_KH = np.eye(15) - K @ H
        self.P = I_KH @ self.P @ I_KH.T + K @ Rm @ K.T

    def gps_update(self, pos, var=None) -> None:
        """Position fix (the GPS factor role).  ``var`` — optional
        per-axis measurement variance (e.g. a GPGST-known covariance from
        the GPS receiver); the configured GPS noise otherwise."""
        if not self.initialized:
            return
        H = np.zeros((3, 15))
        H[:, 0:3] = np.eye(3)
        r = np.asarray(pos, dtype=float) - self.p
        if var is None:
            Rm = np.eye(3) * self.cfg.gps_pos_noise ** 2
        else:
            Rm = np.diag(np.broadcast_to(np.asarray(var, float), (3,)))
        self._apply_correction(H, r, Rm)

    def velocity_update(self, body_vel, var: Optional[float] = None) -> None:
        """Body-frame velocity measurement (the wheel-odometry
        between-factor role)."""
        if not self.initialized:
            return
        R = _quat_to_rot(self.q)
        v_body_pred = R.T @ self.v
        # right-perturbation error state: v_body = (I - skew(dtheta)) R^T v
        # -> d v_body / d dtheta = +skew(R^T v)
        H = np.zeros((3, 15))
        H[:, 3:6] = R.T
        H[:, 6:9] = _skew(v_body_pred)
        r = np.asarray(body_vel, dtype=float) - v_body_pred
        sigma2 = (var if var is not None else self.cfg.vel_meas_noise ** 2)
        self._apply_correction(H, r, np.eye(3) * sigma2)

    # -- output (the /pose_estimate Odometry role) ---------------------------

    def odometry(self) -> dict:
        R = _quat_to_rot(self.q)
        yaw = np.arctan2(R[1, 0], R[0, 0])
        return {
            "t": self.t,
            "position": self.p.copy(),
            "velocity_world": self.v.copy(),
            "quaternion_wxyz": self.q.copy(),
            "yaw": float(yaw),
            "accel_bias": self.b_a.copy(),
            "gyro_bias": self.b_g.copy(),
            "position_var": np.diag(self.P)[:3].copy(),
        }

    def state_vector(self, yaw_rate: float) -> np.ndarray:
        """The controller's 7-state [x, y, yaw, roll, u_x, u_y, yaw_mder]."""
        R = _quat_to_rot(self.q)
        yaw = np.arctan2(R[1, 0], R[0, 0])
        roll = np.arctan2(R[2, 1], R[2, 2])
        v_body = R.T @ self.v
        return np.array([self.p[0], self.p[1], yaw, roll,
                         v_body[0], v_body[1], -yaw_rate], dtype=np.float32)
