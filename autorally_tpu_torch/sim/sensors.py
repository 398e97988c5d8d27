"""Synthetic GPS / IMU / wheel-velocity sensors over the physics sim (port
of ``autorally_tpu/sim/sensors.py``: the same ``RandomState`` draws in the
same order, so that both packages draw the same noise).

The reference's estimator consumes real hardware topics (GPS fixes,
200 Hz IMU, wheel speeds) and is validated only by driving the car
(``StateEstimator.cpp`` has no tests).  Here the independent physics
simulator doubles as a ground-truth rig: this module derives noisy,
biased sensor streams from the true vehicle state so the error-state EKF
(:mod:`autorally_tpu_torch.runtime.state_estimator`) can be *quantified* —
RMSE against truth, bias convergence, covariance consistency — and the
closed loop can be driven from the estimate instead of ground truth
(:class:`SimVehicleEstimatedPlant`), measuring the cost of realistic
state estimation end-to-end.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from autorally_tpu_torch.runtime.state_estimator import (ErrorStateEKF,
                                                        EstimatorConfig)
from autorally_tpu_torch.sim.plant import SimVehiclePlant

GRAVITY = 9.80665


@dataclasses.dataclass
class SensorSimConfig:
    """Noise/bias levels for the synthetic rig (MEMS-IMU / RTK-class)."""

    accel_noise: float = 0.2          # m/s^2 per sample
    gyro_noise: float = 0.02          # rad/s per sample
    accel_bias: tuple = (0.05, -0.08, 0.03)
    gyro_bias: tuple = (0.002, -0.001, 0.004)
    gps_noise: float = 0.15           # m (RTK-ish)
    gps_every: int = 5                # GPS every N control ticks (10 Hz @ 50)
    vel_noise: float = 0.15           # m/s (wheel odometry)
    seed: int = 0


class SensorSimulator:
    """Turns consecutive true states into IMU/GPS/velocity measurements.

    IMU specific force comes from the finite-difference world
    acceleration rotated into the body frame plus the gravity reaction:
    ``f_b = R^T (a_world - g) + b_a + n`` — exactly what an accelerometer
    strapped to the chassis reads."""

    def __init__(self, cfg: SensorSimConfig = SensorSimConfig()):
        self.cfg = cfg
        self.rng = np.random.RandomState(cfg.seed)
        self._prev_vw: Optional[np.ndarray] = None

    @staticmethod
    def world_velocity(yaw: float, vx: float, vy: float) -> np.ndarray:
        c, s = np.cos(yaw), np.sin(yaw)
        return np.array([c * vx - s * vy, s * vx + c * vy, 0.0])

    def imu(self, yaw: float, roll_rate: float, yaw_rate: float,
            vx: float, vy: float, dt: float) -> tuple:
        """(accel_meas (3,), gyro_meas (3,)) for one period."""
        vw = self.world_velocity(yaw, vx, vy)
        a_world = (np.zeros(3) if self._prev_vw is None
                   else (vw - self._prev_vw) / dt)
        self._prev_vw = vw
        c, s = np.cos(yaw), np.sin(yaw)
        Rt = np.array([[c, s, 0.0], [-s, c, 0.0], [0.0, 0.0, 1.0]])
        f_body = Rt @ (a_world - np.array([0.0, 0.0, -GRAVITY]))
        accel = (f_body + np.asarray(self.cfg.accel_bias)
                 + self.rng.randn(3) * self.cfg.accel_noise)
        gyro = (np.array([roll_rate, 0.0, yaw_rate])
                + np.asarray(self.cfg.gyro_bias)
                + self.rng.randn(3) * self.cfg.gyro_noise)
        return accel, gyro

    def gps(self, x: float, y: float) -> np.ndarray:
        return (np.array([x, y, 0.0])
                + self.rng.randn(3) * self.cfg.gps_noise)

    def body_velocity(self, vx: float, vy: float) -> np.ndarray:
        return (np.array([vx, vy, 0.0])
                + self.rng.randn(3) * self.cfg.vel_noise)


class SimVehicleEstimatedPlant(SimVehiclePlant):
    """Physics plant whose control pipeline sees the EKF estimate.

    Every control period the true state generates one IMU sample, a
    wheel-velocity measurement and (every ``gps_every`` ticks) a GPS fix;
    the EKF fuses them and its ``state_vector`` — not the truth — enters
    the pose pipeline, exactly like a deployment where the controller
    subscribes to ``/pose_estimate``.  ``truth_log`` / ``est_log`` record
    both for degradation analysis."""

    def __init__(self, init_state, dt, num_timesteps,
                 sensor_cfg: SensorSimConfig = SensorSimConfig(),
                 est_cfg: EstimatorConfig = EstimatorConfig(), **kw):
        super().__init__(init_state, dt, num_timesteps, **kw)
        self.sensors = SensorSimulator(sensor_cfg)
        self.ekf = ErrorStateEKF(est_cfg)
        self.ekf.initialize(0.0, [float(init_state[0]),
                                  float(init_state[1]), 0.0],
                            yaw=float(init_state[2]))
        self.truth_log: list = []
        self.est_log: list = []
        self._tick = 0

    def step_sim(self, n_steps: int = 1) -> None:
        for _ in range(n_steps):
            self._advance()
            self._tick += 1

            # one read of the state a period: the plant's host copy
            ss = self._host
            yaw, roll_rate = float(ss.yaw), float(ss.roll_rate)
            vx, vy, yaw_rate = (float(ss.vx), float(ss.vy),
                                float(ss.yaw_rate))
            accel, gyro = self.sensors.imu(yaw, roll_rate, yaw_rate,
                                           vx, vy, self.dt)
            self.ekf.imu_update(self.sim_time, accel, gyro)
            self.ekf.velocity_update(self.sensors.body_velocity(vx, vy))
            if self._tick % self.sensors.cfg.gps_every == 0:
                self.ekf.gps_update(self.sensors.gps(float(ss.x),
                                                     float(ss.y)))

            truth = np.asarray(self.true_state, dtype=np.float32)
            est = self.ekf.state_vector(float(gyro[2] - self.ekf.b_g[2]))
            self.truth_log.append(truth)
            self.est_log.append(est)
            self.receive_state_vector(self.sim_time, est)

    def estimation_errors(self) -> dict:
        """Post-run truth-vs-estimate error summary."""
        truth = np.asarray(self.truth_log)
        est = np.asarray(self.est_log)
        pos_err = np.linalg.norm(truth[:, :2] - est[:, :2], axis=1)
        yaw_err = np.abs(np.angle(np.exp(1j * (truth[:, 2] - est[:, 2]))))
        vel_err = np.linalg.norm(truth[:, 4:6] - est[:, 4:6], axis=1)
        return {
            "pos_rmse": float(np.sqrt((pos_err ** 2).mean())),
            "pos_max": float(pos_err.max()),
            "yaw_rmse": float(np.sqrt((yaw_err ** 2).mean())),
            "vel_rmse": float(np.sqrt((vel_err ** 2).mean())),
        }
