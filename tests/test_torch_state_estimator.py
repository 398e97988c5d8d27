"""The port's state estimator (``runtime/state_estimator.py``) and sensor
rig (``sim/sensors.py``) against the JAX package's on the CPU.

The EKF is the same numpy code: on the same measurements it agrees with
the JAX one bit for bit in every field and its covariance.  The sensor rig
draws the same noise from its seeded ``RandomState`` in the same order.
The twins of the JAX estimator-quality tests (accuracy, gyro-bias
convergence, covariance consistency on a synthetic circle) hold the port's
EKF to the same bounds.  Two closed loops run on seeded weights (the
reference weights are not in the repository): the EKF feeding the port's
plant and solver on a circular drive (``tests/test_estimation_to_control``'s
bounds, which do not depend on the weights), and the physics plant driven
from the estimate, whose bounds were measured on both packages with the
same seeded weights (see ``test_closed_loop_on_estimated_state``)."""

import math

import jax
import numpy as np
import pytest
import torch

from autorally_tpu.runtime import state_estimator as jest
from autorally_tpu.sim import sensors as jsensors
from autorally_tpu_torch.runtime import ErrorStateEKF, EstimatorConfig
from autorally_tpu_torch.runtime import state_estimator as tse
from autorally_tpu_torch.sim.sensors import (SensorSimConfig,
                                             SensorSimulator)
from test_vehicle_io import synth_trajectory

FIELDS = ("p", "v", "q", "b_a", "b_g", "P")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The closed loops' small CPU solves on one thread: beside the other
    test workers, more threads only contend for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _run_circle(ekf_cls, seconds=40.0, imu_hz=200, gps_hz=10, vel_hz=50,
                speed=5.0, radius=15.0, sensor_cfg=None, est_cfg=None,
                twin=None):
    """The JAX test's perfect-circle drive through ``ekf_cls``; with
    ``twin`` (another EKF) fed the same measurements, every field of both
    is compared bit for bit after each update.  Returns (ekf, logs)."""
    cfg = sensor_cfg or SensorSimConfig()
    rng = np.random.RandomState(cfg.seed + 1)
    ekf = ekf_cls(est_cfg or EstimatorConfig())
    w = speed / radius
    dt = 1.0 / imu_hz
    gps_every = imu_hz // gps_hz
    vel_every = imu_hz // vel_hz
    ekfs = [ekf] if twin is None else [ekf, twin]
    for e in ekfs:
        e.initialize(0.0, [radius, 0.0, 0.0], yaw=math.pi / 2)
    n = int(seconds * imu_hz)
    logs = {"pos_err": [], "yaw_err": [], "vel_err": [], "nees_pos": []}
    for i in range(1, n + 1):
        t = i * dt
        yaw = math.pi / 2 + w * t
        px, py = radius * math.cos(w * t), radius * math.sin(w * t)
        accel = (np.array([0.0, speed * w, 9.80665])
                 + np.asarray(cfg.accel_bias)
                 + rng.randn(3) * cfg.accel_noise)
        gyro = (np.array([0.0, 0.0, w]) + np.asarray(cfg.gyro_bias)
                + rng.randn(3) * cfg.gyro_noise)
        vel = (np.array([speed, 0.0, 0.0]) + rng.randn(3) * cfg.vel_noise
               if i % vel_every == 0 else None)
        gps = (np.array([px, py, 0.0]) + rng.randn(3) * cfg.gps_noise
               if i % gps_every == 0 else None)
        for e in ekfs:
            e.imu_update(t, accel, gyro)
            if vel is not None:
                e.velocity_update(vel)
            if gps is not None:
                e.gps_update(gps)
        if twin is not None:
            for f in FIELDS:
                assert np.array_equal(getattr(ekf, f), getattr(twin, f)), \
                    (f, i)
        e_p = ekf.p[:2] - np.array([px, py])
        logs["pos_err"].append(np.linalg.norm(e_p))
        R = tse._quat_to_rot(ekf.q)
        yaw_est = math.atan2(R[1, 0], R[0, 0])
        logs["yaw_err"].append(abs(np.angle(np.exp(1j * (yaw_est - yaw)))))
        vw_true = SensorSimulator.world_velocity(yaw, speed, 0.0)
        logs["vel_err"].append(np.linalg.norm(ekf.v[:2] - vw_true[:2]))
        e3 = np.concatenate([e_p, [ekf.p[2]]])
        logs["nees_pos"].append(float(e3 @ np.linalg.solve(ekf.P[:3, :3],
                                                           e3)))
    return ekf, {k: np.asarray(v) for k, v in logs.items()}


def test_ekf_bit_for_bit_jax_on_the_same_measurements():
    cfg = SensorSimConfig(seed=3)
    ekf, _ = _run_circle(ErrorStateEKF, seconds=5.0, sensor_cfg=cfg,
                         twin=jest.ErrorStateEKF(jest.EstimatorConfig()))
    jekf = jest.ErrorStateEKF()
    jekf.initialize(0.0, [1.0, 2.0, 0.0], yaw=0.4)
    ekf = ErrorStateEKF()
    ekf.initialize(0.0, [1.0, 2.0, 0.0], yaw=0.4)
    for e in (ekf, jekf):
        e.imu_update(0.01, [0.1, 0.2, 9.8], [0.0, 0.0, 0.3])
        e.gps_update([1.1, 2.0, 0.0], var=[0.04, 0.09, 0.01])
        e.velocity_update([2.0, 0.1, 0.0], var=0.2)
        e.imu_update(0.9, [0.1, 0.2, 9.8], [0.0, 0.0, 0.3])   # dt > 0.5
    for f in FIELDS:
        assert np.array_equal(getattr(ekf, f), getattr(jekf, f)), f
    assert np.array_equal(ekf.state_vector(0.3), jekf.state_vector(0.3))
    got, want = ekf.odometry(), jekf.odometry()
    assert got.keys() == want.keys()
    for k in want:
        assert np.array_equal(got[k], want[k]), k
    assert EstimatorConfig() == EstimatorConfig(
        **vars(jest.EstimatorConfig()))


def test_sensor_rig_draws_the_jax_noise():
    cfg = SensorSimConfig(seed=11)
    ours = SensorSimulator(cfg)
    ref = jsensors.SensorSimulator(jsensors.SensorSimConfig(seed=11))
    rng = np.random.RandomState(4)
    for _ in range(50):
        yaw, rr, wz, vx, vy = rng.randn(5)
        a, g = ours.imu(yaw, rr, wz, vx, vy, 0.02)
        ja, jg = ref.imu(yaw, rr, wz, vx, vy, 0.02)
        assert np.array_equal(a, ja) and np.array_equal(g, jg)
        assert np.array_equal(ours.gps(vx, vy), ref.gps(vx, vy))
        assert np.array_equal(ours.body_velocity(vx, vy),
                              ref.body_velocity(vx, vy))


# -- twins of tests/test_estimator_quality.py on the port ---------------------

@pytest.fixture(scope="module")
def circle():
    return _run_circle(ErrorStateEKF, seconds=40.0)


def test_ekf_accuracy_on_synthetic_circle(circle):
    _, logs = circle
    conv = slice(len(logs["pos_err"]) // 4, None)
    rmse = {k: float(np.sqrt((logs[k][conv] ** 2).mean()))
            for k in ("pos_err", "yaw_err", "vel_err")}
    assert rmse["pos_err"] < 0.15, rmse
    assert rmse["yaw_err"] < 0.05, rmse
    assert rmse["vel_err"] < 0.20, rmse


def test_ekf_gyro_bias_convergence(circle):
    ekf, _ = circle
    cfg = SensorSimConfig()
    err = abs(ekf.b_g[2] - cfg.gyro_bias[2])
    assert err < 0.4 * abs(cfg.gyro_bias[2]), (ekf.b_g, cfg.gyro_bias)


def test_ekf_covariance_consistency(circle):
    _, logs = circle
    nees = logs["nees_pos"][len(logs["nees_pos"]) // 4:]
    assert 0.3 < float(nees.mean()) < 9.0


# -- closed loops on seeded weights -------------------------------------------

def _seeded_stack(rollouts, timesteps, ppm, desired_speed, layers=None):
    """The port's solver on an oval at ``ppm`` with the JAX package's
    seeded 6-32-32-4 weights (``init_params(PRNGKey(0))``) carried over."""
    from autorally_tpu.models import NeuralNetDynamics as JaxNN
    from autorally_tpu_torch.config import CostParams, MPPIConfig
    from autorally_tpu_torch.costs import MPPICost
    from autorally_tpu_torch.costs.costmap import make_costmap
    from autorally_tpu_torch.models import NeuralNetDynamics
    from autorally_tpu_torch.solver.mppi import MPPISolver
    from autorally_tpu_torch.tools.track_generator import oval_track

    cfg = MPPIConfig(num_rollouts=rollouts, num_timesteps=timesteps)
    data, xb, yb = oval_track(half_length=30.0, half_width=18.0,
                              track_width=6.0, ppm=ppm)
    cm = make_costmap(data, xb, yb, device="cpu")
    jm = JaxNN(cfg.dt, control_ranges=cfg.control_ranges)
    model = NeuralNetDynamics(cfg.dt, control_ranges=cfg.control_ranges,
                              device="cpu")
    params = model.params_from_jax(jax.tree_util.tree_map(
        np.asarray, jm.init_params(jax.random.PRNGKey(0))))
    solver = MPPISolver(model, MPPICost(), cfg, device="cpu")
    return cfg, solver, params, cm, CostParams(desired_speed=desired_speed)


def test_ekf_feeds_plant_and_controller():
    """Noisy IMU and GPS of a circular drive through the EKF into the
    port's plant pipeline and solver (the reference's StateEstimator ->
    /pose_estimate -> AutorallyPlant -> MPPI path)."""
    from autorally_tpu_torch.runtime.plant import BasePlant

    poses, imu = synth_trajectory(T=6.0, dt=0.005)
    rng = np.random.RandomState(7)
    ekf = ErrorStateEKF()
    t0, p0, yaw0 = poses[0]
    ekf.initialize(t0, p0, yaw0)
    cfg, solver, params, cm, cp = _seeded_stack(64, 16, 2.0, 5.0)
    plant = BasePlant(cfg.dt, cfg.num_timesteps, use_feedback_gains=False)
    cs = solver.init_state()
    published = 0
    est_errors = []
    for i, ((t, pos, yaw), (a, w)) in enumerate(zip(poses, imu)):
        if i > 0:
            ekf.imu_update(t, a + rng.randn(3) * 0.05,
                           w + rng.randn(3) * 0.005)
        if i % 40 == 0:
            ekf.gps_update(pos + rng.randn(3) * 0.03)
        if i % 4 == 0 and i > 0:          # 50 Hz pose into the plant
            sv = ekf.state_vector(0.5)    # omega = speed / radius
            if plant.receive_state_vector(t, sv) is not None:
                published += 1
            est_errors.append(np.hypot(sv[0] - pos[0], sv[1] - pos[1]))
        if i % 40 == 0:                   # replan at 5 Hz
            cs, _ = solver.solve(params, cp, cm,
                                 plant.get_state().to_vector(), cs)
            plant.set_solution(cs.state_solution.numpy(),
                               cs.control_solution.numpy(), None, ts=t)
    assert np.mean(est_errors[len(est_errors) // 2:]) < 0.3
    assert published > 100
    assert np.isfinite(cs.U.numpy()).all()


# Measured with these seeded weights, K=96, T=24, 200 ticks, on the CPU:
# the JAX loop ends at 0.60 m/s after 1.38 m of path, estimate RMSE pos
# 0.081, yaw 0.079, vel 0.072; the port's 0.70 m/s, 1.39 m, 0.081, 0.085,
# 0.072.  The seeded model barely moves the car (the JAX test's 2 m/s and
# 20 m are the reference weights'); the estimate bounds are the JAX test's.
EST_TICKS = 200
EST_MIN_PATH = 0.5


def test_closed_loop_on_estimated_state():
    """The physics plant driven from the EKF's estimate by the port's tube
    loop: the controller consumed the estimate the whole run, and the
    estimate stayed within the JAX test's bounds of the truth."""
    from autorally_tpu_torch.runtime import (ControlLoopConfig, Controller,
                                             run_control_loop)
    from autorally_tpu_torch.sim import SimVehicleEstimatedPlant

    cfg, solver, params, cm, cp = _seeded_stack(96, 24, 2.0, 4.0)
    actual = Controller(solver, params, cp, cm)
    predicted = Controller(solver, params, cp, cm, seed=3)
    start = np.array([30.0, 0.0, math.pi / 2, 0, 0, 0, 0], np.float32)
    plant = SimVehicleEstimatedPlant(start, cfg.dt, cfg.num_timesteps,
                                     device="cpu", use_feedback_gains=False)
    plant.receive_state_vector(0.0, start)
    run_control_loop(predicted, actual, plant, ControlLoopConfig(
        hz=cfg.hz, num_timesteps=cfg.num_timesteps,
        use_feedback_gains=False, max_iter=EST_TICKS))
    truth = np.asarray(plant.truth_log)
    assert len(truth) == len(plant.est_log) == EST_TICKS
    assert plant.pose_count == EST_TICKS + 1
    errs = plant.estimation_errors()
    assert errs["pos_rmse"] < 0.5, errs
    assert errs["yaw_rmse"] < 0.15, errs
    assert errs["vel_rmse"] < 0.5, errs
    path = np.sum(np.linalg.norm(np.diff(truth[:, :2], axis=0), axis=1))
    assert path > EST_MIN_PATH, path
    assert np.isfinite(truth).all() and not plant.shutdown
