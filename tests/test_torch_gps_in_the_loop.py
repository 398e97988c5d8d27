"""The port's GPS in the loop (``tests/test_gps_in_the_loop.py`` case for
case on ``autorally_tpu_torch``).

GPS-in-the-loop: ground truth -> synthesized NMEA bytes (checksummed
GPGGA + GPGST) -> NmeaFramer/GpsReceiver -> WGS-84 ENU -> EKF.  The
real parser and geodetic conversions sit inside the estimation loop —
the full GPSHemisphere -> StateEstimator chain of the reference, with
measured accuracy bounds."""

import math

import numpy as np

from autorally_tpu_torch.runtime.gps import (
    GpsEstimatorBridge, GpsNmeaSimulator, GpsReceiver, enu_from_geodetic,
    geodetic_from_enu)
from autorally_tpu_torch.runtime.state_estimator import (ErrorStateEKF,
                                                         EstimatorConfig)
from autorally_tpu_torch.sim.sensors import SensorSimConfig


def test_enu_geodetic_roundtrip_is_mm_exact():
    ref = (33.7805, -84.4005, 250.0)
    for e, n, u in [(30.0, -18.0, 1.5), (-120.0, 55.0, -2.0),
                    (0.0, 0.0, 0.0), (500.0, 500.0, 10.0)]:
        lat, lon, alt = geodetic_from_enu(ref, e, n, u)
        e2, n2, u2 = enu_from_geodetic(ref, lat, lon, alt)
        assert abs(e2 - e) < 1e-3
        assert abs(n2 - n) < 1e-3
        assert abs(u2 - u) < 1e-3


def test_nmea_simulator_parses_back_through_the_real_receiver():
    sim = GpsNmeaSimulator(sigma=0.02)
    fixes = []
    rx = GpsReceiver(position_source="GPGGA", on_fix=fixes.append)
    rx.feed(sim.sentences(t=12 * 3600.0, x=25.0, y=-10.0))
    assert len(fixes) == 1 and rx.framer.bad_checksums == 0
    e, n, _ = enu_from_geodetic(sim.ref, fixes[0].latitude,
                                fixes[0].longitude, fixes[0].altitude)
    # NMEA minutes are printed to 6 decimals: ~2 mm quantization
    assert abs(e - 25.0) < 0.01
    assert abs(n + 10.0) < 0.01
    assert fixes[0].position_covariance[0] == 0.02 ** 2


def test_closed_estimation_loop_from_nmea_bytes():
    """Circle rig from test_estimator_quality, but GPS arrives as NMEA
    bytes through the real driver instead of a local-frame vector."""
    cfg = SensorSimConfig()
    rng = np.random.RandomState(7)
    ekf = ErrorStateEKF(EstimatorConfig())
    speed, radius = 5.0, 15.0
    w = speed / radius
    imu_hz, gps_hz, vel_hz = 200, 10, 50
    dt = 1.0 / imu_hz

    nmea = GpsNmeaSimulator(sigma=cfg.gps_noise)
    bridge = GpsEstimatorBridge(ekf, reference=nmea.ref)
    rx = GpsReceiver(position_source="GPGGA", on_fix=bridge)

    ekf.initialize(0.0, [radius, 0.0, 0.0], yaw=math.pi / 2)
    seconds = 25.0
    n = int(seconds * imu_hz)
    errs = []
    for i in range(1, n + 1):
        t = i * dt
        yaw = math.pi / 2 + w * t
        px = radius * math.cos(w * t)
        py = radius * math.sin(w * t)
        accel = (np.array([0.0, speed * w, 9.80665])
                 + np.asarray(cfg.accel_bias)
                 + rng.randn(3) * cfg.accel_noise)
        gyro = (np.array([0.0, 0.0, w]) + np.asarray(cfg.gyro_bias)
                + rng.randn(3) * cfg.gyro_noise)
        ekf.imu_update(t, accel, gyro)
        if i % (imu_hz // vel_hz) == 0:
            ekf.velocity_update(np.array([speed, 0.0, 0.0])
                                + rng.randn(3) * cfg.vel_noise)
        if i % (imu_hz // gps_hz) == 0:
            noisy = (px + rng.randn() * cfg.gps_noise,
                     py + rng.randn() * cfg.gps_noise)
            rx.feed(nmea.sentences(t, noisy[0], noisy[1]))
        if t > 10.0:                           # post-convergence window
            errs.append(np.linalg.norm(ekf.p[:2] - np.array([px, py])))

    assert bridge.updates == gps_hz * seconds
    assert rx.framer.bad_checksums == 0
    rmse = float(np.sqrt(np.mean(np.square(errs))))
    # same bound the local-frame rig holds (test_estimator_quality):
    # the NMEA+geodetic path must not degrade the estimate
    assert rmse < 0.15, rmse
