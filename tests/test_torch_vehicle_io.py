"""The port's chassis serial protocol, wheel odometry and state estimator
(``tests/test_vehicle_io.py`` case for case on ``autorally_tpu_torch``),
with the chassis cases of ``tests/test_faults.py``,
``tests/test_serial_device.py`` and ``tests/test_msgs.py``.

Chassis serial protocol, wheel odometry, and state estimator tests.

The serial tests use pseudo-terminals — the reference's own technique for
testing serial drivers without hardware
(``serialSensorInterfaceTest.cpp:36``, ``#include <pty.h>``).
"""

import math
import os
import pty
import struct
import time

import numpy as np
import pytest

from autorally_tpu_torch.runtime.chassis import (
    ActuatorCalibration, ActuatorConfig, ChassisCommand, ChassisLink,
    CommandArbiter)
from autorally_tpu_torch.runtime.state_estimator import ErrorStateEKF
from autorally_tpu_torch.runtime.wheel_odometry import WheelOdometry


# -- actuator calibration ----------------------------------------------------

def test_cmd_us_roundtrip():
    cal = ActuatorCalibration({
        "steering": ActuatorConfig(1100, 1500, 1900, reverse=False),
        "throttle": ActuatorConfig(1200, 1500, 1800, reverse=True),
        "frontBrake": ActuatorConfig(1000, 1500, 2000, reverse=False),
    })
    assert cal.cmd_to_us(0.0, "steering") == 1500
    assert cal.cmd_to_us(1.0, "steering") == 1900
    assert cal.cmd_to_us(-1.0, "steering") == 1100
    # reversed throttle: +1 maps to the min side
    assert cal.cmd_to_us(1.0, "throttle") == 1200
    for v in [-0.8, -0.3, 0.0, 0.4, 0.9]:
        us = cal.cmd_to_us(v, "steering")
        assert cal.us_to_cmd(us, "steering") == pytest.approx(v, abs=0.01)


def test_invalid_pulse_two_strikes():
    cal = ActuatorCalibration()
    assert cal.us_to_cmd(1600, "steering") == pytest.approx(0.2)
    # first invalid pulse reuses previous
    assert cal.us_to_cmd(5000, "steering") == pytest.approx(0.2)
    # second consecutive invalid -> disable sentinel
    assert cal.us_to_cmd(5000, "steering") == -5.0
    # recovery
    assert cal.us_to_cmd(1500, "steering") == pytest.approx(0.0)


# -- arbitration -------------------------------------------------------------

def test_arbitration_priority_and_runstop():
    arb = CommandArbiter(["RC", "mppi_controller", "waypoint"])
    now = 100.0
    arb.submit(ChassisCommand("mppi_controller", steering=0.3, throttle=0.5,
                              stamp=now))
    arb.submit(ChassisCommand("waypoint", steering=-0.9, throttle=0.9,
                              stamp=now))

    # no runstop publishers -> motion disabled, steering still arbitrated
    st = arb.arbitrate(now)
    assert not st.runstop_motion_enabled
    assert st.throttle == 0.0
    assert st.steering == pytest.approx(0.3)
    assert st.steering_commander == "mppi_controller"

    # fresh enabled runstop -> throttle flows from highest priority
    arb.submit_runstop("box", True, now)
    st = arb.arbitrate(now)
    assert st.runstop_motion_enabled
    assert st.throttle == pytest.approx(0.5)

    # one disabled publisher kills motion
    arb.submit_runstop("ocs", False, now)
    st = arb.arbitrate(now)
    assert not st.runstop_motion_enabled and st.throttle == 0.0

    # stale disabled publisher is ignored
    arb.submit_runstop("ocs", False, now - 10.0)
    st = arb.arbitrate(now)
    assert st.runstop_motion_enabled

    # stale commands are skipped; lower priority takes over
    arb.commands["mppi_controller"].stamp = now - 1.0
    st = arb.arbitrate(now)
    assert st.steering_commander == "waypoint"
    # RC not commanding (-5 sentinel values are out of range)
    assert st.steering == pytest.approx(-0.9)


# -- serial link over a pty --------------------------------------------------

def test_chassis_link_parses_frames_over_pty():
    import tty

    master, slave = pty.openpty()
    tty.setraw(slave)      # no echo: master must not read back its writes
    received = {"wheels": None, "rc": None, "err": None}
    cal = ActuatorCalibration()
    link = ChassisLink(
        slave, cal, wheel_diameter=0.19,
        on_wheel_speeds=lambda *s: received.__setitem__("wheels", s),
        on_rc_command=lambda *a: received.__setitem__("rc", a),
        on_error=lambda e: received.__setitem__("err", e))
    link.start()
    try:
        # wheel speeds: 10 rot/s each -> 10 * 0.19 * pi m/s
        os.write(master, b"#w10.0,10.0,5.0,5.0\n")
        # RC: steering 1750us (=0.5), throttle 1500us (=0), auton on
        os.write(master, b"garbage#r1750,1500,1600,1\n")
        os.write(master, b"#esensor fault\n")
        deadline = time.time() + 5
        while (received["err"] is None and time.time() < deadline):
            time.sleep(0.01)
        assert received["wheels"] is not None
        np.testing.assert_allclose(received["wheels"][0], 10 * 0.19 * math.pi)
        np.testing.assert_allclose(received["wheels"][2], 5 * 0.19 * math.pi)
        steer, throttle, auton = received["rc"]
        assert steer == pytest.approx(0.5)
        assert throttle == pytest.approx(0.0)
        assert auton is True
        assert received["err"] == "sensor fault"

        # outgoing command frame
        link.send_command(0.5, -0.25, 0.0)
        frame = os.read(master, 9)
        assert frame[:2] == b"#s" and frame[-1:] == b"\n"
        steer_us, thr_us, brake_us = struct.unpack(">hhh", frame[2:8])
        assert steer_us == cal.cmd_to_us(0.5, "steering")
        assert thr_us == cal.cmd_to_us(-0.25, "throttle")
    finally:
        link.stop()
        os.close(master)
        os.close(slave)


# -- wheel odometry ----------------------------------------------------------

def test_wheel_odometry_straight_line():
    wo = WheelOdometry(using_sim=True)
    wo.update_steering(0.0)
    t = 0.0
    for _ in range(50):
        t += 0.02
        est = wo.update_wheel_speeds(t, 2.0, 2.0, 2.0, 2.0)
    # 1 s at 2 m/s straight -> ~2 m in +x (first step uses default dt)
    assert est.x == pytest.approx(2.0, abs=0.1)
    assert abs(est.y) < 1e-9
    assert est.v_x == pytest.approx(2.0)
    assert est.yaw_rate == 0.0
    assert est.velocity_x_var == pytest.approx(0.569)


def test_wheel_odometry_turns():
    wo = WheelOdometry(using_sim=True)
    wo.update_steering(-0.3)        # sim: angle = -21 * -0.3 = +6.3 deg left
    t = 0.0
    for _ in range(100):
        t += 0.02
        est = wo.update_wheel_speeds(t, 3.0, 3.0, 3.0, 3.0)
    assert est.yaw > 0.2            # turned left
    assert est.yaw_rate > 0
    # equal wheel speeds while turning indicate slip -> the variance model
    # reports elevated yaw-rate variance, bounded by its asymptote
    base = -3.199 + 3.7705
    assert base < est.yaw_rate_var <= 3.7705


# -- state estimator ---------------------------------------------------------

def synth_trajectory(T=20.0, dt=0.005, radius=10.0, speed=5.0):
    """Circular drive: true states + perfect body-frame IMU readings."""
    omega = speed / radius
    ts = np.arange(0, T, dt)
    poses, imu = [], []
    for t in ts:
        th = omega * t
        pos = np.array([radius * math.cos(th), radius * math.sin(th), 0.0])
        yaw = th + math.pi / 2
        # body-frame specific force: centripetal accel in body frame - g
        a_world = np.array([-radius * omega ** 2 * math.cos(th),
                            -radius * omega ** 2 * math.sin(th), 0.0])
        R = np.array([[math.cos(yaw), -math.sin(yaw), 0],
                      [math.sin(yaw), math.cos(yaw), 0], [0, 0, 1]])
        accel_body = R.T @ (a_world - np.array([0, 0, -9.80665]))
        gyro_body = np.array([0.0, 0.0, omega])
        poses.append((t, pos, yaw))
        imu.append((accel_body, gyro_body))
    return poses, imu


def test_ekf_tracks_circular_trajectory():
    poses, imu = synth_trajectory()
    ekf = ErrorStateEKF()
    t0, p0, yaw0 = poses[0]
    ekf.initialize(t0, p0, yaw0)
    rng = np.random.RandomState(0)
    errs = []
    for i, ((t, pos, yaw), (a, w)) in enumerate(zip(poses, imu)):
        if i > 0:
            ekf.imu_update(t, a + rng.randn(3) * 0.05,
                           w + rng.randn(3) * 0.005)
        if i % 40 == 0:        # 5 Hz GPS with 3 cm noise
            ekf.gps_update(pos + rng.randn(3) * 0.03)
        if i > len(poses) // 2:
            errs.append(np.linalg.norm(ekf.p[:2] - pos[:2]))
    assert np.mean(errs) < 0.15, np.mean(errs)
    od = ekf.odometry()
    assert np.isfinite(od["position"]).all()


def test_ekf_velocity_update_tightens_estimate():
    poses, imu = synth_trajectory(T=10.0)
    rng = np.random.RandomState(1)

    def run(with_vel):
        ekf = ErrorStateEKF()
        t0, p0, yaw0 = poses[0]
        ekf.initialize(t0, p0, yaw0)
        errs = []
        for i, ((t, pos, yaw), (a, w)) in enumerate(zip(poses, imu)):
            if i > 0:
                ekf.imu_update(t, a + rng.randn(3) * 0.1,
                               w + rng.randn(3) * 0.01)
            if i % 200 == 0:   # sparse 1 Hz GPS
                ekf.gps_update(pos + rng.randn(3) * 0.05)
            if with_vel and i % 10 == 0:
                ekf.velocity_update([5.0, 0.0, 0.0])
            if i > len(poses) // 2:
                errs.append(np.linalg.norm(ekf.v[:2]
                                           - _true_vel(poses, i)[:2]))
        return np.mean(errs)

    def _true_vel(poses, i):
        t, pos, yaw = poses[i]
        speed, radius = 5.0, 10.0
        om = speed / radius
        th = om * t
        return np.array([-speed * math.sin(th), speed * math.cos(th), 0.0])

    e_without = run(False)
    e_with = run(True)
    assert e_with < e_without


def test_ekf_state_vector_for_controller():
    ekf = ErrorStateEKF()
    ekf.initialize(0.0, [1.0, 2.0, 0.0], yaw=0.5)
    ekf.v = np.array([3.0 * math.cos(0.5), 3.0 * math.sin(0.5), 0.0])
    s = ekf.state_vector(yaw_rate=0.3)
    np.testing.assert_allclose(s[:3], [1.0, 2.0, 0.5], atol=1e-6)
    assert s[4] == pytest.approx(3.0, abs=1e-5)   # body forward velocity
    assert s[6] == pytest.approx(-0.3)            # negated yaw rate


# ---------------------------------------------------------------------------
# line noise, the shared transport and the wire types (tests/test_faults.py,
# tests/test_serial_device.py, tests/test_msgs.py)
# ---------------------------------------------------------------------------

def test_chassis_link_noise_and_recovery():
    import random

    rng = random.Random(6)
    got = []
    link = ChassisLink(fd=-1, calibration=ActuatorCalibration(),
                       on_wheel_speeds=lambda *a: got.append(a))
    frame = b"#w1.0,1.0,2.0,2.0\n"
    stream = b""
    for _ in range(40):
        g = bytes(rng.randrange(256) for _ in range(rng.randrange(0, 60)))
        stream += g.replace(b"#", b"*") + frame
    i = 0
    while i < len(stream):
        n = rng.randrange(1, 33)
        link.process_bytes(stream[i:i + n])
        i += n
    assert len(got) >= 38                 # valid frames recovered
    for lf, rf, lb, rb in got:
        assert lf == pytest.approx(0.19 * math.pi)


def test_chassis_link_rides_the_shared_transport():
    from autorally_tpu_torch.runtime.serial_device import (
        SerialDeviceThreaded, SerialSettings, configure_port)

    master, slave = pty.openpty()
    configure_port(slave, SerialSettings())
    speeds = []
    link = ChassisLink(slave, ActuatorCalibration(),
                       on_wheel_speeds=lambda *s: speeds.append(s))
    link.start()
    try:
        assert isinstance(link._device, SerialDeviceThreaded)
        os.write(master, b"#w1.0,1.0,2.0,2.0\n")
        deadline = time.time() + 5.0
        while len(speeds) != 1 and time.time() < deadline:
            time.sleep(0.01)
        assert len(speeds) == 1
        link.send_command(0.0, 0.5)
        frame = os.read(master, 16)
        assert frame.startswith(b"#s") and frame.endswith(b"\n")
    finally:
        link.stop()
        os.close(master)
        os.close(slave)


def test_chassis_types_are_the_runtime_types():
    # one source of truth: the arbiter's records ARE the wire types
    from autorally_tpu_torch import msgs
    from autorally_tpu_torch.runtime import chassis

    assert chassis.ChassisCommand is msgs.ChassisCommand
    assert chassis.ChassisState is msgs.ChassisState
