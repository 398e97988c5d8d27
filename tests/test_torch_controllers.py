"""The port's fallback controllers and SafeSpeed governor
(``tests/test_controllers.py`` case for case on ``autorally_tpu_torch``).

Fallback controllers + SafeSpeed governor (reference parity tests)."""

import math

import numpy as np
import pytest

from autorally_tpu_torch.runtime.chassis import ChassisCommand, CommandArbiter
from autorally_tpu_torch.runtime.controllers import (DEFAULT_CALIBRATION,
                                                     ConstantSpeedController,
                                                     GpsWaypointController,
                                                     JoystickController,
                                                     NOT_COMMANDED,
                                                     SafeSpeedGovernor,
                                                     ThrottleCalibration)


# -- throttle calibration ---------------------------------------------------

def test_calibration_interpolates_and_rejects_out_of_range():
    cal = ThrottleCalibration([(0, 0.0), (4, 0.2), (8, 0.4)])
    assert cal.interpolate(2.0) == pytest.approx(0.1)
    assert cal.interpolate(6.0) == pytest.approx(0.3)
    assert cal.interpolate(8.0) == pytest.approx(0.4)
    assert cal.interpolate(9.0) is None         # interpolateKey false
    assert cal.interpolate(-1.0) is None


# -- constant speed PI ------------------------------------------------------

def test_constant_speed_converges_on_first_order_plant():
    """PI + calibration feedforward drives a crude wheel-speed plant to
    the setpoint (ConstantSpeedController.cpp:109-157)."""
    c = ConstantSpeedController()
    c.set_speed(6.0)
    speed, dt = 0.0, 0.05
    for i in range(400):
        cmd = c.wheel_speeds(speed, speed, speed, speed, stamp=i * dt)
        assert 0.0 <= cmd.throttle <= 1.0
        assert cmd.steering == NOT_COMMANDED
        # plant: speed follows (throttle -> ~25 m/s full scale) with lag
        speed += dt * (25.0 * cmd.throttle - speed) / 0.8
    assert abs(speed - 6.0) < 0.3


def test_constant_speed_idle_and_uncalibrated():
    c = ConstantSpeedController()
    c.set_speed(0.0)                             # below the 0.1 threshold
    assert c.wheel_speeds(3, 3, 3, 3, 0.0).throttle == 0.0
    c.set_speed(99.0)                            # outside the calibration
    assert c.wheel_speeds(3, 3, 3, 3, 0.0).throttle == 0.0


def test_constant_speed_integral_clamp():
    c = ConstantSpeedController(kp=0.0, ki=0.1, integral_max=0.5)
    c.set_speed(6.0)
    for i in range(1000):                        # huge persistent error
        cmd = c.wheel_speeds(0, 0, 0, 0, stamp=float(i))
    ff = DEFAULT_CALIBRATION.interpolate(6.0)
    assert cmd.throttle == pytest.approx(min(1.0, ff + 0.5))


# -- waypoint follower ------------------------------------------------------

def test_waypoint_follower_steers_toward_waypoint_and_advances():
    wp = GpsWaypointController([(10.0, 0.0), (10.0, 10.0)], radius=1.5,
                               heading_p=2.0, use_theta_gps=False)
    # heading +x, waypoint dead ahead: no steering
    cmd = wp.odometry(0.0, 0.0, 0.0, stamp=0.0)
    assert cmd.steering == pytest.approx(0.0, abs=1e-9)
    assert cmd.throttle == NOT_COMMANDED
    # waypoint 90 deg left: saturated steering (2.0 * pi/2 > 1)
    cmd = wp.odometry(10.0, -10.0, 0.0, stamp=0.1)
    assert cmd.steering == pytest.approx(1.0)
    # arriving within the radius advances to the next (cyclic) waypoint
    wp.odometry(9.0, 0.5, 0.0, stamp=0.2)
    assert wp.next_waypoint == (10.0, 10.0)


def test_waypoint_follower_closes_loop_kinematically():
    """Drive a kinematic bicycle around a 4-waypoint square."""
    pts = [(20.0, 0.0), (20.0, 20.0), (0.0, 20.0), (0.0, 0.0)]
    wp = GpsWaypointController(pts, radius=2.0, heading_p=1.5,
                               use_theta_gps=True)
    x, y, yaw, v, dt = 0.0, -5.0, 0.0, 4.0, 0.05
    visited = set()
    for i in range(1200):
        cmd = wp.odometry(x, y, yaw, stamp=i * dt)
        yaw += v * dt * math.tan(0.4 * cmd.steering) / 0.57
        x += v * dt * math.cos(yaw)
        y += v * dt * math.sin(yaw)
        visited.add(wp.next_waypoint)
    assert len(visited) == 4                    # toured every waypoint


def test_waypoint_follower_all_waypoints_reached_terminates():
    """Regression: when every waypoint sits within the arrival radius the
    cyclic advance must stop after one full rotation instead of spinning
    the control thread forever."""
    wp = GpsWaypointController([(0.0, 0.0), (0.5, 0.5), (-0.5, 0.3)],
                               radius=5.0, use_theta_gps=False)
    cmd = wp.odometry(0.0, 0.0, 0.0, stamp=0.0)   # must return, not hang
    assert math.isfinite(cmd.steering)
    assert wp.next_waypoint in {(0.0, 0.0), (0.5, 0.5), (-0.5, 0.3)}


def test_angle_diff_wraps():
    ad = GpsWaypointController._angle_diff
    assert ad(3.0, -3.0) == pytest.approx(3.0 - (-3.0) - 2 * math.pi)
    assert ad(0.1, -0.1) == pytest.approx(0.2)


# -- joystick ---------------------------------------------------------------

def test_joystick_mapping_and_brake():
    j = JoystickController(steering_damping=0.6, throttle_damping=0.5)
    cmd = j.joy([0.5, 0.8], stamp=0.0)
    assert cmd.steering == pytest.approx(-0.3)   # inverted + damped
    assert cmd.throttle == pytest.approx(0.4)
    assert cmd.front_brake == 0.0
    cmd = j.joy([0.0, -0.8], stamp=0.1)          # pull back = brake
    assert cmd.throttle == 0.0
    assert cmd.front_brake == pytest.approx(0.4)
    j.steering_enabled = False
    j.throttle_enabled = False
    cmd = j.joy([1.0, 1.0], stamp=0.2)
    assert cmd.steering == -10.0 and cmd.throttle == -10.0


# -- SafeSpeed governor -----------------------------------------------------

def test_safe_speed_min_over_senders_with_expiry():
    g = SafeSpeedGovernor(max_speed=10.0, timeout=5.0)
    assert g.get_safe_speed(0.0) == 10.0
    g.submit_safe_speed("ocs", 6.0, stamp=0.0)
    g.submit_safe_speed("chronyStatus", 4.0, stamp=0.0)
    assert g.get_safe_speed(1.0) == 4.0
    assert g.get_safe_speed(5.5) == 10.0         # both expired


def test_safe_speed_governs_and_latches():
    g = SafeSpeedGovernor(max_speed=10.0)
    g.submit_safe_speed("ocs", 5.0, stamp=0.0)
    # below the limit: pass through
    assert g.safe_throttle(0.6, vehicle_speed=3.0, now=0.1) == 0.6
    # above the limit: cut and latch
    assert g.safe_throttle(0.6, vehicle_speed=5.5, now=0.2) == 0.0
    assert g.safe_throttle(0.6, vehicle_speed=4.0, now=0.3) == 0.0  # latched
    # commander backs off below the last passed value: release
    assert g.safe_throttle(0.3, vehicle_speed=4.0, now=0.4) == 0.3
    # zero safe speed always cuts
    g.submit_safe_speed("ocs", 0.0, stamp=0.5)
    assert g.safe_throttle(0.9, vehicle_speed=0.0, now=0.6) == 0.0


# -- the arbitration story: MPPI drops out, fallbacks take over -------------

def test_mppi_dropout_fallback_takeover_with_safespeed():
    """The reference safety layering: MPPI commands normally; when it goes
    stale the arbiter hands each actuator to the next fresh commander
    (ConstantSpeed for throttle, waypoint follower for steering), and
    SafeSpeed caps the arbitrated throttle."""
    arb = CommandArbiter(priorities=["mppi", "constantSpeedController",
                                    "waypointFollower"])
    arb.submit_runstop("box", True, stamp=0.0)
    csc = ConstantSpeedController()
    csc.set_speed(4.0)
    wpf = GpsWaypointController([(100.0, 0.0)], use_theta_gps=False)
    gov = SafeSpeedGovernor(max_speed=10.0)
    gov.submit_safe_speed("ocs", 5.0, stamp=0.0)

    # t=0.0: MPPI alive — it owns both actuators
    arb.submit(ChassisCommand(sender="mppi", steering=0.2, throttle=0.5,
                              front_brake=0.0, stamp=0.0))
    arb.submit(csc.wheel_speeds(3, 3, 3, 3, stamp=0.0))
    arb.submit(wpf.odometry(0.0, 0.0, 0.0, stamp=0.0))
    st = arb.arbitrate(now=0.05)
    assert st.steering_commander == "mppi"
    assert st.throttle_commander == "mppi"

    # t=0.3: MPPI stale (command_max_age=0.2) — fallbacks take over
    arb.submit(csc.wheel_speeds(3, 3, 3, 3, stamp=0.29))
    arb.submit(wpf.odometry(0.0, 0.0, 0.0, stamp=0.29))
    st = arb.arbitrate(now=0.3)
    assert st.throttle_commander == "constantSpeedController"
    assert st.steering_commander == "waypointFollower"
    assert 0.0 < st.throttle <= 1.0

    # SafeSpeed caps the arbitrated throttle once the car runs too fast
    assert gov.safe_throttle(st.throttle, vehicle_speed=3.0,
                             now=0.3) == st.throttle
    assert gov.safe_throttle(st.throttle, vehicle_speed=6.0, now=0.31) == 0.0
