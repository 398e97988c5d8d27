"""The port's physics simulator (``autorally_tpu_torch/sim``) against the JAX
package's (``autorally_tpu/sim``) on the CPU.

``vehicle_step``: one period from seeded states (standstill, a hard turn,
braking, a steering angle under the Ackermann branch's 1e-4) within rtol
1e-6 / atol 1e-6 of the JAX step compiled with the parameters constant (as
the JAX tests, the JAX simulator node and the examples compile it), and
500 periods (10 s) under a gentle and a hard command script within rtol
1e-5 / atol 1e-4 on every field at every period.  The twins of the JAX
tests' physics, Ackermann and arbitration checks run on the port.  The
plants run the same open-loop command stream through ``on_control`` beside
the JAX plants (which compile the step with the parameters as arguments,
so XLA folds none of their constants; see ``sim/vehicle.py``): the state
they publish, their wheel speeds, and the estimating plant's truth and
estimate logs and error summary agree within the same tolerance."""

import functools
import math
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autorally_tpu import sim as jsim
from autorally_tpu.sim import vehicle as jvehicle
from autorally_tpu_torch.sim import (ActuationLimits, SimCommand,
                                     SimCommandArbiter, SimVehiclePlant,
                                     VehicleParams, ackermann_angles,
                                     controller_state, init_sim_state,
                                     vehicle_step, wheel_speeds)
from autorally_tpu_torch.sim import SimVehicleEstimatedPlant
from autorally_tpu_torch.sim import vehicle as tvehicle

P = VehicleParams()
JP = jvehicle.VehicleParams()
DT = 0.02
ONE_RTOL, ONE_ATOL = 1e-6, 1e-6          # one period
RUN_RTOL, RUN_ATOL = 1e-5, 1e-4          # 500 periods, and the plants
RUN_PERIODS = 500
PLANT_TICKS = 200
START = np.array([30.0, 0.0, math.pi / 2, 0.0, 0.0, 0.0, 0.0], np.float32)

_jax_step = jax.jit(lambda s, c: jvehicle.vehicle_step(JP, s, c, DT, 20))


def gentle(t):
    """steering 0.2 sin(0.7 t), throttle 0.3 + 0.1 sin(0.3 t)."""
    return [0.2 * math.sin(0.7 * t), 0.3 + 0.1 * math.sin(0.3 * t), 0.0]


def hard(t):
    """Full-lock steering flipping every 2 pi s, throttle 0.9, the front
    brake from t = 8 s."""
    return [1.0 if int(t // (2 * math.pi)) % 2 == 0 else -1.0, 0.9,
            1.0 if t >= 8.0 else 0.0]


SCRIPTS = {"gentle": gentle, "hard": hard}


def _flat(s) -> np.ndarray:
    return np.concatenate([np.asarray(v, np.float32).reshape(-1)
                           for v in s])


def _jax_state(flat: np.ndarray):
    return jvehicle.SimState(*[jnp.asarray(flat[i]) for i in range(9)],
                             omega=jnp.asarray(flat[9:13]))


def _port_flat(s) -> np.ndarray:
    return _flat(tvehicle.sim_state_to_numpy(s))


def _states():
    """Seeded starts: (name, packed state, command)."""
    rng = np.random.RandomState(19)
    out = []
    out.append(("standstill", np.zeros(13, np.float32),
                np.float32([0.0, 0.0, 0.0])))
    s = np.zeros(13, np.float32)
    s[:9] = [3.0, -2.0, 0.7, 0.05, 0.3, 6.5, 0.4, 1.8, -0.38]
    s[9:] = 6.5 / 0.095 + rng.randn(4) * 3.0
    out.append(("hard_turn", s, np.float32([1.0, 0.9, 0.0])))
    s = np.zeros(13, np.float32)
    s[:9] = [-5.0, 8.0, -2.1, -0.02, 0.1, 7.0, -0.2, -0.4, 0.05]
    s[9:] = 7.0 / 0.095
    out.append(("braking", s, np.float32([0.0, -0.8, 1.0])))
    s = np.zeros(13, np.float32)
    s[:9] = [1.0, 1.0, 0.3, 0.0, 0.0, 3.0, 0.01, 0.02, 5e-5]
    s[9:] = 3.0 / 0.095
    out.append(("small_steer", s, np.float32([-1e-4, 0.4, 0.0])))
    for i in range(4):
        s = np.zeros(13, np.float32)
        s[:9] = rng.randn(9) * [10, 10, 3, 0.1, 0.5, 5, 0.5, 1, 0.3]
        s[9:] = rng.randn(4) * 30
        out.append((f"random{i}", s,
                    np.float32(rng.uniform(-1.2, 1.2, 3))))
    return out


@pytest.mark.parametrize("name,flat,cmd", _states(),
                         ids=[c[0] for c in _states()])
def test_one_period_matches_jax(name, flat, cmd):
    want = _flat(_jax_step(_jax_state(flat), jnp.asarray(cmd)))
    got = _port_flat(vehicle_step(
        P, tvehicle.sim_state_from_numpy(flat, "cpu"), cmd, DT, 20))
    assert np.isfinite(want).all()
    np.testing.assert_allclose(got, want, rtol=ONE_RTOL, atol=ONE_ATOL)


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_500_periods_match_jax(script):
    fn = SCRIPTS[script]
    js = jvehicle.init_sim_state()
    ts = init_sim_state(device="cpu")
    for i in range(RUN_PERIODS):
        cmd = np.float32(fn(i * DT))
        js = _jax_step(js, jnp.asarray(cmd))
        ts = vehicle_step(P, ts, cmd, DT, 20)
        np.testing.assert_allclose(_port_flat(ts), _flat(js),
                                   rtol=RUN_RTOL, atol=RUN_ATOL,
                                   err_msg=f"period {i}")
    assert float(ts.vx) > 2.0                    # the car drove


# the factors of ``_Constants`` that XLA folds (``half_r`` is exact either
# way: a product with 0.5)
XLA_FOLDS = ("steer_gain", "inv_tau", "load_transfer", "slip_r", "slip_rr",
             "dt_iw", "dt_iw_denom", "inv_mass", "roll_force", "dt_izz",
             "dt_ixx")


@functools.lru_cache(maxsize=1)
def _hlo_constants() -> frozenset:
    """The float32 scalar constants of the compiled JAX step's HLO."""
    hlo = _jax_step.lower(jvehicle.init_sim_state(),
                          jnp.zeros(3, jnp.float32)).compile().as_text()
    return frozenset(np.float32(v) for v in re.findall(
        r"f32\[1?\](?:\{0\})? constant\(\{?([-+.e0-9]+)\}?\)", hlo))


@pytest.mark.parametrize("name", XLA_FOLDS)
def test_xla_folds_the_factors_the_port_copies(name):
    """Each folded factor of the port's substep is a float32 constant of
    the optimised HLO of the JAX step compiled with the parameters
    constant.  If this fails, the installed XLA folds the substep another
    way, and ``sim/vehicle._Constants`` must be read again from its HLO."""
    c = tvehicle._constants(P, DT / 20, torch.device("cpu"))
    want = np.float32(getattr(c, name).item())
    assert want in _hlo_constants(), (
        f"XLA ({jax.__version__}) no longer folds {name} = {want!r} into "
        f"one float32 constant of the compiled JAX substep")

def test_state_crossing_and_init_match_jax():
    js = jvehicle.init_sim_state(x=1.5, y=-2.0, yaw=0.3, vx=4.2)
    ts = init_sim_state(x=1.5, y=-2.0, yaw=0.3, vx=4.2, device="cpu")
    np.testing.assert_array_equal(_port_flat(ts), _flat(js))
    back = tvehicle.sim_state_from_numpy(
        jax.tree_util.tree_map(np.asarray, js), "cpu")
    assert back.omega.shape == (4,) and back.x.shape == ()
    np.testing.assert_array_equal(_port_flat(back), _flat(js))
    packed = tvehicle.pack_sim_state(back)
    assert packed.shape == (tvehicle.STATE_SIZE,)
    np.testing.assert_array_equal(
        _port_flat(tvehicle.unpack_sim_state(packed)), _flat(js))
    np.testing.assert_array_equal(
        controller_state(ts).numpy(),
        np.asarray(jvehicle.controller_state(js)))
    with pytest.raises(ValueError, match="13"):
        tvehicle.sim_state_from_numpy(np.zeros(12), "cpu")


def _drive(s, cmd, n):
    for _ in range(n):
        s = vehicle_step(P, s, cmd, DT, 20)
    return s


# -- twins of tests/test_sim_vehicle.py on the port ---------------------------

@pytest.fixture(scope="module")
def throttle_drive():
    """2 s at half throttle from rest."""
    return _drive(init_sim_state(device="cpu"), [0.0, 0.5, 0.0], 100)


class TestVehiclePhysics:
    def test_accelerates_under_throttle(self, throttle_drive):
        s = throttle_drive
        assert float(s.vx) > 4.0
        assert float(s.x) > 4.0
        assert abs(float(s.y)) < 0.2

    def test_wheels_spin_consistently(self, throttle_drive):
        s = throttle_drive
        ws = wheel_speeds(P, tvehicle.sim_state_to_numpy(s))
        # rear (driven) wheels spin at or above body speed; fronts roll
        assert ws[2] == pytest.approx(ws[3], rel=1e-3)
        assert ws[0] == pytest.approx(float(s.vx), rel=0.05)
        assert ws[2] >= ws[0] - 1e-3

    def test_steering_sign_matches_reference_models(self):
        s = _drive(init_sim_state(vx=5.0, device="cpu"), [0.5, 0.3, 0.0],
                   50)
        assert float(s.yaw) < -0.3
        assert float(controller_state(s)[6]) > 0.0

    def test_roll_bounded_in_hard_turn(self):
        s = _drive(init_sim_state(vx=7.0, device="cpu"), [0.9, 0.4, 0.0],
                   100)
        assert abs(float(s.roll)) < 0.6

    def test_braking_and_front_brake(self):
        s = _drive(init_sim_state(vx=6.0, device="cpu"), [0.0, -0.5, 0.0],
                   100)
        assert float(s.vx) < 2.0
        s2 = _drive(init_sim_state(vx=6.0, device="cpu"), [0.0, 0.0, 1.0],
                    100)
        s3 = _drive(init_sim_state(vx=6.0, device="cpu"), [0.0, 0.0, 0.0],
                    100)
        assert float(s2.vx) < float(s3.vx)

    def test_friction_limits_lateral_accel(self):
        s = _drive(init_sim_state(vx=8.0, device="cpu"), [1.0, 0.5, 0.0],
                   50)
        ay = abs(float(s.yaw_rate) * float(s.vx))
        assert ay < 1.5 * P.mu * 9.81

    def test_servo_lag(self):
        s = _drive(init_sim_state(vx=3.0, device="cpu"), [1.0, 0.0, 0.0], 1)
        assert abs(float(s.steer)) < P.max_steer * 0.8
        s = _drive(s, [1.0, 0.0, 0.0], 50)
        assert float(s.steer) == pytest.approx(
            P.steer_sign * P.max_steer, abs=0.02)

    def test_standstill_stays_put(self):
        s = _drive(init_sim_state(device="cpu"), [0.0, 0.0, 0.0], 50)
        assert abs(float(s.x)) < 1e-2 and abs(float(s.vx)) < 1e-2


class TestAckermann:
    def test_inner_wheel_steers_more_and_matches_jax(self):
        left, right = ackermann_angles(P, -0.8)
        assert left != right
        assert max(abs(left), abs(right)) <= math.radians(45)
        for cmd in (-1.2, -0.8, -1e-4, 0.0, 0.3, 1.0):
            assert ackermann_angles(P, cmd) == jsim.ackermann_angles(JP,
                                                                     cmd)

    def test_zero_and_sign(self):
        l0, r0 = ackermann_angles(P, 0.0)
        assert l0 == 0.0 and r0 == 0.0
        l1, r1 = ackermann_angles(P, 1.0)
        l2, r2 = ackermann_angles(P, -1.0)
        assert l1 == pytest.approx(-r2, abs=1e-6)
        assert r1 == pytest.approx(-l2, abs=1e-6)


class TestArbitration:
    def test_priority_order(self):
        arb = SimCommandArbiter(["joystick", "mppi"])
        arb.put_command(SimCommand("mppi", steering=0.5, throttle=0.5,
                                   stamp=10.0))
        arb.put_command(SimCommand("joystick", steering=-0.2, throttle=0.1,
                                   stamp=10.0))
        s, t, b, info = arb.arbitrate(10.05)
        assert (s, t) == (-0.2, 0.1)
        assert info["steeringCommander"] == "joystick"

    def test_stale_commander_falls_through(self):
        arb = SimCommandArbiter(["joystick", "mppi"])
        arb.put_command(SimCommand("joystick", steering=-0.2, stamp=1.0))
        arb.put_command(SimCommand("mppi", steering=0.5, throttle=0.4,
                                   stamp=10.0))
        s, t, b, info = arb.arbitrate(10.05)
        assert s == 0.5 and info["steeringCommander"] == "mppi"

    def test_out_of_range_rejected(self):
        arb = SimCommandArbiter(["mppi"])
        arb.put_command(SimCommand("mppi", steering=1.5, throttle=0.4,
                                   stamp=10.0))
        s, t, b, _ = arb.arbitrate(10.05)
        assert s == 0.0 and t == 0.4

    def test_runstop_zeroes_throttle_only(self):
        arb = SimCommandArbiter(["mppi"])
        arb.put_command(SimCommand("mppi", steering=0.3, throttle=0.8,
                                   stamp=10.0))
        arb.put_runstop("box", False)
        s, t, b, info = arb.arbitrate(10.05)
        assert t == 0.0 and s == 0.3
        assert info["throttleCommander"] == "runstop"
        arb.put_runstop("box", True)
        s, t, b, _ = arb.arbitrate(10.05)
        assert t == 0.8

    def test_runstop_is_and_over_publishers(self):
        arb = SimCommandArbiter(["mppi"])
        arb.put_runstop("a", True)
        arb.put_runstop("b", False)
        assert not arb.motion_enabled()

    def test_command_timeout_stops_vehicle(self):
        arb = SimCommandArbiter(["mppi"], ActuationLimits(cmd_timeout=0.5))
        arb.put_command(SimCommand("mppi", steering=0.3, throttle=0.8,
                                   stamp=10.0))
        s, t, b, _ = arb.arbitrate(11.0)
        assert s == 0.0 and t == 0.0


# -- the plants ---------------------------------------------------------------

def _rel(got, want) -> float:
    """The largest |got - want| over the run's tolerance."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float((np.abs(got - want)
                  / (RUN_ATOL + RUN_RTOL * np.abs(want))).max())


@pytest.mark.parametrize("estimated,script", [(False, "gentle"),
                                              (True, "hard")])
def test_plants_match_jax_under_open_loop_commands(estimated, script):
    """The same command stream through ``on_control`` each tick: the state
    each plant publishes (``get_state``), its truth and wheel speeds, and
    for the estimating plant the EKF's estimate and error summary."""
    fn = SCRIPTS[script]
    jcls = jsim.SimVehicleEstimatedPlant if estimated else \
        jsim.SimVehiclePlant
    tcls = SimVehicleEstimatedPlant if estimated else SimVehiclePlant
    jp = jcls(START, DT, 24)
    tp = tcls(START, DT, 24, device="cpu")
    assert tp.period.eager
    worst = 0.0
    for i in range(PLANT_TICKS):
        steer, throttle, _ = fn(i * DT)
        for plant in (jp, tp):
            plant.on_control(plant.sim_time, steer, throttle)
            plant.step_sim(1)
        assert tp.sim_time == jp.sim_time
        assert tp.pose_count == jp.pose_count
        worst = max(worst,
                    _rel(tp.get_state().to_vector(),
                         jp.get_state().to_vector()),
                    _rel(tp.true_state, jp.true_state),
                    _rel(tp.wheel_speeds(), jp.wheel_speeds()))
    assert worst <= 1.0, worst
    np.testing.assert_allclose(
        tvehicle.pack_sim_state(tp.sim_state).numpy(),
        _flat(jp.sim_state), rtol=RUN_RTOL, atol=RUN_ATOL)
    if estimated:
        assert _rel(tp.truth_log, jp.truth_log) <= 1.0
        assert _rel(tp.est_log, jp.est_log) <= 1.0
        te, je = tp.estimation_errors(), jp.estimation_errors()
        assert te.keys() == je.keys()
        for k in je:
            assert te[k] == pytest.approx(je[k], rel=RUN_RTOL,
                                          abs=RUN_ATOL), k
    assert tp.true_state[4] > 1.0


def test_plant_state_setter_and_wheel_speeds():
    plant = SimVehiclePlant(np.zeros(7, dtype=np.float32), DT, 10,
                            device="cpu")
    plant.receive_state_vector(0.0, plant.true_state)
    ws = plant.wheel_speeds()
    assert ws.shape == (4,) and np.all(ws >= 0)
    s = init_sim_state(x=2.0, vx=3.0, device="cpu")
    plant.sim_state = s
    np.testing.assert_array_equal(plant.true_state,
                                  controller_state(s).numpy())
    np.testing.assert_allclose(plant.wheel_speeds(), 3.0, rtol=1e-6)
    plant.step_sim(2)
    assert plant.sim_time == pytest.approx(2 * DT)
    assert plant.true_state[0] > 2.0
    # the getter is a copy: stepping does not move an earlier read
    before = plant.sim_state
    x0 = float(before.x)
    plant.step_sim(1)
    assert float(before.x) == x0 != float(plant.sim_state.x)


def test_plant_on_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no GPU"):
        SimVehiclePlant(START, DT, 10)
    with pytest.raises(RuntimeError, match="no GPU"):
        init_sim_state()
