"""The port's tube-MPPI runtime against the JAX package on the CPU: the pose
functions, the plant pipeline, the telemetry, the controller and the tube
loop (``run_control_loop``) with the same seeded weights and the same fixed
noise injected on both sides, a different noise for each controller's
solver (as ``tests/test_torch_solver.py`` injects it); and
``run_tube_mppi`` itself."""

import json
import math
import socket
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autorally_tpu import msgs as jmsgs
from autorally_tpu.config import CostParams as JaxCostParams
from autorally_tpu.config import MPPIConfig as JaxConfig
from autorally_tpu.costs import MPPICost as JaxCost
from autorally_tpu.costs.costmap import make_costmap as jax_make_costmap
from autorally_tpu.models import NeuralNetDynamics as JaxNN
from autorally_tpu.runtime import control_loop as jloop
from autorally_tpu.runtime import controller as jcontroller
from autorally_tpu.runtime import plant as jplant
from autorally_tpu.runtime import pose as jpose
from autorally_tpu.runtime import telemetry as jtele
from autorally_tpu.solver import mppi as jmppi
from autorally_tpu.solver.ddp import DDPSolver as JaxDDP
from autorally_tpu.tools.track_generator import oval_track
from autorally_tpu_torch import msgs, run_tube_mppi
from autorally_tpu_torch.config import CostParams, MPPIConfig
from autorally_tpu_torch.costs import MPPICost, make_costmap
from autorally_tpu_torch.models import NeuralNetDynamics
from autorally_tpu_torch.runtime import control_loop, controller, plant, pose
from autorally_tpu_torch.runtime import telemetry
from autorally_tpu_torch.runtime.telemetry_bus import send_runstop
from autorally_tpu_torch.solver import mppi
from autorally_tpu_torch.solver.ddp import DDPSolver

START = np.array([30.0, 0.0, math.pi / 2, 0.0, 0.0, 0.0, 0.0], np.float32)
# The tube loop against the JAX loop, twelve closed-loop ticks on a map of
# one cost everywhere: every solve agrees to ~1e-6 relative (as in
# tests/test_torch_solver.py), the plant integrates the published control
# (XLA's fused step against PyTorch's) and the next tick starts from that
# state; measured within 3e-7 (controls, plans) and 1e-6 relative (gains)
# of the JAX loop's over the twelve ticks.  (On the oval's 25 cm texels a
# rounding-level change of position moves some lookup of the swarm across
# a texel edge every few ticks, a step in one rollout's cost, and the two
# loops part by 1e-3 within ten ticks: the map's lookups are held against
# the JAX package by tests/test_torch_costs.py and the solver's by
# tests/test_torch_solver.py.)
LOOP_RTOL, LOOP_ATOL = 1e-4, 1e-6
# the smallest relative gap allowed between the two controllers' costs in
# a tick: 100x the costs' agreement, so that no branch is a near-tie
TIE_MARGIN = 1e-4
NOISE_TABLE = 16
FLAT = np.zeros((60, 80, 4), np.float32)
FLAT[..., 0] = 0.1                     # under the 0.65 boundary: no crash
FLAT_MAP = (FLAT, (-40.0, 40.0), (-30.0, 30.0))


# -- pose --------------------------------------------------------------------

def test_pose_functions_equal_jax():
    rs = np.random.default_rng(0)
    for _ in range(200):
        r, p, y = rs.uniform(-1, 1), rs.uniform(-1, 1), rs.uniform(-3.1, 3.1)
        q = pose.euler_123_to_quat(r, p, y)
        assert q == jpose.euler_123_to_quat(r, p, y)
        assert pose.quat_to_euler_123(*q) == jpose.quat_to_euler_123(*q)
        vx, vy = rs.normal(size=2) * 5
        assert (pose.world_to_body_velocity(y, vx, vy)
                == jpose.world_to_body_velocity(y, vx, vy))
    a, b = pose.HeadingUnwrapper(), jpose.HeadingUnwrapper()
    for h in [3.0, 3.13, -3.13, -3.0, -3.13, 3.13, 3.0, -3.1, 3.1, 2.0]:
        assert a(h) == b(h)


# -- plant -------------------------------------------------------------------

def _plants(**kw):
    return (plant.BasePlant(dt=0.02, num_timesteps=10, **kw),
            jplant.BasePlant(dt=0.02, num_timesteps=10, **kw))


def _both(plants, method, *args):
    outs = [getattr(p, method)(*args) for p in plants]
    assert outs[0] == outs[1], (method, outs)
    return outs[0]


def test_plant_interpolation_feedback_and_clamps_equal_jax():
    plants = _plants(use_feedback_gains=True, throttle_max=0.5)
    T = 10
    ctrl = np.stack([np.linspace(0, 0.9, T), np.full(T, 0.45)], axis=1)
    states = np.zeros((T, 7))
    gains = np.zeros((T, 2, 7))
    gains[:, 0, 1] = -0.5                 # steer = -0.5 * y error
    gains[:, 1, 4] = 0.2                  # throttle = 0.2 * speed error
    _both(plants, "set_solution", states, ctrl, gains, 100.0, "actual")
    s = np.zeros(7)
    for k, (y, ux) in enumerate([(0.0, 0.0), (1.0, 0.0), (-3.0, 2.0),
                                 (0.5, 5.0)]):
        s[1], s[4] = y, ux
        out = _both(plants, "receive_state_vector", 100.0 + 0.013 * (k + 1),
                    s)
        assert -0.99 <= out[0] <= 0.99 and -0.99 <= out[1] <= 0.5
    assert out[1] == 0.5                   # the throttle clamp binds
    # feedforward alone: t = 0.03 -> lo = 1, alpha = 0.5
    plants = _plants(use_feedback_gains=False)
    _both(plants, "set_solution", states, ctrl, None, 100.0)
    out = _both(plants, "receive_state_vector", 100.03, np.zeros(7))
    np.testing.assert_allclose(out, (0.15, 0.45), atol=1e-6)


def test_plant_nan_runstop_stale_and_status_equal_jax():
    plants = _plants(use_feedback_gains=False)
    assert _both(plants, "check_status", 0.0) == 1       # not activated
    _both(plants, "set_solution", np.zeros((10, 7)),
          np.full((10, 2), np.nan), None, 100.0)
    assert _both(plants, "receive_state_vector", 100.02, np.zeros(7)) == (
        0.0, -0.99)
    assert all(p.shutdown for p in plants)
    plants = _plants(use_feedback_gains=False)
    for p in plants:
        p.set_runstop(True)
    _both(plants, "set_solution", np.zeros((10, 7)),
          np.tile([0.3, 0.6], (10, 1)), None, 100.0)
    assert _both(plants, "receive_state_vector", 100.02, np.zeros(7))[1] == 0
    # a pose beyond the horizon publishes nothing; a stale pose is status 2
    assert _both(plants, "receive_state_vector", 100.4, np.zeros(7)) is None
    assert _both(plants, "check_status", 100.45) == 0
    assert _both(plants, "check_status", 101.0) == 2
    assert _both(plants, "check_status_wall") == 0
    for p in plants:
        p.last_pose_mono -= 1.0
    assert _both(plants, "check_status_wall") == 2


def test_plant_pose_stream_drops_reset_and_diagnostic_equal_jax():
    plants = _plants(use_feedback_gains=False)
    q = pose.euler_123_to_quat(0.01, -0.02, 3.1)
    for t in [1.0, 1.02, 1.02, 1.01, 1.04]:        # a duplicate, a regress
        _both(plants, "receive_pose", t, 1.0, 2.0, 0.0, q, (1.0, 0.5, 0.0),
              0.3)
    for a, b in zip(*(p.get_state().__dict__.values() for p in plants)):
        assert a == b
    assert _both(plants, "pose_stream_diagnostic")["level"] == "warn"
    for t in [0.1, 0.2, 0.3]:                       # a restarted clock
        _both(plants, "receive_state_vector", t, np.zeros(7))
    assert _both(plants, "pose_stream_diagnostic")["level"] == "error"
    for p in plants:
        p.reset_pose_clock()
    assert _both(plants, "check_status", 0.0) == 1
    _both(plants, "receive_state_vector", 0.1, np.zeros(7))
    assert _both(plants, "pose_stream_diagnostic") == {
        "level": "ok", "message": "1 poses", "dropped": 0, "received": 1}


def test_plant_hot_update_queue_and_replay_equal_jax(tmp_path):
    plants = _plants()
    for p in plants:
        p.push_cost_params("cost")
        p.push_model_params("model")
        p.push_costmap("map")
    assert _both(plants, "take_updates") == ("cost", "map", "model")
    assert _both(plants, "take_updates") == (None, None, None)
    log = np.zeros((20, 8), dtype=np.float32)
    log[:, 0] = np.arange(20) * 0.02
    log[:, 1] = np.linspace(0, 5, 20)
    path = tmp_path / "poses.csv"
    np.savetxt(path, log, delimiter=",", header="t,x,y,yaw,roll,ux,uy,yd")
    ours = plant.ReplayPlant.from_csv(str(path), 0.02, 10)
    ref = jplant.ReplayPlant.from_csv(str(path), 0.02, 10)
    while ours.advance():
        assert ref.advance()
        assert vars(ours.get_state()) == vars(ref.get_state())
    assert ours.exhausted and ref.exhausted
    assert ours.get_state().x_pos == pytest.approx(5.0)


def _nn_pair(K=128, T=24, seed=0):
    cfg = MPPIConfig(num_rollouts=K, num_timesteps=T)
    jcfg = JaxConfig(num_rollouts=K, num_timesteps=T)
    jm = JaxNN(jcfg.dt, control_ranges=jcfg.control_ranges)
    jp = jm.init_params(jax.random.PRNGKey(seed))
    tm = NeuralNetDynamics(cfg.dt, control_ranges=cfg.control_ranges,
                           device="cpu")
    tp = tm.params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    return cfg, jcfg, jm, jp, tm, tp


def test_synthetic_plant_steps_like_jax():
    cfg, jcfg, jm, jp, tm, tp = _nn_pair()
    start = np.array([30.0, 0.0, math.pi / 2, 0.0, 2.0, 0.1, 0.0],
                     np.float32)
    ours = plant.SyntheticPlant(tm, tp, start, cfg.dt, 24)
    ref = jplant.SyntheticPlant(jm, jp, start, jcfg.dt, 24)
    for p in (ours, ref):
        p.receive_state_vector(0.0, start)
        p.set_solution(np.zeros((24, 7)), np.tile([0.2, 0.4], (24, 1)),
                       None, 0.0)
        p.step_sim(1)
        p.publish_control(p.sim_time, 0.2, 0.4)
        p.step_sim(5)
    np.testing.assert_allclose(ours.true_state, ref.true_state, rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(np.array(ours.published),
                               np.array(ref.published), rtol=1e-6, atol=1e-6)
    assert ours.sim_time == ref.sim_time


# -- telemetry ---------------------------------------------------------------

def test_telemetry_equals_jax():
    rs = np.random.default_rng(1)
    ours, ref = telemetry.TimingStats(window=8), jtele.TimingStats(window=8)
    for _ in range(20):
        v = rs.uniform(0, 30, 3)
        miss = int(rs.integers(0, 2))
        ours.update(*v, missed=miss)
        ref.update(*v, missed=miss)
    assert ours.as_dict() == ref.as_dict()
    assert ours.tick_percentile_ms(90) == ref.tick_percentile_ms(90)
    # the pathIntegralTiming wire message, byte for byte the JAX package's
    assert (msgs.encode(ours.as_msg(stamp=2.0))
            == jmsgs.encode(ref.as_msg(stamp=2.0)))
    mons = telemetry.StatusMonitor(), jtele.StatusMonitor()
    for now, beat in [(0.0, None), (1.0, (1.0, 0, "ok")), (1.2, None),
                      (1.3, (1.3, 2, "bad")), (2.0, None)]:
        for m in mons:
            if beat:
                m.heartbeat(*beat)
        assert mons[0].diagnostic(now) == mons[1].diagnostic(now)
    laps = (telemetry.LapStats(line=(0.0, 0.0, -2.0, 2.0)),
            jtele.LapStats(line=(0.0, 0.0, -2.0, 2.0)))
    recs = ([], [])
    for i in range(800):
        th = i * 0.0314
        for lap, rec in zip(laps, recs):
            r = lap.process_pose(i * 0.02, math.cos(th), math.sin(th),
                                 1.0 + 0.1 * math.sin(th), 0.2)
            if r:
                rec.append(r.__dict__)
    assert len(recs[0]) >= 2 and recs[0] == recs[1]


def test_stats_degenerate_equals_jax():
    rs = np.random.default_rng(2)
    for _ in range(300):
        args = (float(rs.uniform(0, 256)), float(rs.uniform(0.8, 1.0)), 256,
                0.9, 5.0,
                None if rs.random() < 0.3 else float(rs.uniform(0, 1.3)),
                0.65, float(rs.uniform(-4, 4)), 2.0)
        assert (controller.stats_degenerate(*args)
                == jcontroller.stats_degenerate(*args))


# -- the tube loop -----------------------------------------------------------

def _tube_pair(K=128, T=24, seed=0, costmap=None, degeneracy_guard=False,
               max_iter=10, desired_speed=5.0, noise_seed=11):
    """The same tube on both sides: two solvers with the same noise
    table, one DDP solver, a lockstep SyntheticPlant from the oval's start;
    returns {"port": (actual, predicted, plant, loop cfg, loop module),
    "jax": ...}."""
    cfg, jcfg, jm, jp, tm, tp = _nn_pair(K, T, seed)
    data, xb, yb = (oval_track(half_length=30.0, half_width=18.0,
                               track_width=6.0, ppm=4.0)
                    if costmap is None else costmap)
    cm, jcm = make_costmap(data, xb, yb, device="cpu"), jax_make_costmap(
        data, xb, yb)
    # Every solve takes the noise that its subkey picks from one table:
    # the port's key is split as the JAX package's, bit for bit, and the
    # host-noise generator is seeded with the subkey's words, so both
    # sides pick the same noise in every solve of either controller (the
    # JAX sampler runs inside jit, where the pick is an index of the key).
    table = np.random.default_rng(noise_seed).standard_normal(
        (NOISE_TABLE, T, K, 2)).astype(np.float32)
    solvers = [mppi.MPPISolver(tm, MPPICost(), cfg, device="cpu")
               for _ in range(2)]
    jsolvers = [jmppi.MPPISolver(jm, JaxCost(), jcfg) for _ in range(2)]
    jtable = jnp.asarray(table)
    for s, js in zip(solvers, jsolvers):
        s._sample_noise = lambda gen, shape: torch.tensor(
            table[(gen.initial_seed() & 0xFFFFFFFF) % NOISE_TABLE])
        js._sample_noise = lambda key, shape: jtable[key[1] % NOISE_TABLE]
    ddp, jddp = DDPSolver(tm, cfg.dt, T, device="cpu"), JaxDDP(jm, jcfg.dt, T)
    cp, jcp = (CostParams(desired_speed=desired_speed),
               JaxCostParams(desired_speed=desired_speed))
    out = {}
    for side, mods, s, p, c, m, d, model, dt in (
            ("port", (controller, plant, control_loop), solvers, tp, cp, cm,
             ddp, tm, cfg.dt),
            ("jax", (jcontroller, jplant, jloop), jsolvers, jp, jcp, jcm,
             jddp, jm, jcfg.dt)):
        ctl, pl, lp = mods
        actual = ctl.Controller(s[0], p, c, m, ddp=d)
        predicted = ctl.Controller(s[1], p, c, m, ddp=d, seed=77)
        syn = pl.SyntheticPlant(model, p, START, dt, T,
                                use_feedback_gains=True)
        syn.receive_state_vector(0.0, START)
        lcfg = lp.ControlLoopConfig(hz=50, num_timesteps=T,
                                    max_iter=max_iter,
                                    degeneracy_guard=degeneracy_guard)
        out[side] = (actual, predicted, syn, lcfg, lp)
    return out


def _run_tube(side):
    actual, predicted, syn, lcfg, lp = side
    ticks = []

    def on_tick(i, chosen, used, state):
        gains = chosen.get_feedback_gains()
        ticks.append(dict(used=used, gains=gains, state=np.array(state),
                          costs=(actual.get_computed_trajectory_cost(),
                                 predicted.get_computed_trajectory_cost()),
                          U=(actual.get_control_seq(),
                             predicted.get_control_seq())))

    timing = lp.run_control_loop(predicted, actual, syn, lcfg,
                                 on_tick=on_tick)
    return ticks, timing


def test_tube_loop_matches_jax():
    """Twelve ticks of the tube (K=128, T=24, DDP gains on) from rest: the
    same arbitration each tick (both outcomes, the resync included), with
    a clear margin between the two controllers' costs, the same plans,
    gains, published controls and plant states."""
    pair = _tube_pair(costmap=FLAT_MAP, max_iter=12)
    ours, timing = _run_tube(pair["port"])
    ref, jtiming = _run_tube(pair["jax"])
    assert [t["used"] for t in ours] == [t["used"] for t in ref]
    assert {t["used"] for t in ours} == {"actual", "predicted"}
    for k, (a, b) in enumerate(zip(ours, ref)):
        ca, cp = a["costs"]
        assert abs(ca - cp) > TIE_MARGIN * max(abs(ca), abs(cp)), k
        np.testing.assert_allclose(a["costs"], b["costs"], rtol=1e-5,
                                   err_msg=str(k))
        np.testing.assert_allclose(a["gains"], b["gains"], rtol=LOOP_RTOL,
                                   atol=LOOP_ATOL, err_msg=str(k))
        np.testing.assert_allclose(a["state"], b["state"], rtol=LOOP_RTOL,
                                   atol=LOOP_ATOL, err_msg=str(k))
        for u, ju in zip(a["U"], b["U"]):
            np.testing.assert_allclose(u, ju, rtol=LOOP_RTOL,
                                       atol=LOOP_ATOL, err_msg=str(k))
    pub = np.array(pair["port"][2].published)
    jpub = np.array(pair["jax"][2].published)
    assert pub.shape == jpub.shape == (12, 3)
    np.testing.assert_allclose(pub, jpub, rtol=LOOP_RTOL, atol=LOOP_ATOL)
    np.testing.assert_allclose(pair["port"][2].true_state,
                               pair["jax"][2].true_state, rtol=LOOP_RTOL,
                               atol=LOOP_ATOL)
    assert timing.num_iter == jtiming.num_iter == 12
    assert pair["port"][2].check_status(
        pair["port"][2].get_last_pose_time()) == 0


def test_degeneracy_guard_brakes_like_jax():
    """A map with no track: every rollout crashes, the softmax goes flat
    and the guard publishes brake throttles without gains, on both
    sides."""
    bad = np.full((64, 64, 4), 5.0, dtype=np.float32)
    bad[..., 1:] = 0.0
    pair = _tube_pair(K=64, T=16, costmap=(bad, (-40.0, 40.0), (-40.0, 40.0)),
                      degeneracy_guard=True, max_iter=5)
    for side in pair.values():
        side[2].true_state[4] = 3.0                 # moving, over the gate
        side[2].receive_state_vector(0.01, side[2].true_state)
    ours, timing = _run_tube(pair["port"])
    ref, jtiming = _run_tube(pair["jax"])
    assert timing.degenerate_ticks == jtiming.degenerate_ticks == 5
    port_plant, jax_plant = pair["port"][2], pair["jax"][2]
    assert port_plant.feedback_gains is None and jax_plant.feedback_gains is None
    pub, jpub = np.array(port_plant.published), np.array(jax_plant.published)
    assert (pub[:, 2] <= 0).all()
    # every rollout crashed: costs near 1e4 agree to ~1e-7 relative, 1e-3
    # absolute, which the softmax turns into ~1.5e-4 of each weight of a
    # plan that averages the noise
    np.testing.assert_allclose(pub, jpub, rtol=1e-3, atol=1e-5)


def test_resync_leaves_the_controllers_sharing_no_storage():
    """After the resync (the predicted controller takes the actual one's
    sequences), a slide and a solve of one controller leave the other's
    sequences as they were."""
    pair = _tube_pair(max_iter=1)
    actual, predicted = pair["port"][0], pair["port"][1]
    actual.compute_control(START)
    predicted.set_state_sequence(actual.get_state_seq())
    predicted.set_control_sequence(actual.get_control_seq())
    keep = {n: t.clone() for n, t in actual.cs._asdict().items()
            if torch.is_tensor(t)}
    seen = (predicted.get_state_seq(), predicted.get_control_seq())
    predicted.slide_control_and_state_seq(3)
    predicted.compute_control_predicted()
    predicted.set_state(np.full(7, 9.0, np.float32))
    for n, t in keep.items():
        assert torch.equal(getattr(actual.cs, n), t), n
    # and the other way round; the accessors' copies stay as read
    keep = {n: t.clone() for n, t in predicted.cs._asdict().items()
            if torch.is_tensor(t)}
    actual.slide_control_and_state_seq(2)
    actual.compute_control(START)
    for n, t in keep.items():
        assert torch.equal(getattr(predicted.cs, n), t), n
    got = predicted.get_state_seq()
    got[:] = 0.0
    assert not np.array_equal(predicted.get_state_seq(), got)
    assert not np.array_equal(seen[0], predicted.get_state_seq())


def _scaled(tm, tp, f):
    """``tp``'s weights times ``f`` through ``update_model``'s flat
    buffer."""
    flat = np.concatenate([w.t().reshape(-1).numpy() for w in tp["weights"]]
                          + [b.numpy() for b in tp["biases"]])
    return tm.update_model(tp, tm.layers, f * flat)


def test_model_push_reaches_the_next_solve_and_gains():
    """A weight push in the middle of the tube: the next tick's solve and
    gains are a fresh solver's and DDP's on the new weights, not the old
    weights'."""
    pair = _tube_pair(max_iter=6)
    actual, predicted, syn, lcfg, lp = pair["port"]
    tm, old = actual.model, actual.model_params
    new = _scaled(tm, old, 1.1)
    seen = {}
    rollout_costs, run = actual.solver.rollout_costs, actual.ddp.run

    def rec_rollouts(*a, **kw):
        seen.setdefault("rollouts", (a, kw, rollout_costs(*a, **kw)))
        return seen["rollouts"][2]

    def rec_ddp(*a, **kw):
        seen.setdefault("ddp", (a, run(*a, **kw)))
        return seen["ddp"][1]

    def on_tick(i, chosen, used, state):
        seen.clear()
        if i == 3:
            syn.push_model_params(new)
            actual.solver.rollout_costs = rec_rollouts
            actual.ddp.run = rec_ddp
        elif i == 4:
            seen["done"] = True
            actual.solver.rollout_costs = rollout_costs
            actual.ddp.run = run

    got = {}

    def hook(i, chosen, used, state):
        if i == 4:
            got.update(seen)
        on_tick(i, chosen, used, state)

    lp.run_control_loop(predicted, actual, syn, lcfg, on_tick=hook)
    assert actual.model_params is new and predicted.model_params is new
    a, kw, out = got["rollouts"]
    assert a[0] is new
    fresh_model = NeuralNetDynamics(tm.dt, device="cpu")
    fresh_params = fresh_model.params_from_jax(
        {"weights": [w.numpy() for w in new["weights"]],
         "biases": [b.numpy() for b in new["biases"]],
         "control_rngs": new["control_rngs"].numpy()})
    fresh = mppi.MPPISolver(fresh_model, MPPICost(), actual.cfg,
                            device="cpu").rollout_costs(fresh_params,
                                                        *a[1:], **kw)
    stale = rollout_costs(old, *a[1:], **kw)
    assert torch.equal(out[0], fresh[0])
    assert not torch.equal(out[0], stale[0])
    da, dout = got["ddp"]
    fresh_ddp = DDPSolver(fresh_model, tm.dt, actual.ddp.T,
                          device="cpu").run(fresh_params, *da[1:])
    stale_ddp = run(old, *da[1:])
    assert torch.equal(dout.feedback_gain, fresh_ddp.feedback_gain)
    assert not torch.equal(dout.feedback_gain, stale_ddp.feedback_gain)


def test_controller_hot_updates_and_cut_throttle():
    pair = _tube_pair(max_iter=1)
    actual = pair["port"][0]
    jactual = pair["jax"][0]
    for c in (actual, jactual):
        c.compute_control(START)
        c.cut_throttle()
    assert actual.cost_params.desired_speed == 0.0
    assert float(actual.model_params["control_rngs"][1, 1]) == 0.0
    np.testing.assert_array_equal(
        actual.model_params["control_rngs"].numpy(),
        np.asarray(jactual.model_params["control_rngs"]))
    actual.compute_control(START)
    actual.compute_feedback_gains(START)
    assert (actual.get_control_seq()[:, 1] <= 0).all()
    assert (actual.ddp_result.control_traj[:, 1] <= 0).all()
    # plan_degenerate and the footprint cost against the JAX controller
    for c in (actual, jactual):
        c.compute_control(START)
    assert actual.plan_degenerate() == jactual.plan_degenerate()
    for s in (START, np.array([0, 0, 0.3, 0, 3, 0, 0], np.float32),
              np.array([np.nan, 1, 0, 0, 3, 0, 0], np.float32)):
        assert actual.position_track_cost(s) == jactual.position_track_cost(s)
    new_map = make_costmap(*oval_track(ppm=2.0), device="cpu")
    actual.update_costmap(new_map)
    assert actual.costmap is new_map


def test_runtime_defaults_to_cuda_and_raises_without_gpu(monkeypatch):
    pair = _tube_pair(max_iter=1)
    actual = pair["port"][0]
    tm = actual.model
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no GPU"):
        run_tube_mppi.build(ticks=1, rollouts=64, timesteps=8)
    actual.solver.device = torch.device("cuda", 0)
    with pytest.raises(RuntimeError, match="no GPU"):
        controller.Controller(actual.solver, actual.model_params,
                              actual.cost_params, actual.costmap)
    tm.device = torch.device("cuda", 0)
    with pytest.raises(RuntimeError, match="no GPU"):
        plant.SyntheticPlant(tm, actual.model_params, START, 0.02, 8)


def test_run_tube_mppi_on_the_cpu(capsys):
    run_tube_mppi.main(["--cpu", "--ticks", "3", "--rollouts", "64",
                        "--timesteps", "16", "--pred-rollouts", "32",
                        "--degeneracy-guard"])
    out = capsys.readouterr().out
    for line in ("3 ticks in", "controller usage: {", "timing: avg tick",
                 "(budget 20 ms)", "laps: 0  controls published: 3",
                 "final state: pos=("):
        assert line in out, line
    tube = run_tube_mppi.build(ticks=2, rollouts=64, timesteps=16,
                               model="bf", device="cpu")
    res = run_tube_mppi.drive(tube, log=lambda m: None)
    assert res["timing"].num_iter == 2 and tube.predicted.ddp is tube.actual.ddp
    assert sum(res["used"].values()) == 2


def test_run_tube_mppi_ess_target_moves_gamma(capsys):
    """``--ess-target`` drives the loop through ``EssTuner.attach``: 20
    ticks on the CPU, and gamma ends off its start."""
    run_tube_mppi.main(["--cpu", "--ticks", "20", "--rollouts", "64",
                        "--timesteps", "16", "--ess-target", "0.25"])
    out = capsys.readouterr().out
    assert "20 ticks in" in out and "controls published: 20" in out
    line = next(l for l in out.splitlines() if l.startswith("ess tuner:"))
    assert "target ESS 16," in line
    start, end = (float(v) for v in line.split("gamma ")[1].split(" -> "))
    assert start == 0.15 and end != start


# -- the operator's options (telemetry, runstop, log, camera) -----------------

SMALL = ["--cpu", "--rollouts", "64", "--timesteps", "16"]
SOLVE_KEYS = {"t", "kind", "tick", "x", "y", "speed", "used", "ess", "gamma",
              "crash_pct", "traj_cost"}


def _wait_for(pred, what, timeout=5.0):
    deadline = time.time() + timeout
    while not pred():
        assert time.time() < deadline, what
        time.sleep(0.005)


def _log_records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_run_tube_mppi_telemetry_port_feeds_the_console(capsys):
    """``--telemetry-port`` sends every record as a JSON datagram to
    127.0.0.1: four ticks give the run header, four solves, the first 1 Hz
    timing, diagnostics and host status (the CPU's here) and the final
    timing."""
    rx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    rx.bind(("127.0.0.1", 0))
    recs = []
    try:
        run_tube_mppi.main(SMALL + ["--ticks", "4", "--telemetry-port",
                                    str(rx.getsockname()[1])])
        rx.settimeout(0.5)
        while True:
            try:
                recs.append(json.loads(rx.recv(1 << 20).decode()))
            except socket.timeout:
                break
    finally:
        rx.close()
    kinds = [r["kind"] for r in recs]
    assert kinds[0] == "run" and kinds[-1] == "timing"
    assert kinds.count("solve") == 4
    assert {"timing", "diag", "system"} <= set(kinds)
    system = next(r for r in recs if r["kind"] == "system")
    assert system["accelerator"]["platform"] == "cpu"
    assert "controls published: 4" in capsys.readouterr().out


def test_run_tube_mppi_runstop_port_stops_the_throttle(monkeypatch, capsys):
    """``--runstop-port 0`` listens on a free port (printed): a runstop
    datagram at tick 2, held at ticks 3 and 4, engages the plant's runstop
    for the controls it publishes after each of those ticks, each the
    requested throttle cut to at most 0, and its sender's release at tick 5
    lets the requested throttle through again."""
    tubes, pubs = [], []
    build, on_tick = run_tube_mppi.build, run_tube_mppi.OperatorIO.on_tick
    publish = plant.BasePlant.publish_control
    monkeypatch.setattr(run_tube_mppi, "build",
                        lambda **kw: tubes.append(build(**kw)) or tubes[0])

    def recorded(self, t, steering, throttle):
        out = publish(self, t, steering, throttle)
        pubs.append((self.runstop, throttle, out[1]))
        return out

    def operator_tick(self, i, chosen, used, state, lap=None):
        on_tick(self, i, chosen, used, state, lap)
        syn = self.tube.plant
        if 2 <= i < 5:
            send_runstop(self.runstop.port, "ocs", False)
            _wait_for(lambda: syn.runstop, "runstop not applied")
        elif i == 5:
            send_runstop(self.runstop.port, "ocs", True)
            _wait_for(lambda: not syn.runstop, "runstop not released")

    monkeypatch.setattr(plant.BasePlant, "publish_control", recorded)
    monkeypatch.setattr(run_tube_mppi.OperatorIO, "on_tick", operator_tick)
    run_tube_mppi.main(SMALL + ["--ticks", "10", "--runstop-port", "0"])
    assert "runstop: listening on UDP port" in capsys.readouterr().out
    assert len(pubs) == len(tubes[0].plant.published) == 10
    for k, (engaged, asked, published) in enumerate(pubs):
        assert engaged == (1 <= k < 4), k
        assert published == (min(asked, 0.0) if engaged else asked), k


def test_run_tube_mppi_log_appends_the_run_log(tmp_path, capsys):
    """``--log`` appends every record to a JSONL run log: the run header,
    one solve a tick with the JAX example's keys, the 1 Hz records and the
    final timing; a second run appends to the same file."""
    path = str(tmp_path / "run.jsonl")
    run_tube_mppi.main(SMALL + ["--ticks", "5", "--log", path])
    recs = _log_records(path)
    assert recs[0]["kind"] == "run" and recs[0]["num_rollouts"] == 64
    assert recs[0]["num_timesteps"] == 16 and recs[0]["hz"] == 50
    solves = [r for r in recs if r["kind"] == "solve"]
    assert [r["tick"] for r in solves] == [1, 2, 3, 4, 5]
    assert all(set(r) == SOLVE_KEYS for r in solves)
    assert all(r["gamma"] == 0.15 and r["ess"] > 0 for r in solves)
    assert recs[-1]["kind"] == "timing" and recs[-1]["budget_ms"] == 20.0
    assert {"diag", "system"} <= {r["kind"] for r in recs}
    run_tube_mppi.main(SMALL + ["--ticks", "2", "--log", path])
    assert [r["kind"] for r in _log_records(path)].count("run") == 2


@pytest.mark.parametrize("loop", [[], ["--async-loop", "--depth", "2"]],
                         ids=["sync", "async"])
def test_run_tube_mppi_camera_republishes_frames(loop, tmp_path, capsys):
    """``--camera`` renders the car's view every tick, runs the exposure
    loop on it and republishes five frames a second of the plant's clock
    (30 ticks, 0.6 s: three frames) with the console's ASCII view, from
    the sync loop and, through ``_Shim``, the async one."""
    path = str(tmp_path / "run.jsonl")
    run_tube_mppi.main(SMALL + ["--ticks", "30", "--log", path, "--camera"]
                       + loop)
    images = [r for r in _log_records(path) if r["kind"] == "image"]
    assert len(images) == 3
    for r in images:
        assert set(r) == {"t", "kind", "ascii", "msv", "shutter", "gain"}
        assert len(r["ascii"]) == 14 and {len(row) for row in r["ascii"]} \
            == {48}
    # the exposure loop moved the shutter off its minimum
    assert images[-1]["shutter"] > 100.0


def test_run_tube_mppi_async_loop_on_the_cpu(capsys):
    """``--async-loop --depth 2`` drives the async tube in lockstep (the
    first two ticks publish nothing yet), with ``--ess-target`` through
    ``EssTuner.attach_async``."""
    run_tube_mppi.main(["--cpu", "--ticks", "6", "--rollouts", "64",
                        "--timesteps", "16", "--async-loop", "--depth", "2",
                        "--ess-target", "0.25"])
    out = capsys.readouterr().out
    assert "6 ticks in" in out and "(async loop, depth 2)" in out
    assert "controls published: 4" in out
    line = next(l for l in out.splitlines() if l.startswith("ess tuner:"))
    start, end = (float(v) for v in line.split("gamma ")[1].split(" -> "))
    assert start == 0.15 and end != start
    usage = out.split("controller usage: ")[1].splitlines()[0]
    assert sum(eval(usage).values()) == 6


def test_sequential_loop_paces_with_the_native_pacer(monkeypatch):
    """The realtime loop paces with the native absolute-deadline pacer and
    says so (``TimingStats.pacer``); lockstep says lockstep; a realtime
    loop whose pacer cannot load raises instead of sleeping."""
    from autorally_tpu_torch.runtime import native

    pair = _tube_pair(max_iter=3)
    actual, predicted, syn, lcfg, lp = pair["port"]
    timing = lp.run_control_loop(predicted, actual, syn, lcfg)
    assert timing.pacer == "lockstep"
    lcfg.realtime = True
    t0 = time.perf_counter()
    timing = lp.run_control_loop(predicted, actual, syn, lcfg)
    assert timing.pacer == "native" and timing.num_iter == 3
    assert time.perf_counter() - t0 >= 3 * 0.02 * 0.9
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "SO_PATH", native.BUILD_DIR / "absent.so")
    monkeypatch.setattr(native, "SOURCE", native.BUILD_DIR / "absent.cpp")
    with pytest.raises(RuntimeError, match="absent.cpp"):
        lp.run_control_loop(predicted, actual, syn, lcfg)
