"""The port's async-dispatch tube loop (``runtime/async_loop.py``) against
the JAX package on the CPU, and the twins of ``tests/test_async_loop.py``
with seeded weights (``init_params(0)``) in place of the reference
``.npz``.

On the CPU the port's tick runs eagerly; the device-side slide it takes on
the card (``MPPISolver._slide_device``) is held bit for bit against
``_slide`` for every stride.  Each solve takes the noise that its subkey
picks from one table on both sides (as ``tests/test_torch_runtime.py``
injects it), a table of its own for each solver of an asymmetric tube."""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autorally_tpu.config import CostParams as JaxCostParams
from autorally_tpu.config import MPPIConfig as JaxConfig
from autorally_tpu.costs import MPPICost as JaxCost
from autorally_tpu.costs.costmap import make_costmap as jax_make_costmap
from autorally_tpu.models import NeuralNetDynamics as JaxNN
from autorally_tpu.runtime import async_loop as jasync
from autorally_tpu.runtime import plant as jplant
from autorally_tpu.solver import mppi as jmppi
from autorally_tpu.tools.track_generator import oval_track
from autorally_tpu_torch.config import CostParams, MPPIConfig
from autorally_tpu_torch.costs import MPPICost, make_costmap
from autorally_tpu_torch.models import NeuralNetDynamics
from autorally_tpu_torch.runtime import async_loop
from autorally_tpu_torch.runtime.async_loop import (AsyncLoopConfig,
                                                    AsyncTubeController,
                                                    TubeTickOutput,
                                                    run_control_loop_async)
from autorally_tpu_torch.runtime.plant import BasePlant, SyntheticPlant
from autorally_tpu_torch.solver.mppi import MPPISolver

START = np.array([30.0, 0.0, np.pi / 2, 0.0, 2.0, 0.0, 0.0],
                 dtype=np.float32)
# The async tick against the JAX one, twelve lockstep ticks on a map of
# one cost everywhere: as tests/test_torch_runtime.py's tube loop, every
# solve agrees to ~1e-6 relative and the plant integrates the published
# control, so the two loops stay within these of each other.
LOOP_RTOL, LOOP_ATOL = 1e-4, 1e-6
NOISE_TABLE = 16
FLAT = np.zeros((60, 80, 4), np.float32)
FLAT[..., 0] = 0.1                     # under the 0.65 boundary: no crash
FLAT_MAP = (FLAT, (-40.0, 40.0), (-30.0, 30.0))


def _build(use_feedback_gains=False, K=64, T=16, K_pred=None):
    """The tube of tests/test_async_loop.py on the port, seeded weights."""
    cfg = MPPIConfig(num_rollouts=K, num_timesteps=T, hz=50)
    data, xb, yb = oval_track(half_length=30.0, half_width=18.0,
                              track_width=8.0, ppm=2.0)
    cm = make_costmap(data, xb, yb, device="cpu")
    model = NeuralNetDynamics(cfg.dt, control_ranges=cfg.control_ranges,
                              device="cpu")
    params = model.init_params(0)
    solver = MPPISolver(model, MPPICost(), cfg, device="cpu")
    solver_pred = (None if K_pred is None else
                   solver.with_rollouts(K_pred))
    tube = AsyncTubeController(solver, params, CostParams(desired_speed=4.0),
                               cm, use_feedback_gains=use_feedback_gains,
                               solver_predicted=solver_pred)
    plant = SyntheticPlant(model, params, START, cfg.dt, cfg.num_timesteps,
                           use_feedback_gains=use_feedback_gains)
    plant.receive_state_vector(0.0, START)
    return tube, plant, cfg


def _lockstep(depth, max_iter, **kw):
    return AsyncLoopConfig(hz=50, num_timesteps=16, depth=depth,
                           realtime=False, max_iter=max_iter, **kw)


# -- against the JAX package -------------------------------------------------

def _jax_pair(gains: bool, K_pred, K=128, T=16):
    """The same async tube on both sides, from rest on the flat map: the
    port's and the JAX package's (tube, plant)."""
    cfg = MPPIConfig(num_rollouts=K, num_timesteps=T)
    jcfg = JaxConfig(num_rollouts=K, num_timesteps=T)
    jm = JaxNN(jcfg.dt, control_ranges=jcfg.control_ranges)
    jp = jm.init_params(jax.random.PRNGKey(0))
    tm = NeuralNetDynamics(cfg.dt, control_ranges=cfg.control_ranges,
                           device="cpu")
    tp = tm.params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    cm = make_costmap(*FLAT_MAP, device="cpu")
    jcm = jax_make_costmap(*FLAT_MAP)
    solvers = [MPPISolver(tm, MPPICost(), cfg, device="cpu")]
    jsolvers = [jmppi.MPPISolver(jm, JaxCost(), jcfg)]
    if K_pred is not None:
        solvers.append(solvers[0].with_rollouts(K_pred))
        jsolvers.append(jmppi.MPPISolver(
            jm, JaxCost(), jcfg.replace(num_rollouts=K_pred)))
    for n, (s, js) in enumerate(zip(solvers, jsolvers)):
        table = np.random.default_rng(11 + n).standard_normal(
            (NOISE_TABLE, T, s.cfg.num_rollouts, 2)).astype(np.float32)
        jtable = jnp.asarray(table)
        s._sample_noise = lambda gen, shape, table=table: torch.tensor(
            table[(gen.initial_seed() & 0xFFFFFFFF) % NOISE_TABLE])
        js._sample_noise = (lambda key, shape, jtable=jtable:
                            jtable[key[1] % NOISE_TABLE])
    start = START.copy()
    start[4] = 0.0
    out = {}
    for side, mod, pl, ss, p, c, m, model, cp in (
            ("port", async_loop, SyntheticPlant, solvers, tp, cm, None, tm,
             CostParams(desired_speed=5.0)),
            ("jax", jasync, jplant.SyntheticPlant, jsolvers, jp, jcm, None,
             jm, JaxCostParams(desired_speed=5.0))):
        tube = mod.AsyncTubeController(
            ss[0], p, cp, c, use_feedback_gains=gains,
            solver_predicted=ss[1] if len(ss) > 1 else None)
        syn = pl(model, p, start, cfg.dt, T, use_feedback_gains=gains)
        syn.receive_state_vector(0.0, start)
        out[side] = (mod, tube, syn)
    return out, T


def _drive(side, T, ticks=12):
    mod, tube, syn = side
    outs = []

    def on_tick(i, used, state, out, harvest_ms, age_s):
        outs.append((used, out, np.array(state)))

    lcfg = mod.AsyncLoopConfig(hz=50, num_timesteps=T, depth=1,
                               realtime=False, max_iter=ticks)
    timing = mod.run_control_loop_async(tube, syn, lcfg, on_tick=on_tick)
    return outs, timing


@pytest.mark.parametrize("gains,K_pred", [(True, None), (False, None),
                                          (True, 64), (False, 64)],
                         ids=["gains", "no_gains", "asymmetric_gains",
                              "asymmetric"])
def test_dispatch_matches_jax(gains, K_pred):
    """Twelve lockstep ticks of the async tube (K=128, T=16) from rest:
    each harvested tick's arbitration, plans, gains, stats and footprint
    cost, the published controls and the plant's states, as the JAX
    tube's."""
    pair, T = _jax_pair(gains, K_pred)
    ours, timing = _drive(pair["port"], T)
    ref, jtiming = _drive(pair["jax"], T)
    assert timing.num_iter == jtiming.num_iter == 12
    assert len(ours) == len(ref) == 12
    assert [u for u, _, _ in ours] == [u for u, _, _ in ref]
    assert {u for u, _, _ in ours} == {"actual", "predicted"}
    for k, ((_, a, sa), (_, b, sb)) in enumerate(zip(ours, ref)):
        for name in TubeTickOutput._fields:
            x, y = getattr(a, name), getattr(b, name)
            if y is None:
                assert x is None, name
                continue
            np.testing.assert_allclose(
                np.asarray(x, np.float64), np.asarray(y, np.float64),
                rtol=LOOP_RTOL, atol=LOOP_ATOL, err_msg=f"{k} {name}")
        np.testing.assert_allclose(sa, sb, rtol=LOOP_RTOL, atol=LOOP_ATOL)
    pub = np.array(pair["port"][2].published)
    jpub = np.array(pair["jax"][2].published)
    assert pub.shape == jpub.shape and len(pub) >= 11
    np.testing.assert_allclose(pub, jpub, rtol=LOOP_RTOL, atol=LOOP_ATOL)
    np.testing.assert_allclose(pair["port"][2].true_state,
                               pair["jax"][2].true_state, rtol=LOOP_RTOL,
                               atol=LOOP_ATOL)
    # the resynced predicted controller's plan, as JAX's
    for f in ("U", "control_solution", "state_solution"):
        np.testing.assert_allclose(
            getattr(pair["port"][1].cs_p, f).numpy(),
            np.asarray(getattr(pair["jax"][1].cs_p, f)), rtol=LOOP_RTOL,
            atol=LOOP_ATOL, err_msg=f)
    assert np.array_equal(pair["port"][1].cs_a.key,
                          np.asarray(pair["jax"][1].cs_a.key))


def test_device_slide_is_slide_for_every_stride():
    tube, _, cfg = _build(T=16)
    s = tube.solver
    gen = torch.Generator().manual_seed(3)
    T = cfg.num_timesteps
    cs = s.init_state(0)._replace(
        U=torch.randn(T, 2, generator=gen),
        control_hist=torch.randn(2, 2, generator=gen),
        state_solution=torch.randn(T, 7, generator=gen))
    for stride in range(T):
        a = s._slide(cs, stride)
        b = s._slide_device(cs, torch.tensor(stride))
        for f in ("U", "control_hist", "state_solution"):
            assert torch.equal(getattr(a, f), getattr(b, f)), (stride, f)


# -- the twins of tests/test_async_loop.py -----------------------------------

@pytest.mark.parametrize("depth", [1, 2])
def test_lockstep_drives_the_plant(depth):
    """The seeded MLP drives (the reference weights' bounds, 1.5-5 m/s,
    belong to those weights): the car moves and speeds up from 2 m/s."""
    tube, plant, cfg = _build()
    timing = run_control_loop_async(tube, plant, _lockstep(depth, 40))
    assert timing.num_iter == 40 and timing.pacer == "lockstep"
    assert not plant.shutdown
    assert 2.0 < float(plant.true_state[4]) < 5.0
    progress = np.hypot(float(plant.true_state[0]) - START[0],
                        float(plant.true_state[1]) - START[1])
    assert progress > 1.5         # 40 ticks of 0.02 s at over 2 m/s
    assert plant.solution_received
    assert np.isfinite(plant.control_sequence).all()


def test_asymmetric_tube_drives_and_resyncs():
    """The predicted half at K=32 beside K=64: the loop drives, and after
    the last tick the predicted controller holds the published plan (its
    own when it won, the actual one's by the resync when that won).  Both
    outcomes of the arbitration are held against JAX by
    test_dispatch_matches_jax; on the oval the seeded weights' predicted
    controller wins every tick."""
    tube, plant, cfg = _build(K=64, K_pred=32)
    assert tube.solver_predicted is not tube.solver
    assert tube.solver_predicted.cfg.num_rollouts == 32
    outs = []
    timing = run_control_loop_async(
        tube, plant, _lockstep(1, 60),
        on_tick=lambda i, who, state, out, *a: outs.append(out))
    assert timing.num_iter == 60 and not plant.shutdown
    assert 2.0 < float(plant.true_state[4]) < 5.0
    assert np.isfinite(plant.control_sequence).all()
    np.testing.assert_array_equal(tube.cs_p.control_solution.numpy(),
                                  outs[-1].control_solution)
    np.testing.assert_array_equal(tube.cs_p.state_solution.numpy(),
                                  outs[-1].state_solution)


def test_asymmetric_tube_rejects_mismatched_configs():
    tube, _, cfg = _build()
    solver, params, cm = tube.solver, tube.model_params, tube.costmap
    bad = MPPISolver(solver.model, MPPICost(),
                     cfg.replace(num_rollouts=32, num_timesteps=8),
                     device="cpu")
    with pytest.raises(ValueError, match="horizon"):
        AsyncTubeController(solver, params, CostParams(), cm,
                            solver_predicted=bad)
    hot = MPPISolver(solver.model, MPPICost(),
                     cfg.replace(num_rollouts=32, gamma=0.5), device="cpu")
    with pytest.raises(ValueError, match="gamma"):
        AsyncTubeController(solver, params, CostParams(), cm,
                            solver_predicted=hot)


def test_publication_lags_by_depth():
    tube, plant, cfg = _build()
    ages = []
    run_control_loop_async(
        tube, plant, _lockstep(2, 24),
        on_tick=lambda i, used, state, out, h, age: ages.append((i, age)))
    assert ages[0][0] == 3          # depth 2: the first harvest at tick 3
    steady = [a for _, a in ages[5:]]
    assert np.median(steady) == pytest.approx(2 * cfg.dt, abs=cfg.dt / 2)


def test_hot_updates_ride_next_dispatch():
    """A cost push at tick 10 is consumed into the tube and changes the
    very next dispatch's solution (against the same run without it)."""
    runs = []
    for push in (False, True):
        tube, plant, cfg = _build()
        outs = []

        def on_tick(num_iter, used, state, out, harvest_ms, age_s):
            outs.append(out.control_solution.copy())
            if push and num_iter == 10:
                plant.push_cost_params(CostParams(desired_speed=1.0))

        run_control_loop_async(tube, plant, _lockstep(1, 16),
                               on_tick=on_tick)
        runs.append((tube, outs))
    (t0, o0), (t1, o1) = runs
    assert float(t0.cost_params.desired_speed) == 4.0
    assert float(t1.cost_params.desired_speed) == 1.0
    # harvests 1-10 were dispatched before the push, 11 on after it
    for k in range(10):
        np.testing.assert_array_equal(o0[k], o1[k])
    assert not np.array_equal(o0[10], o1[10])


def test_feedback_gains_published():
    tube, plant, cfg = _build(use_feedback_gains=True)
    run_control_loop_async(tube, plant, _lockstep(1, 12))
    assert plant.feedback_gains is not None
    assert plant.feedback_gains.shape == (cfg.num_timesteps, 2, 7)
    assert np.isfinite(plant.feedback_gains).all()


def test_tube_checkpoint_resume_identical_next_tick(tmp_path):
    """Both controllers' states through the checkpoint into a FRESH tube:
    its next dispatch is the original's, bit for bit."""
    from autorally_tpu_torch.io.checkpoint import (load_tube_state,
                                                   save_tube_state)

    tube, plant, cfg = _build()
    run_control_loop_async(tube, plant, _lockstep(1, 12))
    path = str(tmp_path / "tube.npz")
    save_tube_state(tube, path)
    state = plant.get_state().to_vector()
    out1 = tube.dispatch(state, 1).result()
    tube2, _, _ = _build()
    tube2.cs_a, tube2.cs_p = load_tube_state(path, device="cpu")
    out2 = tube2.dispatch(state, 1).result()
    for leaf1, leaf2 in zip(out1, out2):
        if leaf1 is None:
            assert leaf2 is None
        else:
            np.testing.assert_array_equal(leaf1, leaf2)


class _SlowLeaf:
    """Device-array stand-in whose host copy 'lands' at a fixed wall time:
    a dispatch -> ready latency without a device."""

    def __init__(self, value, ready_t):
        self._v = np.asarray(value)
        self._ready = ready_t

    def __array__(self, dtype=None, copy=None):
        now = time.perf_counter()
        if now < self._ready:
            time.sleep(self._ready - now)
        v = self._v if dtype is None else self._v.astype(dtype)
        return np.array(v) if copy else v


class _FakeTube:
    """AsyncTubeController duck type with a configurable solve latency."""

    use_feedback_gains = False

    def __init__(self, T, latency_s):
        self.T = T
        self.latency_s = latency_s

    def reset(self, state):
        pass

    def update_cost_params(self, cp):
        pass

    def update_costmap(self, cm):
        pass

    def update_model_params(self, mp):
        pass

    def dispatch(self, state, stride):
        ready = time.perf_counter() + self.latency_s
        leaf = lambda v: _SlowLeaf(v, ready)
        return TubeTickOutput(
            control_solution=leaf(np.zeros((self.T, 2), np.float32)),
            state_solution=leaf(np.zeros((self.T, 7), np.float32)),
            feedback_gains=None,
            use_actual=leaf(np.bool_(True)),
            trajectory_cost=leaf(np.float32(1.0)),
            ess=leaf(np.float32(32.0)),
            crash_frac=leaf(np.float32(0.0)))


def _fake_rig(latency_s, T=16, dt=0.005):
    tube = _FakeTube(T, latency_s)
    plant = BasePlant(dt=dt, num_timesteps=T, use_feedback_gains=False)
    plant.receive_state_vector(0.0, np.zeros(7, np.float32))
    return tube, plant


def _degenerate_outputs(tube_cls):
    class _Tube(tube_cls):
        def dispatch(self, state, stride):
            out = super().dispatch(state, stride)
            return out._replace(
                control_solution=np.full((self.T, 2), 0.5, np.float32),
                ess=np.float32(60.0), crash_frac=np.float32(1.0))
    return _Tube


def _moving_plant():
    plant = BasePlant(dt=0.01, num_timesteps=16, use_feedback_gains=False)
    moving = np.zeros(7, np.float32)
    moving[4] = 5.0                 # over the speed gate
    plant.receive_state_vector(0.0, moving)
    return plant


def test_async_guard_skips_duck_tube_without_solver():
    tube = _degenerate_outputs(_FakeTube)(16, latency_s=0.0005)
    plant = _moving_plant()
    timing = run_control_loop_async(
        tube, plant, AsyncLoopConfig(hz=100, num_timesteps=16, depth=1,
                                     realtime=True, max_iter=15,
                                     degeneracy_guard=True))
    assert timing.degenerate_ticks == 0         # skipped, not crashed
    assert plant.solution_received and timing.pacer == "native"


def test_adaptive_depth_grows_to_cover_latency():
    tube, plant = _fake_rig(latency_s=0.035)
    lcfg = AsyncLoopConfig(hz=100, num_timesteps=16, depth=1,
                           realtime=True, adaptive_depth=True,
                           max_depth=6, max_iter=200, carry_learned=True)
    timing = run_control_loop_async(tube, plant, lcfg)
    assert 3 <= timing.async_depth_final <= 4
    assert timing.async_depth_max == timing.async_depth_final
    tail = list(timing.harvest_samples_ms)[-50:]
    assert np.median(tail) < 2.5
    assert lcfg.depth == timing.async_depth_final
    assert lcfg.shrink_floor == timing.async_depth_final


def test_adaptive_depth_default_does_not_mutate_config():
    tube, plant = _fake_rig(latency_s=0.035)
    lcfg = AsyncLoopConfig(hz=100, num_timesteps=16, depth=1,
                           realtime=True, adaptive_depth=True,
                           max_depth=6, max_iter=200)
    timing = run_control_loop_async(tube, plant, lcfg)
    assert timing.async_depth_final > 1
    assert lcfg.depth == 1 and lcfg.shrink_floor == 1


def test_adaptive_depth_respects_max_depth():
    tube, plant = _fake_rig(latency_s=0.045)
    lcfg = AsyncLoopConfig(hz=100, num_timesteps=16, depth=1,
                           realtime=True, adaptive_depth=True,
                           max_depth=2, max_iter=60)
    timing = run_control_loop_async(tube, plant, lcfg)
    assert timing.async_depth_final == 2


def test_adaptive_depth_shrinks_when_device_is_early():
    tube, plant = _fake_rig(latency_s=0.0005)
    lcfg = AsyncLoopConfig(hz=100, num_timesteps=16, depth=3,
                           realtime=True, adaptive_depth=True,
                           shrink_after_s=0.05, max_iter=100)
    timing = run_control_loop_async(tube, plant, lcfg)
    assert timing.async_depth_final == 1
    assert [d for _, d in timing.async_depth_changes] == [2, 1]


class _OscillatingTube(_FakeTube):
    """Latency alternates quiet / spiky every 20 dispatches: the loop must
    settle at the depth that covers the spikes."""

    def __init__(self, T, quiet_s, spike_s):
        super().__init__(T, quiet_s)
        self.quiet_s, self.spike_s = quiet_s, spike_s
        self.n = 0

    def dispatch(self, state, stride):
        self.n += 1
        self.latency_s = (self.spike_s if (self.n // 20) % 2 else
                          self.quiet_s)
        return super().dispatch(state, stride)


def test_adaptive_depth_stable_under_oscillating_latency():
    tube = _OscillatingTube(16, quiet_s=0.002, spike_s=0.026)
    plant = BasePlant(dt=0.01, num_timesteps=16, use_feedback_gains=False)
    plant.receive_state_vector(0.0, np.zeros(7, np.float32))
    lcfg = AsyncLoopConfig(hz=100, num_timesteps=16, depth=1,
                           realtime=True, adaptive_depth=True,
                           shrink_after_s=0.15, max_iter=400,
                           carry_learned=True)
    timing = run_control_loop_async(tube, plant, lcfg)
    assert 2 <= timing.async_depth_final <= 3
    changes = [d for _, d in timing.async_depth_changes]
    assert changes.count(2) <= 3 and changes.count(3) <= 2, changes
    assert lcfg.shrink_floor == timing.async_depth_final


def test_adaptive_depth_off_by_default_and_in_lockstep():
    tube, plant, cfg = _build()
    lcfg = _lockstep(2, 12, adaptive_depth=True)
    timing = run_control_loop_async(tube, plant, lcfg)
    assert timing.async_depth_final == 2
    assert timing.async_depth_changes == []
    assert lcfg.depth == 2


def test_drain_leaves_freshest_solution():
    tube, plant, cfg = _build()
    seen = []
    run_control_loop_async(tube, plant, _lockstep(3, 20),
                           on_tick=lambda i, *a: seen.append(i))
    assert len(seen) == 20       # every dispatch was harvested


def test_async_degeneracy_guard_brakes_published_solution():
    class _DegenerateTube(_degenerate_outputs(_FakeTube)):
        class solver:               # duck-typed: .solver.cfg.num_rollouts
            class cfg:
                num_rollouts = 64

    tube = _DegenerateTube(16, latency_s=0.0005)
    plant = _moving_plant()
    pubs = []
    orig = plant.set_solution

    def capture(ss, cs, gains, t, used):
        pubs.append(np.array(cs))
        orig(ss, cs, gains, t, used)

    plant.set_solution = capture
    lcfg = AsyncLoopConfig(hz=100, num_timesteps=16, depth=1,
                           realtime=True, max_iter=20, degeneracy_guard=True)
    timing = run_control_loop_async(tube, plant, lcfg)
    assert timing.degenerate_ticks > 0
    assert all((p[:, 1] <= 0.0).all() for p in pubs)
    assert all((p[:, 0] == 0.5).all() for p in pubs)
    pubs.clear()
    timing2 = run_control_loop_async(
        tube, plant, AsyncLoopConfig(hz=100, num_timesteps=16, depth=1,
                                     realtime=True, max_iter=20))
    assert timing2.degenerate_ticks == 0
    assert all((p[:, 1] == 0.5).all() for p in pubs)


def test_degeneracy_guard_on_the_port_tube_uses_its_footprint_cost():
    """The port's own tube carries the footprint cost: on a map with no
    track every rollout crashes, and a moving car brakes."""
    tube, _, cfg = _build(K=64)
    wall = np.ones((60, 80, 4), np.float32)
    tube.update_costmap(make_costmap(wall, (-40.0, 40.0), (-30.0, 30.0),
                                     device="cpu"))
    plant = SyntheticPlant(tube.solver.model, tube.model_params, START,
                           cfg.dt, cfg.num_timesteps,
                           use_feedback_gains=False)
    plant.receive_state_vector(0.0, START)
    outs = []
    timing = run_control_loop_async(
        tube, plant, _lockstep(1, 6, degeneracy_guard=True),
        on_tick=lambda i, used, state, out, h, a: outs.append(out))
    assert all(float(o.position_track_cost) == 1.0 for o in outs)
    assert all(float(o.crash_frac) == 1.0 for o in outs)
    assert timing.degenerate_ticks > 0
    assert all(c <= 0.0 for _, _, c in plant.published[1:])


def test_dispatch_refuses_a_negative_stride_and_a_second_harvest():
    tube, plant, _ = _build()
    tube.reset(START)
    with pytest.raises(ValueError, match="stride"):
        tube.dispatch(START, -1)
    pending = tube.dispatch(START, 0)
    out = pending.result()
    assert np.isfinite(out.control_solution).all()
    with pytest.raises(RuntimeError, match="harvested"):
        pending.result()


def test_runtime_defaults_to_cuda_and_raises_without_gpu(monkeypatch,
                                                        tmp_path):
    """The gates and the simulator node run on the card unless asked for
    the CPU, and raise without a GPU before they start anything."""
    from autorally_tpu_torch.runtime import realtime_gate
    from autorally_tpu_torch.tools import sim_node

    tube, _, _ = _build()
    npz = str(tmp_path / "nnet.npz")
    tube.solver.model.save_params(tube.model_params, npz)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for gate in (realtime_gate.run_realtime_gate,
                 realtime_gate.run_realtime_gate_async):
        with pytest.raises(RuntimeError, match="no GPU"):
            gate(seconds=0.1)
    with pytest.raises(RuntimeError, match="no GPU"):
        sim_node.main(["--model", npz, "--duration", "0.1"])
