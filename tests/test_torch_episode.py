"""The port's closed-loop episode (``runtime/episode.py``) against the JAX
package's ``EpisodeRunner`` on the CPU, every ``EpisodeResult`` field tick
by tick: plain; feedback gains with two plant substeps a tick and a true
model whose weights are 10 % off, with an ESS target whose starting
``CostParams.gamma`` lies outside the band the config's gamma would give;
the asymmetric tube with moving obstacles; and the BF model with gains.
Every solve takes the noise that its subkey picks from one table, as in
``tests/test_torch_runtime.py``, on a map of one cost.  Also the runner's
refusals, and a port-only episode on the oval that drives.

On the card the tick is a captured CUDA graph; ``chip_smoke.py`` phase 21
holds it bit for bit against the same tick run eagerly there.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autorally_tpu.config import CostParams as JaxCostParams
from autorally_tpu.config import MPPIConfig as JaxConfig
from autorally_tpu.costs import MPPICost as JaxCost
from autorally_tpu.costs.costmap import make_costmap as jax_make_costmap
from autorally_tpu.costs.obstacles import ObstacleCost as JaxObstacleCost
from autorally_tpu.costs.obstacles import make_obstacles as jax_obstacles
from autorally_tpu.models import BasisFunctionDynamics as JaxBF
from autorally_tpu.models import NeuralNetDynamics as JaxNN
from autorally_tpu.runtime.episode import EpisodeRunner as JaxRunner
from autorally_tpu.solver.mppi import MPPISolver as JaxSolver
from autorally_tpu_torch.config import CostParams, MPPIConfig
from autorally_tpu_torch.costs import (MPPICost, ObstacleCost, make_costmap,
                                       make_obstacles)
from autorally_tpu_torch.models import BasisFunctionDynamics, NeuralNetDynamics
from autorally_tpu_torch.runtime.episode import EpisodeResult, EpisodeRunner
from autorally_tpu_torch.solver.mppi import MPPISolver
from autorally_tpu_torch.tools.lap_eval import load_track

K, T, TICKS = 128, 16, 12
START = np.array([30.0, 0.0, math.pi / 2, 0.0, 0.0, 0.0, 0.0], np.float32)
NOISE_TABLE = 16
FLAT = np.zeros((60, 80, 4), np.float32)
FLAT[..., 0] = 0.1                     # under the 0.65 boundary: no crash
FLAT_MAP = (FLAT, (-40.0, 40.0), (-30.0, 30.0))
# The tolerances of tests/test_torch_runtime.py::test_tube_loop_matches_jax
# (the same solves, DDP and plant steps, on the same map): states and
# executed controls within 1e-4 relative / 1e-6 absolute, the chosen
# solve's trajectory cost, ESS and gamma within 1e-5 relative; the
# arbitration's outcome and the crash fraction equal.  The trajectory cost
# and the ESS are sums of the weights exp(-gamma (c - min c)), whose error
# grows with gamma: their 1e-5 holds at the configured 0.15 and is scaled
# by gamma / 0.15 above it (measured within 6e-6 at 0.15 and 4e-5 at the
# ESS case's gamma of 1.5 to 3).
TOLS = {"states": (1e-4, 1e-6), "controls": (1e-4, 1e-6),
        "trajectory_cost": (1e-5, 0.0), "ess": (1e-5, 0.0),
        "crash_frac": (0.0, 0.0), "gamma": (1e-5, 0.0)}
GAMMA_SCALED = ("trajectory_cost", "ess")
HEADROOM = 2.0
GAMMA_OVERRIDE = 20 * 0.15             # far outside the cfg-based band
MISMATCH = 1.1


def _models(kind, dt):
    if kind == "bf":
        jm, tm = JaxBF(dt), BasisFunctionDynamics(dt, device="cpu")
    else:
        jm, tm = JaxNN(dt), NeuralNetDynamics(dt, device="cpu")
    return jm, tm


def _tables(Ks):
    """One noise table for each rollout count, (NOISE_TABLE, T, K, 2)."""
    rs = np.random.default_rng(11)
    return {k: rs.standard_normal((NOISE_TABLE, T, k, 2)).astype(np.float32)
            for k in Ks}


def _inject(solver, jsolver, tables):
    """Each solve's noise picked by its subkey from the table of its K:
    the port's generator is seeded with the subkey's words, the JAX
    sampler gets the subkey (inside jit, where the pick is an index)."""
    jtables = {k: jnp.asarray(v) for k, v in tables.items()}
    solver._sample_noise = lambda gen, shape: torch.tensor(
        tables[shape[1]][(gen.initial_seed() & 0xFFFFFFFF) % NOISE_TABLE])
    jsolver._sample_noise = lambda key, shape: jtables[shape[1]][
        key[1] % NOISE_TABLE]


def _case(name):
    """Both packages' runners and run arguments for one case."""
    kind = "bf" if name == "bf" else "nn"
    substeps = 2 if name == "gains_substeps_mismatch_ess" else 1
    cfg, jcfg = (MPPIConfig(num_rollouts=K, num_timesteps=T),
                 JaxConfig(num_rollouts=K, num_timesteps=T))
    jm, tm = _models(kind, cfg.dt)
    jp = jm.init_params(jax.random.PRNGKey(0))
    tp = tm.params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    run_kw, jrun_kw = {}, {}
    runner_kw = dict(n_ticks=TICKS)
    cost, jcost = MPPICost(), JaxCost()
    cp, jcp = CostParams(desired_speed=5.0), JaxCostParams(desired_speed=5.0)
    k_pred = None
    if name == "gains_substeps_mismatch_ess":
        runner_kw.update(use_feedback_gains=True, pose_substeps=substeps,
                         ess_target_frac=0.25, ess_headroom=HEADROOM)
        jtrue, ttrue = _models(kind, cfg.dt / substeps)
        jrun_kw["params_true"] = {**jp, "weights": [
            w * MISMATCH for w in jp["weights"]]}
        run_kw["params_true"] = {**tp, "weights": [
            w * MISMATCH for w in tp["weights"]]}
        cp = cp.replace(gamma=GAMMA_OVERRIDE)
        jcp = jcp.replace(gamma=jnp.float32(GAMMA_OVERRIDE))
    elif name == "asymmetric_obstacles":
        k_pred = K // 4
        # two circles just ahead of the car, the first moving toward it,
        # and two free slots
        traj = np.full((TICKS, 4, 3), -1.0, np.float32)
        traj[:, 0] = [[30.3, 0.8 - 0.02 * i, 0.3] for i in range(TICKS)]
        traj[:, 1] = [[29.4 + 0.01 * i, 1.2, 0.25] for i in range(TICKS)]
        cost = ObstacleCost(make_obstacles(traj[0], 4, device="cpu"),
                            150.0, 0.75)
        jcost = JaxObstacleCost(jax_obstacles(traj[0], 4), 150.0, 0.75)
        run_kw["obstacle_traj"], jrun_kw["obstacle_traj"] = traj, traj
    elif name == "bf":
        runner_kw.update(use_feedback_gains=True)
    solver = MPPISolver(tm, cost, cfg, device="cpu")
    jsolver = JaxSolver(jm, jcost, jcfg)
    tables = _tables({K} | ({k_pred} if k_pred else set()))
    _inject(solver, jsolver, tables)
    ours_kw, jax_kw = dict(runner_kw), dict(runner_kw)
    if substeps > 1:
        ours_kw["true_model"], jax_kw["true_model"] = ttrue, jtrue
    if k_pred:
        solver_p = solver.with_rollouts(k_pred)
        jsolver_p = jsolver.with_rollouts(k_pred)
        _inject(solver_p, jsolver_p, tables)
        ours_kw["solver_predicted"] = solver_p
        jax_kw["solver_predicted"] = jsolver_p
    cm, jcm = make_costmap(*FLAT_MAP, device="cpu"), jax_make_costmap(
        *FLAT_MAP)
    ours = EpisodeRunner(solver, **ours_kw).run(tp, cp, cm, START, **run_kw)
    ref = JaxRunner(jsolver, **jax_kw).run(jp, jcp, jcm, START, **jrun_kw)
    return ours, jax.tree_util.tree_map(np.asarray, ref)


@pytest.mark.parametrize("name", ["plain", "gains_substeps_mismatch_ess",
                                  "asymmetric_obstacles", "bf"])
def test_episode_matches_jax(name):
    ours, ref = _case(name)
    assert ours._fields == EpisodeResult._fields == ref._fields
    for field in EpisodeResult._fields:
        a, b = getattr(ours, field).numpy(), getattr(ref, field)
        assert a.shape == b.shape, field
        if field == "used_actual":
            assert a.dtype == bool
            np.testing.assert_array_equal(a, b, err_msg=field)
            continue
        rtol, atol = TOLS[field]
        if field in GAMMA_SCALED:
            rtol *= max(1.0, float(ref.gamma.max()) / 0.15)
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, err_msg=field)
    used = ours.used_actual.numpy()
    assert used.any() and not used.all()       # both outcomes, the resync
    assert np.isfinite(ours.states.numpy()).all()
    g = ours.gamma.numpy()
    if name == "gains_substeps_mismatch_ess":
        # the band centers on the override, which the first tick uses
        assert g[0] == np.float32(GAMMA_OVERRIDE)
        assert (g >= np.float32(GAMMA_OVERRIDE / HEADROOM)).all()
        assert (g <= np.float32(GAMMA_OVERRIDE * HEADROOM)).all()
        assert len(set(g.tolist())) > 2             # the law moves it
    else:
        assert (g == np.float32(0.15)).all()


def _solver(K=64, T=8, cost=None, dt=None):
    cfg = MPPIConfig(num_rollouts=K, num_timesteps=T)
    model = NeuralNetDynamics(cfg.dt if dt is None else dt, device="cpu")
    return MPPISolver(model, cost or MPPICost(), cfg, device="cpu"), model


def test_episode_refusals():
    solver, model = _solver()
    with pytest.raises(ValueError, match="horizon"):
        EpisodeRunner(solver, solver_predicted=MPPISolver(
            model, MPPICost(), solver.cfg.replace(num_timesteps=9),
            device="cpu"))
    with pytest.raises(ValueError, match="unreachable"):
        EpisodeRunner(solver, solver_predicted=solver.with_rollouts(16),
                      ess_target_frac=0.5)
    with pytest.raises(ValueError, match="ess_target_frac"):
        EpisodeRunner(solver, ess_target_frac=1.5)
    with pytest.raises(ValueError, match="cfg.dt/pose_substeps"):
        EpisodeRunner(solver, pose_substeps=2)
    runner = EpisodeRunner(solver, n_ticks=3)
    cm = make_costmap(*FLAT_MAP, device="cpu")
    params = model.init_params(0)
    traj = np.full((3, 2, 3), -1.0, np.float32)
    with pytest.raises(TypeError, match="ObstacleCost"):
        runner.run(params, CostParams(), cm, START, obstacle_traj=traj)
    osolver, omodel = _solver(cost=ObstacleCost(make_obstacles(
        [[0.0, 0.0, 1.0]], 2, device="cpu")))
    with pytest.raises(ValueError, match="2 ticks, episode has 3"):
        EpisodeRunner(osolver, n_ticks=3).run(
            omodel.init_params(0), CostParams(), cm, START,
            obstacle_traj=traj[:2])
    with pytest.raises(ValueError, match="optimization_stride"):
        EpisodeRunner(MPPISolver(model, MPPICost(), solver.cfg.replace(
            optimization_stride=0), device="cpu"))


def test_episode_drives_on_the_oval():
    """The port alone, on the oval of ``load_track`` with seeded weights
    (the JAX package's own episode test needs the reference weights): the
    car starts from rest, accelerates and leaves its start, every value
    finite and both controllers used."""
    cm, start_pose, _, _ = load_track("oval", ppm=4.0, device="cpu")
    cfg = MPPIConfig(num_rollouts=256, num_timesteps=24)
    model = NeuralNetDynamics(cfg.dt, device="cpu")
    params = model.init_params(0)
    runner = EpisodeRunner(MPPISolver(model, MPPICost(), cfg, device="cpu"),
                           n_ticks=50)
    start = np.array([*start_pose, 0, 0, 0, 0], np.float32)
    res = runner.run(params, CostParams(desired_speed=5.0), cm, start)
    states = res.states.numpy()
    assert states.shape == (50, 7)
    for field in EpisodeResult._fields:
        assert torch.isfinite(getattr(res, field).float()).all(), field
    # seeded weights are weak: ~0.1 m/s after 50 ticks (1.1 m/s after 200
    # at K=1920, ROADMAP.md)
    assert states[-1, 4] > 0.05 and states[-1, 4] > states[25, 4]
    assert np.hypot(*(states[-1, :2] - start[:2])) > 0.02
    used = res.used_actual.numpy()
    assert used.any() and not used.all()


class _FakeGraph:
    """Stands in for ``torch.cuda.CUDAGraph``: the capture records the tick
    made inside it, and a replay runs that tick again with the arguments it
    was captured with (as a graph replays what it froze), on the plan's
    buffers."""

    capturing = None

    def __init__(self):
        self.call = None

    def replay(self):
        fn, args = self.call
        fn(*args)


class _FakeStream:
    def __init__(self, *a, **k):
        pass

    def wait_stream(self, other):
        pass


class _Context:
    def __init__(self, graph=None):
        self.graph = graph

    def __enter__(self):
        _FakeGraph.capturing = self.graph

    def __exit__(self, *exc):
        _FakeGraph.capturing = None


def test_captured_episode_bookkeeping(monkeypatch):
    """The captured run's bookkeeping on the CPU, through a stand-in graph:
    a replayed run equals the eager run bit for bit; other seeds and other
    circles (their count unchanged) replay the same graph and still equal
    their eager runs (keys, noise and circles are staged per run, not
    frozen); other cost params, weights changed in place or another
    circle count capture anew.  A frozen key, a stale circle buffer, a
    counter not reset or a graph replayed on stale weights fail here."""
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "Stream", _FakeStream)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a: _FakeStream())
    monkeypatch.setattr(torch.cuda, "stream", lambda s: _Context())
    monkeypatch.setattr(torch.cuda, "graph", lambda g: _Context(g))
    monkeypatch.setattr(EpisodeRunner, "captures",
                        property(lambda self: True))
    cfg = MPPIConfig(num_rollouts=64, num_timesteps=8)
    model = NeuralNetDynamics(cfg.dt, device="cpu")
    params = model.init_params(0)
    traj = np.full((5, 3, 3), -1.0, np.float32)
    traj[:, 0] = [[30.2, 0.6 + 0.05 * i, 0.3] for i in range(5)]
    cost = ObstacleCost(make_obstacles(traj[0], 3, device="cpu"), 150.0,
                        0.75)
    runner = EpisodeRunner(MPPISolver(model, cost, cfg, device="cpu"),
                           n_ticks=5, ess_target_frac=0.5)
    tick = runner._tick

    def recorded(*args):
        if _FakeGraph.capturing is not None:
            _FakeGraph.capturing.call = (tick, args)
        tick(*args)

    runner._tick = recorded
    captures = []
    capture = runner._capture
    runner._capture = lambda *a: (captures.append(1), capture(*a))
    cm = make_costmap(*FLAT_MAP, device="cpu")
    cp = CostParams(desired_speed=5.0)

    def held(cost_params=cp, **kw):
        """A run against the same run eagerly: (its result, its
        captures)."""
        n = len(captures)
        got = runner.run(params, cost_params, cm, START, **kw)
        want = runner.run(params, cost_params, cm, START, eager=True, **kw)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        return got, len(captures) - n

    first, n = held(obstacle_traj=traj)
    assert n == 1 and runner._captured.graph.call is not None
    again, n = held(obstacle_traj=traj)
    assert n == 0 and all(torch.equal(a, b) for a, b in zip(first, again))
    other, n = held(obstacle_traj=traj, seed_a=5, seed_p=6)
    assert n == 0 and not torch.equal(other.states, first.states)
    moved = traj.copy()
    moved[:, 0, 1] -= 0.3
    shifted, n = held(obstacle_traj=moved)
    assert n == 0 and not torch.equal(shifted.states, first.states)
    assert held(obstacle_traj=np.concatenate(
        [traj, traj[:, :1]], axis=1))[1] == 1            # 4 circles
    params["weights"][0].mul_(1.1)                       # in place
    assert held(obstacle_traj=traj)[1] == 1
    assert held(cp.replace(desired_speed=3.0), obstacle_traj=traj)[1] == 1
