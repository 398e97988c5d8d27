"""Circles, the neural field, the ESS law and moving obstacles in the lanes
of a stacked ``CostParams`` on the CPU, where the lane forms' wrappers run
their plain versions: kernel 1's lane form with a lane's own circles and
with circles every lane shares (MLP and BF) and kernel 3's lane form with
and without circles, each against the JAX kernel vmapped over the lanes in
interpret mode (the batching rule that gives the JAX sweep's
``pallas_call`` its lane axis, the circles batched or not), each lane
exactly the port's solo plain call; and the sweep (``run_sweep``, or
``EpisodeRunner.run`` with ``obstacle_traj``) lane by lane against the JAX
sweep in four cases: an ``ObstacleCost`` with each lane's circles, the ESS
law (a gamma a lane), moving obstacles and a ``NeuralCostmap``, one lane of
each against the port's solo episode.  The CUDA lane kernels run only on a
GPU: ``chip_smoke.py`` phase 34 holds them against these plain versions and
each lane bit for bit against the solo instance."""

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
from autorally_tpu.costs.neural_costmap import NeuralCostmap as JaxField
from autorally_tpu.costs.obstacles import ObstacleCost as JaxObstacleCost
from autorally_tpu.models import BasisFunctionDynamics as JaxBF
from autorally_tpu.ops import rollout_kernel as jrk
from autorally_tpu.runtime.episode import EpisodeRunner as JaxRunner
from autorally_tpu.solver.mppi import MPPISolver as JaxSolver
from autorally_tpu.tools import param_sweep as jsweep
from autorally_tpu_torch.config import (CostParams, MPPIConfig,
                                        lane_cost_params)
from autorally_tpu_torch.costs import (MPPICost, NeuralCostmap, ObstacleCost,
                                       make_costmap)
from autorally_tpu_torch.models import BasisFunctionDynamics
from autorally_tpu_torch.ops import rollout_kernel as rk
from autorally_tpu_torch.runtime.episode import EpisodeResult, EpisodeRunner
from autorally_tpu_torch.solver.mppi import MPPISolver
from autorally_tpu_torch.tools import param_sweep as sweep
from tests.test_torch_lane_kernels import (COST_ATOL, COST_RTOL, USEQ_ATOL,
                                           L, Lanes)
from tests.test_torch_neural_costmap import _field_arrays
from tests.test_torch_param_sweep import (FLAT_MAP, GAMMA_SCALED, LANE_ATOL,
                                          LANE_RTOL, NOISE_TABLE, TOLS,
                                          _inject)

COEFF, INFLATION = 150.0, 0.75
# Circles about the lanes' starts (x 25, heading +y at 6 m/s: 2.9 m in the
# 24 steps), so that they change the costs and some rollouts run into
# them; each lane its own set of 4 slots (the last one free), or the first
# lane's shared.
LANE_CIRCLES = np.float32([
    [[25.0, 1.5, 0.5], [25.6, 2.4, 0.4], [24.3, 0.9, 0.3], [0, 0, -1]],
    [[24.8, 2.0, 0.6], [25.3, 1.0, 0.3], [0, 0, -1], [0, 0, -1]],
    [[25.2, 1.2, 0.4], [24.5, 2.2, 0.5], [25.9, 1.8, 0.35], [0, 0, -1]]])


@pytest.fixture(scope="module")
def lanes():
    return Lanes()


def _field_pair(scale=1.0, shift=0.0):
    """(port field on the CPU, JAX field) of
    ``tests/test_torch_neural_costmap.py``'s arrays, the output scaled by
    ``scale`` and moved by ``shift``."""
    arrays = _field_arrays()
    W, B = list(arrays["weights"]), list(arrays["biases"])
    W[-1] = (W[-1] * np.float32(scale)).astype(np.float32)
    B[-1] = (B[-1] * np.float32(scale) + np.float32(shift)).astype(
        np.float32)
    arrays.update(weights=tuple(W), biases=tuple(B))
    jf = JaxField(**{k: (tuple(jnp.asarray(a) for a in v)
                         if isinstance(v, tuple) else jnp.asarray(v))
                     for k, v in arrays.items()})
    return (NeuralCostmap.from_jax(jax.tree_util.tree_map(np.asarray, jf),
                                   device="cpu"), jf)


def _model(s, kind):
    """(port model, params, JAX model, JAX params) of ``kind``."""
    if kind == "nn":
        return s.model, s.params, s.jmodel, s.jparams
    jm = JaxBF(s.jcfg.dt)
    jp = jm.init_params(jax.random.PRNGKey(0))
    tm = BasisFunctionDynamics(s.cfg.dt, device="cpu")
    return tm, tm.params_from_jax(jax.tree_util.tree_map(np.asarray, jp)), \
        jm, jp


def _hold_lanes(out, ref, solo_calls):
    """Each lane against the vmapped JAX kernel's (costs within the kernel
    parity tolerances, crash flags equal, u_seq within USEQ_ATOL) and
    exactly the port's solo plain call."""
    costs, u_seq, crash = out
    jc, ju, jx = (np.asarray(r) for r in ref)
    assert costs.shape == crash.shape == (L, costs.shape[1])
    for lane in range(L):
        np.testing.assert_allclose(costs[lane].numpy(), jc[lane],
                                   rtol=COST_RTOL, atol=COST_ATOL)
        np.testing.assert_array_equal(crash[lane].numpy(), jx[lane])
        np.testing.assert_allclose(u_seq[lane].numpy(), ju[lane], rtol=0,
                                   atol=USEQ_ATOL)
        for a, b in zip(out, solo_calls(lane)):
            assert torch.equal(a[lane], b)


@pytest.mark.parametrize("kind", ["nn", "bf"])
@pytest.mark.parametrize("circles", ["per_lane", "shared"])
def test_kernel1_lanes_with_circles_match_the_vmapped_jax_kernel(
        lanes, kind, circles):
    s = lanes
    model, params, jmodel, jparams = _model(s, kind)
    state, U, eps = s.torch_args()
    obs = LANE_CIRCLES if circles == "per_lane" else LANE_CIRCLES[0]
    kw = dict(obstacle_coeff=COEFF, inflation=INFLATION)
    out = rk.fused_exact_rollout_cost_lanes(
        model, params, s.cfg, s.cp, s.cm, state, U, eps,
        obstacles=torch.tensor(obs), **kw)

    def jax_lane(cp, st, u, ob):
        return jrk.fused_exact_rollout_cost_pallas(
            jmodel, jparams, s.jcfg, cp, s.jcm, st, u, jnp.asarray(s.eps),
            interpret=True, obstacles=ob, **kw)

    ref = jax.vmap(jax_lane, in_axes=(0, 0, 0, 0 if obs.ndim == 3 else None))(
        s.jcp, jnp.asarray(s.state), jnp.asarray(s.U), jnp.asarray(obs))
    lanes_cp = lane_cost_params(s.cp)
    _hold_lanes(out, ref, lambda i: rk.fused_exact_rollout_cost(
        model, params, s.cfg, lanes_cp[i], s.cm, state[i], U[i], eps,
        obstacles=torch.tensor(obs[i] if obs.ndim == 3 else obs), **kw))
    # the circles change the costs and crash rollouts that run into them
    free = rk.fused_exact_rollout_cost_lanes(model, params, s.cfg, s.cp,
                                             s.cm, state, U, eps)
    assert (out[0] > free[0]).any()
    assert (out[2] > free[2]).any()


@pytest.mark.parametrize("circles", [False, True], ids=["free", "circles"])
def test_kernel3_lanes_match_the_vmapped_jax_kernel(lanes, circles):
    s = lanes
    field, jfield = _field_pair()
    state, U, eps = s.torch_args()
    kw = (dict(obstacles=LANE_CIRCLES, obstacle_coeff=COEFF,
               inflation=INFLATION) if circles else {})
    out = rk.fused_rollout_cost_lanes(s.model, s.params, s.cfg, s.cp, field,
                                      state, U, eps, **kw)
    jkw = {k: v for k, v in kw.items() if k != "obstacles"}

    def jax_lane(cp, st, u, ob):
        return jrk.fused_rollout_cost_pallas(
            s.jmodel, s.jparams, s.jcfg, cp, jfield, st, u,
            jnp.asarray(s.eps), interpret=True, obstacles=ob, **jkw)

    obs = jnp.asarray(LANE_CIRCLES) if circles else None
    ref = jax.vmap(jax_lane, in_axes=(0, 0, 0, 0 if circles else None))(
        s.jcp, jnp.asarray(s.state), jnp.asarray(s.U), obs)
    lanes_cp = lane_cost_params(s.cp)
    _hold_lanes(out, ref, lambda i: rk.fused_rollout_cost(
        s.model, s.params, s.cfg, lanes_cp[i], field, state[i], U[i], eps,
        **({**jkw, "obstacles": torch.tensor(LANE_CIRCLES[i])}
           if circles else {})))
    if circles:
        # the circles change the costs
        free = rk.fused_rollout_cost_lanes(s.model, s.params, s.cfg, s.cp,
                                           field, state, U, eps)
        assert (out[0] != free[0]).any()
    else:
        assert 0 < int(out[2].sum()) < out[2].numel()


# ---------------------------------------------------------------------------
# the sweep against the JAX sweep
# ---------------------------------------------------------------------------

SK, ST, TICKS = 128, 16, 8
START = np.array([30.0, 0.0, math.pi / 2, 0, 0, 0, 0], np.float32)
# on the field's 10 m x 10 m map, below its crash boundary everywhere
FIELD_START = np.array([25.0, -3.0, math.pi / 2, 0, 0, 0, 0], np.float32)
OBSTACLE_GRID = [
    {"desired_speed": 4.0, "obstacles": np.float32(
        [[30.3, 0.8, 0.3], [29.4, 1.2, 0.25], [0, 0, -1]])},
    {"desired_speed": 6.0, "obstacles": np.float32(
        [[29.7, 1.0, 0.35], [0, 0, -1], [0, 0, -1]])},
]
ESS_GRID = [{"gamma": 0.1}, {"gamma": 0.6}]
SPEED_GRID = [{"desired_speed": 3.0}, {"desired_speed": 6.0}]
ESS_HEADROOM = 2.0


def _moving_traj():
    """Two circles just ahead of the car, the first moving toward it, and
    a free slot (``tests/test_torch_episode.py``'s moving obstacles)."""
    traj = np.full((TICKS, 3, 3), -1.0, np.float32)
    traj[:, 0] = [[30.3, 0.8 - 0.02 * i, 0.3] for i in range(TICKS)]
    traj[:, 1] = [[29.4 + 0.01 * i, 1.2, 0.25] for i in range(TICKS)]
    return traj


def _sweep_case(name):
    """Both packages' sweeps of case ``name``: (the port's result, the JAX
    result as numpy, the port's runner, its run arguments and keywords,
    the stacked CostParams)."""
    cfg = MPPIConfig(num_rollouts=SK, num_timesteps=ST)
    jcfg = JaxConfig(num_rollouts=SK, num_timesteps=ST)
    from autorally_tpu.models import NeuralNetDynamics as JaxNN
    from autorally_tpu_torch.models import NeuralNetDynamics

    jmodel = JaxNN(jcfg.dt, control_ranges=jcfg.control_ranges)
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    model = NeuralNetDynamics(cfg.dt, control_ranges=cfg.control_ranges,
                              device="cpu")
    params = model.params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                          jparams))
    cost, jcost = MPPICost(), JaxCost()
    runner_kw, run_kw, jtraj = dict(n_ticks=TICKS), {}, None
    grid, start = SPEED_GRID, START
    cm, jcm = make_costmap(*FLAT_MAP, device="cpu"), jax_make_costmap(
        *FLAT_MAP)
    if name in ("obstacles", "moving"):
        own = np.full((3, 3), -1.0, np.float32)
        own[0] = [30.0, 1.5, 0.4]
        cost = ObstacleCost(torch.tensor(own), COEFF, INFLATION)
        jcost = JaxObstacleCost(jnp.asarray(own), COEFF, INFLATION)
    if name == "obstacles":
        grid = OBSTACLE_GRID
    elif name == "ess":
        grid = ESS_GRID
        runner_kw.update(ess_target_frac=0.25, ess_headroom=ESS_HEADROOM)
    elif name == "moving":
        run_kw["obstacle_traj"] = jtraj = _moving_traj()
    elif name == "field":
        # the seeded field scaled under its crash boundary: a surface of
        # no texel edges, so that the closed loops stay together
        cm, jcm = _field_pair(scale=0.4, shift=-0.05)
        start = FIELD_START
    solver = MPPISolver(model, cost, cfg, device="cpu")
    jsolver = JaxSolver(jmodel, jcost, jcfg)
    rs = np.random.default_rng(11)
    _inject(solver, jsolver, rs.standard_normal(
        (NOISE_TABLE, ST, SK, 2)).astype(np.float32))
    runner = EpisodeRunner(solver, **runner_kw)
    jrunner = JaxRunner(jsolver, **runner_kw)
    stacked = sweep.stack_cost_params(CostParams(), grid)
    jstacked = jsweep.stack_cost_params(JaxCostParams(), grid)
    if name == "moving":
        ours = runner.run(params, stacked, cm, start, seed_a=0, seed_p=1,
                          **run_kw)
        cs_a, cs_p = (jsolver.init_state(seed) for seed in (0, 1))
        s0 = jnp.asarray(start)
        cs_a, cs_p = (cs._replace(state_solution=cs.state_solution.at[0]
                                  .set(s0)) for cs in (cs_a, cs_p))
        ref = jax.jit(jax.vmap(jrunner._episode, in_axes=(
            None, None, 0, None, None, None, None, None)))(
            jparams, jparams, jstacked, jcm, s0, cs_a, cs_p,
            jnp.asarray(jtraj))
    else:
        ours = sweep.run_sweep(runner, params, stacked, cm, start)
        ref = jsweep.run_sweep(jrunner, jparams, jstacked, jcm, start)
    return (ours, jax.tree_util.tree_map(np.asarray, ref), runner,
            (params, cm, start), run_kw, stacked)


CASES = ("obstacles", "ess", "moving", "field")


@pytest.fixture(scope="module")
def sweeps():
    runs = {}

    def get(name):
        if name not in runs:
            runs[name] = _sweep_case(name)
        return runs[name]
    return get


@pytest.mark.parametrize("name", CASES)
def test_sweep_matches_jax_lane_by_lane(sweeps, name):
    """Every field of the port's sweep against the JAX sweep's, lane by
    lane, at ``tests/test_torch_episode.py``'s tolerances (``trajectory_cost``
    and ``ess`` scaled by the lane's largest gamma / 0.15 above 0.15, as
    that test scales them), gamma (L, n_ticks) included."""
    ours, ref, *_ = sweeps(name)
    n = ref.states.shape[0]
    for field in EpisodeResult._fields:
        a, b = getattr(ours, field).numpy(), getattr(ref, field)
        assert a.shape == b.shape == (n, TICKS) + b.shape[2:], field
        for lane in range(n):
            if field == "used_actual":
                np.testing.assert_array_equal(a[lane], b[lane], field)
                continue
            rtol, atol = TOLS[field]
            if field in GAMMA_SCALED:
                rtol *= max(1.0, float(ref.gamma[lane].max()) / 0.15)
            np.testing.assert_allclose(a[lane], b[lane], rtol=rtol,
                                       atol=atol, err_msg=f"{field} {lane}")
    assert np.isfinite(ours.states.numpy()).all()
    g = ours.gamma.numpy()
    if name == "ess":
        # each lane's law moves its own gamma inside its own band
        for lane, pt in enumerate(ESS_GRID):
            g0 = np.float32(pt["gamma"])
            assert g[lane, 0] == g0
            assert (g[lane] >= g0 / np.float32(ESS_HEADROOM)).all()
            assert (g[lane] <= g0 * np.float32(ESS_HEADROOM)).all()
            assert len(set(g[lane].tolist())) > 2
    else:
        assert (g == np.float32(0.15)).all()


@pytest.mark.parametrize("name", CASES)
def test_sweep_lane_matches_solo_episode(sweeps, name):
    """The last lane of each case against the port's solo episode with
    that lane's ``CostParams`` (``LANE_RTOL``: the plant's batched MLP)."""
    ours, _, runner, (params, cm, start), run_kw, stacked = sweeps(name)
    lanes_cp = lane_cost_params(stacked)
    lane, cp = len(lanes_cp) - 1, lanes_cp[-1]
    solo = runner.run(params, cp, cm, start, **run_kw)
    for field in EpisodeResult._fields:
        a, b = getattr(ours, field)[lane], getattr(solo, field)
        if field in ("used_actual", "crash_frac", "gamma"):
            assert torch.equal(a, b), field
        else:
            torch.testing.assert_close(a, b, rtol=LANE_RTOL, atol=LANE_ATOL,
                                       msg=field)


def test_field_sweep_lies_under_the_crash_boundary():
    """The field case's surface stays under the 0.65 boundary over its
    map, so that no crash latch splits the two packages' loops."""
    field, _ = _field_pair(scale=0.4, shift=-0.05)
    g = torch.linspace(0, 1, 101)
    u, v = torch.meshgrid(g, g, indexing="ij")
    values = field.forward_norm(u.reshape(-1), v.reshape(-1))
    assert float(values.max()) < 0.5 and torch.isfinite(values).all()
