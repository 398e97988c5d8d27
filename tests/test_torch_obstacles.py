"""The port's obstacle costs on the CPU, against the JAX package (modelled on
``tests/test_obstacles.py``): ``make_obstacles``, ``ObstacleCost``'s
geometry, the fused kernels' plain versions with the circle terms against
the interpret-mode Pallas kernels (exact map and neural field) and the JAX
scan path, pass 1 against the JAX host-noise path on the port's stream,
``iterate`` in both modes, the live ``CostParams.obstacles`` override,
the kernels' obstacle block and refusals, and ``drive_oval --obstacles``.

Seeded MLP weights (carried with ``params_from_jax``), two circles directly
in the 1.4 m the swarm covers in T=24 steps at 3 m/s (K=256), as the JAX
test places them.  The CUDA kernels run only on a GPU: ``chip_smoke.py``
phases 17-18 hold them against these plain versions there."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autorally_tpu.config import CostParams as JaxCostParams
from autorally_tpu.config import MPPIConfig as JaxConfig
from autorally_tpu.costs.costmap import make_costmap as jax_make_costmap
from autorally_tpu.costs.obstacles import ObstacleCost as JaxObstacleCost
from autorally_tpu.costs.obstacles import make_obstacles as jax_make_obstacles
from autorally_tpu.models import NeuralNetDynamics as JaxNN
from autorally_tpu.ops import rollout_kernel as jrk
from autorally_tpu.solver import mppi as jmppi
from autorally_tpu.tools.track_generator import oval_track
from autorally_tpu_torch import drive_oval
from autorally_tpu_torch.config import CostParams, MPPIConfig
from autorally_tpu_torch.costs import (MPPICost, ObstacleCost, make_costmap,
                                       make_obstacles)
from autorally_tpu_torch.models import NeuralNetDynamics
from autorally_tpu_torch.ops import kernel_rng as kr
from autorally_tpu_torch.ops import rollout_kernel as rk
from autorally_tpu_torch.solver import mppi
from tests.test_torch_neural_costmap import _fields
from tests.test_torch_solver import _assert_stats

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K, T = 256, 24
START = np.array([25.0, 0.0, np.pi / 2, 0.0, 3.0, 0.0, 0.0], np.float32)
CIRCLES = [[25.0, 1.0, 0.4], [24.6, 0.6, 0.25]]
CAPACITY, COEFF, INFLATION = 8, 250.0, 1.5
KEY = torch.tensor([0x2545F491, 0x9E3779B9])
# tests/test_obstacles.py's tolerances: the exact kernel against the scan
# path, and the field kernel (its fp32 sums in another order).
TOL = {"exact": (2e-5, 1e-4), "field": (2e-4, 1e-3)}
# One iteration: crash costs (~9e3) make the costs' absolute differences
# ~1e-3, which gamma = 0.15 turns into ~1.5e-4 of the weights.
ITER_RTOL, ITER_ATOL = 1e-4, 1e-5
WIDE = dict(steering_std=4 * 0.275, throttle_std=4 * 0.3)
CASES = {
    "nominal": ({}, {}),
    "wide_noise": (WIDE, {}),
    "nan_x": ({}, {0: np.nan}),
}


def _pair(**cfg_kw):
    """(port solver with an ObstacleCost, params, JAX solver, JAX params)
    with the same seeded weights and circles."""
    jcfg = JaxConfig(num_rollouts=K, num_timesteps=T, **cfg_kw)
    cfg = MPPIConfig(num_rollouts=K, num_timesteps=T, **cfg_kw)
    jmodel = JaxNN(jcfg.dt, control_ranges=jcfg.control_ranges)
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    model = NeuralNetDynamics(cfg.dt, control_ranges=cfg.control_ranges,
                              device="cpu")
    params = model.params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                          jparams))
    cost = ObstacleCost(make_obstacles(CIRCLES, CAPACITY, device="cpu"),
                        COEFF, INFLATION)
    jcost = JaxObstacleCost(jax_make_obstacles(CIRCLES, CAPACITY), COEFF,
                            INFLATION)
    return (mppi.MPPISolver(model, cost, cfg, device="cpu"), params,
            jmppi.MPPISolver(jmodel, jcost, jcfg), jparams)


def _surfaces(kind):
    """(port surface, JAX surface): the ppm=2 oval or the small random
    field of ``tests/test_torch_neural_costmap.py``."""
    if kind == "field":
        return _fields()
    data, xb, yb = oval_track(ppm=2.0)
    return (make_costmap(data, xb, yb, device="cpu"),
            jax_make_costmap(data, xb, yb))


def _inputs(state_kw=None, seed=9):
    state = START.copy()
    for i, v in (state_kw or {}).items():
        state[i] = v
    rs = np.random.default_rng(seed)
    U = np.tile(np.array([0.0, 0.3], np.float32), (T, 1))
    eps = rs.standard_normal((T, K, 2)).astype(np.float32)
    return state, U, eps


def _interpret(jsolver):
    js = jmppi.MPPISolver(jsolver.model, jsolver.cost,
                          jsolver.cfg.replace(use_pallas_rollout=True))
    js._pallas_interpret = True
    return js


# ---------------------------------------------------------------------------
# the cost
# ---------------------------------------------------------------------------

def test_make_obstacles_padding_and_capacity_error():
    obs = make_obstacles([[1.0, 2.0, 0.5]], capacity=4, device="cpu")
    assert obs.shape == (4, 3) and obs.dtype == torch.float32
    assert float(obs[0, 2]) == 0.5
    assert (obs[1:, 2] == -1.0).all()
    np.testing.assert_array_equal(
        obs.numpy(), np.asarray(jax_make_obstacles([[1.0, 2.0, 0.5]], 4)))
    assert make_obstacles([], capacity=3, device="cpu").shape == (3, 3)
    with pytest.raises(ValueError, match="capacity"):
        make_obstacles(np.zeros((5, 3)), capacity=4, device="cpu")


def test_obstacle_cost_geometry():
    """tests/test_obstacles.py's geometry: full penalty at the centre, a
    ramp in the band, 0 outside; penetration latches."""
    cost = ObstacleCost(make_obstacles([[0.0, 0.0, 1.0]], device="cpu"),
                        obstacle_coeff=100.0, inflation=1.0)
    c, crash = cost.obstacle_cost_c(CostParams(),
                                    torch.tensor([0.0, 1.5, 2.5, 0.5]),
                                    torch.zeros(4),
                                    torch.zeros(4, dtype=torch.int32))
    c = c.numpy()
    assert c[0] == 100.0 and 0 < c[1] < 100.0 and c[2] == 0.0
    np.testing.assert_array_equal(crash.numpy(), [1, 0, 0, 1])


def test_obstacle_cost_matches_jax_with_inactive_slots_and_nan():
    """Random points against ``ObstacleCost.obstacle_cost_c`` of the JAX
    package; inactive slots (radius <= 0) price nothing; a NaN position
    gives a NaN cost (and no hit) wherever a circle is active, 0 where
    none is."""
    circles = [[0.0, 0.0, 1.0], [3.0, 1.0, 0.5], [5.0, 5.0, 0.0],
               [-2.0, 0.5, -1.0]]
    cost = ObstacleCost(make_obstacles(circles, 6, device="cpu"), 80.0, 0.8)
    jcost = JaxObstacleCost(jax_make_obstacles(circles, 6), 80.0, 0.8)
    rs = np.random.default_rng(2)
    x = rs.uniform(-4, 7, (20, 50)).astype(np.float32)
    y = rs.uniform(-3, 6, (20, 50)).astype(np.float32)
    x[0, :5] = np.nan
    crash0 = np.zeros((20, 50), np.int32)
    c, crash = cost.obstacle_cost_c(CostParams(), torch.tensor(x),
                                    torch.tensor(y), torch.tensor(crash0))
    jc, jcrash = jcost.obstacle_cost_c(JaxCostParams(), jnp.asarray(x),
                                       jnp.asarray(y), jnp.asarray(crash0))
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=1e-6,
                               atol=1e-5, equal_nan=True)
    np.testing.assert_array_equal(crash.numpy(), np.asarray(jcrash))
    assert np.isnan(c.numpy()[0, :5]).all() and not crash.numpy()[0, :5].any()
    assert 0 < int(crash.sum()) < crash.numel()
    # the slots at (5, 5) and (-2, 0.5) are inactive
    at = lambda px, py: float(cost.obstacle_cost_c(
        CostParams(), torch.tensor([px]), torch.tensor([py]),
        torch.zeros(1, dtype=torch.int32))[0])
    assert at(5.0, 5.0) == 0.0 and at(-2.0, 0.5) == 0.0
    none = ObstacleCost(make_obstacles([], 4, device="cpu"))
    nan_cost, _ = none.obstacle_cost_c(CostParams(), torch.tensor([np.nan]),
                                       torch.zeros(1),
                                       torch.zeros(1, dtype=torch.int32))
    assert float(nan_cost) == 0.0


def test_with_obstacles_and_kernel_kwargs_follow_the_live_array():
    cost = ObstacleCost(make_obstacles([], capacity=8, device="cpu"))
    cost2 = cost.with_obstacles([[1, 1, 0.3], [2, 2, 0.4]])
    assert cost2.obstacles.shape == (8, 3)
    assert (cost2.obstacle_coeff, cost2.inflation) == (100.0, 1.0)
    kw = cost2.kernel_kwargs(CostParams())
    assert kw["obstacles"] is cost2.obstacles and kw["obstacle_coeff"] == 100
    live = np.zeros((8, 3), np.float32)
    assert cost2.kernel_kwargs(CostParams(obstacles=live))["obstacles"] \
        is live


# ---------------------------------------------------------------------------
# the fused kernels' plain versions with obstacles against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("surface", ["exact", "field"])
@pytest.mark.parametrize("case", list(CASES))
def test_fused_obstacles_plain_matches_jax_kernel(case, surface):
    """Against the interpret-mode ``fused_exact_rollout_cost_pallas`` /
    ``fused_rollout_cost_pallas`` given the same circles."""
    cfg_kw, state_kw = CASES[case]
    solver, params, jsolver, jparams = _pair(**cfg_kw)
    port_surface, jax_surface = _surfaces(surface)
    state, U, eps = _inputs(state_kw)
    wrapper = {"exact": rk.fused_exact_rollout_cost,
               "field": rk.fused_rollout_cost}[surface]
    costs, u_seq, crash = wrapper(
        solver.model, params, solver.cfg, CostParams(), port_surface,
        torch.tensor(state), torch.tensor(U), torch.tensor(eps),
        **solver._obstacle_kwargs(CostParams()))
    pallas = {"exact": jrk.fused_exact_rollout_cost_pallas,
              "field": jrk.fused_rollout_cost_pallas}[surface]
    jcost = jsolver.cost
    jc, ju, jx = pallas(jsolver.model, jparams, jsolver.cfg, JaxCostParams(),
                        jax_surface, jnp.asarray(state), jnp.asarray(U),
                        jnp.asarray(eps), interpret=True,
                        obstacles=jcost.obstacles,
                        obstacle_coeff=jcost.obstacle_coeff,
                        inflation=jcost.inflation)
    rtol, atol = TOL[surface]
    np.testing.assert_allclose(costs.numpy(), np.asarray(jc), rtol=rtol,
                               atol=atol)
    np.testing.assert_array_equal(crash.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(u_seq.numpy(), np.asarray(ju))
    if case == "nominal":
        assert int(crash.sum()) > 0, "the circles must be hit"
        plain, _, plain_crash = wrapper(
            solver.model, params, solver.cfg, CostParams(), port_surface,
            torch.tensor(state), torch.tensor(U), torch.tensor(eps))
        assert int(plain_crash.sum()) < int(crash.sum())
        assert float(plain.mean()) < float(costs.mean())


@pytest.mark.parametrize("surface", ["exact", "field"])
def test_fused_obstacles_plain_matches_jax_scan(surface):
    """Against the JAX solver's scan path, which prices the circles through
    ``ObstacleCost.track_cost_c``."""
    solver, params, jsolver, jparams = _pair()
    port_surface, jax_surface = _surfaces(surface)
    state, U, eps = _inputs()
    costs, _, crash = solver.rollout_costs(
        params, CostParams(), port_surface, torch.tensor(state),
        torch.tensor(U), torch.tensor(eps))
    assert not jsolver.use_pallas_rollout
    jc, _, jx = jsolver.rollout_costs(jparams, JaxCostParams(), jax_surface,
                                      jnp.asarray(state), jnp.asarray(U),
                                      jnp.asarray(eps))
    rtol, atol = TOL[surface]
    np.testing.assert_allclose(costs.numpy(), np.asarray(jc), rtol=rtol,
                               atol=atol)
    np.testing.assert_array_equal(crash.numpy(), np.asarray(jx))
    assert int(crash.sum()) > 0


def test_live_obstacle_update_via_cost_params():
    """``CostParams.obstacles`` overrides the cost's array on the same
    solver, and reaches the wrapper as its ``obstacles``."""
    solver, params, _, _ = _pair()
    cm, _ = _surfaces("exact")
    state, U, eps = (torch.tensor(a) for a in _inputs())
    moved = make_obstacles([[100.0, 100.0, 0.4]], CAPACITY, device="cpu")
    t_baked, _, c_baked = solver.rollout_costs(params, CostParams(), cm,
                                               state, U, eps)
    p_moved = CostParams(obstacles=moved.numpy())
    t_moved, _, c_moved = solver.rollout_costs(params, p_moved, cm, state, U,
                                               eps)
    assert int(c_baked.sum()) > 0
    assert int(c_moved.sum()) < int(c_baked.sum())
    assert float(t_baked.mean()) > float(t_moved.mean())
    t_direct, _, c_direct = rk.fused_exact_rollout_cost(
        solver.model, params, solver.cfg, p_moved, cm, state, U, eps,
        obstacles=moved, obstacle_coeff=COEFF, inflation=INFLATION)
    assert torch.equal(t_direct, t_moved) and torch.equal(c_direct, c_moved)


@pytest.mark.parametrize("surface", ["exact", "field"])
def test_pass1_obstacles_plain_matches_jax_rollout_costs(surface):
    """Pass 1 with the circles against the JAX host-noise path (scan) fed
    the port's stream."""
    solver, params, jsolver, jparams = _pair(kernel_rng=True, **WIDE)
    port_surface, jax_surface = _surfaces(surface)
    state, U, _ = _inputs()
    total, crash, ctx = rk.fused_rng_costs(
        solver.model, params, solver.cfg, CostParams(), port_surface,
        torch.tensor(state), torch.tensor(U), KEY,
        **solver._obstacle_kwargs(CostParams()))
    jc, _, jx = jsolver.rollout_costs(jparams, JaxCostParams(), jax_surface,
                                      jnp.asarray(state), jnp.asarray(U),
                                      jnp.asarray(rk.rng_noise(ctx).numpy()))
    rtol, atol = TOL[surface]
    np.testing.assert_allclose(total.numpy(), np.asarray(jc), rtol=rtol,
                               atol=atol)
    np.testing.assert_array_equal(crash.numpy(), np.asarray(jx))
    assert int(crash.sum()) > 0


@pytest.mark.parametrize("mode", ["host_noise", "capacity"])
def test_iterate_with_obstacles_matches_jax(mode):
    solver, params, jsolver, jparams = _pair(kernel_rng=mode == "capacity")
    cm, jcm = _surfaces("exact")
    state, U, eps = _inputs()
    cp = CostParams(desired_speed=6.0)
    args = (torch.tensor(state), torch.tensor(U))
    if mode == "capacity":
        assert solver._use_kernel_rng(cm)
        U_new, stats = solver._iterate_kernel_rng(params, cp, cm, *args, KEY)
        eps = kr.kernel_noise(KEY, 0, K, T, None).numpy()
    else:
        U_new, stats = solver.iterate(params, cp, cm, *args,
                                      torch.tensor(eps))
    jU, jstats = jsolver.iterate(jparams, JaxCostParams(desired_speed=6.0),
                                 jcm, jnp.asarray(state), jnp.asarray(U),
                                 jnp.asarray(eps))
    np.testing.assert_allclose(U_new.numpy(), np.asarray(jU),
                               rtol=ITER_RTOL, atol=ITER_ATOL)
    _assert_stats(stats, jstats, ITER_RTOL, ITER_ATOL)
    assert float(stats.crash_frac) > 0


def test_use_kernel_rng_matches_the_jax_gate_with_obstacles():
    cm, jcm = _surfaces("exact")
    for kw in (dict(kernel_rng=True), dict(kernel_rng=False),
               dict(kernel_rng=True, noise_sampler="ou", noise_param=0.15),
               dict(kernel_rng=True, noise_sampler="colored")):
        solver, _, jsolver, _ = _pair(**kw)
        assert solver._use_kernel_rng(cm) == \
            _interpret(jsolver)._use_kernel_rng(jcm), kw


# ---------------------------------------------------------------------------
# the kernels' obstacle block and the refusals
# ---------------------------------------------------------------------------

def test_obstacle_block_is_packed_fresh_for_every_launch():
    circles = make_obstacles(CIRCLES, CAPACITY, device="cpu")
    n, packed = rk._obstacle_launch(circles, torch.device("cpu"))
    assert n == CAPACITY and packed.shape == (3 * CAPACITY,)
    np.testing.assert_array_equal(packed.numpy(),
                                  circles.numpy().T.reshape(-1))
    one = torch.tensor([[1.0, 2.0, 3.0]])
    _, p1 = rk._obstacle_launch(one, torch.device("cpu"))
    one[0, 0] = 9.0                      # a later live update of the source
    assert p1.tolist() == [1.0, 2.0, 3.0]
    assert rk._obstacle_launch(None, torch.device("cpu")) == (0, None)
    solver, *_ = _pair()
    cm, _ = _surfaces("exact")
    floats, ints = rk.launch_scalars(solver.model, solver.cfg, 0, T, K,
                                     CostParams(), cm, False, n, COEFF,
                                     INFLATION)
    f = dict(zip(rk._FLOAT_SCALARS, floats))
    i = dict(zip(rk._INT_SCALARS, ints))
    assert (f["obstacle_coeff"], f["inflation"], i["n_obs"]) == (
        COEFF, INFLATION, CAPACITY)
    _, ints = rk.launch_scalars(solver.model, solver.cfg, 0, T, K,
                                CostParams(), cm)
    assert dict(zip(rk._INT_SCALARS, ints))["n_obs"] == 0


def test_launch_names_follow_the_kernel_instance(monkeypatch):
    """Each prepared launch carries the name its wrapper counts in
    ``rk.LAUNCHES``: the wrapper, ``_field`` for pass 1's field mode, then
    ``_bf`` and ``_obstacles`` (the library is faked: nothing launches;
    the field mode's names are read on the card, phases 13 and 18)."""
    from autorally_tpu_torch.models import BasisFunctionDynamics

    class Lib:
        def __getattr__(self, name):
            return lambda *a: 0

    monkeypatch.setattr(rk, "_kernel_lib", lambda: Lib())
    solver, params, _, _ = _pair()
    bf = BasisFunctionDynamics(solver.cfg.dt, device="cpu")
    bparams = bf.init_params(0)
    state, U, eps = (torch.tensor(a) for a in _inputs())
    okw = solver.cost.kernel_kwargs(CostParams())
    cm, _ = _surfaces("exact")
    names = []
    for model, prm in ((solver.model, params), (bf, bparams)):
        for kw in ({}, okw):
            names.append(rk.prepare_fused_exact_rollout_cost(
                model, prm, solver.cfg, CostParams(), cm, state, U, eps,
                **kw)[0].name)
            names.append(rk.prepare_fused_rng_costs(
                model, prm, solver.cfg, CostParams(), cm, state, U, KEY,
                **kw)[0].name)
        names.append(rk.prepare_dynamics_chain(model, prm, solver.cfg, state,
                                               U, eps)[0].name)
    assert names == [
        "fused_exact_rollout_cost", "fused_rng_costs",
        "fused_exact_rollout_cost_obstacles", "fused_rng_costs_obstacles",
        "dynamics_chain",
        "fused_exact_rollout_cost_bf", "fused_rng_costs_bf",
        "fused_exact_rollout_cost_bf_obstacles",
        "fused_rng_costs_bf_obstacles", "dynamics_chain_bf"]


def test_obstacle_refusals():
    """Circles without an ObstacleCost's coefficients, more slots than the
    kernels stage, and malformed arrays are refused before any build or
    launch; other cost types are refused by the solver."""
    solver, params, _, _ = _pair()
    cm, _ = _surfaces("exact")
    state, U, eps = (torch.tensor(a) for a in _inputs())
    plain = mppi.MPPISolver(solver.model, MPPICost(), solver.cfg,
                            device="cpu")
    with pytest.raises(NotImplementedError, match="ObstacleCost"):
        plain.rollout_costs(params, CostParams(obstacles=np.zeros((1, 3))),
                            cm, state, U, eps)
    many = make_obstacles(np.zeros((65, 3)), capacity=65, device="cpu")
    for prepare in (rk.prepare_fused_exact_rollout_cost,):
        with pytest.raises(ValueError, match="at most 64"):
            prepare(solver.model, params, solver.cfg, CostParams(), cm,
                    state, U, eps, obstacles=many, obstacle_coeff=1.0)
    with pytest.raises(ValueError, match="at most 64"):
        rk.prepare_fused_rng_costs(solver.model, params, solver.cfg,
                                   CostParams(), cm, state, U, KEY,
                                   obstacles=many)
    with pytest.raises(ValueError, match=r"\(N, 3\)"):
        rk.fused_exact_rollout_cost(solver.model, params, solver.cfg,
                                    CostParams(), cm, state, U, eps,
                                    obstacles=np.zeros((4, 2)))

    class SubCost(ObstacleCost):
        pass

    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        mppi.MPPISolver(solver.model, SubCost(np.zeros((1, 3))), solver.cfg,
                        device="cpu")


# ---------------------------------------------------------------------------
# the entry point
# ---------------------------------------------------------------------------

def test_drive_oval_moves_obstacles_every_tick():
    """``drive(tick_params=...)`` feeds a new ``CostParams.obstacles`` to
    every solve of the same solver, as ``examples/two_car_demo.py`` does."""
    solver, params, cost_params, costmap, note = drive_oval.build(
        rollouts=32, model_path="", device="cpu",
        obstacles=[[30.3, 4.0, 0.5]])
    assert type(solver.cost) is ObstacleCost and "obstacles:" in note
    assert solver.cost.obstacles.shape == (16, 3)
    assert (solver.cost.obstacle_coeff, solver.cost.inflation) == (150, 0.75)
    seen = []
    solve = solver.solve

    def spy(p, cp, *a):
        seen.append(cp.obstacles)
        return solve(p, cp, *a)

    solver.solve = spy

    def tick_params(step, state):
        return cost_params.replace(obstacles=make_obstacles(
            [[30.0, 4.0 + step, 0.5]], device="cpu"))

    out = drive_oval.drive(solver, params, cost_params, costmap, 3,
                           log=lambda m: None, tick_params=tick_params)
    assert np.isfinite(out["controls"]).all()
    assert seen[0] is None                      # the untimed first solve
    assert [float(o[0, 1]) for o in seen[1:]] == [4.0, 5.0, 6.0]


def test_drive_oval_entry_point_with_bf_and_obstacles():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = REPO
    run = lambda *extra: subprocess.run(
        [sys.executable, "-m", "autorally_tpu_torch.drive_oval", "--cpu",
         "--steps", "2", "--rollouts", "32", *extra],
        capture_output=True, text=True, timeout=300, cwd=REPO, env=env)
    out = run("--bf", "--obstacles", "30.3,4,0.5;29.5,7,0.5")
    assert out.returncode == 0, out.stderr
    assert "seeded theta" in out.stdout
    assert "obstacles: [[30.3, 4.0, 0.5], [29.5, 7.0, 0.5]]" in out.stdout
    assert "solve latency" in out.stdout
    bad = run("--obstacles", "1,2")
    assert bad.returncode == 2 and "x,y,r" in bad.stderr
