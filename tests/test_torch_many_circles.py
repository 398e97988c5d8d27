"""Circles past the 64 slots the CUDA kernels stage in shared memory
(ROADMAP Queue 2 A5) on the CPU, where the wrappers run their plain
versions: kernel 1 (MLP and BF), kernel 3 (MLP and BF, on the small field
of ``tests/test_torch_neural_costmap.py``) and pass 1 (exact MLP and BF,
field) at 65 and 96 slots, with free slots, a NaN coordinate and a NaN
radius among them, against the JAX Pallas kernels in interpret mode (pass
1 in TPU interpret mode with zero exploration noise: the JAX kernel draws
from the TPU's own PRNG); kernels 1 and 3's lane forms at L=3 with 96 slots
a lane against the JAX kernels vmapped over the lanes; ``iterate`` in both
modes with 96 slots against the JAX solver; the launch of such slots on
the library (faked: the CUDA kernels run only on a GPU, where
``chip_smoke.py`` phase 36 holds them against these plain versions) and
the source's staging rule.

Seeded weights carried with ``params_from_jax``, numpy noise, K=256, T=24.
Tolerances: ``tests/test_torch_obstacles.py``'s (the exact kernel 2e-5 /
1e-4, the field 2e-4 / 1e-3: its fp32 sums in another order), u_seq and
crash flags exactly; the lanes and the iterate at the tolerances of
``tests/test_torch_lane_kernels.py`` and ``tests/test_torch_obstacles.py``.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from autorally_tpu.config import CostParams as JaxCostParams
from autorally_tpu.costs.obstacles import ObstacleCost as JaxObstacleCost
from autorally_tpu.costs.obstacles import make_obstacles as jax_make_obstacles
from autorally_tpu.models import BasisFunctionDynamics as JaxBF
from autorally_tpu.ops import rollout_kernel as jrk
from autorally_tpu_torch.config import CostParams, lane_cost_params
from autorally_tpu_torch.costs import ObstacleCost, make_obstacles
from autorally_tpu_torch.models import BasisFunctionDynamics
from autorally_tpu_torch.ops import _build
from autorally_tpu_torch.ops import kernel_rng as kr
from autorally_tpu_torch.ops import rollout_kernel as rk
from tests.test_torch_lane_circles import _field_pair, _hold_lanes
from tests.test_torch_lane_kernels import L, Lanes
from tests.test_torch_obstacles import (CIRCLES, COEFF, INFLATION, ITER_ATOL,
                                        ITER_RTOL, KEY, TOL, WIDE, _inputs,
                                        _pair, _surfaces)
from tests.test_torch_rng_specs import QUIET
from tests.test_torch_solver import _assert_stats

SLOTS = (65, 96)
LANE_SLOTS = 96


def _many(base, slots: int, seed: int) -> np.ndarray:
    """(slots, 3): the circles ``base`` in the last slots (past the 64 the
    kernels stage), the others scattered 4-12 m from the first of them
    with radii 0.1-0.5 m, every fourth slot free (radius -1); slot 1 holds
    a free circle at a NaN x, slot 2 a NaN radius (an inactive slot in both
    packages)."""
    base = np.float32(base)
    rs = np.random.default_rng(seed)
    ang = rs.uniform(0.0, 2.0 * np.pi, slots)
    dist = rs.uniform(4.0, 12.0, slots)
    out = np.stack([base[0, 0] + dist * np.cos(ang),
                    base[0, 1] + dist * np.sin(ang),
                    rs.uniform(0.1, 0.5, slots)], axis=1).astype(np.float32)
    out[3::4, 2] = -1.0
    out[1] = [np.nan, 0.0, -1.0]
    out[2, 2] = np.nan
    out[slots - len(base):] = base
    return out


def _model(kind, solver, params):
    """(port model, params, JAX model, JAX params) of ``kind``: the
    solver's seeded MLP, or the BF model's seeded theta."""
    if kind == "nn":
        return solver.model, params, None, None
    jm = JaxBF(solver.cfg.dt)
    jp = jm.init_params(jax.random.PRNGKey(0))
    tm = BasisFunctionDynamics(solver.cfg.dt, device="cpu")
    return tm, tm.params_from_jax(jax.tree_util.tree_map(np.asarray, jp)), \
        jm, jp


# ---------------------------------------------------------------------------
# kernels 1 and 3 and pass 1 against the JAX kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("slots", SLOTS)
@pytest.mark.parametrize("kind", ["nn", "bf"])
@pytest.mark.parametrize("surface", ["exact", "field"])
def test_fused_kernels_with_many_slots_match_the_jax_kernels(surface, kind,
                                                             slots):
    """Kernel 1 (exact) and kernel 3 (field) with ``slots`` circles, the
    two hit ones in the last slots, against the interpret-mode Pallas
    kernels given the same circles: costs within ``TOL``, u_seq and crash
    flags exactly; the circles crash rollouts that the free run does
    not."""
    solver, params, jsolver, jparams = _pair(**WIDE)
    model, prm, jmodel, jprm = _model(kind, solver, params)
    jmodel = jsolver.model if jmodel is None else jmodel
    jprm = jparams if jprm is None else jprm
    port_surface, jax_surface = _surfaces(surface)
    state, U, eps = _inputs()
    circles = _many(CIRCLES, slots, seed=slots)
    kw = dict(obstacle_coeff=COEFF, inflation=INFLATION)
    wrapper = {"exact": rk.fused_exact_rollout_cost,
               "field": rk.fused_rollout_cost}[surface]
    costs, u_seq, crash = wrapper(
        model, prm, solver.cfg, CostParams(), port_surface,
        torch.tensor(state), torch.tensor(U), torch.tensor(eps),
        obstacles=torch.tensor(circles), **kw)
    pallas = {"exact": jrk.fused_exact_rollout_cost_pallas,
              "field": jrk.fused_rollout_cost_pallas}[surface]
    jc, ju, jx = pallas(jmodel, jprm, jsolver.cfg, JaxCostParams(),
                        jax_surface, jnp.asarray(state), jnp.asarray(U),
                        jnp.asarray(eps), interpret=True,
                        obstacles=jnp.asarray(circles), **kw)
    rtol, atol = TOL[surface]
    np.testing.assert_allclose(costs.numpy(), np.asarray(jc), rtol=rtol,
                               atol=atol)
    np.testing.assert_array_equal(crash.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(u_seq.numpy(), np.asarray(ju))
    assert np.isfinite(costs.numpy()).all()
    free, _, free_crash = wrapper(
        model, prm, solver.cfg, CostParams(), port_surface,
        torch.tensor(state), torch.tensor(U), torch.tensor(eps))
    assert int(free_crash.sum()) < int(crash.sum())


@pytest.mark.parametrize("slots", SLOTS)
@pytest.mark.parametrize("form", ["exact_nn", "exact_bf", "field_nn"])
def test_pass1_with_many_slots_matches_the_jax_kernel(form, slots):
    """Pass 1 (exact MLP and BF, field MLP) with ``slots`` circles against
    the JAX ``fused_rng_costs`` in TPU interpret mode with zero exploration
    noise (the two streams cannot matter): costs within ``TOL``, crash
    flags exactly; the circles crash some rollouts."""
    surface, kind = form.split("_")
    solver, params, jsolver, jparams = _pair(**QUIET)
    model, prm, jmodel, jprm = _model(kind, solver, params)
    jmodel = jsolver.model if jmodel is None else jmodel
    jprm = jparams if jprm is None else jprm
    port_surface, jax_surface = _surfaces(surface)
    state, U, _ = _inputs()
    circles = _many(CIRCLES, slots, seed=slots + 1)
    kw = dict(obstacle_coeff=COEFF, inflation=INFLATION)
    cp = CostParams(desired_speed=6.0)
    total, crash, _ = rk.fused_rng_costs(
        model, prm, solver.cfg, cp, port_surface, torch.tensor(state),
        torch.tensor(U), KEY, obstacles=torch.tensor(circles), **kw)
    jtotal, jcrash, _ = jrk.fused_rng_costs(
        jmodel, jprm, jsolver.cfg.replace(use_pallas_rollout=True),
        JaxCostParams(desired_speed=6.0), jax_surface, jnp.asarray(state),
        jnp.asarray(U), jax.random.PRNGKey(3),
        interpret=pltpu.InterpretParams(), obstacles=jnp.asarray(circles),
        **kw)
    rtol, atol = TOL[surface]
    np.testing.assert_allclose(total.numpy(), np.asarray(jtotal), rtol=rtol,
                               atol=atol)
    np.testing.assert_array_equal(crash.numpy(), np.asarray(jcrash))
    assert np.isfinite(total.numpy()).all()
    assert int(crash.sum()) > 0


# ---------------------------------------------------------------------------
# the lane forms against the vmapped JAX kernels
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def lanes():
    return Lanes()


def _lane_circles(s):
    """(L, 96, 3): each lane's circles about its own start, three of them
    ahead in its lane, in the last slots."""
    out = []
    for i in range(L):
        x, y = s.state[i, 0], s.state[i, 1]
        ahead = [[x, y + 1.5, 0.5], [x + 0.6, y + 2.4, 0.4],
                 [x - 0.7, y + 0.9, 0.3]]
        out.append(_many(ahead, LANE_SLOTS, seed=10 + i))
    return np.stack(out)


@pytest.mark.parametrize("kernel", [1, 3])
def test_lane_forms_with_many_slots_match_the_vmapped_jax_kernels(lanes,
                                                                  kernel):
    """Kernel 1's (on the map) and kernel 3's (on the field) lane forms
    with 96 slots a lane against the JAX kernels vmapped over the lanes in
    interpret mode (``_hold_lanes``: costs within the lane tests'
    tolerances, crash flags exactly, u_seq within USEQ_ATOL; each lane
    exactly the port's solo plain call); the circles change the costs."""
    s = lanes
    state, U, eps = s.torch_args()
    obs = _lane_circles(s)
    kw = dict(obstacle_coeff=COEFF, inflation=INFLATION)
    if kernel == 1:
        surface, jsurface = s.cm, s.jcm
        port, solo = rk.fused_exact_rollout_cost_lanes, \
            rk.fused_exact_rollout_cost
        pallas = jrk.fused_exact_rollout_cost_pallas
    else:
        surface, jsurface = _field_pair()
        port, solo = rk.fused_rollout_cost_lanes, rk.fused_rollout_cost
        pallas = jrk.fused_rollout_cost_pallas
    out = port(s.model, s.params, s.cfg, s.cp, surface, state, U, eps,
               obstacles=torch.tensor(obs), **kw)

    def jax_lane(cp, st, u, ob):
        return pallas(s.jmodel, s.jparams, s.jcfg, cp, jsurface, st, u,
                      jnp.asarray(s.eps), interpret=True, obstacles=ob, **kw)

    ref = jax.vmap(jax_lane)(s.jcp, jnp.asarray(s.state), jnp.asarray(s.U),
                             jnp.asarray(obs))
    lanes_cp = lane_cost_params(s.cp)
    _hold_lanes(out, ref, lambda i: solo(
        s.model, s.params, s.cfg, lanes_cp[i], surface, state[i], U[i], eps,
        obstacles=torch.tensor(obs[i]), **kw))
    free = port(s.model, s.params, s.cfg, s.cp, surface, state, U, eps)
    assert (out[0] != free[0]).any()


# ---------------------------------------------------------------------------
# the solver
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["host_noise", "capacity"])
def test_iterate_with_many_slots_matches_jax(mode):
    """One iteration with an ObstacleCost of 96 slots in both packages
    (the two hit circles in the last slots): U_new and the stats within
    ITER_RTOL / ITER_ATOL (``tests/test_torch_obstacles.py``'s)."""
    solver, params, jsolver, jparams = _pair(kernel_rng=mode == "capacity")
    circles = _many(CIRCLES, LANE_SLOTS, seed=7)
    solver.cost = ObstacleCost(make_obstacles(circles, LANE_SLOTS,
                                              device="cpu"), COEFF, INFLATION)
    jsolver.cost = JaxObstacleCost(jax_make_obstacles(circles, LANE_SLOTS),
                                   COEFF, INFLATION)
    cm, jcm = _surfaces("exact")
    state, U, eps = _inputs()
    cp = CostParams(desired_speed=6.0)
    args = (torch.tensor(state), torch.tensor(U))
    if mode == "capacity":
        assert solver._use_kernel_rng(cm)
        U_new, stats = solver._iterate_kernel_rng(params, cp, cm, *args, KEY)
        eps = kr.kernel_noise(KEY, 0, solver.cfg.num_rollouts,
                              solver.cfg.num_timesteps, None).numpy()
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


# ---------------------------------------------------------------------------
# the launch and the source
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("prepare", [
    "prepare_fused_exact_rollout_cost", "prepare_fused_rollout_cost",
    "prepare_fused_rng_costs", "prepare_fused_exact_rollout_cost_lanes",
    "prepare_fused_rollout_cost_lanes", "prepare_fused_rng_costs_lanes"])
def test_many_slots_prepare_on_the_library(prepare, lanes, monkeypatch):
    """Each wrapper prepares a launch of 96 slots on the library (faked:
    nothing runs) under the name of its obstacle instance, with the
    circles packed [x..., y..., radius...] a lane for the kernel to read
    in device memory, none of them staged."""

    class Lib:
        def __getattr__(self, name):
            return lambda *a: 0

    monkeypatch.setattr(rk, "_kernel_lib", lambda *a: Lib())
    monkeypatch.setattr(rk, "num_sms", lambda index: 132)
    s = lanes
    state, U, eps = s.torch_args()
    obs = torch.tensor(_lane_circles(s))
    field, _ = _field_pair()
    kw = dict(obstacle_coeff=COEFF, inflation=INFLATION)
    fn = getattr(rk, prepare)
    surface = (field if "rollout_cost" in prepare and "exact" not in prepare
               else s.cm)
    cfg = s.cfg.replace(kernel_rng=True) if "rng" in prepare else s.cfg
    last = KEY if "rng" in prepare else eps
    if prepare.endswith("_lanes"):
        res = fn(s.model, s.params, cfg, s.cp, surface, state, U, last,
                 obstacles=obs, **kw)
        want = (L, 3 * LANE_SLOTS)
    else:
        res = fn(s.model, s.params, cfg, lane_cost_params(s.cp)[0], surface,
                 state[0], U[0], last, obstacles=obs[0], **kw)
        want = (3 * LANE_SLOTS,)
    launch = res[0]
    assert "_obstacles" in launch.name
    packed = [t for t in _tensors(launch.inputs) if t.numel() == np.prod(
        want)]
    assert packed
    xs = packed[-1].reshape(want)[..., :LANE_SLOTS]     # [x..., y..., r...]
    first = obs[0] if len(want) == 1 else obs
    assert torch.allclose(xs, first[..., 0], equal_nan=True)
    assert rk.staged_obstacles(LANE_SLOTS) == 0


def _tensors(x):
    """The tensors in a launch's kept inputs, depth first."""
    if torch.is_tensor(x):
        return [x]
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    return []


def test_the_kernels_stage_64_slots_and_read_the_rest():
    """The source stages up to kMaxObstacles circles (the wrapper's
    MAX_OBSTACLES) and none past it (staged_obstacles, mirrored by
    ``rk.staged_obstacles``); every launcher refuses only a negative
    n_obs; the step reads the staged copy up to kMaxObstacles, else the
    device copy through __ldg."""
    src = _build.SOURCE.read_text()
    assert re.search(r"constexpr int kMaxObstacles = (\d+);",
                     src).group(1) == str(rk.MAX_OBSTACLES)
    assert "return n_obs <= kMaxObstacles ? n_obs : 0;" in src
    assert [rk.staged_obstacles(n) for n in (0, 16, 64, 65, 1024)] == \
        [0, 16, 64, 0, 0]
    assert "n_obs > kMaxObstacles" not in src
    assert src.count("c.n_obs < 0") == 8
    assert src.count("staged_obstacles(c.n_obs)") == 6
    assert """track += c.n_obs <= kMaxObstacles
                     ? obstacle_cost(c, obs_s, x, y, hit)
                     : obstacle_cost<true>(c, obs_g, x, y, hit);""" in src
    assert "if constexpr (kGlobal) return __ldg(p);" in src
    # the opt-ins still reserve kMaxObstacles circles
    assert src.count("kMaxT, kMaxObstacles), device);") == 3
