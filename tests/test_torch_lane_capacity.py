"""The capacity mode in the lanes of a stacked ``CostParams``, and the lane
forms of the libraries of other MLP specs, other fields and bf16 operands,
on the CPU, where the lane forms' wrappers run their plain versions.

The JAX package's kernel-RNG passes draw from the TPU's own PRNG, which has
no CPU lowering, so the capacity mode's oracle is the JAX host-noise path
fed the port's stream (``tests/test_torch_kernel_rng.py``): ``jax.vmap`` of
the JAX ``MPPISolver.iterate`` over a stacked JAX ``CostParams``
(``autorally_tpu.tools.param_sweep.stack_cost_params``), every lane on the
one stream, as the JAX sweep's vmap passes the controller's key unbatched.
Each lane of both passes, of the iteration and of a whole solve is the
port's solo call exactly; a capacity sweep's lanes are their solo episodes
(the solves exactly, the plant within ``LANE_RTOL``: its batched MLP sums
in another order on the CPU).  Kernels 1-3's lane forms at a 6-64-4 MLP,
kernel 3's on a 22-40-20-1 field and kernels 1-3's at
``matmul_precision="default"`` are held lane by lane against the vmapped
JAX kernels in interpret mode (``"default"`` through the emulated MXU of
``tests/test_torch_matmul_precision.py``).  K=256, T=24, L=3.  The CUDA
lane kernels run only on a GPU: ``chip_smoke.py`` phase 35 holds each lane
bit for bit against its solo instance there."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autorally_tpu.config import CostParams as JaxCostParams
from autorally_tpu.costs.obstacles import ObstacleCost as JaxObstacleCost
from autorally_tpu.models import NeuralNetDynamics as JaxNN
from autorally_tpu.ops import rollout_kernel as jrk
from autorally_tpu.solver import mppi as jmppi
from autorally_tpu.tools import param_sweep as jsweep
from autorally_tpu_torch.config import CostParams, MPPIConfig, lane_cost_params
from autorally_tpu_torch.costs import ObstacleCost
from autorally_tpu_torch.models import NeuralNetDynamics
from autorally_tpu_torch.ops import kernel_rng as kr
from autorally_tpu_torch.ops import rollout_kernel as rk
from autorally_tpu_torch.runtime.episode import EpisodeResult, EpisodeRunner
from autorally_tpu_torch.solver import mppi
from autorally_tpu_torch.tools import param_sweep as sweep
from tests.test_torch_field_tile_specs import _fields
from tests.test_torch_lane_circles import (COEFF, INFLATION, LANE_CIRCLES,
                                           _field_pair)
from tests.test_torch_lane_kernels import (COST_ATOL, COST_RTOL, STATE_ATOL,
                                           STATE_RTOL, USEQ_ATOL, L, Lanes)
from tests.test_torch_matmul_precision import (FLIP_ATOL, FLIP_SHARE,
                                               one_pass_bf16)
from tests.test_torch_param_sweep import LANE_ATOL, LANE_RTOL
from tests.test_torch_solver import ITER_ATOL, ITER_RTOL, _assert_stats, _pair

K, T = 256, 24
KEY = torch.tensor([0x2545F491, 0x9E3779B9])
SAMPLERS = {"gaussian": {}, "ou": dict(noise_sampler="ou", noise_param=0.15)}
# every lane its own coefficients, gamma and circles (LANE_CIRCLES: about
# the lanes' starts, so that they change the costs)
GRID = [dict(desired_speed=4.0, speed_coeff=2.5, gamma=0.1),
        dict(desired_speed=6.0, track_coeff=150.0, discount=0.2, gamma=0.15),
        dict(desired_speed=8.0, crash_coeff=5000.0, gamma=0.3)]
# LANE_CIRCLES 1.2 m to the side of the lanes' paths: inside the penalty
# band of the rollouts that veer that way, which some of them cross.  (On
# the paths every rollout runs into them: a swarm that crashes whole
# prices each rollout near 1e4, whose float32 rounding, times gamma, moves
# the weights by more than the iteration's tolerance.)
CIRCLES = LANE_CIRCLES + np.float32([1.2, 0.0, 0.0]) * (
    LANE_CIRCLES[..., 2:] > 0)


def _rig(sampler, surface):
    """Both packages' capacity solvers with an ``ObstacleCost`` (a free
    slot of its own; each lane's circles ride its ``CostParams``), the
    surface (the ppm=2 oval, or the seeded 34-64-64-1 field under its
    crash boundary), the stacked ``CostParams`` of both, and L start
    states and plans about (25, 0)."""
    solver, params, cm, jsolver, jparams, jcm = _pair(K=K, T=T,
                                                      **SAMPLERS[sampler])
    own = np.full((4, 3), -1.0, np.float32)
    port = mppi.MPPISolver(solver.model,
                           ObstacleCost(torch.tensor(own), COEFF, INFLATION),
                           solver.cfg.replace(kernel_rng=True), device="cpu")
    assert port._use_kernel_rng(cm)
    jport = jmppi.MPPISolver(jsolver.model,
                             JaxObstacleCost(jnp.asarray(own), COEFF,
                                             INFLATION), jsolver.cfg)
    if surface == "field":
        cm, jcm = _field_pair(scale=0.4, shift=-0.05)
    grid = [dict(pt, obstacles=CIRCLES[i]) for i, pt in enumerate(GRID)]
    rs = np.random.default_rng(1)
    base = np.array([25.0, 0.0, np.pi / 2, 0.0, 6.0, 0.0, 0.0], np.float32)
    state = (base + rs.normal(0, 0.3, (L, 7)).astype(np.float32)
             * np.float32([1, 1, 0.1, 0, 1, 0, 0]))
    U = np.tile(np.float32([0.0, 0.3]), (L, T, 1))
    U[..., 0] = rs.uniform(-0.3, 0.3, (L, T))
    return dict(port=port, jsolver=jport, params=params, jparams=jparams,
                cm=cm, jcm=jcm, cp=sweep.stack_cost_params(CostParams(), grid),
                jcp=jsweep.stack_cost_params(JaxCostParams(), grid),
                state=state, U=U)


def _lane_carries(cs):
    return cs._replace(**{n: getattr(cs, n).expand(L, *getattr(
        cs, n).shape).clone() for n in ("U", "control_hist",
                                        "state_solution",
                                        "control_solution")})


@pytest.mark.parametrize("surface", ["exact", "field"])
@pytest.mark.parametrize("sampler", list(SAMPLERS))
def test_each_lane_is_the_solo_capacity_call_exactly(sampler, surface):
    """Pass 1's lane form (costs and crash flags), pass 2's (the
    numerator on seeded weights), the iteration (U_new and all six
    ``SolveStats``, each lane at its own gamma) and a whole solve, each
    lane ``torch.equal`` to the solo call with that lane's ``CostParams``,
    start, plan and circles, on the one stream."""
    r = _rig(sampler, surface)
    port, params, cm, cp = r["port"], r["params"], r["cm"], r["cp"]
    state, U = torch.tensor(r["state"]), torch.tensor(r["U"])
    total, crash, ctx = rk.fused_rng_costs_lanes(
        port.model, params, port.cfg, cp, cm, state, U, KEY,
        **port._obstacle_kwargs(cp))
    assert total.shape == crash.shape == (L, K) and ctx.U.shape == (L, T, 2)
    w = torch.tensor(np.random.default_rng(4).uniform(0, 1, (L, K))
                     .astype(np.float32))
    numer = rk.fused_rng_numer_lanes(ctx, w)
    assert numer.shape == (L, 2, T)
    U_new, stats = port._iterate_kernel_rng(params, cp, cm, state, U, KEY)
    U_plain, total_plain, _ = rk.fused_rng_solve_iteration_lanes_plain(
        port.model, params, port.cfg, cp, cm, state, U, KEY,
        **port._obstacle_kwargs(cp))
    assert torch.equal(U_plain, U_new) and torch.equal(total_plain, total)
    cs = port.init_state(0)
    solved, solved_stats = port.solve(params, cp, cm, state,
                                      _lane_carries(cs))
    for lane, cp_l in enumerate(lane_cost_params(cp)):
        kw = port._obstacle_kwargs(cp_l)
        t1, c1, ctx1 = rk.fused_rng_costs(port.model, params, port.cfg, cp_l,
                                          cm, state[lane], U[lane], KEY, **kw)
        assert torch.equal(total[lane], t1) and torch.equal(crash[lane], c1)
        assert torch.equal(numer[lane], rk.fused_rng_numer(ctx1, w[lane]))
        U1, st1 = port._iterate_kernel_rng(params, cp_l, cm, state[lane],
                                           U[lane], KEY)
        assert torch.equal(U_new[lane], U1)
        one, one_stats = port.solve(params, cp_l, cm, state[lane], cs)
        for name in ("U", "state_solution", "control_solution"):
            assert torch.equal(getattr(solved, name)[lane],
                               getattr(one, name)), name
        assert np.array_equal(solved.key, one.key)
        for name in mppi.SolveStats._fields:
            assert torch.equal(getattr(stats, name)[lane],
                               getattr(st1, name)), name
            assert torch.equal(getattr(solved_stats, name)[lane],
                               getattr(one_stats, name)), name
    # each lane's coefficients, gamma and circles reach its costs
    assert len({float(t.mean()) for t in total}) == L
    assert len({float(e) for e in stats.ess}) == L
    free, _, _ = rk.fused_rng_costs_lanes(port.model, params, port.cfg,
                                          cp.replace(obstacles=None), cm,
                                          state, U, KEY)
    assert all((total[lane] > free[lane]).any() for lane in range(L))
    assert (crash < 1).any()


@pytest.mark.parametrize("surface", ["exact", "field"])
@pytest.mark.parametrize("sampler", list(SAMPLERS))
def test_capacity_lanes_match_the_vmapped_jax_iterate(sampler, surface):
    """U_new and all six ``SolveStats`` of each lane against ``jax.vmap``
    of the JAX ``iterate`` over the stacked JAX ``CostParams``, the states
    and the plans, fed the port's stream (``kr.kernel_noise``), within
    ITER_RTOL / ITER_ATOL."""
    r = _rig(sampler, surface)
    port = r["port"]
    U_new, stats = port._iterate_kernel_rng(
        r["params"], r["cp"], r["cm"], torch.tensor(r["state"]),
        torch.tensor(r["U"]), KEY)
    eps = jnp.asarray(kr.kernel_noise(
        KEY, 0, K, T, SAMPLERS[sampler].get("noise_param")).numpy())
    jU, jstats = jax.vmap(lambda c, st, u: r["jsolver"].iterate(
        r["jparams"], c, r["jcm"], st, u, eps))(
        r["jcp"], jnp.asarray(r["state"]), jnp.asarray(r["U"]))
    assert U_new.shape == jU.shape == (L, T, 2)
    for lane in range(L):
        np.testing.assert_allclose(U_new[lane].numpy(), np.asarray(jU[lane]),
                                   rtol=ITER_RTOL, atol=ITER_ATOL)
        _assert_stats(mppi.SolveStats(*(v[lane] for v in stats)),
                      jax.tree_util.tree_map(lambda x: x[lane], jstats),
                      ITER_RTOL, ITER_ATOL)
    assert all(1.0 < float(e) < K for e in stats.ess)


def test_capacity_sweep_lanes_are_their_solo_episodes():
    """A 3-lane sweep (``run_sweep``) of a runner whose solver has
    ``kernel_rng=True``, 3 ticks: each lane against the solo capacity
    episode with that lane's ``CostParams``: the first tick's solve (its
    executed control, trajectory cost and ESS) and the arbitration, the
    crash fractions and gamma exactly, the rest within LANE_RTOL /
    LANE_ATOL (the CPU plant's batched MLP)."""
    cfg = MPPIConfig(num_rollouts=64, num_timesteps=16, kernel_rng=True)
    model = NeuralNetDynamics(cfg.dt, control_ranges=cfg.control_ranges,
                              device="cpu")
    params = model.init_params(0)
    r = _rig("gaussian", "exact")
    solver = mppi.MPPISolver(model, r["port"].cost, cfg, device="cpu")
    runner = EpisodeRunner(solver, n_ticks=3)
    start = np.array([25.0, 0.0, math.pi / 2, 0, 2, 0, 0], np.float32)
    res = sweep.run_sweep(runner, params, r["cp"], r["cm"], start)
    assert res.states.shape == (L, 3, 7)
    for lane, cp_l in enumerate(lane_cost_params(r["cp"])):
        solo = runner.run(params, cp_l, r["cm"], start)
        for field in EpisodeResult._fields:
            a, b = getattr(res, field)[lane], getattr(solo, field)
            if field in ("used_actual", "crash_frac", "gamma"):
                assert torch.equal(a, b), field
            else:
                torch.testing.assert_close(a, b, rtol=LANE_RTOL,
                                           atol=LANE_ATOL, msg=field)
            if field in ("controls", "trajectory_cost", "ess"):
                assert torch.equal(a[0], b[0]), field
    assert len({float(v) for v in res.states[:, -1, 4]}) == L


# ---------------------------------------------------------------------------
# the lane forms of the other libraries' kernels 1-3
# ---------------------------------------------------------------------------

WIDE = (6, 64, 4)


def _models(s, case):
    """(port model, params, cfg, JAX model, JAX params, JAX config) of
    ``case``: the 6-64-4 MLP, or the fixture's 6-32-32-4 at
    ``"default"`` (the JAX kernels' precision argument, their config's
    too)."""
    if case == "wide":
        jm = JaxNN(s.jcfg.dt, layers=WIDE,
                   control_ranges=s.jcfg.control_ranges)
        jp = jm.init_params(jax.random.PRNGKey(2))
        m = NeuralNetDynamics(s.cfg.dt, layers=WIDE,
                              control_ranges=s.cfg.control_ranges,
                              device="cpu")
        return (m, m.params_from_jax(jax.tree_util.tree_map(np.asarray, jp)),
                s.cfg, jm, jp, s.jcfg.replace(use_pallas_rollout=True))
    return (s.model, s.params, s.cfg.replace(matmul_precision="default"),
            s.jmodel, s.jparams, s.jcfg.replace(matmul_precision="default",
                                                use_pallas_rollout=True))


@pytest.fixture(scope="module")
def lanes():
    return Lanes()


@pytest.mark.parametrize("kernel,case", [
    (1, "wide"), (2, "wide"), (3, "wide"), (3, "F5-40-20"), (1, "default"),
    (2, "default"), (3, "default")])
def test_other_library_lanes_match_the_vmapped_jax_kernels(lanes, kernel,
                                                           case):
    """Kernels 1-3's lane forms (plain) at a 6-64-4 MLP, kernel 3's on a
    22-40-20-1 field and kernels 1-3's at ``"default"``, each lane against
    the JAX kernel vmapped over the lanes in interpret mode (at
    ``"default"`` on the emulated MXU) at ``tests/test_torch_lane_kernels
    .py``'s tolerances (kernel 2 at ``"default"`` by
    ``tests/test_torch_matmul_precision.py``'s flip rule for it), and
    exactly the port's solo plain call."""
    s = lanes
    m, p, cfg, jm, jp, jcfg = _models(s, "wide" if case == "wide"
                                      else "default")
    if case == "F5-40-20":
        m, p, cfg, jm, jp = s.model, s.params, s.cfg, s.jmodel, s.jparams
        jcfg = s.jcfg.replace(use_pallas_rollout=True)
    prec = "default" if case == "default" else None
    jprec = {"precision": "default"} if prec else {}
    if kernel == 3:
        field, jfield = (_fields(rk.KERNEL_LAYERS, case) if case == "F5-40-20"
                         else _field_pair())
    state, U, eps = s.torch_args()
    jeps = jnp.asarray(s.eps)
    lanes_cp = lane_cost_params(s.cp)
    if kernel == 2:
        out = rk.dynamics_chain_lanes(m, p, cfg, state, U, eps,
                                      precision=prec)
        solo = [rk.dynamics_chain(m, p, cfg, state[i], U[i], eps,
                                  precision=prec) for i in range(L)]

        def jax_lane(cp, st, u):
            return jrk.dynamics_chain_pallas(jm, jp, jcfg, st, u, jeps,
                                             interpret=True, **jprec)
    else:
        surface, jsurface = ((s.cm, s.jcm) if kernel == 1
                             else (field, jfield))
        lanes_fn = (rk.fused_exact_rollout_cost_lanes if kernel == 1
                    else rk.fused_rollout_cost_lanes)
        solo_fn = (rk.fused_exact_rollout_cost if kernel == 1
                   else rk.fused_rollout_cost)
        jfn = (jrk.fused_exact_rollout_cost_pallas if kernel == 1
               else jrk.fused_rollout_cost_pallas)
        out = lanes_fn(m, p, cfg, s.cp, surface, state, U, eps,
                       precision=prec)
        solo = [solo_fn(m, p, cfg, lanes_cp[i], surface, state[i], U[i], eps,
                        precision=prec) for i in range(L)]

        def jax_lane(cp, st, u):
            return jfn(jm, jp, jcfg, cp, jsurface, st, u, jeps,
                       interpret=True, **jprec)

    vmapped = jax.vmap(jax_lane, in_axes=(0 if kernel != 2 else None, 0, 0))
    args = (s.jcp, jnp.asarray(s.state), jnp.asarray(s.U))
    if prec:
        with one_pass_bf16():
            ref = vmapped(*args)
    else:
        ref = vmapped(*args)
    ref = tuple(np.asarray(x) for x in ref)
    for lane in range(L):
        for a, b in zip(out, solo[lane]):
            assert torch.equal(a[lane], b)
        if kernel == 2:
            states, u_seq = out
            got, want = states[lane].numpy(), ref[0][lane, :m.STATE_DIM]
            if prec:
                # test_torch_matmul_precision.py's rule for kernel 2 at
                # "default": a bf16 operand on the other side of a rounding
                # boundary in the two packages flips a few rollouts
                near = np.isclose(got, want, rtol=STATE_RTOL,
                                  atol=STATE_ATOL).all(axis=(0, 1))
                assert (~near).sum() <= FLIP_SHARE * K, (~near).sum()
                np.testing.assert_allclose(got, want, rtol=0, atol=FLIP_ATOL)
            else:
                np.testing.assert_allclose(got, want, rtol=STATE_RTOL,
                                           atol=STATE_ATOL)
            np.testing.assert_allclose(u_seq[lane].numpy(), ref[1][lane],
                                       rtol=0, atol=USEQ_ATOL)
            continue
        costs, u_seq, crash = out
        np.testing.assert_allclose(costs[lane].numpy(), ref[0][lane],
                                   rtol=COST_RTOL, atol=COST_ATOL)
        np.testing.assert_array_equal(crash[lane].numpy(), ref[2][lane])
        np.testing.assert_allclose(u_seq[lane].numpy(), ref[1][lane],
                                   rtol=0, atol=USEQ_ATOL)
    if kernel != 2:
        assert len({float(c.mean()) for c in out[0]}) == L
