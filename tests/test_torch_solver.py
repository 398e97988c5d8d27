"""The port's MPPI solver against the JAX package's, on the CPU: one
iteration with the same noise (U_new and all six SolveStats), the
Savitzky-Golay filter, the receding-horizon slide, and a 3-tick slide +
solve scenario with the same fixed noise injected on both sides (as
``tests/test_regression.py`` runs it, with seeded weights)."""

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
from autorally_tpu.solver import mppi as jmppi
from autorally_tpu.tools.track_generator import oval_track
from autorally_tpu_torch.config import CostParams, MPPIConfig
from autorally_tpu_torch.costs import MPPICost, make_costmap
from autorally_tpu_torch.models import NeuralNetDynamics
from autorally_tpu_torch.ops import kernel_rng
from autorally_tpu_torch.solver import mppi

# Costs agree to ~1e-6 relative (fp32 MLP sums in another order); the
# softmax, its sums and three closed-loop ticks keep that near 1e-6.
ITER_RTOL, ITER_ATOL = 1e-5, 1e-6
SCENARIO_RTOL, SCENARIO_ATOL = 1e-5, 1e-6
SCENARIO_START = np.array([0.0, -15.0, 0.0, 0.0, 2.0, 0.0, 0.0], np.float32)


def _pair(K=256, T=24, ppm=2.0, seed=0, **cfg_kw):
    jcfg = JaxConfig(num_rollouts=K, num_timesteps=T, **cfg_kw)
    cfg = MPPIConfig(num_rollouts=K, num_timesteps=T, **cfg_kw)
    data, xb, yb = oval_track(ppm=ppm)
    jmodel = JaxNN(jcfg.dt, control_ranges=jcfg.control_ranges)
    jparams = jmodel.init_params(jax.random.PRNGKey(seed))
    model = NeuralNetDynamics(cfg.dt, control_ranges=cfg.control_ranges,
                              device="cpu")
    params = model.params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                          jparams))
    jsolver = jmppi.MPPISolver(jmodel, JaxCost(), jcfg)
    solver = mppi.MPPISolver(model, MPPICost(), cfg, device="cpu")
    return (solver, params, make_costmap(data, xb, yb, device="cpu"),
            jsolver, jparams, jax_make_costmap(data, xb, yb))


def _interpret_solver(jsolver):
    """The JAX solver forced through its Pallas kernels in interpret mode
    (as tests/test_obstacles.py does)."""
    js = jmppi.MPPISolver(jsolver.model, jsolver.cost,
                          jsolver.cfg.replace(use_pallas_rollout=True))
    js._pallas_interpret = True
    return js


def _assert_stats(stats, jstats, rtol, atol):
    for name in mppi.SolveStats._fields:
        np.testing.assert_allclose(float(getattr(stats, name)),
                                   float(getattr(jstats, name)),
                                   rtol=rtol, atol=atol, err_msg=name)


@pytest.mark.parametrize("backend", ["scan", "interpret_kernel"])
def test_iterate_matches_jax(backend):
    solver, params, cm, jsolver, jparams, jcm = _pair()
    if backend == "interpret_kernel":
        jsolver = _interpret_solver(jsolver)
    T, K = solver.cfg.num_timesteps, solver.cfg.num_rollouts
    rs = np.random.default_rng(5)
    eps = rs.standard_normal((T, K, 2)).astype(np.float32)
    state = np.array([25.0, 0.0, np.pi / 2, 0.0, 3.0, 0.1, 0.0], np.float32)
    U = np.tile(np.array([0.05, 0.3], np.float32), (T, 1))
    cp = CostParams(desired_speed=6.0)
    U_new, stats = solver.iterate(params, cp, cm, torch.tensor(state),
                                  torch.tensor(U), torch.tensor(eps))
    jU, jstats = jsolver.iterate(jparams, JaxCostParams(desired_speed=6.0),
                                 jcm, jnp.asarray(state), jnp.asarray(U),
                                 jnp.asarray(eps))
    np.testing.assert_allclose(U_new.numpy(), np.asarray(jU),
                               rtol=ITER_RTOL, atol=ITER_ATOL)
    _assert_stats(stats, jstats, ITER_RTOL, ITER_ATOL)
    assert 1.0 < float(stats.ess) < K


def test_iterate_gamma_override_matches_jax():
    solver, params, cm, jsolver, jparams, jcm = _pair(K=128, T=16)
    rs = np.random.default_rng(6)
    eps = rs.standard_normal((16, 128, 2)).astype(np.float32)
    state = np.array([25.0, 0.0, np.pi / 2, 0.0, 3.0, 0.0, 0.0], np.float32)
    U = np.zeros((16, 2), np.float32)
    _, stats = solver.iterate(params, CostParams(gamma=0.02), cm,
                              torch.tensor(state), torch.tensor(U),
                              torch.tensor(eps))
    _, jstats = jsolver.iterate(jparams, JaxCostParams(gamma=0.02), jcm,
                                jnp.asarray(state), jnp.asarray(U),
                                jnp.asarray(eps))
    _assert_stats(stats, jstats, ITER_RTOL, ITER_ATOL)


def test_savitzky_golay_matches_jax():
    rs = np.random.default_rng(7)
    U = rs.standard_normal((40, 2)).astype(np.float32)
    hist = rs.standard_normal((2, 2)).astype(np.float32)
    got = mppi.savitzky_golay(torch.tensor(U), torch.tensor(hist)).numpy()
    ref = np.asarray(jmppi.savitzky_golay(jnp.asarray(U), jnp.asarray(hist)))
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(mppi.SAVGOL_FILTER, jmppi.SAVGOL_FILTER)


@pytest.mark.parametrize("stride", [0, 1, 2, 3, 23, 24, 30])
def test_slide_matches_jax(stride):
    """Including the odd-stride history quirk and strides >= T."""
    solver, _, _, jsolver, _, _ = _pair(T=24)
    rs = np.random.default_rng(stride)
    U = rs.standard_normal((24, 2)).astype(np.float32)
    hist = rs.standard_normal((2, 2)).astype(np.float32)
    ss = rs.standard_normal((24, 7)).astype(np.float32)
    cs = solver.init_state()._replace(
        U=torch.tensor(U), control_hist=torch.tensor(hist),
        state_solution=torch.tensor(ss))
    jcs = jsolver.init_state()._replace(
        U=jnp.asarray(U), control_hist=jnp.asarray(hist),
        state_solution=jnp.asarray(ss))
    out, jout = solver.slide(cs, stride), jsolver.slide(jcs, stride)
    for name in ("U", "control_hist", "state_solution", "control_solution"):
        np.testing.assert_array_equal(getattr(out, name).numpy(),
                                      np.asarray(getattr(jout, name)),
                                      err_msg=name)


@pytest.mark.parametrize("backend", ["scan", "interpret_kernel"])
def test_three_tick_scenario_matches_jax(backend):
    """slide + solve three times from the regression scenario's start
    (K=256, T=32, ppm=4), the same fixed noise on both sides."""
    solver, params, cm, jsolver, jparams, jcm = _pair(K=256, T=32, ppm=4.0,
                                                      seed=1234)
    if backend == "interpret_kernel":
        jsolver = _interpret_solver(jsolver)
    eps = np.random.default_rng(11).standard_normal((32, 256, 2)).astype(
        np.float32)
    solver._sample_noise = lambda gen, shape: torch.tensor(eps)
    jsolver._sample_noise = lambda key, shape: jnp.asarray(eps)
    cs, jcs = solver.init_state(), jsolver.init_state()
    for _ in range(3):
        cs = solver.slide(cs, 1)
        cs, stats = solver.solve(params, CostParams(desired_speed=5.0), cm,
                                 SCENARIO_START, cs)
        jcs = jsolver.slide(jcs, 1)
        jcs, jstats = jsolver.solve(jparams, JaxCostParams(desired_speed=5.0),
                                    jcm, SCENARIO_START, jcs)
    for name in ("U", "control_hist", "control_solution", "state_solution"):
        np.testing.assert_allclose(getattr(cs, name).numpy(),
                                   np.asarray(getattr(jcs, name)),
                                   rtol=SCENARIO_RTOL, atol=SCENARIO_ATOL,
                                   err_msg=name)
    _assert_stats(stats, jstats, SCENARIO_RTOL, SCENARIO_ATOL)
    assert np.isfinite(cs.U.numpy()).all()


def test_solve_from_a_nan_speed_is_finite_and_matches_eager_jax():
    """A solve from a state whose u_x is NaN: every rollout latches at the
    1e12 clamp, so the weights are all 1; U and the control solution stay
    finite, and the stats equal the JAX solver's run eagerly (under
    ``jax.disable_jit()``: jitted, XLA computes the costs' minimum and the
    exponent's costs apart and the normalizer overflows; ROADMAP.md, Queue
    3).  The same noise on both sides, picked by the subkey."""
    solver, params, cm, jsolver, jparams, jcm = _pair(K=64, T=12)
    T, K = solver.cfg.num_timesteps, solver.cfg.num_rollouts
    table = np.random.default_rng(2).standard_normal(
        (4, T, K, 2)).astype(np.float32)
    solver._sample_noise = lambda gen, shape: torch.tensor(
        table[(gen.initial_seed() & 0xFFFFFFFF) % 4])
    jsolver._sample_noise = lambda key, shape: jnp.asarray(
        table[int(key[1]) % 4])
    state = np.array([25.0, 0.0, np.pi / 2, 0.0, np.nan, 0.1, 0.0],
                     np.float32)
    cs, stats = solver.solve(params, CostParams(), cm, state,
                             solver.init_state(7))
    with jax.disable_jit():
        jcs, jstats = jsolver.solve(jparams, JaxCostParams(), jcm,
                                    jnp.asarray(state),
                                    jsolver.init_state(7))
    assert torch.isfinite(cs.U).all()
    assert torch.isfinite(cs.control_solution).all()
    assert float(stats.normalizer) == K == float(stats.ess)
    assert float(stats.crash_frac) == 1.0
    _assert_stats(stats, jstats, ITER_RTOL, ITER_ATOL)
    np.testing.assert_allclose(cs.U.numpy(), np.asarray(jcs.U),
                               rtol=ITER_RTOL, atol=ITER_ATOL)


def test_controller_state_helpers():
    solver, params, cm, *_ = _pair(K=128, T=16, init_throttle=0.2)
    a, b = solver.init_state(), solver.init_state()
    np.testing.assert_array_equal(a.key, b.key)
    assert a.key.dtype == np.uint32 and a.key.shape == (2,)
    # a solve returns the split key and leaves its input state as it was
    key = a.key.copy()
    out, _ = solver.solve(params, CostParams(), cm, SCENARIO_START, a)
    np.testing.assert_array_equal(a.key, key)
    np.testing.assert_array_equal(out.key, kernel_rng.split(key)[0])
    shape = (16, 128, 2)
    first = solver._sample_noise(solver._noise_generator(a.key), shape)
    assert torch.equal(first, solver._sample_noise(
        solver._noise_generator(b.key), shape))
    assert not torch.equal(first, solver._sample_noise(
        solver._noise_generator(out.key), shape))
    assert first.dtype == torch.float32 and first.shape == shape
    assert a.U.shape == (16, 2) and torch.all(a.U[:, 1] == 0.2)
    moved = a._replace(U=torch.ones(16, 2))
    assert torch.equal(solver.reset_controls(moved).U, a.U)
    assert solver.with_rollouts(128) is solver
    small = solver.with_rollouts(64)
    assert small.cfg.num_rollouts == 64 and small.model is solver.model
    mppi.validate_tube_pair(solver, small)
    with pytest.raises(ValueError, match="only in num_rollouts"):
        mppi.validate_tube_pair(solver, mppi.MPPISolver(
            solver.model, solver.cost, solver.cfg.replace(gamma=0.3),
            device="cpu"))
    with pytest.raises(ValueError, match="horizon"):
        mppi.validate_tube_pair(solver, mppi.MPPISolver(
            solver.model, solver.cost, solver.cfg.replace(num_timesteps=8),
            device="cpu"))


@pytest.mark.parametrize("option", [
    dict(kernel_rng=True), dict(noise_sampler="colored"),
    dict(noise_sampler="ou", noise_param=0.15), dict(matmul_precision="default")])
def test_unported_options_raise_and_name_the_roadmap(option):
    """Options once unported construct and solve: the capacity mode,
    colored and OU noise, and ``matmul_precision="default"`` (bf16
    operands in the dynamics' products; a name the JAX package does not
    take raises ``ValueError``); so does a cost subclass, once refused: it
    takes the general path (the chain and the batched cost epilogue) and
    matches the JAX solver's iteration."""
    solver, params, cm, jsolver, jparams, jcm = _pair(K=128, T=16)
    model, cfg = solver.model, solver.cfg
    if "matmul_precision" not in option:
        ported = mppi.MPPISolver(model, MPPICost(), cfg.replace(**option),
                                 device="cpu")
        cs, stats = ported.solve(params, CostParams(), cm, SCENARIO_START,
                                 ported.init_state())
        assert np.isfinite(cs.U.numpy()).all() and cs.U.shape == (16, 2)
        assert 1.0 <= float(stats.ess) <= 128
        return

    class SubCost(MPPICost):
        pass

    class JaxSubCost(JaxCost):
        pass

    default = mppi.MPPISolver(model, MPPICost(), cfg.replace(**option),
                              device="cpu")
    cs, stats = default.solve(params, CostParams(), cm, SCENARIO_START,
                              default.init_state())
    assert np.isfinite(cs.U.numpy()).all() and cs.U.shape == (16, 2)
    assert 1.0 <= float(stats.ess) <= 128
    with pytest.raises(ValueError, match="matmul_precision"):
        mppi.MPPISolver(model, MPPICost(),
                        cfg.replace(matmul_precision="fastest"), device="cpu")
    sub = mppi.MPPISolver(model, SubCost(), cfg, device="cpu")
    jsub = jmppi.MPPISolver(jsolver.model, JaxSubCost(), jsolver.cfg)
    rs = np.random.default_rng(8)
    eps_s = rs.standard_normal((16, 128, 2)).astype(np.float32)
    U_s = np.tile(np.array([0.05, 0.3], np.float32), (16, 1))
    U_new, stats = sub.iterate(params, CostParams(), cm,
                               torch.tensor(SCENARIO_START),
                               torch.tensor(U_s), torch.tensor(eps_s))
    jU, jstats = jsub.iterate(jparams, JaxCostParams(), jcm,
                              jnp.asarray(SCENARIO_START), jnp.asarray(U_s),
                              jnp.asarray(eps_s))
    np.testing.assert_allclose(U_new.numpy(), np.asarray(jU),
                               rtol=ITER_RTOL, atol=ITER_ATOL)
    _assert_stats(stats, jstats, ITER_RTOL, ITER_ATOL)
    state = torch.zeros(7)
    U = torch.zeros(16, 2)
    eps = torch.zeros(16, 128, 2)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        solver.rollout_costs(params, CostParams(), object(), state, U, eps)
    with pytest.raises(NotImplementedError, match="obstacle"):
        solver.rollout_costs(params, CostParams(obstacles=np.zeros((1, 3))),
                             cm, state, U, eps)


def test_solver_defaults_to_cuda_and_raises_without_gpu(monkeypatch):
    solver, *_ = _pair(K=128, T=16)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no GPU"):
        mppi.MPPISolver(solver.model, MPPICost(), solver.cfg)
    with pytest.raises(RuntimeError, match="no GPU"):
        NeuralNetDynamics(0.02)
    with pytest.raises(RuntimeError, match="no GPU"):
        make_costmap(*oval_track(ppm=1.0))
