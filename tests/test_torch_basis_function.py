"""The port's basis-function (BF) model and its kernel paths on the CPU,
against the JAX package: ``car_basis_functions``, the model's derivative and
Euler step, the reference ``.npz`` layout, the plain versions of the chain
and fused kernels against the interpret-mode Pallas kernels and the JAX
scan path, pass 1 against the JAX host-noise path on the port's stream, and
``iterate`` / ``solve`` in both modes.

theta is seeded (``init_params``, numpy): the trained
``basis_function_09_12_2018.npz`` is not in the repository.  K=256, T=24,
from a moving start (``tests/test_bf_kernel.py``'s), on the ppm=2 oval and
on a fine random map where crash flags differ between rollouts.  The CUDA
kernels run only on a GPU: ``chip_smoke.py`` phases 15-18 hold them
against these plain versions there."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autorally_tpu.config import CostParams as JaxCostParams
from autorally_tpu.config import MPPIConfig as JaxConfig
from autorally_tpu.costs import MPPICost as JaxCost
from autorally_tpu.costs.costmap import make_costmap as jax_make_costmap
from autorally_tpu.models import BasisFunctionDynamics as JaxBF
from autorally_tpu.models.basis_function import \
    car_basis_functions as jax_basis_functions
from autorally_tpu.ops import rollout_kernel as jrk
from autorally_tpu.solver import mppi as jmppi
from autorally_tpu.tools.track_generator import oval_track
from autorally_tpu_torch import drive_oval
from autorally_tpu_torch.config import CostParams, MPPIConfig
from autorally_tpu_torch.costs import MPPICost, make_costmap
from autorally_tpu_torch.models import (BasisFunctionDynamics,
                                        NeuralNetDynamics,
                                        car_basis_functions)
from autorally_tpu_torch.ops import kernel_rng as kr
from autorally_tpu_torch.ops import rollout_kernel as rk
from autorally_tpu_torch.solver import mppi
from tests.test_torch_rollout_kernel import USEQ_ATOL, random_map
from tests.test_torch_solver import _assert_stats

K, T = 256, 24
SEED = 3
START = np.array([25.0, 0.0, np.pi / 2, 0.0, 3.0, 0.1, 0.05], np.float32)
KEY = torch.tensor([0x2545F491, 0x9E3779B9])
# Against the interpret-mode kernels: the JAX package's own tolerance for
# its polynomial atan and sin/cos tan (tests/test_bf_kernel.py).
KERNEL_RTOL = KERNEL_ATOL = 5e-4
# Against the scan path: both take arctan and tan, from two libraries, over
# 24 steps of fp32.
SCAN_RTOL = SCAN_ATOL = 1e-4
# One iteration or solve: the costs' 1e-4 through the softmax.
ITER_RTOL, ITER_ATOL = 1e-4, 1e-5
BASIS_ATOL = 1e-6
WIDE = dict(steering_std=4 * 0.275, throttle_std=4 * 0.3)
# name -> (MPPIConfig overrides, start-state overrides, map)
CASES = {
    "nominal": ({}, {}, "oval"),
    "wide_noise": (WIDE, {}, "oval"),
    "nan_x": ({}, {0: np.nan}, "oval"),
    # u_x = 0.05 <= 0.1: the not-moving branch (seeded theta hardly
    # accelerates the car)
    "slow": (WIDE, {4: 0.05}, "oval"),
    # 2 cm texels of random cost: crash flags differ between rollouts
    "random_map": (WIDE, {}, "random"),
}
SAMPLERS = {"gaussian": {}, "ou": dict(noise_sampler="ou", noise_param=0.15)}


def _pair(**cfg_kw):
    """(port solver, params, JAX solver, JAX params) with the same seeded
    theta."""
    jcfg = JaxConfig(num_rollouts=K, num_timesteps=T, **cfg_kw)
    cfg = MPPIConfig(num_rollouts=K, num_timesteps=T, **cfg_kw)
    model = BasisFunctionDynamics(cfg.dt, control_ranges=cfg.control_ranges,
                                  device="cpu")
    params = model.init_params(SEED)
    jmodel = JaxBF(jcfg.dt, control_ranges=jcfg.control_ranges)
    jparams = {k: jnp.asarray(v.numpy()) for k, v in params.items()}
    return (mppi.MPPISolver(model, MPPICost(), cfg, device="cpu"), params,
            jmppi.MPPISolver(jmodel, JaxCost(), jcfg), jparams)


def _maps(kind="oval"):
    """The ppm=2 oval, or the 2 cm random map ("random")."""
    data, xb, yb = (random_map(np.random.default_rng(0)) if kind == "random"
                    else oval_track(ppm=2.0))
    return (make_costmap(data, xb, yb, device="cpu"),
            jax_make_costmap(data, xb, yb))


def _inputs(state_kw=None, seed=1):
    state = START.copy()
    for i, v in (state_kw or {}).items():
        state[i] = v
    rs = np.random.default_rng(seed)
    U = np.tile(np.array([0.05, 0.3], np.float32), (T, 1))
    U[:, 0] = rs.uniform(-0.3, 0.3, T).astype(np.float32)
    eps = rs.standard_normal((T, K, 2)).astype(np.float32)
    return state, U, eps


def _interpret(jsolver):
    js = jmppi.MPPISolver(jsolver.model, jsolver.cost,
                          jsolver.cfg.replace(use_pallas_rollout=True))
    js._pallas_interpret = True
    return js


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("regime", ["moving", "slow"])
def test_car_basis_functions_match_jax(regime):
    """All 25 rows on random states; "slow" puts u_x around the 0.1
    threshold (safe_ux = 1 and rows 9, 13-15 zeroed at or below it)."""
    rs = np.random.default_rng(4)
    n = 2000
    s = rs.normal(0.0, 1.0, (n, 7)).astype(np.float32)
    s[:, 4] = (rs.uniform(0.5, 12.0, n) if regime == "moving"
               else rs.uniform(-0.3, 0.3, n)).astype(np.float32)
    if regime == "slow":
        s[:8, 4] = [0.1, 0.1, -0.0, 0.0, 0.1000001, 0.0999999, -0.1, 0.2]
    u = rs.uniform(-0.99, 0.99, (n, 2)).astype(np.float32)
    got = car_basis_functions(torch.tensor(s), torch.tensor(u)).numpy()
    want = np.asarray(jax_basis_functions(jnp.asarray(s), jnp.asarray(u)))
    assert got.shape == (n, 25)
    # tan's argument within 0.01 of its pole (|cos| < 0.01) turns an ulp of
    # the argument into ~1e-4 of tan: those rows are held at 1e-3
    ux = s[:, 4].astype(np.float64)
    sux = np.where(ux > 0.1, ux, 1.0)
    arg = np.where(ux > 0.1, np.arctan((s[:, 5] + 0.45 * s[:, 6]) / sux)
                   - u[:, 0], -u[:, 0])
    near_pole = np.abs(np.cos(arg)) < 0.01
    np.testing.assert_allclose(got[~near_pole], want[~near_pole], rtol=1e-5,
                               atol=BASIS_ATOL)
    np.testing.assert_allclose(got[near_pole], want[near_pole], rtol=1e-3,
                               atol=BASIS_ATOL)
    if regime == "slow":
        still = s[:, 4] <= 0.1
        assert still.any() and (~still).any()
        np.testing.assert_array_equal(got[still][:, [9, 13, 14, 15]], 0.0)
        np.testing.assert_allclose(got[still][:, 10],
                                   np.tan(-u[still, 0]) / 1400, rtol=1e-5)


def test_state_deriv_and_step_match_jax():
    solver, params, jsolver, jparams = _pair()
    rs = np.random.default_rng(5)
    s = rs.normal(0.0, 1.0, (500, 7)).astype(np.float32)
    s[:, 4] = rs.uniform(-1.0, 8.0, 500).astype(np.float32)
    u = rs.uniform(-1.5, 1.5, (500, 2)).astype(np.float32)
    m, jm = solver.model, jsolver.model
    got = m.state_deriv(params, torch.tensor(s), torch.tensor(u)).numpy()
    want = np.asarray(jm.state_deriv(jparams, jnp.asarray(s), jnp.asarray(u)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    nxt, ucl = m.update_state(params, torch.tensor(s), torch.tensor(u))
    jnxt, jucl = jm.update_state(jparams, jnp.asarray(s), jnp.asarray(u))
    np.testing.assert_allclose(nxt.numpy(), np.asarray(jnxt), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_array_equal(ucl.numpy(), np.asarray(jucl))
    assert m.negate_yaw_der and got[0, 2] == -s[0, 6]


def test_params_init_npz_round_trip_and_kernel_weights(tmp_path):
    """Seeded theta (25, 4) at the JAX package's scale; the reference
    ``.npz`` layout ``W`` (4, 25) float64, read by the JAX package too."""
    model = BasisFunctionDynamics(0.02, device="cpu")
    params = model.init_params(SEED)
    theta = params["theta"]
    assert theta.shape == (25, 4) and theta.dtype == torch.float32
    assert 0.005 < float(theta.std()) < 0.015
    assert torch.equal(model.init_params(SEED)["theta"], theta)
    assert model.num_params == rk.KERNEL_BF_WEIGHTS == 100
    path = str(tmp_path / "bf.npz")
    model.save_params(params, path)
    W = np.load(path)["W"]
    assert W.shape == (4, 25) and W.dtype == np.float64
    np.testing.assert_array_equal(W.T.astype(np.float32), theta.numpy())
    back = BasisFunctionDynamics(0.02, device="cpu").load_params(path)
    assert torch.equal(back["theta"], theta)
    jback = JaxBF(0.02).load_params(path)
    np.testing.assert_array_equal(np.asarray(jback["theta"]), theta.numpy())
    (panel,) = model.kernel_weights(params)
    assert panel.shape == (4, 25) and torch.equal(panel, theta.t())
    carried = model.params_from_jax({k: np.asarray(v) for k, v in
                                     jback.items()})
    assert torch.equal(carried["theta"], theta)


# ---------------------------------------------------------------------------
# the kernels' plain versions against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["nominal", "wide_noise", "nan_x", "slow"])
def test_bf_chain_plain_matches_jax_kernel(case):
    cfg_kw, state_kw, _ = CASES[case]
    solver, params, jsolver, jparams = _pair(**cfg_kw)
    state, U, eps = _inputs(state_kw)
    states, u_seq = rk.dynamics_chain(solver.model, params, solver.cfg,
                                      torch.tensor(state), torch.tensor(U),
                                      torch.tensor(eps))
    js, ju = jrk.dynamics_chain_pallas(jsolver.model, jparams, jsolver.cfg,
                                       jnp.asarray(state), jnp.asarray(U),
                                       jnp.asarray(eps), interpret=True)
    np.testing.assert_allclose(states.numpy(), np.asarray(js)[:7],
                               rtol=KERNEL_RTOL, atol=KERNEL_ATOL)
    np.testing.assert_allclose(u_seq.numpy(), np.asarray(ju), rtol=0,
                               atol=0)


@pytest.mark.parametrize("backend", ["interpret_kernel", "scan"])
@pytest.mark.parametrize("case", list(CASES))
def test_bf_fused_exact_plain_matches_jax(case, backend):
    """Kernel A's plain version with the BF model against
    ``fused_exact_rollout_cost_pallas`` in interpret mode (5e-4) and the
    JAX solver's scan path (1e-4); crash flags equal."""
    cfg_kw, state_kw, kind = CASES[case]
    solver, params, jsolver, jparams = _pair(**cfg_kw)
    cm, jcm = _maps(kind)
    state, U, eps = _inputs(state_kw)
    costs, u_seq, crash = rk.fused_exact_rollout_cost(
        solver.model, params, solver.cfg, CostParams(), cm,
        torch.tensor(state), torch.tensor(U), torch.tensor(eps))
    jargs = (jnp.asarray(state), jnp.asarray(U), jnp.asarray(eps))
    if backend == "interpret_kernel":
        jc, ju, jx = jrk.fused_exact_rollout_cost_pallas(
            jsolver.model, jparams, jsolver.cfg, JaxCostParams(), jcm, *jargs,
            interpret=True)
        ju, tol, u_tol = np.asarray(ju), KERNEL_RTOL, 0
    else:
        assert not jsolver.use_pallas_rollout
        jc, ju, jx = jsolver.rollout_costs(jparams, JaxCostParams(), jcm,
                                           *jargs)
        ju, tol, u_tol = np.asarray(ju).transpose(2, 0, 1), SCAN_RTOL, \
            USEQ_ATOL
    np.testing.assert_allclose(costs.numpy(), np.asarray(jc), rtol=tol,
                               atol=tol)
    np.testing.assert_array_equal(crash.numpy(), np.asarray(jx))
    np.testing.assert_allclose(u_seq.numpy(), ju, rtol=0, atol=u_tol)
    assert np.isfinite(costs.numpy()).all()
    if case == "random_map":
        assert 0 < int(crash.sum()) < K


def test_bf_nominal_trajectory_matches_jax_kernel_and_scan():
    solver, params, jsolver, jparams = _pair()
    state, U, _ = _inputs()
    ss, cs = rk.nominal_trajectory(solver.model, params, solver.cfg,
                                   torch.tensor(state), torch.tensor(U))
    jss, jcs = jrk.nominal_trajectory_pallas(
        jsolver.model, jparams, jsolver.cfg, jnp.asarray(state),
        jnp.asarray(U), interpret=True)
    sss, _ = jsolver.nominal_trajectory(jparams, jnp.asarray(state),
                                        jnp.asarray(U))
    np.testing.assert_allclose(ss.numpy(), np.asarray(jss),
                               rtol=KERNEL_RTOL, atol=KERNEL_ATOL)
    np.testing.assert_allclose(ss.numpy(), np.asarray(sss), rtol=SCAN_RTOL,
                               atol=SCAN_ATOL)
    np.testing.assert_array_equal(cs.numpy(), np.asarray(jcs))


@pytest.mark.parametrize("sampler", list(SAMPLERS))
def test_bf_pass1_plain_matches_jax_rollout_costs(sampler):
    """Pass 1 with the BF model against the JAX host-noise path (scan) fed
    the port's stream (the JAX kernel-RNG passes draw from the TPU's own
    PRNG), on the 2 cm random map.  There a rollout whose trajectory differs
    by rounding (arctan and tan from two libraries) can cross a texel edge
    on one side only: at most 1 % of the rollouts may differ."""
    solver, params, jsolver, jparams = _pair(kernel_rng=True, **WIDE,
                                             **SAMPLERS[sampler])
    cm, jcm = _maps("random")
    state, U, _ = _inputs()
    total, crash, ctx = rk.fused_rng_costs(
        solver.model, params, solver.cfg, CostParams(), cm,
        torch.tensor(state), torch.tensor(U), KEY)
    jc, _, jx = jsolver.rollout_costs(jparams, JaxCostParams(), jcm,
                                      jnp.asarray(state), jnp.asarray(U),
                                      jnp.asarray(rk.rng_noise(ctx).numpy()))
    near = np.isclose(total.numpy(), np.asarray(jc), rtol=SCAN_RTOL,
                      atol=SCAN_ATOL)
    same = crash.numpy() == np.asarray(jx)
    assert int((~near | ~same).sum()) <= K // 100
    assert 0 < int(crash.sum()) < K


@pytest.mark.parametrize("mode", ["host_noise", "capacity"])
def test_bf_iterate_matches_jax(mode):
    solver, params, jsolver, jparams = _pair(kernel_rng=mode == "capacity")
    cm, jcm = _maps()
    state, U, eps = _inputs()
    cp = CostParams(desired_speed=6.0)
    args = (torch.tensor(state), torch.tensor(U))
    if mode == "capacity":
        assert solver._use_kernel_rng(cm)
        U_new, stats = solver._iterate_kernel_rng(params, cp, cm, *args, KEY)
        eps = kr.kernel_noise(KEY, 0, K, T, None).numpy()
    else:
        assert not solver._use_kernel_rng(cm)
        U_new, stats = solver.iterate(params, cp, cm, *args,
                                      torch.tensor(eps))
    jU, jstats = jsolver.iterate(jparams, JaxCostParams(desired_speed=6.0),
                                 jcm, jnp.asarray(state), jnp.asarray(U),
                                 jnp.asarray(eps))
    np.testing.assert_allclose(U_new.numpy(), np.asarray(jU),
                               rtol=ITER_RTOL, atol=ITER_ATOL)
    _assert_stats(stats, jstats, ITER_RTOL, ITER_ATOL)
    assert 1.0 < float(stats.ess) < K


@pytest.mark.parametrize("mode", ["host_noise", "capacity"])
def test_bf_solve_matches_jax(mode):
    """One ``solve`` (iteration, Savitzky-Golay, nominal trajectory) against
    JAX fed the same noise (the capacity solve's stream from the subkey
    that ``jax.random.split`` takes from the JAX state's key); both solves
    return the same new key."""
    solver, params, jsolver, jparams = _pair(kernel_rng=mode == "capacity")
    cm, jcm = _maps()
    state, _, eps = _inputs()
    jcs0 = jsolver.init_state()
    if mode == "capacity":
        sub = jax.random.split(jcs0.key)[1]
        key = torch.tensor(np.asarray(jax.random.key_data(sub)),
                           dtype=torch.int64)
        eps = kr.kernel_noise(key, 0, K, T, None).numpy()
    else:
        solver._sample_noise = lambda gen, shape: torch.tensor(eps)
    jsolver._sample_noise = lambda key, shape: jnp.asarray(eps)
    cs, stats = solver.solve(params, CostParams(), cm, state,
                             solver.init_state())
    jcs, jstats = jsolver.solve(jparams, JaxCostParams(), jcm, state, jcs0)
    np.testing.assert_array_equal(cs.key,
                                  np.asarray(jax.random.key_data(jcs.key)))
    for name in ("U", "control_solution", "state_solution"):
        np.testing.assert_allclose(getattr(cs, name).numpy(),
                                   np.asarray(getattr(jcs, name)),
                                   rtol=ITER_RTOL, atol=ITER_ATOL,
                                   err_msg=name)
    _assert_stats(stats, jstats, ITER_RTOL, ITER_ATOL)


def test_use_kernel_rng_matches_the_jax_gate_for_bf():
    cm, jcm = _maps()
    for kw in (dict(kernel_rng=True), dict(kernel_rng=False),
               dict(kernel_rng=True, exact_fused=False),
               dict(kernel_rng=True, noise_sampler="colored")):
        solver, _, jsolver, _ = _pair(**kw)
        assert solver._use_kernel_rng(cm) == \
            _interpret(jsolver)._use_kernel_rng(jcm), kw


# ---------------------------------------------------------------------------
# the kernels' host side: form, packing, scalars, refusals
# ---------------------------------------------------------------------------

def test_kernel_form_packing_and_scalars():
    solver, params, *_ = _pair()
    model = solver.model
    assert rk.has_kernel_form(model)
    rk._check_kernel_model(model)                         # accepted
    packed = rk._pack_weights(model, params)
    assert packed.numel() == rk.KERNEL_BF_WEIGHTS
    torch.testing.assert_close(packed, params["theta"].t().reshape(-1),
                               rtol=0, atol=0)
    assert rk._pack_weights(model, params) is packed
    with torch.no_grad():
        params["theta"][0, 1].add_(1.0)
    repacked = rk._pack_weights(model, params)
    assert repacked is not packed
    assert repacked[25] == packed[25] + 1.0                 # theta^T[1, 0]
    _, ints = rk.launch_scalars(model, solver.cfg, 0, T, K)
    assert dict(zip(rk._INT_SCALARS, ints))["bf"] == 1
    nn = NeuralNetDynamics(solver.cfg.dt, device="cpu")
    _, ints = rk.launch_scalars(nn, solver.cfg, 0, T, K)
    assert dict(zip(rk._INT_SCALARS, ints))["bf"] == 0


def test_check_kernel_model_still_refuses_other_mlp_specs(monkeypatch):
    """The BF form and an MLP of another layer spec are accepted by every
    kernel (kernels 3 and 4 too, from a library built for the spec); pass 1
    on the card asks for the spec's own library (``_build.load``, which
    records the request and raises here: nothing is built, nothing runs
    the plain version instead)."""
    wide = NeuralNetDynamics(0.02, layers=(6, 64, 4), device="cpu")
    solver, params, *_ = _pair()
    for kernel in (1, 2, 3, 4):
        assert rk.has_kernel_form(solver.model, kernel=kernel)
        assert rk.has_kernel_form(wide, kernel=kernel)
        rk._check_kernel_model(wide, kernel=kernel)
    asked = []

    def load(layers=None):
        asked.append(layers)
        raise LookupError("no build here")

    monkeypatch.setattr(rk._build, "load", load)
    rk._kernel_lib.cache_clear()
    state, U, eps = (torch.tensor(a) for a in _inputs())
    cm = make_costmap(*oval_track(ppm=1.0), device="cpu")
    with pytest.raises(LookupError):
        rk.prepare_fused_rng_costs(wide, wide.init_params(0), solver.cfg,
                                   CostParams(), cm, state, U,
                                   torch.tensor([1, 2]))
    assert asked == [(6, 64, 4)]
    rk._kernel_lib.cache_clear()


def test_drive_oval_with_the_bf_model():
    solver, params, cost_params, costmap, note = drive_oval.build(
        model="bf", rollouts=32, model_path="", device="cpu")
    assert type(solver.model) is BasisFunctionDynamics
    assert "seeded theta" in note and cost_params.desired_speed == 6.0
    assert drive_oval.MODELS["bf"][1] == 2560
    out = drive_oval.drive(solver, params, cost_params, costmap, 3,
                           log=lambda m: None)
    assert out["controls"].shape == (3, 2)
    assert np.isfinite(out["controls"]).all()
