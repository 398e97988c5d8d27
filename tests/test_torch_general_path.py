"""The port's general rollout path on the CPU, against the JAX package: a
cost subclass (the MLP and the BF model, on the exact map and on a neural
field) through the chain and the batched cost epilogue, against the JAX
solver forced onto its chain kernel (interpret mode) and against its
``lax.scan`` path; models without a kernel form (a subclass that overrides
``dynamics``, ``EnsembleDynamics``) through the solver's plain chain,
against the JAX scan path; ``_kernel_form_consistent`` and the kernel-form
decisions; a 3-tick slide + solve with injected noise; and the host-noise
gate of a cost subclass.

Seeded weights carried with ``params_from_jax``, inputs from a numpy seed.
K=256, T=24 from a moving start on the ppm=2 oval.  On the card the chain
is kernel 2 (``chip_smoke.py`` phase 24 holds it and the epilogue)."""

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
from autorally_tpu.models import EnsembleDynamics as JaxEnsemble
from autorally_tpu.models import NeuralNetDynamics as JaxNN
from autorally_tpu.models.ensemble import stack_params as jax_stack_params
from autorally_tpu.solver import mppi as jmppi
from autorally_tpu.tools.track_generator import oval_track
from autorally_tpu_torch.config import CostParams, MPPIConfig
from autorally_tpu_torch.costs import MPPICost, make_costmap
from autorally_tpu_torch.models import (BasisFunctionDynamics,
                                        EnsembleDynamics, NeuralNetDynamics)
from autorally_tpu_torch.ops import rollout_kernel as rk
from autorally_tpu_torch.solver import mppi
from tests.test_torch_neural_costmap import _fields
from tests.test_torch_solver import _assert_stats

K, T = 256, 24
START = np.array([25.0, 0.0, np.pi / 2, 0.0, 3.0, 0.1, 0.05], np.float32)
# The port's tolerances: costs, u_seq (exact arithmetic on both sides),
# one iteration and a 3-tick scenario.
COST_RTOL, COST_ATOL = 2e-5, 1e-4
USEQ_ATOL = 1e-6
ITER_RTOL, ITER_ATOL = 1e-5, 1e-6
# The BF model: both packages' arctan and tan over 24 steps of fp32 (the
# scan path), and the JAX kernel's polynomial atan and sin/cos tan (its
# own tolerance, tests/test_bf_kernel.py).
BF_TOL = {"scan": (1e-4, 1e-4), "chain_kernel": (5e-4, 5e-4)}
MEMBERS = 4


class DoubledSpeed(MPPICost):
    """Overrides one term, so that dispatch through the subclass shows."""

    def speed_cost_c(self, p, ux):
        return 2.0 * super().speed_cost_c(p, ux)


class JaxDoubledSpeed(JaxCost):
    def speed_cost_c(self, p, ux):
        return 2.0 * super().speed_cost_c(p, ux)


class Doubled(NeuralNetDynamics):
    """Overrides ``dynamics``: no kernel form."""

    def dynamics(self, params, states, controls):
        return super().dynamics(params, states, controls) * 2.0


class JaxDoubled(JaxNN):
    def dynamics(self, params, states, controls):
        return super().dynamics(params, states, controls) * 2.0


def _models(kind, cfg):
    """(port model, params, JAX model, JAX params) with the same seeded
    weights: "mlp", "bf", "override" (:class:`Doubled`) or "ensemble"
    (``MEMBERS`` members: the seeded base, then the base plus 0.2 N(0, 1)
    from ``RandomState(0)``, as ``tests/test_ensemble.py`` builds them)."""
    ranges = dict(control_ranges=cfg.control_ranges)
    key = jax.random.PRNGKey(3)
    if kind == "ensemble":
        jbase = JaxNN(cfg.dt, **ranges)
        p0 = jax.tree_util.tree_map(np.asarray, jbase.init_params(key))
        rng = np.random.RandomState(0)
        members = [{
            "weights": [W + (m > 0) * 0.2 * rng.randn(*W.shape).astype(
                np.float32) for W in p0["weights"]],
            "biases": [b + (m > 0) * 0.2 * rng.randn(*b.shape).astype(
                np.float32) for b in p0["biases"]],
            "control_rngs": p0["control_rngs"]} for m in range(MEMBERS)]
        jparams = jax_stack_params([jax.tree_util.tree_map(jnp.asarray, mp)
                                    for mp in members])
        jmodel = JaxEnsemble(jbase, MEMBERS)
        model = EnsembleDynamics(NeuralNetDynamics(cfg.dt, device="cpu",
                                                   **ranges), MEMBERS)
    else:
        cls, jcls = {"mlp": (NeuralNetDynamics, JaxNN),
                     "bf": (BasisFunctionDynamics, JaxBF),
                     "override": (Doubled, JaxDoubled)}[kind]
        jmodel = jcls(cfg.dt, **ranges)
        jparams = jmodel.init_params(key)
        model = cls(cfg.dt, device="cpu", **ranges)
    params = model.params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                          jparams))
    return model, params, jmodel, jparams


def _surfaces(kind):
    if kind == "field":
        return _fields()
    data, xb, yb = oval_track(ppm=2.0)
    return (make_costmap(data, xb, yb, device="cpu"),
            jax_make_costmap(data, xb, yb))


def _pair(model_kind, cost=DoubledSpeed, jcost=JaxDoubledSpeed,
          backend="scan", **cfg_kw):
    """(port solver, params, JAX solver, JAX params); ``backend``
    "chain_kernel" forces the JAX solver onto its Pallas chain kernel in
    interpret mode (``tests/test_bf_kernel.py``'s way)."""
    cfg = MPPIConfig(num_rollouts=K, num_timesteps=T, **cfg_kw)
    jcfg = JaxConfig(num_rollouts=K, num_timesteps=T, **cfg_kw)
    model, params, jmodel, jparams = _models(model_kind, cfg)
    if backend == "chain_kernel":
        jcfg = jcfg.replace(use_pallas_rollout=True)
    jsolver = jmppi.MPPISolver(jmodel, jcost(), jcfg)
    jsolver._pallas_interpret = backend == "chain_kernel"
    return (mppi.MPPISolver(model, cost(), cfg, device="cpu"), params,
            jsolver, jparams)


def _inputs(seed=4):
    rs = np.random.default_rng(seed)
    U = np.tile(np.array([0.0, 0.3], np.float32), (T, 1))
    U[:, 0] = rs.uniform(-0.3, 0.3, T).astype(np.float32)
    eps = rs.standard_normal((T, K, 2)).astype(np.float32)
    return START.copy(), U, eps


def _jax_u_seq(jsolver, u_seq):
    """The JAX solver's u_seq in the port's (C, T, K) layout."""
    u = np.asarray(u_seq)
    return u if jsolver.use_pallas_rollout else u.transpose(2, 0, 1)


def _held(solver, params, jsolver, jparams, surface, rtol, atol):
    """``rollout_costs`` of both solvers on the same inputs: costs within
    (rtol, atol), crash flags equal, u_seq within ``USEQ_ATOL``.  Returns
    the port's costs."""
    cm, jcm = _surfaces(surface)
    state, U, eps = _inputs()
    cp = dict(desired_speed=6.0)
    total, u_seq, crash = solver.rollout_costs(
        params, CostParams(**cp), cm, torch.tensor(state), torch.tensor(U),
        torch.tensor(eps))
    jt, ju, jc = jsolver.rollout_costs(
        jparams, JaxCostParams(**cp), jcm, jnp.asarray(state),
        jnp.asarray(U), jnp.asarray(eps))
    np.testing.assert_allclose(total.numpy(), np.asarray(jt), rtol=rtol,
                               atol=atol)
    np.testing.assert_array_equal(crash.numpy(), np.asarray(jc))
    np.testing.assert_allclose(u_seq.numpy(), _jax_u_seq(jsolver, ju),
                               rtol=0, atol=USEQ_ATOL)
    return total


@pytest.mark.parametrize("backend", ["scan", "chain_kernel"])
@pytest.mark.parametrize("surface", ["exact", "field"])
@pytest.mark.parametrize("model_kind", ["mlp", "bf"])
def test_cost_subclass_matches_jax(model_kind, surface, backend):
    """A cost subclass with a kernel-form model: kernel 2's plain version
    and the epilogue, against the JAX chain kernel + epilogue and the JAX
    scan path; the doubled speed term shows in the costs."""
    solver, params, jsolver, jparams = _pair(model_kind, backend=backend)
    assert solver.kernel_form and not solver._fusable_cost()
    assert jsolver.use_pallas_rollout == (backend == "chain_kernel")
    rtol, atol = (BF_TOL[backend] if model_kind == "bf"
                  else (COST_RTOL, COST_ATOL))
    total = _held(solver, params, jsolver, jparams, surface, rtol, atol)
    base = mppi.MPPISolver(solver.model, MPPICost(), solver.cfg,
                           device="cpu")
    cm = _surfaces(surface)[0]
    state, U, eps = (torch.tensor(a) for a in _inputs())
    plain, _, _ = base.rollout_costs(params, CostParams(desired_speed=6.0),
                                     cm, state, U, eps)
    assert not torch.allclose(total, plain, rtol=1e-3)


@pytest.mark.parametrize("surface", ["exact", "field"])
def test_unchanged_subclass_matches_the_fused_path(surface):
    """A subclass that overrides nothing takes the chain and the epilogue
    and gives the fused kernels' costs (their plain versions here)."""

    class Same(MPPICost):
        pass

    solver, params, *_ = _pair("mlp", cost=Same)
    fused = mppi.MPPISolver(solver.model, MPPICost(), solver.cfg,
                            device="cpu")
    cm = _surfaces(surface)[0]
    state, U, eps = (torch.tensor(a) for a in _inputs())
    cp = CostParams(desired_speed=6.0)
    got = solver.rollout_costs(params, cp, cm, state, U, eps)
    ref = fused.rollout_costs(params, cp, cm, state, U, eps)
    torch.testing.assert_close(got[0], ref[0], rtol=COST_RTOL,
                               atol=COST_ATOL)
    assert torch.equal(got[1], ref[1]) and torch.equal(got[2], ref[2])


@pytest.mark.parametrize("model_kind", ["override", "ensemble"])
def test_model_without_a_kernel_form_matches_jax_scan(model_kind):
    """The solver's plain chain and the epilogue (with the plain
    ``MPPICost``: the fused kernels need a kernel form) against the JAX
    scan path: rollout costs and one iteration."""
    solver, params, jsolver, jparams = _pair(model_kind, cost=MPPICost,
                                             jcost=JaxCost)
    assert not solver.kernel_form and not jsolver.use_pallas_rollout
    _held(solver, params, jsolver, jparams, "exact", COST_RTOL, COST_ATOL)
    cm, jcm = _surfaces("exact")
    state, U, eps = _inputs()
    U_new, stats = solver.iterate(params, CostParams(desired_speed=6.0), cm,
                                  *(torch.tensor(a) for a in (state, U, eps)))
    jU, jstats = jsolver.iterate(jparams, JaxCostParams(desired_speed=6.0),
                                 jcm, *(jnp.asarray(a) for a in (state, U,
                                                                 eps)))
    np.testing.assert_allclose(U_new.numpy(), np.asarray(jU),
                               rtol=ITER_RTOL, atol=ITER_ATOL)
    _assert_stats(stats, jstats, ITER_RTOL, ITER_ATOL)
    s, c = solver.nominal_trajectory(params, torch.tensor(state), U_new)
    js, jc = jsolver.nominal_trajectory(jparams, jnp.asarray(state), jU)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=1e-5,
                               atol=1e-6)


def test_kernel_form_consistent_cases():
    """``tests/test_obstacles.py``'s cases, the same answers in both
    packages, and the decisions that follow from them: the kernel form
    (``rk.kernel_form_applies``, the solver's ``kernel_form``), the kernels'
    own check and ``cfg.use_pallas_rollout=True``'s force."""

    class Custom(NeuralNetDynamics):
        def dynamics(self, params, states, controls):
            return super().dynamics(params, states, controls) * 2.0

    class Redeclared(NeuralNetDynamics):
        KERNEL_KIND = "mlp"

        def dynamics(self, params, states, controls):
            return super().dynamics(params, states, controls)

        def kernel_weights(self, params):
            return super().kernel_weights(params)

    class Plain(NeuralNetDynamics):
        pass

    class JaxCustom(JaxNN):
        def dynamics(self, params, states, controls):
            return super().dynamics(params, states, controls) * 2.0

    class JaxRedeclared(JaxNN):
        KERNEL_KIND = "mlp"

        def dynamics(self, params, states, controls):
            return super().dynamics(params, states, controls)

        def kernel_weights(self, params):
            return super().kernel_weights(params)

    class JaxPlain(JaxNN):
        pass

    cfg = MPPIConfig(num_rollouts=64, num_timesteps=8)
    for cls, jcls, want in ((Custom, JaxCustom, False),
                            (Redeclared, JaxRedeclared, True),
                            (Plain, JaxPlain, True),
                            (NeuralNetDynamics, JaxNN, True)):
        model = cls(0.02, device="cpu")
        assert mppi._kernel_form_consistent(model) is want, cls
        assert jmppi._kernel_form_consistent(jcls(0.02)) is want, cls
        assert rk.kernel_form_applies(model) is want
        assert rk.has_kernel_form(model) is want
        assert mppi.MPPISolver(model, MPPICost(), cfg,
                               device="cpu").kernel_form is want
        forced = cfg.replace(use_pallas_rollout=True)
        assert mppi.MPPISolver(model, MPPICost(), forced,
                               device="cpu").kernel_form
        rk._check_kernel_model(model, forced)
        if not want:
            with pytest.raises(NotImplementedError, match="kernel form"):
                rk._check_kernel_model(model, cfg)
            assert not mppi.MPPISolver(
                model, MPPICost(), cfg.replace(use_pallas_rollout=False),
                device="cpu").kernel_form
    ensemble = EnsembleDynamics(NeuralNetDynamics(0.02, device="cpu"), 4)
    assert mppi._kernel_form_consistent(ensemble) is \
        jmppi._kernel_form_consistent(JaxEnsemble(JaxNN(0.02), 4)) is False
    assert not rk.kernel_form_applies(ensemble, cfg.replace(
        use_pallas_rollout=True))
    with pytest.raises(NotImplementedError, match="kernel form"):
        rk._check_kernel_model(ensemble)
    # another layer spec keeps the kernel path: kernels 1-4 take it (a
    # library built for its spec; its plain versions run on the CPU)
    wide = NeuralNetDynamics(0.02, layers=(6, 64, 4), device="cpu")
    assert mppi.MPPISolver(wide, MPPICost(), cfg, device="cpu").kernel_form
    for kernel in (1, 2, 3, 4):
        assert rk.has_kernel_form(wide, kernel=kernel)
        rk._check_kernel_model(wide, kernel=kernel)


@pytest.mark.parametrize("case", ["cost_subclass", "no_kernel_form"])
def test_three_tick_scenario_matches_jax(case):
    """slide + solve three times, the same fixed noise on both sides."""
    if case == "cost_subclass":
        solver, params, jsolver, jparams = _pair("mlp")
    else:
        solver, params, jsolver, jparams = _pair("override", cost=MPPICost,
                                                 jcost=JaxCost)
    cm, jcm = _surfaces("exact")
    eps = np.random.default_rng(11).standard_normal((T, K, 2)).astype(
        np.float32)
    solver._sample_noise = lambda gen, shape: torch.tensor(eps)
    jsolver._sample_noise = lambda key, shape: jnp.asarray(eps)
    cs, jcs = solver.init_state(), jsolver.init_state()
    for _ in range(3):
        cs = solver.slide(cs, 1)
        cs, stats = solver.solve(params, CostParams(desired_speed=5.0), cm,
                                 START, cs)
        jcs = jsolver.slide(jcs, 1)
        jcs, jstats = jsolver.solve(jparams, JaxCostParams(desired_speed=5.0),
                                    jcm, START, jcs)
    for name in ("U", "control_hist", "control_solution", "state_solution"):
        np.testing.assert_allclose(getattr(cs, name).numpy(),
                                   np.asarray(getattr(jcs, name)),
                                   rtol=ITER_RTOL, atol=1e-5, err_msg=name)
    _assert_stats(stats, jstats, ITER_RTOL, ITER_ATOL)


def test_kernel_rng_with_a_cost_subclass_takes_host_noise():
    """The capacity mode's gate: a cost subclass, or a model without a
    kernel form, takes host noise (eps drawn on the host), as in the JAX
    package; the plain cost with the MLP keeps the capacity mode."""
    cm, jcm = _surfaces("exact")
    for model_kind, cost, jcost, want in (
            ("mlp", DoubledSpeed, JaxDoubledSpeed, False),
            ("override", MPPICost, JaxCost, False),
            ("mlp", MPPICost, JaxCost, True)):
        solver, params, jsolver, _ = _pair(model_kind, cost=cost,
                                           jcost=jcost, kernel_rng=True)
        jforced = jmppi.MPPISolver(jsolver.model, jsolver.cost,
                                   jsolver.cfg.replace(
                                       use_pallas_rollout=None))
        jforced.use_pallas_rollout = jmppi._kernel_form_consistent(
            jsolver.model)
        assert solver._use_kernel_rng(cm) is want
        assert jforced._use_kernel_rng(jcm) is want
        draw = solver._draw(cm, np.array([1, 2], np.uint32))
        assert draw.shape == ((2,) if want else (T, K, 2))
    solver, params, *_ = _pair("mlp", kernel_rng=True)
    cs, stats = solver.solve(params, CostParams(desired_speed=6.0), cm,
                             START, solver.init_state())
    assert torch.isfinite(cs.U).all() and 1.0 <= float(stats.ess) <= K
