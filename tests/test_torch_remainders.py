"""The remainders of the port's first modules against the JAX package and
the literal NumPy port of the reference pipeline (``tests/reference_mppi.py``)
on the CPU, with seeded weights: ``NeuralNetDynamics.from_npz`` and
``update_model`` (and the kernels' packed weights after one),
``save_costmap`` and ``Costmap.bounds``, ``MPPICost.footprint_track_cost``,
and the reference's models, costs, solve and slide on the port's plain
path."""

import ast
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autorally_tpu.costs import MPPICost as JaxCost
from autorally_tpu.costs.costmap import load_costmap as jax_load_costmap
from autorally_tpu.costs.costmap import make_costmap as jax_make_costmap
from autorally_tpu.models import NeuralNetDynamics as JaxNN
from autorally_tpu.tools.track_generator import oval_track
from autorally_tpu_torch.config import CostParams, MPPIConfig
from autorally_tpu_torch.costs import (MPPICost, load_costmap, make_costmap,
                                       save_costmap)
from autorally_tpu_torch.models import (BasisFunctionDynamics,
                                        NeuralNetDynamics)
from autorally_tpu_torch.ops import rollout_kernel as rk
from autorally_tpu_torch.solver import mppi
from tests import reference_mppi as ref

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DT = 0.02
RANGES = [[-0.99, 0.99], [-0.99, 0.65]]
COST_DICT = dict(desired_speed=6.0, speed_coeff=4.25, track_coeff=200.0,
                 max_slip_ang=1.25, slip_penalty=10.0, track_slop=0.0,
                 crash_coeff=10000.0, steering_coeff=0.3, throttle_coeff=0.2,
                 boundary_threshold=0.65, discount=0.1)
START = np.array([0.0, -15.0, 0.0, 0.0, 2.0, 0.0, 0.0], dtype=np.float32)


# -- NeuralNetDynamics.from_npz / update_model -------------------------------

@pytest.mark.parametrize("layers", [(6, 32, 32, 4), (6, 64, 64, 64, 64, 4)])
def test_from_npz_infers_the_spec_of_a_saved_model(layers, tmp_path):
    """Written by ``save_params`` and read back on the CPU, in both
    packages; kernels 1-4 take the spec it reads."""
    src = NeuralNetDynamics(DT, layers=layers, device="cpu")
    params = src.init_params(3)
    path = str(tmp_path / "model.npz")
    src.save_params(params, path)
    model, loaded = NeuralNetDynamics.from_npz(path, DT, device="cpu")
    jmodel, jloaded = JaxNN.from_npz(path, DT)
    assert model.layers == jmodel.layers == layers
    for a, b, j in zip(loaded["weights"] + loaded["biases"],
                       params["weights"] + params["biases"],
                       jloaded["weights"] + jloaded["biases"]):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
        np.testing.assert_array_equal(a.numpy(), np.asarray(j))
    for kernel in (1, 2, 3, 4):
        assert rk.has_kernel_form(model, kernel=kernel)
        rk._check_kernel_model(model, kernel=kernel)


def _flat(rs, layers):
    n = sum(a * b + b for a, b in zip(layers[:-1], layers[1:]))
    return rs.standard_normal(n).astype(np.float32)


def test_update_model_equals_jax_and_keeps_params_on_a_mismatch():
    model = NeuralNetDynamics(DT, device="cpu")
    jmodel = JaxNN(DT)
    params = model.init_params(0)
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    flat = _flat(np.random.default_rng(1), model.layers)
    new = model.update_model(params, list(model.layers), flat)
    jnew = jmodel.update_model(jparams, list(model.layers), flat)
    for a, j in zip(new["weights"] + new["biases"],
                    jnew["weights"] + jnew["biases"]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(j))
        assert a.is_contiguous()
    assert new["control_rngs"] is params["control_rngs"]
    # the held weights are not touched; a wrong spec changes nothing
    assert model.params()["weights"][0] is params["weights"][0]
    assert model.update_model(params, (6, 64, 4), flat) is params
    assert jmodel.update_model(jparams, (6, 64, 4), flat) is jparams


def test_packed_weights_follow_an_update_model():
    """The CUDA kernels read a weight buffer packed once per set of weight
    tensors (``rk._pack_weights``, cached on the model): after an
    ``update_model`` the next launch must pack the new weights."""
    model = NeuralNetDynamics(DT, device="cpu")
    params = model.init_params(0)
    old = rk._pack_weights(model, params)
    flat = _flat(np.random.default_rng(2), model.layers)
    new = model.update_model(params, model.layers, flat)
    packed = rk._pack_weights(model, new)
    want = torch.cat([w.reshape(-1) for w in model.kernel_weights(new)])
    assert torch.equal(packed, want) and not torch.equal(packed, old)
    assert rk._pack_weights(model, params).data_ptr() != packed.data_ptr()


# -- save_costmap / Costmap.bounds / footprint_track_cost --------------------

def test_save_costmap_round_trips_and_bounds_equal_jax(tmp_path):
    data, xb, yb = oval_track(ppm=4.0)
    path = str(tmp_path / "map.npz")
    save_costmap(data, xb, yb, 4.0, path)
    ours, theirs = load_costmap(path, device="cpu"), jax_load_costmap(path)
    np.testing.assert_array_equal(ours.data.numpy(), np.asarray(data))
    np.testing.assert_array_equal(ours.data.numpy(),
                                  np.asarray(theirs.data))
    for cm in (ours, make_costmap(data, xb, yb, device="cpu")):
        jcm = jax_make_costmap(data, xb, yb)
        assert cm.bounds == jcm.bounds
        np.testing.assert_allclose(np.ravel(cm.bounds), [*xb, *yb],
                                   rtol=1e-6)


def test_footprint_track_cost_equals_jax_and_the_latch_points():
    data, xb, yb = oval_track(ppm=4.0)
    cm, jcm = make_costmap(data, xb, yb, device="cpu"), jax_make_costmap(
        data, xb, yb)
    rs = np.random.default_rng(3)
    pts = np.concatenate([
        np.stack([rs.uniform(-45, 45, 300), rs.uniform(-30, 30, 300),
                  rs.uniform(-4, 4, 300)], 1),
        [[np.nan, 1.0, 0.0], [1.0, np.nan, 0.3], [2.0, 3.0, np.nan],
         [500.0, -500.0, 1.0]]]).astype(np.float32)
    for x, y, yaw in pts:
        got = float(MPPICost.footprint_track_cost(
            cm, *(torch.tensor(v) for v in (x, y, yaw))))
        want = float(JaxCost.footprint_track_cost(
            jcm, jnp.float32(x), jnp.float32(y), jnp.float32(yaw)))
        assert got == want or (np.isnan(got) and np.isnan(want)), (x, y, yaw)
        # the crash latch of track_cost_c fires exactly at this max
        _, crash = MPPICost().track_cost_c(
            CostParams(boundary_threshold=got), cm, torch.tensor(x),
            torch.tensor(y), torch.tensor(yaw), torch.tensor(0))
        assert int(crash) == (0 if np.isnan(got) else 1)


# -- against the literal NumPy port of the reference -------------------------

def _ref_models(kind, seed=0):
    if kind == "nn":
        model = NeuralNetDynamics(DT, control_ranges=RANGES, device="cpu")
        params = model.init_params(seed)
        ref_model = ref.RefNNModel(
            [w.t().numpy() for w in params["weights"]],
            [b.numpy() for b in params["biases"]], RANGES, DT)
    else:
        model = BasisFunctionDynamics(DT, control_ranges=RANGES,
                                      device="cpu")
        params = model.init_params(seed)
        ref_model = ref.RefBFModel(params["theta"].t().numpy(), RANGES, DT)
    return model, params, ref_model


@pytest.mark.parametrize("kind", ["nn", "bf"])
def test_models_match_the_reference(kind):
    model, params, ref_model = _ref_models(kind)
    rs = np.random.default_rng(4)
    s = rs.standard_normal((64, 7)).astype(np.float32)
    s[:, 4] = np.abs(s[:, 4]) * 5
    s[:8, 4] = rs.uniform(0, 0.1, 8)            # the BF model's slow branch
    u = rs.uniform(-1.2, 1.0, (64, 2)).astype(np.float32)
    ours = model.state_deriv(params, torch.tensor(s), torch.tensor(u))
    theirs = np.stack([ref_model.state_deriv(a, b) for a, b in zip(s, u)])
    np.testing.assert_allclose(ours.numpy(), theirs, rtol=2e-5, atol=2e-5)
    np.testing.assert_array_equal(
        model.enforce_constraints(params, torch.tensor(u)).numpy(),
        np.stack([ref_model.enforce_constraints(b) for b in u]))


def _ref_build(kind, K=64, T=16):
    cfg = MPPIConfig(num_rollouts=K, num_timesteps=T, gamma=0.15)
    data, xb, yb = oval_track(ppm=4.0)
    cm = make_costmap(data, xb, yb, device="cpu")
    model, params, ref_model = _ref_models(kind)
    ref_costs = ref.RefCosts(data, cm.r_c1.numpy(), cm.r_c2.numpy(),
                             cm.trs.numpy(), COST_DICT)
    solver = mppi.MPPISolver(model, MPPICost(), cfg, device="cpu")
    return solver, params, CostParams(**COST_DICT), cm, ref_model, ref_costs


@pytest.mark.parametrize("kind", ["nn", "bf"])
def test_rollout_costs_match_the_reference(kind):
    """Per-rollout costs and pre-clamp controls of the port's plain fused
    path against the reference's literal rollout kernel (rolloutKernel,
    every cost term through RefCosts)."""
    solver, params, p, cm, ref_model, ref_costs = _ref_build(kind)
    K, T = solver.cfg.num_rollouts, solver.cfg.num_timesteps
    rs = np.random.default_rng(5)
    U0 = rs.uniform(-0.3, 0.5, (T, 2)).astype(np.float32)
    noise = rs.standard_normal((K, T, 2)).astype(np.float32)
    nu = np.array(solver.cfg.exploration_std, np.float32)
    costs, u_seq, _ = rk.fused_rollout_cost_plain(
        solver.model, params, solver.cfg, p, cm, torch.tensor(START),
        torch.tensor(U0), torch.tensor(noise.transpose(1, 0, 2)))
    want, du_d = ref.rollout_kernel(T, START, U0, noise, nu, ref_model,
                                    ref_costs, solver.cfg.optimization_stride,
                                    K)
    np.testing.assert_allclose(costs.numpy(), want, rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(u_seq.numpy(), du_d.transpose(2, 1, 0),
                               rtol=1e-6, atol=1e-6)


def test_solve_matches_the_reference():
    """One iteration, the Savitzky-Golay smoothing and the nominal
    trajectory (computeControl) against the reference's, as
    ``tests/test_solver.py`` holds the JAX package (seeded weights)."""
    solver, params, p, cm, ref_model, ref_costs = _ref_build("nn")
    K, T = solver.cfg.num_rollouts, solver.cfg.num_timesteps
    rs = np.random.default_rng(6)
    U0 = rs.uniform(-0.2, 0.2, (T, 2)).astype(np.float32)
    noise = rs.standard_normal((K, T, 2)).astype(np.float32)
    hist = rs.uniform(-0.1, 0.1, (2, 2)).astype(np.float32)
    nu = np.array(solver.cfg.exploration_std, np.float32)
    golden = ref.compute_control(START, U0, noise, nu, ref_model, ref_costs,
                                 solver.cfg.gamma,
                                 solver.cfg.optimization_stride, hist)
    U_new, stats = solver.iterate(params, p, cm, torch.tensor(START),
                                  torch.tensor(U0),
                                  torch.tensor(noise.transpose(1, 0, 2)))
    w = golden["weights"] / golden["normalizer"]
    np.testing.assert_allclose(U_new.numpy(), np.einsum(
        "k,ktc->tc", w, golden["du_d"]), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(float(stats.trajectory_cost),
                               golden["trajectory_cost"], rtol=1e-4)
    np.testing.assert_allclose(float(stats.normalizer),
                               golden["normalizer"], rtol=1e-4)
    U_smooth = mppi.savitzky_golay(U_new, torch.tensor(hist))
    np.testing.assert_allclose(U_smooth.numpy(), golden["U"], rtol=2e-4,
                               atol=2e-4)
    states, controls = solver.nominal_trajectory(params, torch.tensor(START),
                                                 U_smooth)
    np.testing.assert_allclose(states.numpy(), golden["state_solution"],
                               rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(controls.numpy(), golden["control_solution"],
                               rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("stride", [1, 2, 3, 5])
def test_slide_matches_the_reference(stride):
    solver, *_ = _ref_build("nn")
    T = solver.cfg.num_timesteps
    rs = np.random.default_rng(stride)
    U = rs.uniform(-0.5, 0.5, (T, 2)).astype(np.float32)
    hist = rs.uniform(-0.5, 0.5, (2, 2)).astype(np.float32)
    cs = solver.init_state()._replace(U=torch.tensor(U),
                                      control_hist=torch.tensor(hist))
    out = solver.slide(cs, stride)
    U_ref, hist_ref = ref.slide_control_seq(
        U, hist, stride, np.array(solver.cfg.init_u, np.float32))
    np.testing.assert_array_equal(out.U.numpy(), U_ref)
    np.testing.assert_array_equal(out.control_hist.numpy(), hist_ref)


def test_port_sources_and_chip_smoke_import_no_jax():
    """Every import statement of the port's sources (its build directory
    aside) and of ``chip_smoke.py``: none names jax or the JAX package."""
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, dirs, names in os.walk(os.path.join(REPO,
                                                  "autorally_tpu_torch")):
        dirs[:] = [d for d in dirs if d not in ("_build", "__pycache__")]
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert any(f.endswith("run_tube_mppi.py") for f in files)
    for path in files:
        for node in ast.walk(ast.parse(open(path).read())):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            for m in mods:
                root = m.split(".")[0]
                assert root not in ("jax", "jaxlib", "autorally_tpu"), (
                    path, m)
