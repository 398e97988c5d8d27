"""Kernels 1 and 2 at MLP layer specs other than the default library's
6-32-32-4: their plain PyTorch versions (which the wrappers run for CPU
tensors) against the JAX Pallas kernels in interpret mode at
6-64-64-64-64-4 (the JAX package's wider model, BASELINE #3's), 6-24-4
(hidden width a multiple of 8 only) and 6-16-4; the launchers' geometries
and instance names per spec; and the capacity mode with another spec: it
is taken as the JAX package takes it (pass 1's plain version on the CPU,
held against the JAX capacity iterate with zero exploration noise in TPU
interpret mode), and run on the card by pass 1 of the spec's own
library, never on host noise instead.  Same seeded weights (``params_from_jax``), same numpy
noise, K=256, T=24.  The CUDA kernels run only on a GPU:
``chip_smoke.py`` holds them against these plain versions there."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from autorally_tpu.config import CostParams as JaxCostParams
from autorally_tpu.config import MPPIConfig as JaxConfig
from autorally_tpu.costs.costmap import make_costmap as jax_make_costmap
from autorally_tpu.models import NeuralNetDynamics as JaxNN
from autorally_tpu.ops import rollout_kernel as jrk
from autorally_tpu.tools.track_generator import oval_track
from autorally_tpu_torch.config import CostParams, MPPIConfig
from autorally_tpu_torch.costs import MPPICost, make_costmap
from autorally_tpu_torch.models import NeuralNetDynamics
from autorally_tpu_torch.ops import _build
from autorally_tpu_torch.ops import rollout_kernel as rk
from autorally_tpu_torch.solver import mppi

SPECS = [(6, 64, 64, 64, 64, 4), (6, 24, 4), (6, 16, 4)]
K, T = 256, 24
# 23 running-average steps of fp32 with another summation order in the MLP
# (tests/test_torch_rollout_kernel.py's tolerances)
COST_RTOL, COST_ATOL = 2e-5, 1e-4
USEQ_ATOL = 1e-6                    # perturb is one multiply and one add
STATE_RTOL, STATE_ATOL = 1e-5, 1e-5  # 24 Euler steps of the same MLP
# the capacity iterate: tests/test_torch_parallel.py's (a softmax over 256
# float32 costs summed in another order)
ITER_RTOL, ITER_ATOL = 1e-4, 1e-5
START = (25.0, 0.0, np.pi / 2, 0.0, 3.0, 0.0, 0.0)
CASES = {
    "nominal": ({}, {}, 0),
    "wide_noise": (dict(steering_std=4 * 0.275, throttle_std=4 * 0.3), {},
                   0),
    "nan_x": ({}, {0: np.nan}, 0),
    "k_offset": ({}, {}, 128),
}


def _label(spec):
    return "-".join(map(str, spec))


def _setup(spec, case="nominal", seed=0, **cfg_extra):
    cfg_kw, state_kw, k_off = CASES[case]
    cfg_kw = {**cfg_kw, **cfg_extra}
    jcfg = JaxConfig(num_rollouts=K, num_timesteps=T, **cfg_kw)
    cfg = MPPIConfig(num_rollouts=K, num_timesteps=T, **cfg_kw)
    jmodel = JaxNN(jcfg.dt, layers=spec, control_ranges=jcfg.control_ranges)
    jparams = jmodel.init_params(jax.random.PRNGKey(seed))
    model = NeuralNetDynamics(cfg.dt, layers=spec,
                              control_ranges=cfg.control_ranges,
                              device="cpu")
    params = model.params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                          jparams))
    rs = np.random.default_rng(seed)
    state = np.array(START, np.float32)
    for i, v in state_kw.items():
        state[i] = v
    eps = rs.standard_normal((T, K - k_off, 2)).astype(np.float32)
    U = np.tile(np.array([0.0, 0.3], np.float32), (T, 1))
    U[:, 0] = rs.uniform(-0.3, 0.3, T).astype(np.float32)
    data, xb, yb = oval_track(ppm=2.0)
    return dict(cfg=cfg, jcfg=jcfg, model=model, params=params,
                jmodel=jmodel, jparams=jparams, state=state, U=U, eps=eps,
                k_offset=k_off, costmap=make_costmap(data, xb, yb,
                                                     device="cpu"),
                jcostmap=jax_make_costmap(data, xb, yb))


def _args(s, lib):
    return tuple(lib.asarray(a) if lib is jnp else torch.tensor(a)
                 for a in (s["state"], s["U"], s["eps"]))


@pytest.mark.parametrize("case", ["nominal", "nan_x", "k_offset"])
@pytest.mark.parametrize("spec", SPECS, ids=_label)
def test_fused_exact_plain_matches_jax_kernel(spec, case):
    """Kernel 1's plain version against ``fused_exact_rollout_cost_pallas``
    in interpret mode at the spec."""
    s = _setup(spec, case)
    costs, u_seq, crash = rk.fused_exact_rollout_cost(
        s["model"], s["params"], s["cfg"], CostParams(), s["costmap"],
        *_args(s, torch), k_offset=s["k_offset"])
    jc, ju, jx = jrk.fused_exact_rollout_cost_pallas(
        s["jmodel"], s["jparams"], s["jcfg"], JaxCostParams(),
        s["jcostmap"], *_args(s, jnp), k_offset=s["k_offset"],
        interpret=True)
    np.testing.assert_allclose(costs.numpy(), np.asarray(jc),
                               rtol=COST_RTOL, atol=COST_ATOL)
    np.testing.assert_array_equal(crash.numpy(), np.asarray(jx))
    np.testing.assert_allclose(u_seq.numpy(), np.asarray(ju), rtol=0,
                               atol=USEQ_ATOL)
    assert np.isfinite(costs.numpy()).all()


@pytest.mark.parametrize("case", ["nominal", "wide_noise", "k_offset"])
@pytest.mark.parametrize("spec", SPECS, ids=_label)
def test_dynamics_chain_plain_matches_jax_kernel(spec, case):
    s = _setup(spec, case)
    states, u_seq = rk.dynamics_chain(s["model"], s["params"], s["cfg"],
                                      *_args(s, torch),
                                      k_offset=s["k_offset"])
    js, ju = jrk.dynamics_chain_pallas(s["jmodel"], s["jparams"], s["jcfg"],
                                       *_args(s, jnp), k_offset=s["k_offset"],
                                       interpret=True)
    js = np.asarray(js)[:7]                          # drop the SPAD rows
    assert states.shape == js.shape
    np.testing.assert_allclose(states.numpy(), js, rtol=STATE_RTOL,
                               atol=STATE_ATOL)
    np.testing.assert_allclose(u_seq.numpy(), np.asarray(ju), rtol=0,
                               atol=USEQ_ATOL)


@pytest.mark.parametrize("spec", SPECS, ids=_label)
def test_nominal_trajectory_matches_jax_kernel(spec):
    s = _setup(spec)
    state, U, _ = _args(s, torch)
    ss, cs = rk.nominal_trajectory(s["model"], s["params"], s["cfg"], state,
                                   U)
    jss, jcs = jrk.nominal_trajectory_pallas(
        s["jmodel"], s["jparams"], s["jcfg"], jnp.asarray(s["state"]),
        jnp.asarray(s["U"]), interpret=True)
    assert ss.shape == (T, 7) and cs.shape == (T, 2)
    np.testing.assert_allclose(ss.numpy(), np.asarray(jss), rtol=STATE_RTOL,
                               atol=STATE_ATOL)
    np.testing.assert_array_equal(cs.numpy(), np.asarray(jcs))


# -- the launchers per spec ------------------------------------------------

def test_geometries_follow_the_spec():
    """A lane group owns whole units of every hidden layer: G is offered
    where it divides every hidden width, kernel 2's warp form where 32
    does; the picks of ``exact_geometry`` and ``chain_geometry`` stay among
    the spec's geometries, and the default spec keeps its own."""
    assert rk.lane_groups(rk.KERNEL_LAYERS) == rk.LANE_GROUPS
    assert rk.geometries(rk.KERNEL_LAYERS) == rk.GEOMETRIES
    assert rk.lane_groups(SPECS[0]) == (8, 16, 32)
    assert rk.lane_groups((6, 24, 4)) == (8,)
    assert rk.lane_groups((6, 16, 4)) == (8, 16)
    assert rk.lane_groups((6, 64, 24, 4)) == (8,)
    assert rk.lane_groups((6, 12, 4)) == ()
    assert rk.chain_geometries((6, 24, 4)) == rk.CHAIN_GEOMETRIES[:1]
    assert rk.chain_geometries((6, 24, 4), bf=True) == rk.CHAIN_GEOMETRIES
    assert rk.chain_geometries(SPECS[0]) == rk.CHAIN_GEOMETRIES
    for spec in SPECS + [(6, 12, 4)]:
        ok = set(rk.geometries(spec))
        for k in (1, 7, 1920, 8192, 8448, 8449, 65536):
            assert rk.exact_geometry(k, 132, layers=spec)[:2] in ok
            assert (rk.chain_geometry(k, 132, layers=spec)[:2]
                    in rk.chain_geometries(spec))
        assert rk.chain_geometry(1, 132, layers=spec).group == (
            32 if 32 in rk.lane_groups(spec) else 1)
    assert rk.exact_geometry(8192, 132, layers=SPECS[0]).group == 8
    assert rk.exact_geometry(1, 132, layers=(6, 16, 4)).group == 16
    assert rk.exact_geometry(1, 132, layers=(6, 12, 4)).group == 1
    for k in (1, 1920, 262144):
        assert rk.exact_geometry(k, 132) == rk.exact_geometry(
            k, 132, layers=rk.KERNEL_LAYERS)


def test_instances_and_libraries_are_named_by_spec():
    """The launch counters name another spec's instances; each spec has a
    library of its own, built from the one source with its widths as a
    define, and the default library keeps its flags."""
    wide = NeuralNetDynamics(0.02, layers=SPECS[0], device="cpu")
    default = NeuralNetDynamics(0.02, device="cpu")
    assert rk._form(wide, 0) == "_6-64-64-64-64-4"
    assert rk._form(wide, 16) == "_6-64-64-64-64-4_obstacles"
    assert rk._form(default, 0) == ""
    assert rk.kernel_layers(wide) == SPECS[0]
    assert _build.spec_defines(None) == _build.spec_defines(
        rk.KERNEL_LAYERS) == ""
    assert _build.spec_defines(SPECS[0]) == (
        "#define ARTT_MLP_HIDDEN 64, 64, 64, 64\n"
        "#define ARTT_SPEC_LIBRARY\n")
    names = {_build.library_path(s).name for s in [None] + SPECS}
    assert len(names) == 4
    assert _build.library_path(SPECS[1]).name.startswith(
        "rollout_kernels_mlp6-24-4_")
    assert _build.library_path().parent == _build.BUILD_DIR
    assert set(_build.SPEC_FUNCTIONS) < set(_build.SIGNATURES)
    with pytest.raises(ValueError, match="hidden layer"):
        _build.library_path((6, 4))
    src = _build.SOURCE.read_text()
    assert "#define ARTT_MLP_HIDDEN 32, 32" in src
    assert rk.num_weights(SPECS[0]) == 13188
    assert rk.num_weights(rk.KERNEL_LAYERS) == rk.KERNEL_NUM_WEIGHTS == 1412


# -- the capacity mode with another spec -----------------------------------

QUIET = dict(steering_std=0.0, throttle_std=0.0, kernel_rng=True)


def test_capacity_mode_with_another_spec_matches_the_jax_iterate():
    """``kernel_rng=True`` with a 6-64-64-64-64-4 model takes the capacity
    mode, as the JAX package does (``_use_kernel_rng`` by the kernel form,
    not the compiled spec): on the CPU one iteration is pass 1's and pass
    2's plain versions, held against the JAX ``fused_rng_solve_iteration``
    in TPU interpret mode with zero exploration noise (every control U
    but the pure-noise band's 0, whatever the stream; the two streams
    differ)."""
    s = _setup(SPECS[0], **QUIET)
    solver = mppi.MPPISolver(s["model"], MPPICost(), s["cfg"], device="cpu")
    assert solver._use_kernel_rng(s["costmap"])
    key = torch.tensor([0x2545F491, 0x9E3779B9])
    state, U = torch.tensor(s["state"]), torch.tensor(s["U"])
    cp = CostParams(desired_speed=6.0)
    U_new, stats = solver._iterate_kernel_rng(s["params"], cp, s["costmap"],
                                              state, U, key)
    jU, jtotal, _ = jrk.fused_rng_solve_iteration(
        s["jmodel"], s["jparams"], s["jcfg"].replace(use_pallas_rollout=True),
        JaxCostParams(desired_speed=6.0), s["jcostmap"],
        jnp.asarray(s["state"]), jnp.asarray(s["U"]), jax.random.PRNGKey(3),
        interpret=pltpu.InterpretParams())
    np.testing.assert_allclose(U_new.numpy(), np.asarray(jU),
                               rtol=ITER_RTOL, atol=ITER_ATOL)
    np.testing.assert_allclose(float(stats.baseline),
                               float(jnp.min(jtotal)), rtol=ITER_RTOL)
    np.testing.assert_allclose(float(stats.mean_cost),
                               float(jnp.mean(jtotal)), rtol=ITER_RTOL)
    # the band moved U
    assert not np.allclose(U_new.numpy()[1:], s["U"][1:])


def test_capacity_mode_with_another_spec_never_takes_host_noise(
        monkeypatch):
    """The solve draws the passes' key, not host noise; on the card pass 1
    takes the spec's own library (``_build.load``, which records the
    request and raises here: nothing is built), and a tensor on no CUDA
    device is refused, never run on host noise instead."""
    s = _setup(SPECS[0], **QUIET)
    solver = mppi.MPPISolver(s["model"], MPPICost(), s["cfg"], device="cpu")

    def no_host_noise(*args):
        raise AssertionError("host noise drawn in the capacity mode")

    solver._sample_noise = no_host_noise
    draw = solver._draw(s["costmap"], np.array([1, 2], np.uint32))
    assert draw.dtype == torch.int64 and draw.shape == (2,)
    cs, stats = solver.solve(s["params"], CostParams(), s["costmap"],
                             s["state"], solver.init_state())
    assert torch.isfinite(cs.U).all() and np.isfinite(float(stats.ess))
    asked = []

    def load(layers=None):
        asked.append(layers)
        raise LookupError("no build here")

    monkeypatch.setattr(rk._build, "load", load)
    rk._kernel_lib.cache_clear()
    with pytest.raises(LookupError):
        rk.prepare_fused_rng_costs(s["model"], s["params"], s["cfg"],
                                   CostParams(), s["costmap"],
                                   torch.tensor(s["state"]),
                                   torch.tensor(s["U"]), draw)
    assert asked == [SPECS[0]]
    rk._kernel_lib.cache_clear()
    with pytest.raises(ValueError, match="no rollout kernel"):
        rk.fused_rng_costs(s["model"], s["params"], s["cfg"], CostParams(),
                           s["costmap"], torch.tensor(s["state"]),
                           torch.tensor(s["U"]).to("meta"), draw)
