"""The port's neural costmap and its fused rollout paths on the CPU, against
the JAX package: ``NeuralCostmap.lookup_ch0``, kernel 3's plain version
against ``fused_rollout_cost_pallas`` in interpret mode and the JAX scan
path, pass 1's field mode against the JAX host-noise path fed the port's
stream, ``iterate`` and ``solve`` in both modes, the capacity-mode gate,
the fit, and ``drive_oval --neural-costmap``.

The field is small and random (F=4, hidden (16, 16)) from a numpy seed, its
output rescaled to values around the 0.65 crash boundary over a 10 m x 10 m
map around the start, and carried to both packages as the same arrays
(``NeuralCostmap.from_jax``).  K=256, T=24.  The CUDA kernels run only on a
GPU: ``chip_smoke.py`` holds them against these plain versions there."""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from autorally_tpu.config import CostParams as JaxCostParams
from autorally_tpu.config import MPPIConfig as JaxConfig
from autorally_tpu.costs import MPPICost as JaxCost
from autorally_tpu.costs.costmap import make_costmap as jax_make_costmap
from autorally_tpu.costs.neural_costmap import NeuralCostmap as JaxField
from autorally_tpu.models import NeuralNetDynamics as JaxNN
from autorally_tpu.ops import rollout_kernel as jrk
from autorally_tpu.solver import mppi as jmppi
from autorally_tpu.tools.track_generator import oval_track
from autorally_tpu_torch import drive_oval
from autorally_tpu_torch.config import CostParams, MPPIConfig
from autorally_tpu_torch.costs import (MPPICost, NeuralCostmap,
                                       fit_neural_costmap, make_costmap)
from autorally_tpu_torch.models import NeuralNetDynamics
from autorally_tpu_torch.ops import kernel_rng as kr
from autorally_tpu_torch.ops import rollout_kernel as rk
from autorally_tpu_torch.solver import mppi
from tests.test_torch_rollout_kernel import COST_ATOL, COST_RTOL, USEQ_ATOL
from tests.test_torch_solver import ITER_ATOL, ITER_RTOL, _assert_stats

K, T = 256, 24
F, HIDDEN = 4, (16, 16)
XB, YB = (20.0, 30.0), (-5.0, 5.0)
START = np.array([25.0, 0.0, np.pi / 2, 0.0, 6.0, 0.1, 0.0], np.float32)
FIELD_SEED = 3
KEY = torch.tensor([0x2545F491, 0x9E3779B9])
LOOKUP_ATOL = 1e-5
CASES = {
    "nominal": ({}, {}),
    "wide_noise": (dict(steering_std=4 * 0.275, throttle_std=4 * 0.3), {}),
    "nan_x": ({}, {0: np.nan}),
}
SAMPLERS = {"gaussian": {}, "ou": dict(noise_sampler="ou", noise_param=0.15)}


def _field_arrays(seed=FIELD_SEED):
    """He-normal weights and small biases from ``seed``; the output layer
    rescaled so that the field has mean 0.35 and std 0.25 over the map
    (values cross the 0.65 boundary; 0.45 and 0.36 at the start's front
    and back, so that the rollouts' shared first step does not crash)."""
    rs = np.random.default_rng(seed)
    layers = (2 + 4 * F,) + HIDDEN + (1,)
    W = [(np.sqrt(2.0 / a) * rs.standard_normal((a, b))).astype(np.float32)
         for a, b in zip(layers[:-1], layers[1:])]
    B = [(0.1 * rs.standard_normal(b)).astype(np.float32) for b in layers[1:]]
    freqs = ((2.0 ** np.arange(F)) * np.pi).astype(np.float32)
    r_c1 = np.array([1 / (XB[1] - XB[0]), 0, 0], np.float32)
    r_c2 = np.array([0, 1 / (YB[1] - YB[0]), 0], np.float32)
    trs = np.array([-XB[0] / (XB[1] - XB[0]), -YB[0] / (YB[1] - YB[0]), 1],
                   np.float32)
    g = np.linspace(0, 1, 101, dtype=np.float32)
    uu, vv = np.meshgrid(g, g)
    raw = NeuralCostmap.build(W, B, freqs, r_c1, r_c2, trs, device="cpu") \
        .forward_norm(torch.tensor(uu.ravel()), torch.tensor(vv.ravel())) \
        .numpy()
    scale = 0.25 / raw.std()
    W[-1] = (W[-1] * scale).astype(np.float32)
    B[-1] = ((B[-1] - raw.mean()) * scale + 0.35).astype(np.float32)
    return dict(weights=tuple(W), biases=tuple(B), freqs=freqs, r_c1=r_c1,
                r_c2=r_c2, trs=trs)


def _fields(seed=FIELD_SEED):
    """(port field on the CPU, JAX field) with the same arrays."""
    jf = JaxField(**{k: (tuple(jnp.asarray(a) for a in v)
                         if isinstance(v, tuple) else jnp.asarray(v))
                     for k, v in _field_arrays(seed).items()})
    return (NeuralCostmap.from_jax(jax.tree_util.tree_map(np.asarray, jf),
                                   device="cpu"), jf)


def _pair(**cfg_kw):
    """(port solver, params, JAX solver, JAX params) with the same seeded
    weights."""
    jcfg = JaxConfig(num_rollouts=K, num_timesteps=T, **cfg_kw)
    cfg = MPPIConfig(num_rollouts=K, num_timesteps=T, **cfg_kw)
    jmodel = JaxNN(jcfg.dt, control_ranges=jcfg.control_ranges)
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    model = NeuralNetDynamics(cfg.dt, control_ranges=cfg.control_ranges,
                              device="cpu")
    params = model.params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                          jparams))
    return (mppi.MPPISolver(model, MPPICost(), cfg, device="cpu"), params,
            jmppi.MPPISolver(jmodel, JaxCost(), jcfg), jparams)


def _interpret(jsolver):
    """The JAX solver through its Pallas kernels in interpret mode."""
    js = jmppi.MPPISolver(jsolver.model, jsolver.cost,
                          jsolver.cfg.replace(use_pallas_rollout=True))
    js._pallas_interpret = True
    return js


def _inputs(state_kw=None, seed=1):
    state = START.copy()
    for i, v in (state_kw or {}).items():
        state[i] = v
    rs = np.random.default_rng(seed)
    U = np.tile(np.array([0.0, 0.3], np.float32), (T, 1))
    U[:, 0] = rs.uniform(-0.3, 0.3, T).astype(np.float32)
    eps = rs.standard_normal((T, K, 2)).astype(np.float32)
    return state, U, eps


# ---------------------------------------------------------------------------
# the field
# ---------------------------------------------------------------------------

def test_lookup_ch0_matches_jax_on_random_off_map_and_nan_points():
    field, jfield = _fields()
    rs = np.random.default_rng(3)
    x = rs.uniform(XB[0] - 5, XB[1] + 5, 3000).astype(np.float32)
    y = rs.uniform(YB[0] - 5, YB[1] + 5, 3000).astype(np.float32)
    x[:10], y[10:20], x[20:30], y[20:30] = np.nan, np.nan, np.inf, -np.inf
    x, y = x.reshape(30, 100), y.reshape(30, 100)
    got = field.lookup_ch0(torch.tensor(x), torch.tensor(y)).numpy()
    want = np.asarray(jfield.lookup_ch0(jnp.asarray(x), jnp.asarray(y)))
    assert got.shape == (30, 100) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=LOOKUP_ATOL)
    # off the map the coordinates clip to the edge; NaN samples (0, 0)
    corner = field.lookup_ch0(torch.tensor([XB[0] - 50.0, np.nan]),
                              torch.tensor([YB[0] - 50.0, 0.0]))
    assert corner[0] == corner[1]
    four = field.lookup(torch.tensor(x[0]), torch.tensor(y[0])).numpy()
    np.testing.assert_array_equal(four[:, 0], got[0])
    np.testing.assert_array_equal(four[:, 1:], 0.0)


def test_from_jax_carries_float32_fields_only():
    """float32 and bfloat16 fields cross bit for bit (a bf16 field keeps
    its dtype); weights of another dtype raise."""
    field, jfield = _fields()
    assert field.layers == (2 + 4 * F,) + HIDDEN + (1,)
    assert field.device == torch.device("cpu")
    assert field.dtype == torch.float32
    for w, jw in zip(field.weights, jfield.weights):
        np.testing.assert_array_equal(w.numpy(), np.asarray(jw))
    assert field.transform == tuple(float(v) for c in (
        jfield.r_c1, jfield.r_c2, jfield.trs) for v in np.asarray(c))
    host = jax.tree_util.tree_map(np.asarray, jfield)
    rest = [getattr(host, n) for n in ("biases", "freqs", "r_c1", "r_c2",
                                       "trs")]
    bf16 = JaxField(tuple(w.astype(ml_dtypes.bfloat16)
                          for w in host.weights), *rest)
    got = NeuralCostmap.from_jax(bf16, device="cpu")
    assert got.dtype == torch.bfloat16 and got.layers == field.layers
    for w, jw in zip(got.weights, bf16.weights):
        assert w.dtype == torch.bfloat16
        np.testing.assert_array_equal(w.view(torch.int16).numpy(),
                                      np.asarray(jw).view(np.int16))
    for b, jb in zip(got.biases, host.biases):
        assert b.dtype == torch.float32
        np.testing.assert_array_equal(b.numpy(), jb)
    assert got.to_float32().dtype == torch.float32
    assert field.to_float32() is field
    f16 = JaxField(tuple(w.astype(np.float16) for w in host.weights), *rest)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        NeuralCostmap.from_jax(f16, device="cpu")


@pytest.fixture(scope="module")
def fitted():
    """``tests/test_neural_costmap.py``'s fixture, fitted by the port."""
    data, xb, yb = oval_track(ppm=4.0)
    cm = make_costmap(data, xb, yb, device="cpu")
    nc, metrics = fit_neural_costmap(cm, epochs=1200, batch=8192,
                                     num_freqs=6, hidden=(48, 48),
                                     device="cpu")
    return cm, nc, metrics


def test_fit_meets_the_jax_tests_bounds(fitted):
    """Fit quality (``test_fit_quality``) and agreement with the exact map
    on the track (``test_field_matches_costmap_on_track``)."""
    cm, nc, metrics = fitted
    assert metrics["mae"] < 0.05, metrics
    assert metrics["boundary_flip_rate"] < 0.05, metrics
    assert metrics["max_err"] >= metrics["mae"]
    assert nc.layers == (26, 48, 48, 1) and nc.transform == cm.transform
    th = np.random.RandomState(0).uniform(0, 2 * np.pi, 500)
    xs = torch.tensor(25.0 * np.cos(th), dtype=torch.float32)
    ys = torch.tensor(15.0 * np.sin(th), dtype=torch.float32)
    err = (cm.lookup_ch0(xs, ys) - nc.lookup_ch0(xs, ys)).abs().mean()
    assert float(err) < 0.15


# ---------------------------------------------------------------------------
# kernel 3 and pass 1's field mode (plain versions) against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["interpret_kernel", "scan"])
@pytest.mark.parametrize("case", list(CASES))
def test_fused_field_plain_matches_jax(case, backend):
    """Against ``fused_rollout_cost_pallas`` in interpret mode and the JAX
    solver's scan path (``rollout_costs``)."""
    cfg_kw, state_kw = CASES[case]
    solver, params, jsolver, jparams = _pair(**cfg_kw)
    field, jfield = _fields()
    state, U, eps = _inputs(state_kw)
    costs, u_seq, crash = rk.fused_rollout_cost(
        solver.model, params, solver.cfg, CostParams(), field,
        torch.tensor(state), torch.tensor(U), torch.tensor(eps))
    jargs = (jnp.asarray(state), jnp.asarray(U), jnp.asarray(eps))
    if backend == "interpret_kernel":
        jc, ju, jx = jrk.fused_rollout_cost_pallas(
            jsolver.model, jparams, jsolver.cfg, JaxCostParams(), jfield,
            *jargs, interpret=True)
        ju = np.asarray(ju)
    else:
        assert not jsolver.use_pallas_rollout
        jc, ju, jx = jsolver.rollout_costs(jparams, JaxCostParams(), jfield,
                                           *jargs)
        ju = np.asarray(ju).transpose(2, 0, 1)
    np.testing.assert_allclose(costs.numpy(), np.asarray(jc),
                               rtol=COST_RTOL, atol=COST_ATOL)
    np.testing.assert_array_equal(crash.numpy(), np.asarray(jx))
    # u_seq equals the kernel's exactly; XLA contracts the scan path's
    # U + eps * nu into one FMA, hence USEQ_ATOL there
    np.testing.assert_allclose(u_seq.numpy(), ju, rtol=0, atol=(
        0 if backend == "interpret_kernel" else USEQ_ATOL))
    assert np.isfinite(costs.numpy()).all()
    if case == "wide_noise":
        assert 0 < int(crash.sum()) < K     # the flags differ between rollouts


@pytest.mark.parametrize("backend", ["scan", "interpret_kernel"])
@pytest.mark.parametrize("sampler", list(SAMPLERS))
def test_pass1_field_plain_matches_jax_rollout_costs(sampler, backend):
    """Pass 1 in field mode against the JAX host-noise path fed the port's
    stream (the JAX kernel-RNG passes draw from the TPU's own PRNG)."""
    wide = dict(steering_std=4 * 0.275, throttle_std=4 * 0.3)
    solver, params, jsolver, jparams = _pair(kernel_rng=True, **wide,
                                             **SAMPLERS[sampler])
    if backend == "interpret_kernel":
        jsolver = _interpret(jsolver)
    field, jfield = _fields()
    state, U, _ = _inputs()
    total, crash, ctx = rk.fused_rng_costs(
        solver.model, params, solver.cfg, CostParams(), field,
        torch.tensor(state), torch.tensor(U), KEY)
    eps = rk.rng_noise(ctx).numpy()
    jc, _, jx = jsolver.rollout_costs(jparams, JaxCostParams(), jfield,
                                      jnp.asarray(state), jnp.asarray(U),
                                      jnp.asarray(eps))
    np.testing.assert_allclose(total.numpy(), np.asarray(jc),
                               rtol=ITER_RTOL, atol=ITER_ATOL)
    np.testing.assert_array_equal(crash.numpy(), np.asarray(jx))
    assert 0 < int(crash.sum()) < K


@pytest.mark.parametrize("mode", ["host_noise", "capacity"])
def test_iterate_matches_jax(mode):
    """One iteration on a field, U_new and all six SolveStats, against JAX
    ``iterate`` on the same noise (in the capacity mode, the stream)."""
    solver, params, jsolver, jparams = _pair(
        kernel_rng=mode == "capacity")
    field, jfield = _fields()
    state, U, eps = _inputs()
    cp = CostParams(desired_speed=6.0)
    args = (torch.tensor(state), torch.tensor(U))
    if mode == "capacity":
        assert solver._use_kernel_rng(field)
        U_new, stats = solver._iterate_kernel_rng(params, cp, field, *args,
                                                  KEY)
        eps = kr.kernel_noise(KEY, 0, K, T, None).numpy()
    else:
        U_new, stats = solver.iterate(params, cp, field, *args,
                                      torch.tensor(eps))
    jU, jstats = jsolver.iterate(jparams, JaxCostParams(desired_speed=6.0),
                                 jfield, jnp.asarray(state), jnp.asarray(U),
                                 jnp.asarray(eps))
    np.testing.assert_allclose(U_new.numpy(), np.asarray(jU),
                               rtol=ITER_RTOL, atol=ITER_ATOL)
    _assert_stats(stats, jstats, ITER_RTOL, ITER_ATOL)
    assert 1.0 < float(stats.ess) < K


@pytest.mark.parametrize("mode", ["host_noise", "capacity"])
def test_solve_matches_jax(mode):
    """One ``solve`` on a field (iteration, Savitzky-Golay, nominal
    trajectory) against JAX fed the same noise: the host-noise solve's
    sampler is replaced by fixed noise on both sides; the capacity solve
    draws the stream of the subkey that ``jax.random.split`` takes from the
    JAX state's own key, and JAX is fed that stream; both solves return the
    same new key."""
    solver, params, jsolver, jparams = _pair(
        kernel_rng=mode == "capacity")
    field, jfield = _fields()
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
    cs, stats = solver.solve(params, CostParams(), field, state,
                             solver.init_state())
    jcs, jstats = jsolver.solve(jparams, JaxCostParams(), jfield, state,
                                jcs0)
    np.testing.assert_array_equal(cs.key,
                                  np.asarray(jax.random.key_data(jcs.key)))
    for name in ("U", "control_solution", "state_solution"):
        np.testing.assert_allclose(getattr(cs, name).numpy(),
                                   np.asarray(getattr(jcs, name)),
                                   rtol=ITER_RTOL, atol=ITER_ATOL,
                                   err_msg=name)
    _assert_stats(stats, jstats, ITER_RTOL, ITER_ATOL)


def test_use_kernel_rng_matches_the_jax_gate_for_a_field():
    """The JAX gate (on a solver forced onto its kernel path, where the
    gate is decided) and the port's agree for a field, exact_fused or not;
    a field needs no exact_fused in either."""
    field, jfield = _fields()
    for kw in (dict(kernel_rng=True), dict(kernel_rng=False),
               dict(kernel_rng=True, exact_fused=False),
               dict(kernel_rng=True, noise_sampler="ou", noise_param=0.15),
               dict(kernel_rng=True, noise_sampler="ou", noise_param=2.5),
               dict(kernel_rng=True, noise_sampler="colored")):
        solver, _, jsolver, _ = _pair(**kw)
        want = _interpret(jsolver)._use_kernel_rng(jfield)
        assert solver._use_kernel_rng(field) == want, kw
    assert solver._use_kernel_rng(field) is False      # colored


# ---------------------------------------------------------------------------
# the kernels' host side: packing, scalars, dispatch, refusals
# ---------------------------------------------------------------------------

def _default_field():
    """A random field of the spec the CUDA kernels are compiled for."""
    data, xb, yb = oval_track(ppm=1.0)
    return fit_neural_costmap(make_costmap(data, xb, yb, device="cpu"),
                              epochs=0, device="cpu")[0]


def test_pack_field_follows_the_kernel_layout_and_is_reused():
    field = _default_field()
    assert field.layers == rk.FIELD_KERNEL_LAYERS
    packed = rk._pack_field(field)
    # the tensor-core layout: layer 1's and layer 2's B fragments (TF32 hi
    # and lo, 4 floats a lane), then the float32 tail
    n1, n2 = 5 * 8 * 32 * 4, 8 * 8 * 32 * 4
    assert packed.numel() == rk.FIELD_PACK_FLOATS == n1 + n2 + 204
    (W0, W1, W2), (b0, b1, b2) = field.weights, field.biases
    frag1 = packed[:n1].reshape(5, 8, 32, 4)
    frag2 = packed[n1:n1 + n2].reshape(8, 8, 32, 4)
    # lane 6 (g 1, t 2) of k-step 1, n-tile 3: layer 1's b0 is tile row
    # 8 + 2 (cos uF_1, feature 2 + 2F + 1), column 25, b1 tile row 14
    # (cos uF_2); layer 2's are rows 8 + 4 and 8 + 5 of W1
    hi, lo = rk.tf32_split(torch.stack([W0[19, 25], W0[20, 25]]))
    assert torch.equal(frag1[1, 3, 6], torch.cat([hi, lo]))
    hi, lo = rk.tf32_split(torch.stack([W1[12, 25], W1[13, 25]]))
    assert torch.equal(frag2[1, 3, 6], torch.cat([hi, lo]))
    assert not frag1[4, :, :, 1::2].any()         # padding rows 36-39
    tail = packed[n1 + n2:]
    for got, want in zip(torch.split(tail, [64, 64, 64, 1, 8, 3]),
                         (b0, b1, W2.reshape(-1), b2, field.freqs,
                          torch.zeros(3))):
        assert torch.equal(got, want)
    assert rk._pack_field(field) is packed
    W0.add_(1.0)
    assert rk._pack_field(field) is not packed
    src = (Path(rk.__file__).parent.parent / "csrc"
           / "rollout_kernels.cu").read_text()
    consts = dict(re.findall(r"\b(kFieldBlock|kMaxFieldT) = (\d+)", src))
    assert consts == {"kFieldBlock": str(rk.FIELD_BLOCK),
                      "kMaxFieldT": str(rk.MAX_FIELD_KERNEL_T)}
    # the default field spec (F, hidden widths) and its first layer's tile
    assert re.search(r"#define ARTT_FIELD_SPEC ([\d, ]+)\n", src).group(1) \
        == ", ".join(map(str, rk.FIELD_KERNEL_SPEC))
    assert "kK1 = (4 + 4 * F + 7) / 8 * 8;" in src
    assert rk.field_tile_k(rk.FIELD_KERNEL_SPEC) == rk.FIELD_TILE_K == 40


def test_launch_scalars_take_the_fields_transform_and_no_map_size():
    field, _ = _fields()
    solver, *_ = _pair()
    floats, ints = rk.launch_scalars(solver.model, solver.cfg, 0, T, K,
                                     CostParams(), field)
    f = dict(zip(rk._FLOAT_SCALARS, floats))
    i = dict(zip(rk._INT_SCALARS, ints))
    assert [f[n] for n in ("rc1x", "rc1y", "rc1w", "rc2x", "rc2y", "rc2w",
                           "trsx", "trsy", "trsw")] == list(field.transform)
    assert (i["H"], i["W"]) == (0, 0)


def test_wrappers_dispatch_by_device_and_refuse_other_surfaces_and_specs(
        monkeypatch):
    """CPU tensors run the plain versions; a tensor on no CUDA device, the
    wrong surface, circles without obstacle terms, a horizon over 2048 and
    a field whose pack leaves no room beside an MLP spec's tiles are
    refused.  A field of another spec than the default library's asks for
    its own library (``_build.load(layers, field)``, which records the
    request and raises here: nothing is built, nothing runs the plain
    version instead); so does a pair whose staged field leaves no room (its
    library keeps the field in device memory), and a launch that fits
    neither layout raises before any build."""
    solver, params, *_ = _pair(kernel_rng=True)
    field, _ = _fields()
    state, U, eps = (torch.tensor(a) for a in _inputs())
    before = dict(rk.LAUNCHES)
    solver.solve(params, CostParams(), field, START, solver.init_state())
    rk.fused_rollout_cost(solver.model, params, solver.cfg, CostParams(),
                          field, state, U, eps)
    assert dict(rk.LAUNCHES) == before                  # CPU: plain
    run = lambda fn, surface, e=eps: fn(solver.model, params, solver.cfg,
                                        CostParams(), surface, state, U, e)
    with pytest.raises(ValueError, match="no rollout kernel"):
        run(rk.fused_rollout_cost, field, eps.to("meta"))
    cm = make_costmap(*oval_track(ppm=1.0), device="cpu")
    with pytest.raises(TypeError, match="takes a NeuralCostmap"):
        run(rk.fused_rollout_cost, cm)
    with pytest.raises(TypeError, match="takes a Costmap"):
        run(rk.fused_exact_rollout_cost, field)
    # the small test field (F=4, hidden (16, 16)) asks for the library of
    # its spec beside the MLP's, both kernels
    asked = []

    def load(layers=None, field=None):
        asked.append((layers, field))
        raise LookupError("no build here")

    monkeypatch.setattr(rk._build, "load", load)
    rk._kernel_lib.cache_clear()
    with pytest.raises(LookupError):
        run(rk.prepare_fused_rollout_cost, field)
    with pytest.raises(LookupError):
        rk.prepare_fused_rng_costs(solver.model, params, solver.cfg,
                                   CostParams(), field, state, U, KEY)
    assert asked == [(rk.KERNEL_LAYERS, (F,) + HIDDEN)] * 2
    # 34-128-128-1 beside an 8-warp spec library: no room for U beside the
    # staged field, so the pair's library takes the global layout and both
    # kernels ask for it; beside the default MLP (staged) at T=793, past
    # that library's staged horizon, U goes to device memory and both
    # kernels ask for the pair's library too
    wide = NeuralCostmap.build(
        [np.zeros((34, 128), np.float32), np.zeros((128, 128), np.float32),
         np.zeros((128, 1), np.float32)],
        [np.zeros(128, np.float32), np.zeros(128, np.float32),
         np.zeros(1, np.float32)], (2.0 ** np.arange(8)) * np.pi,
        *(np.asarray(c) for c in (field.r_c1, field.r_c2, field.trs)),
        device="cpu")
    narrow = NeuralNetDynamics(solver.cfg.dt, layers=(6, 24, 4),
                               control_ranges=solver.cfg.control_ranges,
                               device="cpu")
    nparams = narrow.init_params(0)
    for prepare in (lambda: rk.prepare_fused_rollout_cost(
            narrow, nparams, solver.cfg, CostParams(), wide, state, U, eps),
                    lambda: rk.prepare_fused_rng_costs(
            narrow, nparams, solver.cfg, CostParams(), wide, state, U,
            KEY)):
        with pytest.raises(LookupError):
            prepare()
    assert asked[2:] == [((6, 24, 4), (8, 128, 128))] * 2
    assert rk.field_global((6, 24, 4), (8, 128, 128))
    U_long, eps_long = torch.zeros(793, 2), torch.zeros(793, K, 2)
    for prepare in (lambda: rk.prepare_fused_rollout_cost(
            solver.model, params, solver.cfg, CostParams(), wide, state,
            U_long, eps_long),
                    lambda: rk.prepare_fused_rng_costs(
            solver.model, params, solver.cfg, CostParams(), wide, state,
            U_long, KEY)):
        with pytest.raises(LookupError):
            prepare()
    assert asked[4:] == [(rk.KERNEL_LAYERS, (8, 128, 128))] * 2
    lay = rk.field_smem_layout(rk.KERNEL_LAYERS, 793, 16, (8, 128, 128))
    assert (lay["layout"], lay["u_layout"]) == ("staged", "global")
    assert lay["obs"] == lay["U"]
    rk._kernel_lib.cache_clear()
    with pytest.raises(NotImplementedError, match="obstacle"):
        rk.fused_rng_costs(solver.model, params, solver.cfg,
                           CostParams(obstacles=np.zeros((1, 3))), field,
                           state, U, KEY)
    # past MAX_FIELD_KERNEL_T the default pair's launch asks for its
    # library too (U in device memory); only int32 indexing bounds T
    asked.clear()
    with pytest.raises(LookupError):
        rk.prepare_fused_rollout_cost(
            solver.model, params, solver.cfg, CostParams(), _default_field(),
            state, torch.zeros(2049, 2), torch.zeros(2049, K, 2))
    assert asked == [(rk.KERNEL_LAYERS, None)]
    assert rk.field_smem_layout(T=2049)["u_layout"] == "global"
    with pytest.raises(ValueError, match=r"T x K x C < 2\^31"):
        rk._check_horizon(2 ** 24, 64)


# ---------------------------------------------------------------------------
# the entry point
# ---------------------------------------------------------------------------

def test_drive_oval_with_a_neural_costmap():
    solver, params, cost_params, field, note = drive_oval.build(
        rollouts=32, model_path="", device="cpu", neural_costmap=True,
        fit_kwargs=dict(epochs=30, batch=1024))
    assert type(field) is NeuralCostmap and field.layers == (34, 64, 64, 1)
    assert "neural costmap fit: mae=" in note and "boundary_flip_rate" in note
    out = drive_oval.drive(solver, params, cost_params, field, 3,
                           log=lambda m: None)
    assert out["controls"].shape == (3, 2)
    assert np.isfinite(out["controls"]).all()
