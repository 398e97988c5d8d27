"""Kernel 3 (the fused rollout on a neural field) at MLP layer specs other
than the default library's 6-32-32-4, on the CPU: its plain PyTorch
version, which the wrapper runs for CPU tensors, against the JAX
``fused_rollout_cost_pallas`` in interpret mode at 6-16-16-16-4 (deeper
than the default) and 6-24-4; ``MPPISolver.iterate`` on the field with
host noise and in the capacity mode against the JAX iterate; and the
field kernels' shared-memory layout per spec (the field after the
weights at a float4, also for 6-25-4's 279 weights).  The field is the
spec the CUDA field kernels are compiled for, 34-64-64-1 with F=8, from a
numpy seed.  Same seeded weights (``params_from_jax``), same numpy noise,
K=256, T=24.  The CUDA kernels run only on a GPU: ``chip_smoke.py`` phase
28 holds them against these plain versions there."""

import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autorally_tpu.config import CostParams as JaxCostParams
from autorally_tpu.config import MPPIConfig as JaxConfig
from autorally_tpu.costs import MPPICost as JaxCost
from autorally_tpu.costs.neural_costmap import NeuralCostmap as JaxField
from autorally_tpu.models import NeuralNetDynamics as JaxNN
from autorally_tpu.ops import rollout_kernel as jrk
from autorally_tpu.solver import mppi as jmppi
from autorally_tpu_torch.config import CostParams, MPPIConfig
from autorally_tpu_torch.costs import MPPICost, NeuralCostmap
from autorally_tpu_torch.models import NeuralNetDynamics
from autorally_tpu_torch.ops import _build
from autorally_tpu_torch.ops import kernel_rng as kr
from autorally_tpu_torch.ops import rollout_kernel as rk
from autorally_tpu_torch.solver import mppi
from autorally_tpu_torch.tools import field_variants
from tests.test_torch_solver import _assert_stats

SPECS = [(6, 16, 16, 16, 4), (6, 24, 4)]
K, T = 256, 24
F, HIDDEN = rk.FIELD_KERNEL_FREQS, (64, 64)
# 23 running-average steps of fp32 with another summation order in the MLP
# and the field (tests/test_torch_mlp_specs.py's tolerances)
COST_RTOL, COST_ATOL = 2e-5, 1e-4
USEQ_ATOL = 1e-6                    # perturb is one multiply and one add
# one iteration: tests/test_torch_mlp_specs.py's (a softmax over 256
# float32 costs summed in another order)
ITER_RTOL, ITER_ATOL = 1e-4, 1e-5
XB, YB = (20.0, 30.0), (-5.0, 5.0)
START = (25.0, 0.0, np.pi / 2, 0.0, 6.0, 0.1, 0.0)
FIELD_SEED = 5
KEY = torch.tensor([0x2545F491, 0x9E3779B9])
CASES = {
    "nominal": ({}, {}, 0),
    "wide_noise": (dict(steering_std=4 * 0.275, throttle_std=4 * 0.3), {},
                   0),
    "nan_x": ({}, {0: np.nan}, 0),
    "k_offset": ({}, {}, 128),
}


def _label(spec):
    return "-".join(map(str, spec))


@functools.cache
def field_arrays(spec, seed=FIELD_SEED, fspec=(F,) + HIDDEN):
    """A field of the spec ``fspec`` (F and the hidden widths; 34-64-64-1,
    F=8, by default) over a 10 m x 10 m map around the start: He-normal
    weights and small biases from ``seed``, the output layer rescaled to a
    standard deviation of 0.25 over the map and shifted so that the 0.65
    crash boundary lies at the median of the highest value that each
    rollout of ``spec``'s wide-noise case meets (its plain chain): about
    half of those rollouts crash, at different steps."""
    rs = np.random.default_rng(seed)
    layers = rk.field_layers(fspec)
    W = [(np.sqrt(2.0 / a) * rs.standard_normal((a, b))).astype(np.float32)
         for a, b in zip(layers[:-1], layers[1:])]
    B = [(0.1 * rs.standard_normal(b)).astype(np.float32) for b in layers[1:]]
    freqs = ((2.0 ** np.arange(fspec[0])) * np.pi).astype(np.float32)
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
    B[-1] = ((B[-1] - raw.mean()) * scale).astype(np.float32)
    field = NeuralCostmap.build(W, B, freqs, r_c1, r_c2, trs, device="cpu")
    s = setup(spec, "wide_noise")
    states, _ = rk.dynamics_chain_plain(
        s["model"], s["params"], s["cfg"], torch.tensor(s["state"]),
        torch.tensor(s["U"]), torch.tensor(s["eps"]))
    x, y, yaw = states[0, :-1], states[1, :-1], states[2, :-1]  # s_1..s_T-1
    hx, hy = 0.5 * torch.cos(yaw), 0.5 * torch.sin(yaw)
    peak = torch.maximum(field.lookup_ch0(x + hx, y + hy),
                         field.lookup_ch0(x - hx, y - hy)).amax(dim=0)
    B[-1] = (B[-1] + np.float32(0.65 - torch.median(peak).item())).astype(
        np.float32)
    return dict(weights=tuple(W), biases=tuple(B), freqs=freqs, r_c1=r_c1,
                r_c2=r_c2, trs=trs)


def fields(spec, seed=FIELD_SEED, fspec=(F,) + HIDDEN):
    """(port field on the CPU, JAX field) with the same arrays, of the
    field spec ``fspec``, the boundary placed for ``spec``
    (``field_arrays``)."""
    jf = JaxField(**{k: (tuple(jnp.asarray(a) for a in v)
                         if isinstance(v, tuple) else jnp.asarray(v))
                     for k, v in field_arrays(spec, seed, fspec).items()})
    return (NeuralCostmap.from_jax(jax.tree_util.tree_map(np.asarray, jf),
                                   device="cpu"), jf)


def setup(spec, case="nominal", seed=0, **cfg_extra):
    """The port's and the JAX package's model, params and config of
    ``spec`` (the same seeded weights), the case's state, U, eps and
    k_offset (eps over the K - k_offset rollouts of a shard)."""
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
    rs = np.random.default_rng(seed + 1)
    state = np.array(START, np.float32)
    for i, v in state_kw.items():
        state[i] = v
    U = np.tile(np.array([0.0, 0.3], np.float32), (T, 1))
    U[:, 0] = rs.uniform(-0.3, 0.3, T).astype(np.float32)
    eps = rs.standard_normal((T, K - k_off, 2)).astype(np.float32)
    return dict(cfg=cfg, jcfg=jcfg, model=model, params=params,
                jmodel=jmodel, jparams=jparams, state=state, U=U, eps=eps,
                k_offset=k_off)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("spec", SPECS, ids=_label)
def test_fused_field_plain_matches_jax_kernel(spec, case):
    """Kernel 3's plain version against ``fused_rollout_cost_pallas`` in
    interpret mode at the spec: costs within COST_RTOL / COST_ATOL, crash
    flags equal, u_seq within USEQ_ATOL."""
    s = setup(spec, case)
    field, jfield = fields(spec)
    costs, u_seq, crash = rk.fused_rollout_cost(
        s["model"], s["params"], s["cfg"], CostParams(), field,
        torch.tensor(s["state"]), torch.tensor(s["U"]),
        torch.tensor(s["eps"]), k_offset=s["k_offset"])
    jc, ju, jx = jrk.fused_rollout_cost_pallas(
        s["jmodel"], s["jparams"], s["jcfg"], JaxCostParams(), jfield,
        jnp.asarray(s["state"]), jnp.asarray(s["U"]), jnp.asarray(s["eps"]),
        k_offset=s["k_offset"], interpret=True)
    np.testing.assert_allclose(costs.numpy(), np.asarray(jc),
                               rtol=COST_RTOL, atol=COST_ATOL)
    np.testing.assert_array_equal(crash.numpy(), np.asarray(jx))
    np.testing.assert_allclose(u_seq.numpy(), np.asarray(ju), rtol=0,
                               atol=USEQ_ATOL)
    assert np.isfinite(costs.numpy()).all()
    if case == "wide_noise":
        n = K - s["k_offset"]
        assert 0 < int(crash.sum()) < n     # the flags differ between rollouts


def _solvers(spec, **cfg_kw):
    """(port solver, params, JAX solver, JAX params) of ``spec``."""
    s = setup(spec, **cfg_kw)
    return (mppi.MPPISolver(s["model"], MPPICost(), s["cfg"], device="cpu"),
            s["params"], jmppi.MPPISolver(s["jmodel"], JaxCost(), s["jcfg"]),
            s["jparams"], s)


@pytest.mark.parametrize("mode", ["host_noise", "capacity"])
@pytest.mark.parametrize("spec", SPECS, ids=_label)
def test_field_iterate_matches_jax(spec, mode):
    """One iteration on the field, U_new and the six SolveStats within
    ITER_RTOL / ITER_ATOL, against the JAX ``iterate`` on the same noise (in
    the capacity mode the port's stream: the JAX kernel-RNG passes draw
    from the TPU's own PRNG).  On the CPU the capacity mode runs pass 1's
    field mode and pass 2 as their plain versions, which the card's
    ``fused_rng_field_kernel`` of the spec's library replaces."""
    solver, params, jsolver, jparams, s = _solvers(
        spec, kernel_rng=mode == "capacity")
    field, jfield = fields(spec)
    cp = CostParams(desired_speed=6.0)
    args = (torch.tensor(s["state"]), torch.tensor(s["U"]))
    eps = s["eps"]
    if mode == "capacity":
        assert solver._use_kernel_rng(field)
        U_new, stats = solver._iterate_kernel_rng(params, cp, field, *args,
                                                  KEY)
        eps = kr.kernel_noise(KEY, 0, K, T, None).numpy()
    else:
        assert not solver._use_kernel_rng(field)
        U_new, stats = solver.iterate(params, cp, field, *args,
                                      torch.tensor(eps))
    jU, jstats = jsolver.iterate(jparams, JaxCostParams(desired_speed=6.0),
                                 jfield, jnp.asarray(s["state"]),
                                 jnp.asarray(s["U"]), jnp.asarray(eps))
    np.testing.assert_allclose(U_new.numpy(), np.asarray(jU),
                               rtol=ITER_RTOL, atol=ITER_ATOL)
    _assert_stats(stats, jstats, ITER_RTOL, ITER_ATOL)
    assert 1.0 < float(stats.ess) < K


# ---------------------------------------------------------------------------
# the field kernels' shared memory and instances per spec
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", [(6, 25, 4), (6, 64, 64, 64, 64, 4),
                                  rk.KERNEL_LAYERS], ids=_label)
def test_field_layout_follows_the_kernels(spec):
    """The packed weights in the kernels' order (W0 (out, in) row-major,
    b0, W1, b1, ...), and the field kernels' shared memory (csrc
    FieldSmem): the field after the weights rounded up to a float4 (6-25-4:
    279 weights, the field at float 280), the tiles of the spec library's
    warps a block (8 for another spec, one block an SM; 4 for the default,
    two), U and the circles; the longest horizon a field launch takes."""
    model = NeuralNetDynamics(0.02, layers=spec, device="cpu")
    params = model.init_params(2)
    packed = rk._pack_weights(model, params)
    n_w = rk.num_weights(spec)
    assert packed.shape == (n_w,)
    at = 0
    for W, b in zip(params["weights"], params["biases"]):
        n_in, n_out = W.shape
        assert torch.equal(packed[at:at + n_in * n_out],
                           W.T.reshape(-1))                  # (out, in)
        assert torch.equal(packed[at + n_in * n_out:
                                  at + n_in * n_out + n_out], b)
        at += n_in * n_out + n_out
    assert at == n_w
    lay = rk.field_smem_layout(spec, T=100, n_obs=16)
    default = spec == rk.KERNEL_LAYERS
    block = rk.field_block(spec)
    assert block == (128 if default else 256)
    assert lay["f"] == -(-n_w // 4) * 4 and lay["f"] % 4 == 0
    assert lay["f"] - n_w == (1 if spec == (6, 25, 4) else 0)
    assert lay["tiles"] == lay["f"] + rk.FIELD_PACK_FLOATS
    assert lay["U"] == lay["tiles"] + block // 32 * (64 * 44 + 64)
    assert lay["tiles"] % 4 == lay["U"] % 4 == 0      # float4 tile rows
    assert lay["bytes"] == 4 * (lay["U"] + 2 * 100 + 3 * 16)
    if default:
        assert rk.field_smem_layout(spec, T=100)["bytes"] == 106592
    if spec == (6, 64, 64, 64, 64, 4):
        # one 8-warp block an SM; the longest launch fits a block's 227 KB
        assert rk.field_smem_layout(spec, T=100)["bytes"] == 199776
        assert rk.field_smem_layout(spec, T=2048, n_obs=64)["bytes"] \
            == 216128 <= 232448
    assert rk.max_field_kernel_t(spec) == rk.MAX_FIELD_KERNEL_T
    assert rk.field_smem_layout(spec, T=rk.max_field_kernel_t(spec),
                                n_obs=rk.MAX_OBSTACLES)["bytes"] <= 232448
    # past the staged horizon U stays in device memory: any T fits
    past = rk.field_smem_layout(spec, T=rk.max_field_kernel_t(spec) + 1,
                                n_obs=rk.MAX_OBSTACLES)
    assert past["u_layout"] == "global" and past["obs"] == past["U"]
    assert past["bytes"] == 4 * (past["U"] + 3 * rk.MAX_OBSTACLES)


def test_field_layout_matches_the_source():
    """The wrapper's mirror of the layout reads the source's constants: the
    spec library's block, the tile, the weights rounded up to a float4, the
    horizon's room; a spec whose weights leave no room for the staged field
    takes the global layout (the field in device memory), past its staged
    horizon U stays in device memory too, and one whose weights and tiles
    leave no room at all stages U at no T and is refused (Queue 2 A9)."""
    src = _build.SOURCE.read_text()
    assert re.search(r"constexpr int kSpecFieldBlock = (\d+);",
                     src).group(1) == str(rk.SPEC_FIELD_BLOCK)
    # the tile's row stride: the first layer's K1 columns and 4 (44 for
    # the default field)
    assert "static constexpr int kTileStride = kK1 + 4;" in src
    assert rk.field_tile_floats(rk.FIELD_KERNEL_SPEC) == 64 * 44 + 64
    assert "return (Deriv::kNumWeights + 3) / 4 * 4;" in src
    assert "(232448 / 4 - field_weight_floats<MlpDeriv>() - pack" in src
    assert "const int room = field_room_t(kFieldStagedPack, reserved);" in src
    assert rk.SMEM_FLOATS == 232448 // 4
    assert rk.field_global((6, 128, 128, 128, 4))
    assert rk.max_field_kernel_t((6, 128, 128, 128, 4)) == 222
    assert rk.max_field_kernel_t((6, 128, 128, 128, 128, 4)) == 0
    assert "return T <= cap ? T : 0;" in src          # staged_u
    assert rk.staged_u(222, 222) == 222 and rk.staged_u(223, 222) == 0
    assert rk.field_smem_layout((6, 128, 128, 128, 4), T=223)["u_layout"] \
        == "global"
    rk._check_field_room((6, 128, 128, 128, 4), rk.FIELD_KERNEL_SPEC)
    with pytest.raises(NotImplementedError, match="Queue 2 A9"):
        rk._check_field_room((6, 128, 128, 128, 128, 4),
                             rk.FIELD_KERNEL_SPEC)
    assert not rk.field_global((6, 128, 128, 4))
    assert 0 < rk.max_field_kernel_t((6, 128, 128, 4)) < rk.MAX_FIELD_KERNEL_T
    # the entry points a spec library now holds
    for fn in ("artt_fused_field_rollout_cost", "artt_fused_rng_costs",
               "artt_fused_rng_field_costs", "artt_field_kernel_info",
               "artt_field_block", "artt_max_field_t"):
        assert fn in _build.SPEC_FUNCTIONS
    for fn in ("artt_weighted_update", "artt_num_bf_weights",
               "artt_div_const_check"):
        assert fn not in _build.SPEC_FUNCTIONS


@pytest.mark.parametrize("name", list(field_variants.VARIANTS)
                         + list(field_variants.SPEC_BLOCK_VARIANTS)
                         + list(field_variants.FIELD_BLOCK_VARIANTS))
def test_field_variants_edit_the_source_as_it_is(name):
    """``tools/field_variants.py`` builds each variant by replacing text of
    the source: every text it replaces is there, once (the tool raises on
    a missing one, on the card, after its builds started)."""
    src = _build.SOURCE.read_text()
    edits = {**field_variants.VARIANTS,
             **field_variants.SPEC_BLOCK_VARIANTS,
             **field_variants.FIELD_BLOCK_VARIANTS}[name]
    for old, new in edits:
        assert src.count(old) == 1, old
        assert old != new
