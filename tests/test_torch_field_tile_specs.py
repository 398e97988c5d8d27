"""Kernels 3 and 4 (the fused rollout on a neural field and pass 1's field
mode) on every field spec the JAX field kernels take, and on bf16 fields,
on the CPU.

The CUDA field kernels are built for one field spec a library (F and the
hidden widths, ``csrc`` FieldSpec); a field of another spec than the
default 34-64-64-1 (F=8) takes a library of its own.  Here, at each label
of ``LABELS`` (F6-48-48 is the JAX package's own fit,
``tests/test_neural_costmap.py:29-30``; F5-40-20 has 24 columns, no
padding, and a width of 20 in a padded n-tile; F4-32-32-32 three hidden
layers; F8-64 one; F8-128-128 one m-tile a pass; F3 none):

- kernel 3's and pass 1's plain versions, which the wrappers run for CPU
  tensors, against the JAX ``fused_rollout_cost_pallas`` in interpret mode
  and against ``fused_rng_costs`` in TPU interpret mode with zero
  exploration noise (costs rtol 2e-5 / atol 1e-4, u_seq 1e-6, crash flags
  equal: ``tests/test_torch_field_specs.py``'s tolerances), beside the
  default MLP and, for F5-40-20, beside 6-24-4 too;
- ``MPPISolver.iterate`` on F6-48-48 with host noise and in the capacity
  mode against the JAX iterate (rtol 1e-4 / atol 1e-5);
- the packed buffer read back by the kernel's fragment formulas
  (``tests/test_torch_field_tiles.py``'s reader, a function of the spec)
  and the warp's 3xTF32 tile evaluation against both packages' float32
  field within ``TILE_ATOL`` (one TF32 pass misses it);
- the field kernels' shared memory (``rk.field_smem_layout``,
  ``rk.max_field_kernel_t``) for each MLP spec of ``MLP_SPECS`` beside
  each label, the one pair without room (F8-128-128 beside an 8-warp
  spec library) refused before any build, and the libraries the wrappers
  ask for;
- a bf16 field: ``lookup_ch0`` against the JAX ``lookup_ch0`` on the same
  bf16 values, the plain kernel 3 and pass 1 against the JAX kernels
  (which upcast the layers to float32, as the plain versions do), and
  ``fit_neural_costmap(dtype=torch.bfloat16)``.

Fields from a numpy seed (``tests/test_torch_field_specs.py``'s
``field_arrays`` at the label's spec, the crash boundary between the two
middle rollouts' highest values: ``_arrays``), K=256, T=24.  The CUDA kernels run
only on a GPU: ``chip_smoke.py`` phase 30 holds them against these plain
versions there."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from autorally_tpu.config import CostParams as JaxCostParams
from autorally_tpu.costs.neural_costmap import NeuralCostmap as JaxField
from autorally_tpu.ops import rollout_kernel as jrk
from autorally_tpu.tools.track_generator import oval_track
from autorally_tpu_torch.config import CostParams
from autorally_tpu_torch.costs import (NeuralCostmap, fit_neural_costmap,
                                       make_costmap)
from autorally_tpu_torch.ops import _build
from autorally_tpu_torch.ops import kernel_rng as kr
from autorally_tpu_torch.ops import rollout_kernel as rk
from tests import test_torch_field_tiles as tiles
from tests.test_torch_field_specs import (CASES, COST_ATOL, COST_RTOL,
                                          FIELD_SEED, ITER_ATOL, ITER_RTOL,
                                          KEY, USEQ_ATOL, K, T, _label,
                                          _solvers, field_arrays, setup)
from tests.test_torch_rng_specs import QUIET, SAMPLERS
from tests.test_torch_solver import _assert_stats

LABELS = {"F6-48-48": (6, 48, 48), "F5-40-20": (5, 40, 20),
          "F4-32-32-32": (4, 32, 32, 32), "F8-64": (8, 64),
          "F8-128-128": (8, 128, 128), "F3": (3,)}
# The fields' numpy seeds: tests/test_torch_field_specs.py's, but for
# F6-48-48, whose field of that seed meets its highest value at the
# rollouts' shared first steps (every rollout of the wide-noise case peaks
# there, so a boundary there crashes all of them or none)
SEEDS = {"F6-48-48": FIELD_SEED + 2}
DEFAULT = rk.KERNEL_LAYERS
# (MLP spec, field label): every label beside the default MLP, F5-40-20
# beside 6-24-4 too (a field library of another MLP spec)
PAIRS = [(DEFAULT, label) for label in LABELS] + [((6, 24, 4), "F5-40-20")]
MLP_SPECS = (DEFAULT, (6, 24, 4), (6, 64, 64, 64, 64, 4))
# 3xTF32 against float32 on field values of order 1 (largest |value| 2.5
# to 5.0 at these specs): calibrated on the CPU, max 3-pass error 2.4e-6
# (F4-32-32-32), one pass 1.2e-3 to 3.8e-3; F3 has no hidden layer and
# no tensor-core product (its one layer in fp32)
TILE_ATOL = 1e-5
# bf16 lookups: the packages' bf16 roundings of each layer's float32 sum
# agree but where the two sums (another order) straddle a rounding edge:
# there the two values differ by one bf16 step of the value (2^-8 of its
# binade; measured: 1 to 13 of 100,000 points, at most 7.8e-3)
BF16_MAX_DIFFER = 1e-3          # share of the points


def _pair_id(pair):
    return f"{_label(pair[0])}-{pair[1]}"


@functools.cache
def _arrays(layers, label) -> dict:
    """``field_arrays`` at the label's spec, the 0.65 boundary then moved
    from the median rollout's highest value to halfway between the two
    middle ones of ``layers``' wide-noise case: half of those rollouts
    crash, and none meets the boundary within a rounding (where the port's
    and the JAX field values, summed in other orders, could latch on
    either side)."""
    a = field_arrays(layers, SEEDS.get(label, FIELD_SEED), LABELS[label])
    field = NeuralCostmap.build(a["weights"], a["biases"], a["freqs"],
                                a["r_c1"], a["r_c2"], a["trs"], device="cpu")
    s = setup(layers, "wide_noise")
    states, _ = rk.dynamics_chain_plain(
        s["model"], s["params"], s["cfg"], torch.tensor(s["state"]),
        torch.tensor(s["U"]), torch.tensor(s["eps"]))
    x, y, yaw = states[0, :-1], states[1, :-1], states[2, :-1]  # s_1..s_T-1
    hx, hy = 0.5 * torch.cos(yaw), 0.5 * torch.sin(yaw)
    peak = torch.maximum(field.lookup_ch0(x + hx, y + hy),
                         field.lookup_ch0(x - hx, y - hy)).amax(dim=0)
    lo, hi = torch.sort(peak).values[K // 2 - 1:K // 2 + 1].tolist()
    B = list(a["biases"])
    B[-1] = (B[-1] + np.float32(0.65 - (lo + hi) / 2)).astype(np.float32)
    return dict(a, biases=tuple(B))


def _fields(layers, label, dtype=None):
    """(port field on the CPU, JAX field) with the same arrays
    (``_arrays``); with ``dtype`` bfloat16, both with the same bf16
    weights."""
    jf = JaxField(**{k: (tuple(jnp.asarray(a) for a in v)
                         if isinstance(v, tuple) else jnp.asarray(v))
                     for k, v in _arrays(layers, label).items()})
    if dtype is not None:
        jf = JaxField(tuple(w.astype(jnp.bfloat16) for w in jf.weights),
                      jf.biases, jf.freqs, jf.r_c1, jf.r_c2, jf.trs)
    return (NeuralCostmap.from_jax(jax.tree_util.tree_map(np.asarray, jf),
                                   device="cpu"), jf)


def _kernel3(layers, label, case, dtype=None):
    s = setup(layers, case)
    field, jfield = _fields(layers, label, dtype)
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
    return s, crash


# ---------------------------------------------------------------------------
# kernel 3 and pass 1's field mode (plain versions) against the JAX kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("pair", PAIRS, ids=_pair_id)
def test_plain_kernel3_matches_the_jax_kernel_at_every_field_spec(pair,
                                                                   case):
    s, crash = _kernel3(*pair, case)
    if case == "wide_noise":
        n = K - s["k_offset"]
        assert 0 < int(crash.sum()) < n     # the flags differ between rollouts


@pytest.mark.parametrize("sampler", list(SAMPLERS))
@pytest.mark.parametrize("pair", PAIRS, ids=_pair_id)
def test_plain_field_pass1_matches_the_jax_kernel_at_every_field_spec(
        pair, sampler):
    """Pass 1's field mode against the JAX ``fused_rng_costs`` in TPU
    interpret mode with zero exploration noise (the JAX kernels draw from
    the TPU's own PRNG): costs within COST_RTOL / COST_ATOL, crash flags
    equal."""
    layers, label = pair
    s = setup(layers, **QUIET, **SAMPLERS[sampler])
    field, jfield = _fields(layers, label)
    cp = CostParams(desired_speed=6.0)
    total, crash, _ = rk.fused_rng_costs(
        s["model"], s["params"], s["cfg"], cp, field,
        torch.tensor(s["state"]), torch.tensor(s["U"]), KEY)
    jtotal, jcrash, _ = jrk.fused_rng_costs(
        s["jmodel"], s["jparams"], s["jcfg"].replace(use_pallas_rollout=True),
        JaxCostParams(desired_speed=6.0), jfield, jnp.asarray(s["state"]),
        jnp.asarray(s["U"]), jax.random.PRNGKey(3),
        interpret=pltpu.InterpretParams())
    np.testing.assert_allclose(total.numpy(), np.asarray(jtotal),
                               rtol=COST_RTOL, atol=COST_ATOL)
    np.testing.assert_array_equal(crash.numpy(), np.asarray(jcrash))
    assert np.isfinite(total.numpy()).all()


@pytest.mark.parametrize("mode", ["host_noise", "capacity"])
def test_iterate_on_the_jax_packages_own_fit_spec_matches_jax(mode):
    """``MPPISolver.iterate`` on an F6-48-48 field (26-48-48-1, the spec of
    the JAX package's own fit): U_new and the six SolveStats within
    ITER_RTOL / ITER_ATOL of the JAX ``iterate`` on the same noise (in the
    capacity mode the port's stream)."""
    solver, params, jsolver, jparams, s = _solvers(
        DEFAULT, kernel_rng=mode == "capacity")
    field, jfield = _fields(DEFAULT, "F6-48-48")
    cp = CostParams(desired_speed=6.0)
    args = (torch.tensor(s["state"]), torch.tensor(s["U"]))
    eps = s["eps"]
    assert solver._use_kernel_rng(field) == (mode == "capacity")
    if mode == "capacity":
        U_new, stats = solver._iterate_kernel_rng(params, cp, field, *args,
                                                  KEY)
        eps = kr.kernel_noise(KEY, 0, K, T, None).numpy()
    else:
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
# the packed buffer and the warp's tiles at every spec
# ---------------------------------------------------------------------------

def _tile_fields(label):
    fspec = LABELS[label]
    a = tiles._arrays(fspec=fspec)
    field = NeuralCostmap.build(a["weights"], a["biases"], a["freqs"],
                                a["r_c1"], a["r_c2"], a["trs"], device="cpu")
    jfield = JaxField(tuple(jnp.asarray(w) for w in a["weights"]),
                      tuple(jnp.asarray(b) for b in a["biases"]),
                      *(jnp.asarray(a[k]) for k in ("freqs", "r_c1", "r_c2",
                                                    "trs")))
    return field, jfield, rk._pack_field(field)


@pytest.mark.parametrize("label", list(LABELS))
def test_packed_fragments_give_back_the_weights_at_every_spec(label):
    """The kernel's fragment formulas recover each layer's weights (TF32 hi
    and lo within 2^-22 of each weight, zeros in the padded rows and
    columns), the padded biases and output weights, the freqs."""
    fspec = LABELS[label]
    field, _, packed = _tile_fields(label)
    lay = rk.field_pack_layout(fspec)
    assert packed.numel() == rk.field_pack_floats(fspec) == lay["pack"]
    assert lay["pack"] % 4 == 0
    order = np.array(tiles._tile_order(fspec))
    assert tuple(order) == rk.field_tile_features(fspec)
    assert len(order) == rk.field_tile_k(fspec) == -(-(4 + 4 * fspec[0])
                                                     // 8) * 8
    r = tiles._read_packed(packed, fspec)
    hidden = fspec[1:]
    for i, h in enumerate(hidden):
        hi, lo = r[f"W{i}"]
        assert not np.isnan(hi).any() and not np.isnan(lo).any()
        W = field.weights[i].numpy()
        if i == 0:
            assert (hi[order < 0] == 0).all() and (lo[order < 0] == 0).all()
            hi, lo = hi[order >= 0], lo[order >= 0]
            W = W[order[order >= 0]]
        else:
            assert (hi[hidden[i - 1]:] == 0).all()     # padded inputs
            hi, lo = hi[:hidden[i - 1]], lo[:hidden[i - 1]]
        assert (hi[:, h:] == 0).all() and (lo[:, h:] == 0).all()
        hi, lo = hi[:, :h], lo[:, :h]
        np.testing.assert_array_equal(hi, tiles._tf32(W))
        np.testing.assert_array_equal(lo, tiles._tf32(W - hi))
        err = np.abs(hi.astype(np.float64) + lo - W)
        assert (err <= 2.0 ** -22 * np.abs(W)).all(), err.max()
        np.testing.assert_array_equal(r[f"b{i}"][:h],
                                      field.biases[i].numpy())
        assert (r[f"b{i}"][h:] == 0).all()
    w_out = field.weights[-1].numpy()[:, 0]
    if hidden:
        np.testing.assert_array_equal(r["Wout"][:hidden[-1]], w_out)
        assert (r["Wout"][hidden[-1]:] == 0).all()
    else:
        np.testing.assert_array_equal(
            r["Wout"], np.where(order >= 0, w_out[np.maximum(order, 0)], 0))
    np.testing.assert_array_equal(r["bout"], field.biases[-1].numpy())
    np.testing.assert_array_equal(r["freqs"], field.freqs.numpy())
    assert (r["pad"] == 0).all() and r["pad"].size < 4


@pytest.mark.parametrize("passes", [3, 1])
@pytest.mark.parametrize("reference", ["port", "jax"])
@pytest.mark.parametrize("label", list(LABELS))
def test_tile_evaluation_at_every_spec(label, reference, passes):
    """The warp's tile evaluation (3xTF32 products, float32 sums) against
    the float32 field within TILE_ATOL; one TF32 pass misses it by at
    least 10x (F3, without a hidden layer, takes no product: both passes
    are its fp32 dot product)."""
    fspec = LABELS[label]
    field, jfield, packed = _tile_fields(label)
    # a first large sin call (tests/test_torch_field_tiles.py's fixture)
    torch.sin(torch.linspace(0.0, 128 * np.pi, 1 << 18))
    x, y = tiles._points(n=20_000)
    got = tiles._tile_eval(field, packed, x, y, passes, fspec)
    if reference == "port":
        want = field.lookup_ch0(torch.tensor(x), torch.tensor(y)).numpy()
    else:
        want = np.asarray(jfield.lookup_ch0(jnp.asarray(x), jnp.asarray(y)))
    assert np.isfinite(got).all() and np.abs(want).max() > 1.0
    err = np.abs(got - want).max()
    if passes == 3 or len(fspec) == 1:
        assert err <= TILE_ATOL, err
    else:
        assert err >= 10 * TILE_ATOL, err


# ---------------------------------------------------------------------------
# shared memory, libraries, refusals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("label", list(LABELS))
@pytest.mark.parametrize("layers", MLP_SPECS, ids=_label)
def test_field_layout_follows_the_source_at_every_pair(layers, label):
    """The field kernels' shared memory beside each MLP spec's library
    (csrc FieldSmem): the weights, the field at a float4, the tiles of the
    library's warps at the field's stride, U, the circles; every pair fits
    T=2048 with 64 slots but F8-128-128: 225,344 bytes before U beside the
    default MLP's 4 warps (T <= 792); beside 8 warps, where staging it
    leaves no room, the field stays in device memory (the global layout:
    the tiles right after the weights) and T=2048 fits."""
    fspec = LABELS[label]
    lay = rk.field_smem_layout(layers, T=100, n_obs=16, field=fspec)
    warps = rk.field_block(layers) // 32
    stride = rk.field_tile_k(fspec) + 4
    assert stride % 8 == 4                 # conflict-free column loads
    assert lay["f"] == -(-rk.num_weights(layers) // 4) * 4
    glob = label == "F8-128-128" and layers != DEFAULT
    assert lay["layout"] == ("global" if glob else "staged")
    assert lay["tiles"] == lay["f"] + (0 if glob
                                       else rk.field_pack_floats(fspec))
    assert lay["U"] == lay["tiles"] + warps * (64 * stride + 64)
    assert lay["tiles"] % 4 == lay["U"] % 4 == 0
    assert lay["bytes"] == 4 * (lay["U"] + 2 * 100 + 3 * 16)
    room = rk.max_field_kernel_t(layers, fspec)
    if label == "F8-128-128":
        assert rk.field_pack_floats(fspec) * 4 == 173616
        if layers == DEFAULT:
            assert 4 * lay["U"] == 225344 and room == 792
        else:
            assert room == rk.MAX_FIELD_KERNEL_T
            assert lay["bytes"] == {(6, 24, 4): 94224,
                                    (6, 64, 64, 64, 64, 4): 145904}[layers]
    else:
        assert room == rk.MAX_FIELD_KERNEL_T
        assert rk.field_smem_layout(layers, rk.MAX_FIELD_KERNEL_T,
                                    rk.MAX_OBSTACLES, fspec)["bytes"] \
            <= 4 * rk.SMEM_FLOATS
    if (layers, label) == ((6, 64, 64, 64, 64, 4), "F6-48-48"):
        assert 4 * lay["U"] == 159856
    if fspec == rk.FIELD_KERNEL_SPEC:
        assert lay == rk.field_smem_layout(layers, 100, 16)


def test_field_spec_constants_match_the_source():
    """The source's FieldSpec formulas are the ones the wrapper mirrors;
    the default field's pack and tile are the earlier constants."""
    src = _build.SOURCE.read_text()
    for text in ("static constexpr int kK1 = (4 + 4 * F + 7) / 8 * 8;",
                 "return (width(l) + 7) / 8;",
                 "return l == 0 ? kK1 / 8 : ntiles(l - 1);",
                 "n += ksteps(i) * ntiles(i) * 32 * 4;",
                 "for (int i = 0; i < l; ++i) n += 8 * ntiles(i);",
                 "kOutW + (S::kHidden == 0 ? S::kK1 : 8 * S::ntiles(S::kHidden - 1));",
                 "static constexpr int kPack = (kFreqOff + S::kFreqs + 3) / 4 * 4;",
                 "static constexpr int kMTiles = S::widest_pair() <= 16 ? 2 : 1;",
                 "static constexpr int kTileStride = kK1 + 4;",
                 "static constexpr int kTileFloats = 64 * kTileStride + 64;"):
        assert src.count(text) == 1, text
    assert rk.FIELD_PACK_FLOATS == 13516 and rk.FIELD_TILE_K == 40
    assert rk.FIELD_TILE_FLOATS == 64 * 44 + 64
    assert rk.field_pack_layout(LABELS["F4-32-32-32"])["ntiles"] == (4, 4, 4)
    assert rk.field_pack_layout(LABELS["F5-40-20"])["ntiles"] == (5, 3)


@pytest.mark.parametrize("pair", PAIRS, ids=_pair_id)
def test_field_kernels_ask_for_the_pairs_library(pair, monkeypatch):
    """On the card kernel 3 and pass 1's field mode take the library of
    the MLP spec and the field spec (``_build.load(layers, field)``; the
    MLP spec's own for the default field); here ``_build.load`` records
    the request and raises: nothing is built, nothing runs the plain
    version instead.  The libraries' names and defines per pair; their
    launches are counted under the field's label."""
    layers, label = pair
    fspec = LABELS[label]
    s = setup(layers, kernel_rng=True)
    field, _ = _fields(layers, label)
    asked = []

    def load(*args):
        asked.append(args)
        raise LookupError("no build here")

    monkeypatch.setattr(rk._build, "load", load)
    rk._kernel_lib.cache_clear()
    state, U = torch.tensor(s["state"]), torch.tensor(s["U"])
    args = (s["model"], s["params"], s["cfg"], CostParams(), field, state, U)
    with pytest.raises(LookupError):
        rk.prepare_fused_rollout_cost(*args, torch.tensor(s["eps"]))
    with pytest.raises(LookupError):
        rk.prepare_fused_rng_costs(*args, KEY)
    assert asked == [(layers, fspec)] * 2
    rk._kernel_lib.cache_clear()
    defines = _build.spec_defines(layers, fspec)
    assert f"#define ARTT_FIELD_SPEC {', '.join(map(str, fspec))}\n" \
        in defines and "#define ARTT_FIELD_LIBRARY\n" in defines
    assert ("ARTT_SPEC_LIBRARY" in defines) == (layers != DEFAULT)
    name = _build.library_path(layers, fspec).name
    assert f"_field{label}_" in name
    assert name != _build.library_path(layers).name
    assert _build.functions(layers, fspec) == _build.FIELD_FUNCTIONS
    assert set(_build.FIELD_FUNCTIONS) < set(_build.SIGNATURES)
    for fn in ("artt_fused_exact_rollout_cost", "artt_dynamics_chain",
               "artt_fused_rng_costs", "artt_weighted_update"):
        assert fn not in _build.FIELD_FUNCTIONS

    class Lib:
        def __getattr__(self, name):
            return lambda *a: 0

    monkeypatch.setattr(rk, "_kernel_lib", lambda *a: Lib())
    launch, _ = rk.prepare_fused_rollout_cost(*args, torch.tensor(s["eps"]))
    launch_p, _, _ = rk.prepare_fused_rng_costs(*args, KEY)
    spec = "" if layers == DEFAULT else "_" + _label(layers)
    assert launch.name == f"fused_rollout_cost{spec}_{label}"
    assert launch_p.name == f"fused_rng_costs_field{spec}_{label}"


def test_a_field_without_room_is_refused_before_any_build(monkeypatch):
    """F8-128-128 beside an 8-warp spec library, which once had no room
    for U at any T, now takes the global layout (the field in device
    memory): both kernels ask for the pair's library, which reports the
    layout.  Beside the default MLP the field stays staged: room up to
    T=792, refused beyond it before any build, naming the bytes, the
    layout and the ROADMAP item; so is a spec whose weights and tiles leave
    no room in either layout."""
    calls = []

    class Lib:
        def __init__(self, *key):
            calls.append(key)

        def __getattr__(self, name):
            return lambda *a: 0

    monkeypatch.setattr(rk._build, "load", Lib)
    monkeypatch.setattr(rk, "_kernel_lib", lambda *a: rk._build.load(*a))
    for layers, T_, fits in (((6, 24, 4), T, True),
                             ((6, 64, 64, 64, 64, 4), T, True),
                             (DEFAULT, 793, False)):
        s = setup(layers, kernel_rng=True)
        field, _ = _fields(layers, "F8-128-128")
        U = torch.zeros(T_, 2)
        eps = torch.zeros(T_, K, 2)
        run3 = lambda: rk.prepare_fused_rollout_cost(
            s["model"], s["params"], s["cfg"], CostParams(), field,
            torch.tensor(s["state"]), U, eps)
        run1 = lambda: rk.prepare_fused_rng_costs(
            s["model"], s["params"], s["cfg"], CostParams(), field,
            torch.tensor(s["state"]), U, KEY)
        if fits:
            calls.clear()
            spec = "_" + _label(layers)
            assert run3()[0].name == f"fused_rollout_cost{spec}_F8-128-128"
            assert run1()[0].name == \
                f"fused_rng_costs_field{spec}_F8-128-128"
            assert calls == [(layers, LABELS["F8-128-128"], False)] * 2
            assert rk.field_global(layers, LABELS["F8-128-128"])
            assert rk.field_smem_layout(
                layers, T_, 16, LABELS["F8-128-128"])["layout"] == "global"
            continue
        calls.clear()
        with pytest.raises(NotImplementedError,
                           match=r"staged layout\) need \d+ bytes.*Queue 2 A8"):
            run3()
        with pytest.raises(NotImplementedError, match="Queue 2 A8"):
            run1()
        assert calls == []
    wide = (6, 128, 128, 128, 128, 4)
    assert rk.max_field_kernel_t(wide, LABELS["F8-128-128"]) == 0
    with pytest.raises(NotImplementedError,
                       match=r"global layout\) need \d+ bytes"):
        rk._check_field_room(wide, LABELS["F8-128-128"], T)


# ---------------------------------------------------------------------------
# bf16 fields
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("label", ["F6-48-48", "F8-64", "F3"])
def test_bf16_lookup_ch0_matches_jax(label):
    """``lookup_ch0`` of a bf16 field follows the JAX casts: equal values
    but at a rounding edge of a layer's bf16 cast, where the two differ by
    one bf16 step of the value (on at most BF16_MAX_DIFFER of the points);
    it differs from the float32 field by the bf16 roundings."""
    field, jfield = _fields(DEFAULT, label, torch.bfloat16)
    f32, _ = _fields(DEFAULT, label)
    x, y = tiles._points(n=20_000)
    got = field.lookup_ch0(torch.tensor(x), torch.tensor(y)).numpy()
    want = np.asarray(jfield.lookup_ch0(jnp.asarray(x), jnp.asarray(y)))
    assert got.dtype == np.float32 and np.isfinite(got).all()
    diff = np.abs(got - want)
    step = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -20)))
                   - 7)
    assert (diff <= step).all(), diff.max()
    assert (diff > 0).mean() <= BF16_MAX_DIFFER
    full = f32.lookup_ch0(torch.tensor(x), torch.tensor(y)).numpy()
    assert np.abs(got - full).max() > 1e-3          # not the float32 path


@pytest.mark.parametrize("case", ["nominal", "wide_noise"])
@pytest.mark.parametrize("label", ["F6-48-48", "F8-64"])
def test_bf16_plain_kernel3_matches_the_jax_kernel(label, case):
    """The JAX kernels upcast a bf16 field's layers to float32 before the
    launch (``rollout_kernel.py:810-811``); the plain kernel 3 evaluates
    the same upcast weights (not the bf16 ``lookup_ch0``)."""
    _kernel3(DEFAULT, label, case, torch.bfloat16)


def test_bf16_plain_field_pass1_matches_the_jax_kernel():
    """Pass 1 on a bf16 field (upcast at ``rollout_kernel.py:1512-1513``),
    zero exploration noise, against the JAX ``fused_rng_costs``."""
    s = setup(DEFAULT, **QUIET)
    field, jfield = _fields(DEFAULT, "F6-48-48", torch.bfloat16)
    cp = CostParams(desired_speed=6.0)
    total, crash, _ = rk.fused_rng_costs(
        s["model"], s["params"], s["cfg"], cp, field,
        torch.tensor(s["state"]), torch.tensor(s["U"]), KEY)
    jtotal, jcrash, _ = jrk.fused_rng_costs(
        s["jmodel"], s["jparams"], s["jcfg"].replace(use_pallas_rollout=True),
        JaxCostParams(desired_speed=6.0), jfield, jnp.asarray(s["state"]),
        jnp.asarray(s["U"]), jax.random.PRNGKey(3),
        interpret=pltpu.InterpretParams())
    np.testing.assert_allclose(total.numpy(), np.asarray(jtotal),
                               rtol=COST_RTOL, atol=COST_ATOL)
    np.testing.assert_array_equal(crash.numpy(), np.asarray(jcrash))
    # the packed field is the upcast weights': bf16 values are exact TF32
    packed = rk._pack_field(field)
    assert torch.equal(packed, rk._pack_field(field.to_float32()))


def test_fit_neural_costmap_casts_to_bf16_at_the_end():
    """``fit_neural_costmap(dtype=torch.bfloat16)``: the float32 fit's
    weights cast at the end (the biases stay float32), the same metrics
    (taken before the cast, as the JAX fit takes them)."""
    data, xb, yb = oval_track(ppm=1.0)
    cm = make_costmap(data, xb, yb, device="cpu")
    kw = dict(hidden=(48, 48), num_freqs=6, epochs=20, batch=512,
              device="cpu")
    f32, m32 = fit_neural_costmap(cm, **kw)
    bf, mbf = fit_neural_costmap(cm, dtype=torch.bfloat16, **kw)
    assert bf.dtype == torch.bfloat16 and f32.dtype == torch.float32
    assert bf.layers == f32.layers == (26, 48, 48, 1)
    for w, w32 in zip(bf.weights, f32.weights):
        assert torch.equal(w, w32.to(torch.bfloat16))
    for b, b32 in zip(bf.biases, f32.biases):
        assert b.dtype == torch.float32 and torch.equal(b, b32)
    assert mbf == m32
    assert rk.field_spec(bf) == (6, 48, 48)
