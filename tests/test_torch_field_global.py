"""The field kernels' global layout (ROADMAP Queue 2 A6) on the CPU: a
field whose staged pack leaves a lane form no room for U at T=100
(34-128-128-1 beside BASELINE #3's 6-64-64-64-64-4 or 6-24-4) keeps the
packed field in device memory in its library, which the wrappers now ask
for instead of refusing.  Here the plain kernel 3 and pass 1 of both
pairs against the JAX kernels in interpret mode (pass 1 in TPU interpret
mode with zero exploration noise), the wrapper's mirror of the layout
against the source's constexprs, which libraries take which layout, and
the libraries the wrappers ask for.  The CUDA kernels of that layout run
only on a GPU: ``chip_smoke.py`` phase 36 holds them there.

Seeded weights and fields (``tests/test_torch_field_tile_specs.py``'s
``_fields``: the crash boundary halfway between the middle rollouts'
highest values), numpy noise, K=256, T=24.  Tolerances: kernel 3's costs
within ``COST_RTOL`` / ``COST_ATOL`` of ``tests/test_torch_field_specs.py``
(2e-5 / 1e-4: fp32 sums in another order over 23 cost steps), crash flags
exactly, u_seq within 1e-6 (one multiply and one add); pass 1 the same
costs' tolerances.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from autorally_tpu.config import CostParams as JaxCostParams
from autorally_tpu.ops import rollout_kernel as jrk
from autorally_tpu_torch.config import CostParams
from autorally_tpu_torch.ops import _build
from autorally_tpu_torch.ops import rollout_kernel as rk
from tests.test_torch_field_specs import (COST_ATOL, COST_RTOL, KEY, K,
                                          _label, setup)
from tests.test_torch_field_tile_specs import LABELS, _fields, _kernel3
from tests.test_torch_rng_specs import QUIET, SAMPLERS

WIDE = (6, 64, 64, 64, 64, 4)
FIELD = LABELS["F8-128-128"]
GLOBAL_PAIRS = [(WIDE, "F8-128-128"), ((6, 24, 4), "F8-128-128")]
DEFAULT = rk.KERNEL_LAYERS
# Every (MLP spec, field spec) pair whose library chip_smoke.py builds
# (phases 1, 28, 30, 31): each keeps the staged layout
BUILT = ([(DEFAULT, rk.FIELD_KERNEL_SPEC)]
         + [(spec, rk.FIELD_KERNEL_SPEC) for spec in (
             WIDE, (6, 24, 4), (6, 25, 4))]
         + [(DEFAULT, f) for f in LABELS.values()]
         + [((6, 24, 4), LABELS["F5-40-20"])])


def _pair_id(pair):
    return f"{_label(pair[0])}-{pair[1]}"


# ---------------------------------------------------------------------------
# the plain kernels against the JAX kernels
# ---------------------------------------------------------------------------

# interpret mode takes about 30 s a case at these widths: each pair in the
# cases that tell most (the nominal swarm, a shard's slice, the wide swarm
# some of whose rollouts cross the boundary), each sampler once
KERNEL3_CASES = [(GLOBAL_PAIRS[0], "nominal"), (GLOBAL_PAIRS[0], "k_offset"),
                 (GLOBAL_PAIRS[1], "wide_noise")]
PASS1_CASES = [(GLOBAL_PAIRS[0], "gaussian"), (GLOBAL_PAIRS[1], "ou")]


@pytest.mark.parametrize("pair, case", KERNEL3_CASES,
                         ids=lambda v: v if isinstance(v, str)
                         else _pair_id(v))
def test_plain_kernel3_of_a_global_pair_matches_the_jax_kernel(pair, case):
    """Kernel 3's plain version on the pair's field against the JAX
    ``fused_rollout_cost_pallas`` in interpret mode (``_kernel3``: costs
    within COST_RTOL / COST_ATOL, crash flags exactly, u_seq within
    USEQ_ATOL); in the wide-noise case some rollouts crash and some do
    not."""
    s, crash = _kernel3(*pair, case)
    if case == "wide_noise":
        assert 0 < int(crash.sum()) < K - s["k_offset"]


@pytest.mark.parametrize("pair, sampler", PASS1_CASES,
                         ids=lambda v: v if isinstance(v, str)
                         else _pair_id(v))
def test_plain_field_pass1_of_a_global_pair_matches_the_jax_kernel(pair,
                                                                   sampler):
    """Pass 1's field mode on the pair's field against the JAX
    ``fused_rng_costs`` in TPU interpret mode with zero exploration noise:
    costs within COST_RTOL / COST_ATOL, crash flags exactly."""
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


# ---------------------------------------------------------------------------
# the layout
# ---------------------------------------------------------------------------

def test_the_global_layout_follows_the_source():
    """The wrapper's mirror (``field_global``, ``field_smem_layout``,
    ``max_field_kernel_t``) reads the source's constexprs: the reference
    horizon, the room a lane form needs there with kMaxObstacles circles,
    the pack's floats in shared memory (none in the global layout), the
    launch's bytes (only the staged circles and the staged U count) and the
    room then left for U."""
    src = _build.SOURCE.read_text()
    assert re.search(r"constexpr int kFieldGlobalT = (\d+);",
                     src).group(1) == str(rk.FIELD_GLOBAL_T)
    assert ("constexpr bool kFieldGlobal =\n"
            "    field_room_t(kFieldPack, kLaneScalarFloats) < kFieldGlobalT;"
            in src)
    assert ("constexpr int kFieldStagedPack = kFieldGlobal ? 0 : kFieldPack;"
            in src)
    assert ("(232448 / 4 - field_weight_floats<MlpDeriv>() - pack\n"
            "          - kFieldWarps * kTileFloats - 3 * kMaxObstacles - "
            "reserved) / 2;" in src)
    assert "float* tiles = f + kFieldStagedPack;" in src
    assert "return FieldLookup{kFieldGlobal ? field : f, tile};" in src
    assert ("  return (size_t)(field_weight_floats<Deriv>() + kFieldStagedPack"
            "\n                  + kFieldWarps * kTileFloats\n"
            "                  + 2 * staged_u(T, lanes ? kLibMaxFieldLanesT\n"
            "                                          : kLibMaxFieldT)\n"
            "                  + 3 * staged_obstacles(n_obs))" in src)
    assert "using FieldLookup = FieldLookupOf<Field, kFieldGlobal>;" in src
    assert "int artt_field_global() { return kFieldGlobal ? 1 : 0; }" in src
    for layers, label in GLOBAL_PAIRS:
        fspec = LABELS[label]
        lay = rk.field_smem_layout(layers, T=100, n_obs=200, field=fspec)
        warps = rk.field_block(layers) // 32
        f = -(-rk.num_weights(layers) // 4) * 4
        assert lay["layout"] == "global" and lay["tiles"] == lay["f"] == f
        assert lay["U"] == f + warps * rk.field_tile_floats(fspec)
        assert lay["bytes"] == 4 * (lay["U"] + 2 * 100)   # 200 > 64: none
        assert rk.max_field_kernel_t(layers, fspec) == rk.MAX_FIELD_KERNEL_T
        staged = (rk.SMEM_FLOATS - lay["U"] - rk.field_pack_floats(fspec)
                  - 3 * rk.MAX_OBSTACLES - rk.LANE_SCALAR_FLOATS) // 2
        assert staged < rk.FIELD_GLOBAL_T
    assert rk.field_smem_layout(WIDE, T=100, field=FIELD)["bytes"] == 145712


@pytest.mark.parametrize("pair", BUILT, ids=lambda p: _label(p[0]) + "-F"
                         + "-".join(map(str, p[1])))
def test_every_library_built_today_keeps_the_staged_layout(pair):
    """The libraries of ``chip_smoke.py``'s runs (its phases 1, 28, 30 and
    31) keep the staged field, their shared memory and horizons: the
    global layout is only where the staged one leaves no room at
    FIELD_GLOBAL_T."""
    layers, fspec = pair
    lay = rk.field_smem_layout(layers, T=100, n_obs=16, field=fspec)
    assert not rk.field_global(layers, fspec)
    assert lay["layout"] == "staged"
    assert lay["tiles"] == lay["f"] + rk.field_pack_floats(fspec)
    assert rk.max_field_kernel_t(layers, fspec, lanes=True) \
        >= rk.FIELD_GLOBAL_T


def test_only_a_launch_without_room_in_either_layout_is_refused():
    """A pair once refused now asks for its library, and so does a launch
    past its library's staged horizon (U in device memory); only weights
    and tiles that leave no room even with the field and U in device
    memory are refused before any build, naming the layout and the ROADMAP
    item."""
    assert rk.field_global(WIDE, FIELD) and rk.field_global((6, 24, 4),
                                                            FIELD)
    rk._check_field_room(WIDE, FIELD)
    rk._check_field_room(WIDE, FIELD, lanes=True)
    # the staged library past its horizon: U in device memory, no refusal
    rk._check_field_room(DEFAULT, FIELD)
    rk._check_field_room(DEFAULT, FIELD, lanes=True)
    for T, u in ((792, "staged"), (793, "global"), (4100, "global")):
        lay = rk.field_smem_layout(DEFAULT, T, 64, FIELD)
        assert (lay["layout"], lay["u_layout"]) == ("staged", u)
        assert lay["bytes"] <= 4 * rk.SMEM_FLOATS
    assert rk.field_smem_layout(WIDE, 2049, 16, FIELD)["u_layout"] == "global"
    # weights and tiles that leave no room even with U in device memory
    huge = (6, 128, 128, 128, 128, 4)
    with pytest.raises(NotImplementedError,
                       match=r"global layout\) need \d+ bytes.*Queue 2 A9"):
        rk._check_field_room(huge, rk.FIELD_KERNEL_SPEC)


@pytest.mark.parametrize("lanes", [False, True], ids=["solo", "lanes"])
@pytest.mark.parametrize("pair", GLOBAL_PAIRS, ids=_pair_id)
def test_a_global_pair_asks_for_its_library(pair, lanes, monkeypatch):
    """Kernel 3 and pass 1's field mode, solo and in lanes, ask for the
    pair's library (``_build.load(layers, field)``, which records the
    request and raises here: nothing is built, nothing runs the plain
    version instead), a field library in one ``nvcc``."""
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
    eps = torch.tensor(s["eps"])
    if lanes:
        from autorally_tpu_torch.tools.param_sweep import stack_cost_params
        cp = stack_cost_params(CostParams(), [{"desired_speed": 4.0},
                                              {"desired_speed": 6.0}])
        st, Ul = state.repeat(2, 1), U.repeat(2, 1, 1)
        with pytest.raises(LookupError):
            rk.prepare_fused_rollout_cost_lanes(
                s["model"], s["params"], s["cfg"], cp, field, st, Ul, eps)
        with pytest.raises(LookupError):
            rk.prepare_fused_rng_costs_lanes(
                s["model"], s["params"], s["cfg"], cp, field, st, Ul, KEY)
    else:
        args = (s["model"], s["params"], s["cfg"], CostParams(), field,
                state, U)
        with pytest.raises(LookupError):
            rk.prepare_fused_rollout_cost(*args, eps)
        with pytest.raises(LookupError):
            rk.prepare_fused_rng_costs(*args, KEY)
    assert asked == [(layers, fspec)] * 2
    rk._kernel_lib.cache_clear()
    assert _build.parts(layers, fspec) == 1
    assert "_fieldF8-128-128_" in _build.library_path(layers, fspec).name
    assert "artt_field_global" in _build.FIELD_FUNCTIONS
