"""Every horizon the JAX kernels take (ROADMAP.md, Queue 2 A8), on the CPU.

The JAX solver sends any T to its Pallas kernels.  The port's kernels
stage U in shared memory up to ``rk.max_kernel_t`` (4096) and the field
kernels up to ``rk.max_field_kernel_t`` (2048, or what a library's layout
leaves room for: 792 for F8-128-128 beside 6-32-32-4); past that a launch
stages no U (nor kernel 2's warp form its eps) and reads them in device
memory (``rk.staged_u``).  Here, with a stand-in library (no ``nvcc`` on
the CPU): every wrapper, solo and lane form, takes a horizon past its cap
and asks for its library; the layout switches at the cap; only the int32
bound (T x K x C < 2^31) and an MLP that leaves the field kernels no room
at any T (A9) are refused, by name; the source stages U through
``staged_u`` in every kernel that reads it; and the plain version of
kernel 1 agrees with the JAX kernel (interpret mode) at a T whose launch
the port stages.  ``chip_smoke.py`` phase 39 runs the past-cap forms on
the card against their plain versions."""

import re

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
from tests.test_torch_field_specs import KEY, fields, setup
from tests.test_torch_field_tile_specs import LABELS, _fields
from tests.test_torch_rng_specs import _maps

DEFAULT = rk.KERNEL_LAYERS
K_SMALL = 8


class Lib:
    """A stand-in kernel library: records who asked for it; every entry
    returns 0 (success)."""

    asked = []

    def __init__(self, *key, **kw):
        Lib.asked.append((key, kw))

    def __getattr__(self, name):
        return lambda *a: 0


@pytest.fixture
def stub(monkeypatch):
    Lib.asked = []
    real = rk._kernel_lib
    real.cache_clear()
    monkeypatch.setattr(rk._build, "load", Lib)
    monkeypatch.setattr(rk, "_kernel_lib", lambda *a: Lib(*a))
    monkeypatch.setattr(rk, "num_sms", lambda index: 132)   # an H100's
    yield Lib
    real.cache_clear()


def _inputs(T: int, L: int = 0, seed: int = 0):
    s = setup(DEFAULT)
    rs = np.random.default_rng(seed)
    U = torch.tensor(np.tile([0.0, 0.3], (max(L, 1), T, 1)),
                     dtype=torch.float32)
    eps = torch.tensor(rs.standard_normal((T, K_SMALL, 2)),
                       dtype=torch.float32)
    state = torch.tensor(s["state"]).repeat(max(L, 1), 1)
    cfg = s["cfg"].replace(num_rollouts=K_SMALL, num_timesteps=T)
    return s["model"], s["params"], cfg, (state if L else state[0]), (
        U if L else U[0]), eps


def _lane_costs(L: int):
    from autorally_tpu_torch.tools.param_sweep import stack_cost_params

    return stack_cost_params(CostParams(), [dict(desired_speed=4.0 + i)
                                            for i in range(L)])


EXACT_FORMS = ("kernel 1", "kernel 2", "exact pass 1", "pass 2",
               "kernel 1 lanes", "kernel 2 lanes", "exact pass 1 lanes",
               "pass 2 lanes")
FIELD_FORMS = ("kernel 3", "field pass 1", "kernel 3 lanes",
               "field pass 1 lanes")


def _prepare(form: str, T: int, surface):
    """The launch of ``form`` at horizon T on ``surface`` (not run)."""
    lanes = form.endswith("lanes")
    model, params, cfg, state, U, eps = _inputs(T, L=2 if lanes else 0)
    cp = _lane_costs(2) if lanes else CostParams()
    if form.startswith(("kernel 1", "kernel 3")):
        fn = {("kernel 1", False): rk.prepare_fused_exact_rollout_cost,
              ("kernel 1", True): rk.prepare_fused_exact_rollout_cost_lanes,
              ("kernel 3", False): rk.prepare_fused_rollout_cost,
              ("kernel 3", True): rk.prepare_fused_rollout_cost_lanes}[
            form[:8], lanes]
        return fn(model, params, cfg, cp, surface, state, U, eps)[0]
    if form.startswith("kernel 2"):
        fn = (rk.prepare_dynamics_chain_lanes if lanes
              else rk.prepare_dynamics_chain)
        return fn(model, params, cfg, state, U, eps)[0]
    cfg = cfg.replace(kernel_rng=True)
    fn = (rk.prepare_fused_rng_costs_lanes if lanes
          else rk.prepare_fused_rng_costs)
    launch, _, ctx = fn(model, params, cfg, cp, surface, state, U, KEY)
    if not form.startswith("pass 2"):
        return launch
    w = torch.ones((2, K_SMALL) if lanes else (K_SMALL,))
    fn = (rk.prepare_fused_rng_numer_lanes if lanes
          else rk.prepare_fused_rng_numer)
    return fn(ctx, w)[0]


@pytest.mark.parametrize("form", EXACT_FORMS)
def test_the_exact_forms_take_a_horizon_past_their_cap(form, stub):
    """Kernels 1 and 2, both capacity passes, solo and in lanes, at
    T = MAX_KERNEL_T + 4: no refusal, the default library asked for."""
    T = rk.MAX_KERNEL_T + 4
    assert rk.max_kernel_t() < T and rk.staged_u(T, rk.max_kernel_t()) == 0
    launch = _prepare(form, T, _maps()[0])
    assert callable(launch)
    assert stub.asked and all(key[:1] in ((), (DEFAULT,))
                              for key, _ in stub.asked)


@pytest.mark.parametrize("form", FIELD_FORMS)
@pytest.mark.parametrize("label", [None, "F8-128-128"])
def test_the_field_forms_take_a_horizon_past_their_cap(form, label, stub):
    """Kernel 3 and field pass 1, solo and in lanes, past their library's
    staged horizon: the default pair at T = 2052, F8-128-128 beside the
    default MLP at T = 800 (its staged cap 792, its lane forms' less).
    No refusal; the pair's library asked for; U in device memory."""
    if label is None:
        surface, fspec = fields(DEFAULT)[0], rk.FIELD_KERNEL_SPEC
        T = rk.MAX_FIELD_KERNEL_T + 4
    else:
        surface, fspec = _fields(DEFAULT, label)[0], LABELS[label]
        T = 800
    lanes = form.endswith("lanes")
    cap = rk.max_field_kernel_t(DEFAULT, fspec, lanes)
    assert cap < T
    launch = _prepare(form, T, surface)
    assert callable(launch)
    assert launch.name.startswith(("fused_rollout_cost", "fused_rng_costs"))
    assert stub.asked
    lay = rk.field_smem_layout(DEFAULT, T, 16, fspec, lanes)
    assert lay["u_layout"] == "global" and lay["obs"] == lay["U"]
    assert lay["bytes"] <= 4 * rk.SMEM_FLOATS


@pytest.mark.parametrize("layers", [DEFAULT, (6, 24, 4),
                                    (6, 64, 64, 64, 64, 4)])
@pytest.mark.parametrize("label", sorted(LABELS))
def test_the_layout_switches_at_the_staged_horizon(layers, label):
    """U staged up to ``max_field_kernel_t`` (lane forms: theirs), in
    device memory one step past it; the bytes of a launch never exceed a
    block's, at any T."""
    fspec = LABELS[label]
    for lanes in (False, True):
        cap = rk.max_field_kernel_t(layers, fspec, lanes)
        at = rk.field_smem_layout(layers, cap, 64, fspec, lanes)
        past = rk.field_smem_layout(layers, cap + 1, 64, fspec, lanes)
        far = rk.field_smem_layout(layers, 100000, 64, fspec, lanes)
        assert at["u_layout"] == "staged" and at["obs"] == at["U"] + 2 * cap
        assert past["u_layout"] == far["u_layout"] == "global"
        assert past["bytes"] == far["bytes"] == 4 * (past["U"] + 3 * 64)
        assert at["bytes"] <= 4 * rk.SMEM_FLOATS - (
            4 * rk.LANE_SCALAR_FLOATS if lanes else 0)


def test_only_int32_indexing_and_a9_are_refused(stub):
    """T x K x C at 2^31 is refused by name before anything is allocated;
    an MLP whose weights leave the field kernels no room at any T is
    refused by its ROADMAP label before any build."""
    rk._check_horizon(2 ** 20, 1023)
    with pytest.raises(ValueError, match=r"T x K x C < 2\^31"):
        rk._check_horizon(2 ** 20, 1024)
    model, params, cfg, state, _, _ = _inputs(4)
    U = torch.zeros((2 ** 20, 2))
    with pytest.raises(ValueError, match=r"int32"):
        rk.prepare_fused_rng_costs(model, params, cfg.replace(
            num_rollouts=1024, kernel_rng=True), CostParams(), _maps()[0],
            state, U, KEY)
    assert rk.max_field_kernel_t((6, 128, 128, 128, 128, 4)) == 0
    with pytest.raises(NotImplementedError, match="Queue 2 A9"):
        rk._check_field_room((6, 128, 128, 128, 128, 4),
                             rk.FIELD_KERNEL_SPEC)
    with pytest.raises(NotImplementedError, match="Queue 2 A9"):
        rk._check_field_room((6, 128, 128, 128, 128, 4),
                             rk.FIELD_KERNEL_SPEC, lanes=True)
    stub.asked.clear()
    wide = setup((6, 128, 128, 128, 128, 4))
    with pytest.raises(NotImplementedError, match="Queue 2 A9"):
        rk.prepare_fused_rollout_cost(
            wide["model"], wide["params"], wide["cfg"], CostParams(),
            fields(DEFAULT)[0], torch.tensor(wide["state"]),
            torch.tensor(wide["U"]), torch.tensor(wide["eps"]))
    assert stub.asked == []


def test_the_source_stages_u_through_staged_u():
    """Every kernel that reads U takes its staged steps from ``staged_u``
    and reads U through a ``USource``; the launchers size shared memory
    with it; no launcher refuses a horizon past a cap."""
    src = _build.SOURCE.read_text()
    assert "return T <= cap ? T : 0;" in src
    # kernels 1 (thread, group), exact pass 1 (MLP, BF), kernel 2 (thread,
    # warp), pass 2 at kMaxT; kernel 3 and field pass 1 at the field caps
    assert src.count("const int Tu = staged_u(s.T, kMaxT);") == 7
    assert src.count("staged_u(s.T, kLanes ? kLibMaxFieldLanesT : "
                     "kLibMaxFieldT);") == 2
    assert src.count("USource{") == 6 and src.count("const USource u{") == 3
    for fn in ("smem_bytes", "group_smem_bytes", "update_smem_bytes",
               "chain_warp_smem_bytes", "field_smem_bytes"):
        body = re.search(r"size_t %s\(int T[^{]*\{(.*?)\n\}" % fn, src,
                         re.S).group(1)
        assert "staged_u(T, " in body, fn
    assert not re.search(r"s\.T > k(Max|LibMax)", src)
    assert not re.search(r"\bT > k(Max|LibMax)", src)
    assert re.search(r"constexpr int kMaxFieldT = (\d+);", src).group(1) \
        == str(rk.MAX_FIELD_KERNEL_T)


def test_plain_kernel_1_matches_the_jax_kernel():
    """The plain version of kernel 1 against the JAX kernel in interpret
    mode, whose T has no cap, at T=32: costs, u_seq and crash flags."""
    s = setup(DEFAULT)
    T = 32
    rs = np.random.default_rng(3)
    U = np.tile(np.array([0.0, 0.3], np.float32), (T, 1))
    U[:, 0] = rs.uniform(-0.3, 0.3, T).astype(np.float32)
    eps = rs.standard_normal((T, 64, 2)).astype(np.float32)
    cm, jcm = _maps()
    cfg = s["cfg"].replace(num_rollouts=64, num_timesteps=T)
    jcfg = s["jcfg"].replace(num_rollouts=64, num_timesteps=T)
    pc, pu, px = rk.fused_rollout_cost_plain(
        s["model"], s["params"], cfg, CostParams(), cm,
        torch.tensor(s["state"]), torch.tensor(U), torch.tensor(eps))
    jc, ju, jx = jrk.fused_exact_rollout_cost_pallas(
        s["jmodel"], s["jparams"], jcfg, JaxCostParams(), jcm,
        jnp.asarray(s["state"]), jnp.asarray(U), jnp.asarray(eps),
        interpret=pltpu.InterpretParams())
    np.testing.assert_allclose(pc.numpy(), np.asarray(jc), rtol=1e-4,
                               atol=1e-3)
    np.testing.assert_array_equal(pu.numpy(), np.asarray(ju))
    np.testing.assert_array_equal(px.numpy(), np.asarray(jx))
