"""``MPPIConfig.matmul_precision`` in kernels 1-4, on the CPU.

The JAX kernels take the dynamics' products at ``Precision.DEFAULT`` for
``"default"``: on the TPU one MXU pass, both operands rounded to bf16 and
the products summed in float32.  JAX on the CPU ignores that precision, so
here the JAX side runs under :func:`one_pass_bf16`, which makes
``jax.lax.dot_general`` do what the MXU does where the precision is
exactly ``Precision.DEFAULT`` (the neural field's own products pass None
and stay float32); a port that ran float32 would agree with the JAX
package without it.  Against that emulation, with the JAX solver forced
through its Pallas kernels in interpret mode:

- one step of each derivative form (the concatenated MLP at 6-32-32-4 and
  6-64-64-64-64-4, kernel 3's split layer 0, the BF model), layer by
  layer, against ``jax.lax.dot_general`` on bf16-cast operands;
- the plain versions of kernels 1, 2 (at K) and 3 and pass 1 (gaussian and
  OU, exact and field), each also at least ``CLOSER`` times closer to the
  emulated ``"default"`` than to ``"highest"``;
- one ``"default"`` iteration in each mode (host noise, capacity, field,
  the general path with a cost subclass) and a one-rank sharded capacity
  iterate.

``"high"`` is ``"highest"`` bit for bit (the JAX kernels round it up), and
so is the nominal trajectory at every precision.  Seeded weights, numpy
noise, K=256, T=24 (``tests/test_torch_field_specs.py``'s set-up).  The
CUDA instances run only on a GPU: ``chip_smoke.py`` phase 31 holds them
against these plain versions there."""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from autorally_tpu.config import CostParams as JaxCostParams
from autorally_tpu.config import MPPIConfig as JaxConfig
from autorally_tpu.costs import MPPICost as JaxCost
from autorally_tpu.models import BasisFunctionDynamics as JaxBF
from autorally_tpu.ops import rollout_kernel as jrk
from autorally_tpu.solver import mppi as jmppi
from autorally_tpu_torch.config import (MATMUL_PRECISIONS, CostParams,
                                        MPPIConfig)
from autorally_tpu_torch.costs import MPPICost
from autorally_tpu_torch.models import (BasisFunctionDynamics,
                                        NeuralNetDynamics,
                                        car_basis_functions)
from autorally_tpu_torch.ops import _build
from autorally_tpu_torch.ops import kernel_rng as kr
from autorally_tpu_torch.ops import rollout_kernel as rk
from autorally_tpu_torch.parallel import ShardedMPPISolver
from autorally_tpu_torch.solver import mppi
from tests.test_torch_field_specs import (CASES, K, KEY, START, T, fields,
                                          setup)
from tests.test_torch_rng_specs import _maps
from tests.test_torch_solver import _assert_stats

WIDE = (6, 64, 64, 64, 64, 4)
DEFAULT = rk.KERNEL_LAYERS
# tests/test_exact_fused.py's and tests/test_torch_field_specs.py's: 23
# running-average steps of float32 with another summation order
COST_RTOL, COST_ATOL = 2e-5, 1e-4
USEQ_ATOL = 1e-6
# tests/test_torch_rollout_kernel.py's: 24 Euler steps of the same MLP, in
# all but FLIP_SHARE of the rollouts; in those a bf16 operand lies on the
# other side of a rounding boundary in the two packages (its float32 value
# one ulp apart: another tanh, another summation order), one bf16 ulp
# apart there (2^-5 at u_x = 6), which the chain carries on: 4 of 256
# rollouts, states up to 1.3e-4 apart (measured on this CPU), within
# FLIP_ATOL
STATE_RTOL, STATE_ATOL = 1e-5, 1e-5
FLIP_SHARE, FLIP_ATOL = 0.02, 1e-3
# the BF model against the JAX kernels' polynomial atan and sin/cos tan
# (tests/test_torch_basis_function.py's KERNEL_RTOL / KERNEL_ATOL)
BF_RTOL = BF_ATOL = 5e-4
# one iteration: tests/test_torch_field_specs.py's
ITER_RTOL, ITER_ATOL = 1e-4, 1e-5
# one layer's products: exact in float32, summed in another order
LAYER_RTOL = 1e-6
# the port is at least this many times closer to the emulated "default"
# than to "highest"
CLOSER = 10.0
QUIET = dict(steering_std=0.0, throttle_std=0.0, kernel_rng=True)
SAMPLERS = {"gaussian": {}, "ou": dict(noise_sampler="ou", noise_param=0.15)}
BF_SEED = 3
# the seeded BF theta (std 0.01) scaled up, so that its products' rounding
# moves the costs well above float32's
BF_THETA_SCALE = 30.0
# both packages' init_params give zero biases; these tests give the MLPs
# seeded biases of this std, so that a rounded bias shows
BIAS_STD = 0.3


@contextlib.contextmanager
def one_pass_bf16():
    """``jax.lax.dot_general`` as the TPU's MXU takes ``Precision.DEFAULT``:
    both operands cast to bfloat16, the products summed in float32.  Any
    other precision passes through.  The JAX caches are cleared before and
    after, because the JAX kernels are traced with the precision static."""
    real = jax.lax.dot_general

    def dot_general(lhs, rhs, dimension_numbers, precision=None,
                    preferred_element_type=None, **kw):
        if precision is jax.lax.Precision.DEFAULT:
            return real(lhs.astype(jnp.bfloat16), rhs.astype(jnp.bfloat16),
                        dimension_numbers, precision=precision,
                        preferred_element_type=jnp.float32, **kw)
        return real(lhs, rhs, dimension_numbers, precision=precision,
                    preferred_element_type=preferred_element_type, **kw)

    jax.clear_caches()
    jax.lax.dot_general = dot_general
    try:
        yield
    finally:
        jax.lax.dot_general = real
        jax.clear_caches()


def _mean_err(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    fin = np.isfinite(a) & np.isfinite(b)
    return float(np.abs(a[fin] - b[fin]).mean())


def _closer(port, emulated, highest, what: str) -> None:
    """The port at ``"default"`` is at least CLOSER times closer to the
    emulated JAX ``"default"`` than to the JAX ``"highest"``, by the mean
    absolute difference over the outputs (a rounding flip moves a few
    rollouts, not the mean)."""
    near, far = _mean_err(port, emulated), _mean_err(port, highest)
    assert CLOSER * near <= far, (
        f"{what}: {near:.3e} from the emulated 'default', {far:.3e} from "
        f"'highest'")


def _biases(layers, seed: int) -> list:
    rs = np.random.default_rng(seed)
    return [rs.normal(0.0, BIAS_STD, n).astype(np.float32)
            for n in layers[1:]]


def _setup(spec, case="nominal", **cfg_kw):
    """``setup``'s dict with seeded biases (``_biases``) in both
    packages' params."""
    s = setup(spec, case, **cfg_kw)
    s["jparams"] = dict(s["jparams"], biases=[
        jnp.asarray(b) for b in _biases(spec, 5)])
    s["params"] = s["model"].params_from_jax(jax.tree_util.tree_map(
        np.asarray, s["jparams"]))
    return s


def _bf_setup(**cfg_kw):
    """The BF model of both packages with the same theta (seeded, scaled
    by BF_THETA_SCALE) and configs at K, T."""
    jcfg = JaxConfig(num_rollouts=K, num_timesteps=T, **cfg_kw)
    cfg = MPPIConfig(num_rollouts=K, num_timesteps=T, **cfg_kw)
    model = BasisFunctionDynamics(cfg.dt, control_ranges=cfg.control_ranges,
                                  device="cpu")
    params = model.init_params(BF_SEED)
    params = dict(params, theta=params["theta"] * BF_THETA_SCALE)
    jmodel = JaxBF(jcfg.dt, control_ranges=jcfg.control_ranges)
    jparams = {k: jnp.asarray(v.numpy()) for k, v in params.items()}
    return dict(cfg=cfg, jcfg=jcfg, model=model, params=params,
                jmodel=jmodel, jparams=jparams)


def _case(model: str, case: str = "nominal", **cfg_kw):
    """``setup``'s dict of ``case`` for the MLP; for the BF model its own
    with the same state, U and eps."""
    s = _setup(DEFAULT, case, **cfg_kw)
    if model == "bf":
        s.update(_bf_setup(**CASES[case][0], **cfg_kw))
    return s


def _jax(s, precision):
    return s["jcfg"].replace(matmul_precision=precision,
                             use_pallas_rollout=True)


def _torch(s, *names):
    return tuple(torch.tensor(s[n]) for n in names)


# ---------------------------------------------------------------------------
# one step of each derivative form, layer by layer
# ---------------------------------------------------------------------------

def _jax_layer(W_out_in, x, b):
    """One product as the emulated MXU takes it: ``dot_general`` on
    bf16-cast operands, float32 sums, the bias added in float32 after it;
    and the magnitude of its terms."""
    Wb = W_out_in.astype(jnp.bfloat16)
    xb = x.astype(jnp.bfloat16)
    y = jax.lax.dot_general(Wb, xb, (((1,), (0,)), ((), ())),
                            preferred_element_type=jnp.float32) + b
    scale = jnp.abs(Wb.astype(jnp.float32)) @ jnp.abs(xb.astype(
        jnp.float32)) + jnp.abs(b)
    return np.asarray(y), np.asarray(scale)


def _assert_layer(got, want, scale, what):
    err = np.abs(np.asarray(got, np.float64) - want) / np.maximum(scale,
                                                                   1e-30)
    assert err.max() <= LAYER_RTOL, f"{what}: {err.max():.3e}"


def _states(n=512, seed=11):
    rs = np.random.default_rng(seed)
    s = np.zeros((n, 7), np.float32)
    s[:, 3] = rs.uniform(-0.3, 0.3, n)
    s[:, 4] = rs.uniform(-1.0, 8.0, n)
    s[:, 5] = rs.uniform(-1.0, 1.0, n)
    s[:, 6] = rs.uniform(-2.0, 2.0, n)
    u = rs.uniform(-1.0, 1.0, (n, 2)).astype(np.float32)
    return s, u


@pytest.mark.parametrize("form", ["concat", "concat_wide", "split"])
def test_mlp_step_matches_bf16_dot_general_layer_by_layer(form):
    """Each layer of ``rk.kernel_dynamics`` at ``"default"`` (the MLP,
    layer 0 concatenated or, for kernel 3, split) against ``dot_general``
    on bf16-cast operands, each layer fed the JAX side's activations:
    within LAYER_RTOL of the terms' magnitudes; the whole step is the
    port's layers composed.  The split layer 0 keeps the controls, their
    weights and the bias in float32: its result differs from the
    concatenated one's."""
    layers = WIDE if form == "concat_wide" else DEFAULT
    model = NeuralNetDynamics(0.02, layers=layers, device="cpu")
    params = model.init_params(4)
    params = dict(params, biases=[torch.tensor(b) for b in _biases(layers,
                                                                     4)])
    s, u = _states()
    st, ut = torch.tensor(s), torch.tensor(u)
    got = rk.kernel_dynamics(model, params, st, ut, "default",
                             split=form == "split")
    W = [w.numpy() for w in params["weights"]]
    b = [v.numpy() for v in params["biases"]]
    d4 = s[:, 3:]
    if form == "split":
        y0, scale = _jax_layer(W[0][:4].T, d4.T, 0.0)
        y0 = y0 + W[0][4][:, None] * u[:, 0] + W[0][5][:, None] * u[:, 1]
        y0 = y0 + b[0][:, None]
        scale = (scale + np.abs(W[0][4][:, None] * u[:, 0])
                 + np.abs(W[0][5][:, None] * u[:, 1]) + np.abs(b[0])[:, None])
        port0 = (rk.bf16_round(st[:, 3:]) @ rk.bf16_round(
            params["weights"][0][:4]) + ut[:, :1] * params["weights"][0][4]
            + ut[:, 1:] * params["weights"][0][5] + params["biases"][0])
    else:
        x = np.concatenate([d4, u], axis=1)
        y0, scale = _jax_layer(W[0].T, x.T, b[0][:, None])
        port0 = (rk.bf16_round(torch.tensor(x)) @ rk.bf16_round(
            params["weights"][0]) + params["biases"][0])
    _assert_layer(port0.numpy().T, y0, scale, f"{form} layer 0")
    acts, port = y0, port0
    for i in range(1, len(W)):
        h = np.tanh(acts)                   # the JAX side's activations
        y, scale = _jax_layer(W[i].T, h, b[i][:, None])
        mine = (rk.bf16_round(torch.tensor(h.T)) @ rk.bf16_round(
            params["weights"][i]) + params["biases"][i])
        _assert_layer(mine.numpy().T, y, scale, f"{form} layer {i}")
        acts = y
        port = (rk.bf16_round(torch.tanh(port)) @ rk.bf16_round(
            params["weights"][i]) + params["biases"][i])
    assert torch.equal(got, port)
    assert got.shape == (len(s), 4)
    other = rk.kernel_dynamics(model, params, st, ut, "default",
                               split=form != "split")
    assert not torch.equal(got, other)
    assert torch.equal(rk.kernel_dynamics(model, params, st, ut, "high"),
                       model.dynamics(params, st, ut))


def test_bf_step_matches_bf16_dot_general():
    """The BF model at ``"default"``: theta^T and the 25 basis functions
    rounded to bf16, against ``dot_general`` on bf16-cast operands within
    LAYER_RTOL of the terms' magnitudes; ``"highest"`` is the model's own
    derivative bit for bit."""
    model = BasisFunctionDynamics(0.02, device="cpu")
    params = model.init_params(BF_SEED)
    s, u = _states()
    st, ut = torch.tensor(s), torch.tensor(u)
    got = rk.kernel_dynamics(model, params, st, ut, "default")
    phi = car_basis_functions(st, ut)
    theta = params["theta"]
    y, scale = _jax_layer(theta.numpy().T, phi.numpy().T, 0.0)
    _assert_layer(got.numpy().T, y, scale, "BF")
    assert torch.equal(got, rk.bf16_round(phi) @ rk.bf16_round(theta))
    assert not torch.equal(got, phi @ theta)
    for p in ("highest", "high"):
        assert torch.equal(rk.kernel_dynamics(model, params, st, ut, p),
                           model.dynamics(params, st, ut))


def test_bf16_round_is_round_to_nearest_even():
    """``rk.bf16_round``: ties to even, NaN stays NaN, infinities and
    zeros kept, the largest finite values carried to infinity only past
    bf16's range (as ``__float2bfloat16_rn``)."""
    bits = np.array([0x3F808000, 0x3F818000, 0x3F808001, 0x7FC00000,
                     0x7F800000, 0x80000000, 0x7F7FFFFF, 0x7F7F7FFF],
                    np.uint32)
    x = torch.from_numpy(bits.view(np.float32).copy())
    got = rk.bf16_round(x).numpy().view(np.uint32)
    assert list(got[:3]) == [0x3F800000, 0x3F820000, 0x3F810000]
    assert np.isnan(rk.bf16_round(x)[3].item())
    assert list(got[4:6]) == [0x7F800000, 0x80000000]
    assert got[6] == 0x7F800000 and got[7] == 0x7F7F0000


# ---------------------------------------------------------------------------
# the plain kernels against the emulated JAX kernels
# ---------------------------------------------------------------------------

def _kernel1(s, precision, jax_side):
    cm, jcm = _maps()
    if jax_side:
        return jrk.fused_exact_rollout_cost_pallas(
            s["jmodel"], s["jparams"], _jax(s, precision),
            JaxCostParams(desired_speed=6.0), jcm, jnp.asarray(s["state"]),
            jnp.asarray(s["U"]), jnp.asarray(s["eps"]),
            k_offset=s["k_offset"], interpret=True, precision=precision)
    return rk.fused_exact_rollout_cost(
        s["model"], s["params"], s["cfg"], CostParams(desired_speed=6.0), cm,
        *_torch(s, "state", "U", "eps"), k_offset=s["k_offset"],
        precision=precision)


def _kernel3(s, precision, jax_side):
    field, jfield = fields(DEFAULT)
    if jax_side:
        return jrk.fused_rollout_cost_pallas(
            s["jmodel"], s["jparams"], _jax(s, precision),
            JaxCostParams(desired_speed=6.0), jfield, jnp.asarray(s["state"]),
            jnp.asarray(s["U"]), jnp.asarray(s["eps"]),
            k_offset=s["k_offset"], interpret=True, precision=precision)
    return rk.fused_rollout_cost(
        s["model"], s["params"], s["cfg"], CostParams(desired_speed=6.0),
        field, *_torch(s, "state", "U", "eps"), k_offset=s["k_offset"],
        precision=precision)


@pytest.mark.parametrize("model", ["mlp", "bf"])
@pytest.mark.parametrize("kernel", [1, 3])
def test_plain_fused_kernels_match_the_emulated_jax_kernels(kernel, model):
    """Kernel 1 on the exact map and kernel 3 on the field at
    ``"default"``: costs within COST_RTOL / COST_ATOL (the BF model
    BF_RTOL / BF_ATOL), u_seq within USEQ_ATOL, crash flags equal, against
    the emulated JAX kernel in interpret mode; CLOSER times closer to it
    than to the JAX ``"highest"``; ``"high"`` bit for bit ``"highest"``."""
    run = {1: _kernel1, 3: _kernel3}[kernel]
    s = _case(model, "wide_noise")
    rtol, atol = ((BF_RTOL, BF_ATOL) if model == "bf"
                  else (COST_RTOL, COST_ATOL))
    costs, u_seq, crash = run(s, "default", False)
    with one_pass_bf16():
        jc, ju, jx = run(s, "default", True)
    jc_hi, _, _ = run(s, "highest", True)
    np.testing.assert_allclose(costs.numpy(), np.asarray(jc), rtol=rtol,
                               atol=atol)
    np.testing.assert_array_equal(crash.numpy(), np.asarray(jx))
    np.testing.assert_allclose(u_seq.numpy(), np.asarray(ju), rtol=0,
                               atol=USEQ_ATOL)
    assert np.isfinite(costs.numpy()).all()
    _closer(costs.numpy(), jc, jc_hi, f"kernel {kernel} {model}")
    hi = run(s, "highest", False)
    for a, b in zip(run(s, "high", False), hi):
        assert torch.equal(a, b)


@pytest.mark.parametrize("model", ["mlp", "bf"])
def test_plain_chain_at_k_matches_the_emulated_jax_kernel(model):
    """Kernel 2 at K (the general path's chain) at ``"default"``: states
    within STATE_RTOL / STATE_ATOL (the BF model BF_RTOL / BF_ATOL) in all
    but FLIP_SHARE of the rollouts and within FLIP_ATOL in those, u_seq
    equal, against the emulated ``dynamics_chain_pallas``; CLOSER times
    closer to it than to ``"highest"``; ``"high"`` bit for bit
    ``"highest"``."""
    s = _case(model)
    args = _torch(s, "state", "U", "eps")

    def port(p):
        return rk.dynamics_chain(s["model"], s["params"], s["cfg"], *args,
                                 precision=p)

    def jax_side(p):
        S = s["model"].STATE_DIM
        states, u_seq = jrk.dynamics_chain_pallas(
            s["jmodel"], s["jparams"], _jax(s, p), *(jnp.asarray(s[n]) for n
                                                     in ("state", "U",
                                                         "eps")),
            interpret=True, precision=p)
        return np.asarray(states)[:S], np.asarray(u_seq)

    states, u_seq = port("default")
    with one_pass_bf16():
        js, ju = jax_side("default")
    js_hi, _ = jax_side("highest")
    rtol, atol = ((BF_RTOL, BF_ATOL) if model == "bf"
                  else (STATE_RTOL, STATE_ATOL))
    near = np.isclose(states.numpy(), js, rtol=rtol, atol=atol)
    flipped = ~near.all(axis=(0, 1))                 # rollouts
    assert flipped.sum() <= FLIP_SHARE * K, flipped.sum()
    np.testing.assert_allclose(states.numpy(), js, rtol=0, atol=FLIP_ATOL)
    np.testing.assert_array_equal(u_seq.numpy(), ju)
    _closer(states.numpy(), js, js_hi, f"kernel 2 {model}")
    for a, b in zip(port("high"), port("highest")):
        assert torch.equal(a, b)


@pytest.mark.parametrize("sampler", list(SAMPLERS))
@pytest.mark.parametrize("surface", ["exact", "field"])
def test_plain_pass1_matches_the_emulated_jax_kernel(surface, sampler):
    """Pass 1 at ``"default"``, both modes (layer 0 concatenated in both),
    gaussian and OU, zero exploration noise (the JAX kernels draw from the
    TPU's own PRNG): costs within COST_RTOL / COST_ATOL, crash flags
    equal, against the emulated ``fused_rng_costs`` in TPU interpret mode;
    CLOSER times closer to it than to ``"highest"``; ``"high"`` bit for bit
    ``"highest"``."""
    s = _setup(DEFAULT, **QUIET, **SAMPLERS[sampler])
    surf, jsurf = fields(DEFAULT) if surface == "field" else _maps()
    cp = CostParams(desired_speed=6.0)

    def port(p):
        return rk.fused_rng_costs(s["model"], s["params"], s["cfg"], cp,
                                  surf, *_torch(s, "state", "U"), KEY,
                                  precision=p)[:2]

    def jax_side(p):
        total, crash, _ = jrk.fused_rng_costs(
            s["jmodel"], s["jparams"], _jax(s, p),
            JaxCostParams(desired_speed=6.0), jsurf, jnp.asarray(s["state"]),
            jnp.asarray(s["U"]), jax.random.PRNGKey(3),
            interpret=pltpu.InterpretParams(), precision=p)
        return np.asarray(total), np.asarray(crash)

    total, crash = port("default")
    with one_pass_bf16():
        jt, jx = jax_side("default")
    jt_hi, _ = jax_side("highest")
    np.testing.assert_allclose(total.numpy(), jt, rtol=COST_RTOL,
                               atol=COST_ATOL)
    np.testing.assert_array_equal(crash.numpy(), jx)
    _closer(total.numpy(), jt, jt_hi, f"pass 1 {surface} {sampler}")
    for a, b in zip(port("high"), port("highest")):
        assert torch.equal(a, b)


def test_nominal_trajectory_is_float32_at_every_precision():
    """The nominal trajectory (kernel 2 at K = 1) takes no precision, as
    the JAX solver calls ``nominal_trajectory_pallas``: bit for bit
    ``"highest"`` under ``"default"``, through the wrapper and the
    solver."""
    s = _setup(DEFAULT)
    state, U = _torch(s, "state", "U")
    outs = []
    for p in MATMUL_PRECISIONS:
        cfg = s["cfg"].replace(matmul_precision=p)
        solver = mppi.MPPISolver(s["model"], MPPICost(), cfg, device="cpu")
        outs.append(rk.nominal_trajectory(s["model"], s["params"], cfg,
                                          state, U)
                    + solver.nominal_trajectory(s["params"], state, U))
    for other in outs[1:]:
        for a, b in zip(outs[0], other):
            assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the solver in each mode
# ---------------------------------------------------------------------------

class _SubCost(MPPICost):
    pass


class _JaxSubCost(JaxCost):
    pass


def _iterates(mode):
    """(port U_new, stats; emulated JAX U_new, stats; JAX "highest" U_new)
    of one ``"default"`` iteration in ``mode`` on the same noise (in the
    capacity mode the port's stream)."""
    capacity = mode == "capacity"
    s = _setup(DEFAULT, "wide_noise", matmul_precision="default",
              kernel_rng=capacity)
    surf, jsurf = fields(DEFAULT) if mode == "field" else _maps()
    cost, jcost = ((_SubCost(), _JaxSubCost()) if mode == "general"
                   else (MPPICost(), JaxCost()))
    solver = mppi.MPPISolver(s["model"], cost, s["cfg"], device="cpu")
    assert solver._use_kernel_rng(surf) == capacity
    assert solver._fusable_cost() == (mode != "general")
    cp = CostParams(desired_speed=6.0)
    state, U = _torch(s, "state", "U")
    if capacity:
        U_new, stats = solver._iterate_kernel_rng(s["params"], cp, surf,
                                                  state, U, KEY)
        eps = kr.kernel_noise(KEY, 0, K, T, None).numpy()
    else:
        eps = s["eps"]
        U_new, stats = solver.iterate(s["params"], cp, surf, state, U,
                                      torch.tensor(eps))
    out = []
    for p in ("default", "highest"):
        js = jmppi.MPPISolver(s["jmodel"], jcost, _jax(s, p).replace(
            kernel_rng=False))
        js._pallas_interpret = True
        with one_pass_bf16() if p == "default" else contextlib.nullcontext():
            out.append(js.iterate(s["jparams"],
                                  JaxCostParams(desired_speed=6.0), jsurf,
                                  jnp.asarray(s["state"]),
                                  jnp.asarray(s["U"]), jnp.asarray(eps)))
    return U_new, stats, out[0][0], out[0][1], out[1][0]


@pytest.mark.parametrize("mode", ["host_noise", "capacity", "field",
                                  "general"])
def test_default_iterate_matches_the_emulated_jax_iterate(mode):
    """One ``"default"`` iteration (kernel 1, pass 1 and pass 2, kernel 3,
    kernel 2 at K and the cost epilogue): U_new and the six SolveStats
    within ITER_RTOL / ITER_ATOL of the emulated JAX iterate, and U_new
    CLOSER times closer to it than to the JAX ``"highest"`` one."""
    U_new, stats, jU, jstats, jU_hi = _iterates(mode)
    np.testing.assert_allclose(U_new.numpy(), np.asarray(jU),
                               rtol=ITER_RTOL, atol=ITER_ATOL)
    _assert_stats(stats, jstats, ITER_RTOL, ITER_ATOL)
    _closer(U_new.numpy(), jU, jU_hi, f"{mode} iterate")


def test_high_solves_bit_for_bit_as_highest_and_default_differs():
    """``MPPISolver.solve`` at ``"high"`` equals ``"highest"`` bit for bit
    (host noise and the capacity mode); ``"default"`` solves and differs."""
    for extra in ({}, dict(kernel_rng=True)):
        s = _setup(DEFAULT, **extra)
        cm, _ = _maps()
        outs = {}
        for p in MATMUL_PRECISIONS:
            solver = mppi.MPPISolver(s["model"], MPPICost(), s["cfg"].replace(
                matmul_precision=p), device="cpu")
            cs, stats = solver.solve(s["params"], CostParams(), cm, START,
                                     solver.init_state())
            outs[p] = (cs.U, cs.state_solution, stats.baseline)
        for a, b in zip(outs["high"], outs["highest"]):
            assert torch.equal(a, b)
        assert torch.isfinite(outs["default"][0]).all()
        assert not torch.equal(outs["default"][0], outs["highest"][0])


def test_one_rank_sharded_capacity_iterate_equals_the_solver():
    """A one-rank sharded capacity iterate (the inline body: pass 1 on the
    whole batch, the collectives' identities) at ``"default"`` equals
    ``MPPISolver``'s bit for bit, and differs from ``"highest"``'s."""
    s = _setup(DEFAULT, kernel_rng=True, matmul_precision="default")
    cm, _ = _maps()
    cp = CostParams(desired_speed=6.0)
    state, U = _torch(s, "state", "U")
    sub = np.array([0x0BADF00D, 0x5EED1234], np.uint32)
    out = {}
    for p in ("default", "highest"):
        cfg = s["cfg"].replace(matmul_precision=p)
        sharded = ShardedMPPISolver(s["model"], MPPICost(), cfg,
                                    device="cpu")
        assert sharded._inline_body and sharded._use_kernel_rng(cm)
        out[p] = sharded._sharded_rng_iterate(s["params"], cp, cm, state, U,
                                              sub)
    single = mppi.MPPISolver(s["model"], MPPICost(), s["cfg"], device="cpu")
    U_s, st_s = single._iterate_drawn(s["params"], cp, cm, state, U,
                                      sharded._draw(cm, sub))
    U_new, stats = out["default"]
    assert torch.equal(U_new, U_s)
    for f in mppi.SolveStats._fields:
        assert torch.equal(getattr(stats, f), getattr(st_s, f)), f
    assert not torch.equal(U_new, out["highest"][0])


# ---------------------------------------------------------------------------
# the names, the libraries and the launches
# ---------------------------------------------------------------------------

def test_an_unknown_precision_raises_value_error():
    """A name the JAX package does not take raises ``ValueError`` when the
    solver is built and in every wrapper, before anything runs."""
    s = _setup(DEFAULT)
    cm, _ = _maps()
    with pytest.raises(ValueError, match="matmul_precision"):
        mppi.MPPISolver(s["model"], MPPICost(), s["cfg"].replace(
            matmul_precision="fastest"), device="cpu")
    args = (s["model"], s["params"], s["cfg"], CostParams(), cm,
            *_torch(s, "state", "U"))
    with pytest.raises(ValueError, match="matmul_precision"):
        rk.fused_exact_rollout_cost(*args, torch.tensor(s["eps"]),
                                    precision="fastest")
    with pytest.raises(ValueError, match="matmul_precision"):
        rk.fused_rng_costs(*args, KEY, precision="HIGHEST")
    with pytest.raises(ValueError, match="matmul_precision"):
        rk.dynamics_chain(s["model"], s["params"], s["cfg"],
                          *_torch(s, "state", "U", "eps"), precision="bf16")
    assert MATMUL_PRECISIONS == {"highest": False, "high": False,
                                 "default": True}
    assert set(MATMUL_PRECISIONS) == set(jrk.PRECISIONS)


def test_precision_none_follows_the_config(monkeypatch):
    """Without ``precision`` (None) every plain version, wrapper and
    ``prepare_*`` runs at ``cfg.matmul_precision``; a ``precision`` that is
    given wins over the config's; the nominal trajectory passes
    ``"highest"`` itself."""
    s = _setup(DEFAULT, kernel_rng=True)
    state, U, eps = _torch(s, "state", "U", "eps")
    cm, _ = _maps()
    hcfg = s["cfg"]
    dcfg = hcfg.replace(matmul_precision="default")
    common = (s["model"], s["params"])

    def run(fn, cfg, *args, **kw):
        return fn(*common, cfg, *args, **kw)

    for fn, args in ((rk.fused_rollout_cost_plain,
                      (CostParams(), cm, state, U, eps)),
                     (rk.fused_exact_rollout_cost,
                      (CostParams(), cm, state, U, eps)),
                     (rk.dynamics_chain, (state, U, eps)),
                     (rk.fused_rng_costs, (CostParams(), cm, state, U, KEY)),
                     (rk.fused_rng_solve_iteration,
                      (CostParams(), cm, state, U, KEY))):
        d, h = run(fn, dcfg, *args), run(fn, hcfg, *args)
        for ours, given in ((d, run(fn, hcfg, *args, precision="default")),
                            (h, run(fn, dcfg, *args, precision="highest"))):
            for a, b in zip(ours, given):
                if torch.is_tensor(a):
                    assert torch.equal(a, b), fn.__name__
        assert not torch.equal(d[0], h[0]), fn.__name__
    nominal = [rk.nominal_trajectory(*common, c, state, U)
               for c in (hcfg, dcfg)]
    for a, b in zip(*nominal):
        assert torch.equal(a, b)

    asked = []

    def load(*args, **kw):
        asked.append(kw)
        raise LookupError("no build here")

    monkeypatch.setattr(rk._build, "load", load)
    monkeypatch.setattr(rk, "num_sms", lambda index: 132)
    for call in (
            lambda c: rk.prepare_fused_exact_rollout_cost(
                *common, c, CostParams(), cm, state, U, eps),
            lambda c: rk.prepare_dynamics_chain(*common, c, state, U, eps),
            lambda c: rk.prepare_fused_rng_costs(*common, c, CostParams(),
                                                 cm, state, U, KEY)):
        for c, kw in ((dcfg, {"bf16": True}), (hcfg, {})):
            asked.clear()
            rk._kernel_lib.cache_clear()
            with pytest.raises(LookupError):
                call(c)
            assert asked == [kw]
    rk._kernel_lib.cache_clear()


@pytest.mark.parametrize("spec", [DEFAULT, WIDE], ids=["default", "wide"])
def test_default_asks_for_the_bf16_library_and_names_its_launches(
        spec, monkeypatch):
    """On the card ``"default"`` takes the library of bf16 operands of the
    spec (``_build.load(layers, bf16=True)``; the field kernels the same
    for the default field), ``"high"`` the float32 one, and pass 2 the
    float32 default library; the launches are counted as ``..._default``.
    ``_build.load`` records what it is asked for and raises: nothing is
    built, nothing runs the plain version instead."""
    s = _setup(spec, kernel_rng=True)
    field, _ = fields(DEFAULT)
    cm, _ = _maps()
    asked = []

    def load(*args, **kw):
        asked.append((args, kw))
        raise LookupError("no build here")

    monkeypatch.setattr(rk._build, "load", load)
    monkeypatch.setattr(rk, "num_sms", lambda index: 132)
    rk._kernel_lib.cache_clear()
    state, U, eps = _torch(s, "state", "U", "eps")
    common = (s["model"], s["params"], s["cfg"])
    calls = (
        lambda p: rk.prepare_fused_exact_rollout_cost(
            *common, CostParams(), cm, state, U, eps, precision=p),
        lambda p: rk.prepare_fused_rollout_cost(
            *common, CostParams(), field, state, U, eps, precision=p),
        lambda p: rk.prepare_dynamics_chain(*common, state, U, eps,
                                            precision=p),
        lambda p: rk.prepare_fused_rng_costs(*common, CostParams(), cm,
                                             state, U, KEY, precision=p),
        lambda p: rk.prepare_fused_rng_costs(*common, CostParams(), field,
                                             state, U, KEY, precision=p))
    for p, kw in (("default", {"bf16": True}), ("high", {})):
        for call in calls:
            asked.clear()
            rk._kernel_lib.cache_clear()
            with pytest.raises(LookupError):
                call(p)
            assert asked == [((spec,), kw)], (p, asked)
    asked.clear()
    ctx = rk.RngContext(s["model"], s["cfg"].replace(
        matmul_precision="default"), U, KEY, 0, K, None)
    with pytest.raises(LookupError):
        rk.prepare_fused_rng_numer(ctx, torch.ones(K))
    assert asked == [((rk.KERNEL_LAYERS,), {})]
    rk._kernel_lib.cache_clear()

    class Lib:
        def __getattr__(self, name):
            return lambda *a: rk.MAX_KERNEL_T if name == "artt_max_t" else 0

    monkeypatch.setattr(rk, "_kernel_lib", lambda *a: Lib())
    sfx = "" if spec == DEFAULT else "_" + "-".join(map(str, spec))
    names = [calls[i]("default")[0].name for i in range(3)] + [
        calls[i]("default")[0].name for i in (3, 4)]
    assert names == [f"fused_exact_rollout_cost{sfx}_default",
                     f"fused_rollout_cost{sfx}_default",
                     f"dynamics_chain{sfx}_default",
                     f"fused_rng_costs{sfx}_default",
                     f"fused_rng_costs_field{sfx}_default"]
    assert calls[0]("highest")[0].name == f"fused_exact_rollout_cost{sfx}"


def test_the_bf16_libraries_are_their_own():
    """The libraries of bf16 operands: ``ARTT_BF16_OPERANDS`` in the
    pre-included header, a name and hash of their own beside each float32
    library, without pass 2 and the quotient check; the float32 libraries'
    defines as they were.  The source rounds where the module says."""
    for layers, field in ((None, None), (WIDE, None), (None, (6, 48, 48)),
                          ((6, 24, 4), (5, 40, 20))):
        fp32 = _build.spec_defines(layers, field)
        bf16 = _build.spec_defines(layers, field, bf16=True)
        assert "ARTT_BF16_OPERANDS" not in fp32
        assert bf16 == "#define ARTT_BF16_OPERANDS\n" + fp32
        a = _build.library_path(layers, field)
        b = _build.library_path(layers, field, bf16=True)
        assert a != b and b.name.startswith(a.name.rsplit("_", 1)[0]
                                            + "_bf16_")
    assert _build.library_path().name.startswith("rollout_kernels_")
    held = _build.functions(bf16=True)
    assert set(held) == set(_build.SIGNATURES) - set(
        _build.FP32_ONLY_FUNCTIONS)
    assert "artt_fused_rng_costs" in held and "artt_bf16_operands" in held
    assert _build.functions(WIDE, bf16=True) == _build.SPEC_FUNCTIONS
    assert _build.functions(None, (6, 48, 48), bf16=True) \
        == _build.FIELD_FUNCTIONS
    src = _build.SOURCE.read_text()
    for text in ("#ifdef ARTT_BF16_OPERANDS",
                 "__float2bfloat16_rn", "struct MlpSplitDeriv",
                 "int artt_bf16_operands()"):
        assert text in src, text
