"""The port's kernel-RNG capacity mode on the CPU, through the plain
versions its wrappers run for CPU tensors.

The JAX package's kernel-RNG passes draw from the TPU's own PRNG, which has
no CPU lowering, so the oracle is the JAX *host-noise* path fed the port's
noise stream: on the same noise the two modes compute the same thing (the
same perturb/clamp/freeze masks, the same step cost, the weighted numerator
over pre-clamp controls).  The stream itself is held bit for bit against
``jax.extend.random.threefry_2x32`` and statistically against N(0, 1) and
OU.  Sizes: K <= 4096, T <= 32.  The CUDA passes run only on a GPU:
``chip_smoke.py`` holds them against these plain versions there."""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.extend.random import threefry_2x32

from autorally_tpu.config import CostParams as JaxCostParams
from autorally_tpu.costs.costmap import make_costmap as jax_make_costmap
from autorally_tpu.ops import rollout_kernel as jrk
from autorally_tpu.solver import mppi as jmppi
from autorally_tpu_torch.config import CostParams
from autorally_tpu_torch.costs import MPPICost, make_costmap
from autorally_tpu_torch.models import NeuralNetDynamics
from autorally_tpu_torch.ops import kernel_rng as kr
from autorally_tpu_torch.ops import rollout_kernel as rk
from autorally_tpu_torch.solver import mppi
from tests.test_torch_rollout_kernel import random_map
from tests.test_torch_solver import (ITER_ATOL, ITER_RTOL, SCENARIO_ATOL,
                                     SCENARIO_RTOL, SCENARIO_START,
                                     _assert_stats, _interpret_solver, _pair)

K, T = 256, 24
KEY = torch.tensor([0x2545F491, 0x9E3779B9])
STATE = np.array([25.0, 0.0, np.pi / 2, 0.0, 3.0, 0.1, 0.0], np.float32)
CP = dict(desired_speed=6.0)
# Pass 2 against a float64 reference, relative to sum_k |w_k u_{k,t,c}|:
# float32 sums of K = 256 products in another order.
NUMER_RTOL = 1e-6
SAMPLERS = {"gaussian": {}, "ou": dict(noise_sampler="ou", noise_param=0.15)}


def _theta(sampler):
    return SAMPLERS[sampler].get("noise_param")


def _capacity_pair(sampler, **kw):
    """(port solver in capacity mode, params, map, JAX host-noise solver,
    JAX params, JAX map)."""
    solver, params, cm, jsolver, jparams, jcm = _pair(**SAMPLERS[sampler],
                                                      **kw)
    port = mppi.MPPISolver(solver.model, MPPICost(),
                           solver.cfg.replace(kernel_rng=True), device="cpu")
    assert port._use_kernel_rng(cm)
    return port, params, cm, jsolver, jparams, jcm


def _inputs(T=T):
    U = np.tile(np.array([0.05, 0.3], np.float32), (T, 1))
    U[:, 0] = np.random.default_rng(2).uniform(-0.3, 0.3, T)
    return torch.tensor(STATE), torch.tensor(U)


# ---------------------------------------------------------------------------
# the stream
# ---------------------------------------------------------------------------

def test_threefry_matches_jax_bit_for_bit():
    """Random123's known-answer vector, then 10^4 random keys and
    counters, against ``jax.extend.random.threefry_2x32``."""
    word = lambda v: torch.tensor(v, dtype=torch.int64)
    out = kr.threefry2x32((word(0x13198A2E), word(0x03707344)),
                          (word(0x243F6A88), word(0x85A308D3)))
    assert [int(v) for v in out] == [0xC4923A9C, 0x483DF7A0]

    rs = np.random.default_rng(0)
    k, c = (rs.integers(0, 1 << 32, (10_000, 2), dtype=np.uint64)
            .astype(np.uint32) for _ in range(2))
    ref = np.asarray(jax.vmap(lambda k0, k1, cc: threefry_2x32((k0, k1), cc))(
        jnp.asarray(k[:, 0]), jnp.asarray(k[:, 1]), jnp.asarray(c)))
    as64 = lambda a: torch.tensor(a.astype(np.int64))
    x0, x1 = kr.threefry2x32((as64(k[:, 0]), as64(k[:, 1])),
                             (as64(c[:, 0]), as64(c[:, 1])))
    np.testing.assert_array_equal(x0.numpy(), ref[:, 0].astype(np.int64))
    np.testing.assert_array_equal(x1.numpy(), ref[:, 1].astype(np.int64))


def test_stream_math_is_accurate_and_uniforms_exact():
    """log within 2 ulp, sin/cos within 2e-7 of float64; the 23-bit
    uniforms are ``raw >> 9`` times 2^-23 exactly."""
    rs = np.random.default_rng(1)
    x = rs.uniform(1e-7, 1.0, 200_000).astype(np.float32)
    got = kr.stream_log(torch.tensor(x)).numpy()
    ref = np.log(x.astype(np.float64))
    ulp = np.spacing(np.abs(ref).astype(np.float32)).astype(np.float64)
    assert np.max(np.abs(got - ref) / ulp) <= 2.0
    m = rs.integers(0, 1 << 23, 200_000)
    cos, sin = kr.stream_sincos_2pi(torch.tensor(m))
    ang = 2 * np.pi * m * 2.0 ** -23
    assert np.max(np.abs(cos.numpy() - np.cos(ang))) < 2e-7
    assert np.max(np.abs(sin.numpy() - np.sin(ang))) < 2e-7
    raw = torch.tensor([0, 511, 512, 0xFFFFFFFF], dtype=torch.int64)
    pair = kr.normals_from_bits(raw, torch.zeros_like(raw))   # angle 0
    u1 = np.array([0, 0, 1, (1 << 23) - 1], np.float32) * np.float32(2 ** -23)
    u1 = u1 + np.float32(1e-7)
    np.testing.assert_allclose(pair[:, 0].numpy(), np.sqrt(-2 * np.log(u1)),
                               rtol=2e-7)
    np.testing.assert_array_equal(pair[:, 1].numpy(), 0.0)


def _numpy_normals(r0, r1):
    """The stream's Box-Muller pair in numpy float32, one IEEE-rounded
    operation at a time (as the kernels evaluate it)."""
    C = {k: np.float32(v) for k, v in kr.CONSTANTS.items()}
    u1 = (r0 >> 9).astype(np.float32) * C["kTwoM23"] + C["kU1Guard"]
    bits = u1.view(np.int32)
    e = (bits >> 23) - 126
    m = ((bits & 0x7FFFFF) | 0x3F000000).astype(np.int32).view(np.float32)
    small = m < C["kSqrtHalf"]
    m, e = np.where(small, m * np.float32(2), m), np.where(small, e - 1, e)
    s = (m - np.float32(1)) / (m + np.float32(1))
    z = s * s
    p = np.full_like(z, C["kLog13"])
    for n in (11, 9, 7, 5, 3):
        p = p * z + C[f"kLog{n}"]
    log_u1 = e.astype(np.float32) * C["kLn2"] + (s * np.float32(2)
                                                 + (s * z) * p)
    r = np.sqrt(log_u1 * np.float32(-2))
    m2 = r1 >> 9
    q, f = m2 >> 21, (m2 & 0x1FFFFF).astype(np.float32) * C["kTwoM23"]
    hi = f >= np.float32(0.125)
    f, q = np.where(hi, f - np.float32(0.25), f), np.where(hi, q + 1, q) & 3
    x = f * C["kTwoPi"]
    z = x * x
    ps = np.full_like(z, C["kSin9"])
    for n in (7, 5, 3):
        ps = ps * z + C[f"kSin{n}"]
    pc = np.full_like(z, C["kCos10"])
    for n in (8, 6, 4, 2):
        pc = pc * z + C[f"kCos{n}"]
    sn, cs = x + (x * z) * ps, z * pc + np.float32(1)
    cos = np.select([q == 0, q == 1, q == 2], [cs, -sn, -cs], sn)
    sin = np.select([q == 0, q == 1, q == 2], [sn, cs, -sn], -cs)
    return np.stack([r * cos, r * sin], axis=-1)


def test_stream_is_single_rounded_float32_operations():
    """The plain stream equals a numpy float32 evaluation bit for bit:
    each of its steps is one correctly rounded operation, which is what
    lets the CUDA kernels (``__fadd_rn``, ``__fmul_rn``, ``__fdiv_rn``,
    ``__fsqrt_rn``) reproduce it exactly."""
    rs = np.random.default_rng(2)
    r0, r1 = (rs.integers(0, 1 << 32, 500_000) for _ in range(2))
    got = kr.normals_from_bits(torch.tensor(r0), torch.tensor(r1)).numpy()
    np.testing.assert_array_equal(got, _numpy_normals(r0, r1))


def test_stream_constants_match_the_cuda_source():
    """The kernels spell the stream's float32 constants as hex floats; they
    must equal the plain version's."""
    src = (Path(rk.__file__).parent.parent / "csrc"
           / "rollout_kernels.cu").read_text()
    found = {name: float.fromhex(v) for name, v in re.findall(
        r"constexpr float (k\w+) = (-?0x[0-9a-fA-F.p+-]+)f;", src)}
    assert {n: found.get(n) for n in kr.CONSTANTS} == kr.CONSTANTS
    assert "0x1BD11BDAu" in src
    for r in (13, 15, 26, 6, 17, 29, 16, 24):
        assert f"ARTT_ROUND({r})" in src


def test_stream_is_keyed_on_the_global_rollout():
    """The same rollouts from a launch at another k_offset, or of another
    size, get the same numbers; another key gets others."""
    whole = kr.kernel_normals(KEY, 0, 512, 16)
    np.testing.assert_array_equal(kr.kernel_normals(KEY, 256, 256, 16).numpy(),
                                  whole[:, 256:].numpy())
    np.testing.assert_array_equal(kr.kernel_normals(KEY, 0, 100, 8).numpy(),
                                  whole[:8, :100].numpy())
    other = kr.kernel_normals(KEY + 1, 0, 512, 16)
    assert not np.any(other.numpy() == whole.numpy())
    ou = kr.kernel_noise(KEY, 0, 512, 16, 0.15)
    np.testing.assert_array_equal(ou[0].numpy(), whole[0].numpy())
    with pytest.raises(ValueError, match="int64"):
        kr.kernel_normals(KEY.to(torch.int32), 0, 8, 8)


@pytest.mark.parametrize("sampler", list(SAMPLERS))
def test_stream_statistics(sampler):
    """Eight launches of 4096 rollouts x 32 steps at consecutive k_offsets:
    |mean| < 0.01, |var - 1| < 0.02, lag-1 autocorrelation within 0.01 of
    0 (white) or 1 - theta (OU), cross-channel and adjacent-rollout
    correlation |rho| < 0.01 (all at least 4 standard errors)."""
    theta = _theta(sampler)
    x = torch.cat([kr.kernel_noise(KEY, b * 4096, 4096, 32, theta)
                   for b in range(8)], dim=1).double().numpy()
    assert abs(x.mean()) < 0.01
    assert abs(x.var() - 1.0) < 0.02
    x = x - x.mean()

    def corr(a, b):
        return float((a * b).mean() / np.sqrt((a * a).mean() * (b * b).mean()))

    want = 0.0 if theta is None else 1.0 - theta
    assert abs(corr(x[1:], x[:-1]) - want) < 0.01
    assert abs(corr(x[..., 0], x[..., 1])) < 0.01
    assert abs(corr(x[:, 1:], x[:, :-1])) < 0.01


# ---------------------------------------------------------------------------
# pass 1, pass 2 and the iteration against the JAX host-noise path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["scan", "interpret_kernel"])
@pytest.mark.parametrize("sampler", list(SAMPLERS))
@pytest.mark.parametrize("map_kind", ["oval", "random"])
def test_pass1_plain_matches_jax_rollout_costs(map_kind, sampler, backend):
    """On the oval and, with the exploration std x4, on a 2 cm random map
    (``tests/test_torch_rollout_kernel.py``'s, values in [0, 0.66)) where
    the crash flags differ between rollouts."""
    wide = dict(steering_std=4 * 0.275, throttle_std=4 * 0.3)
    port, params, cm, jsolver, jparams, jcm = _capacity_pair(
        sampler, **(wide if map_kind == "random" else {}))
    if backend == "interpret_kernel":
        jsolver = _interpret_solver(jsolver)
    if map_kind == "random":
        data, xb, yb = random_map(np.random.default_rng(0), hi=0.66)
        cm = make_costmap(data, xb, yb, device="cpu")
        jcm = jax_make_costmap(data, xb, yb)
    state, U = _inputs()
    total, crash, ctx = rk.fused_rng_costs(port.model, params, port.cfg,
                                           CostParams(**CP), cm, state, U,
                                           KEY)
    eps = rk.rng_noise(ctx).numpy()
    assert eps.shape == (T, K, 2) and ctx.theta == _theta(sampler)
    jc, _, jx = jsolver.rollout_costs(jparams, JaxCostParams(**CP), jcm,
                                      jnp.asarray(STATE), jnp.asarray(U),
                                      jnp.asarray(eps))
    np.testing.assert_allclose(total.numpy(), np.asarray(jc),
                               rtol=ITER_RTOL, atol=ITER_ATOL)
    np.testing.assert_array_equal(crash.numpy(), np.asarray(jx))
    if map_kind == "random":
        assert 0 < int(crash.sum()) < K   # the flags differ between rollouts


@pytest.mark.parametrize("k_offset", [0, 128])
@pytest.mark.parametrize("sampler", list(SAMPLERS))
def test_pass2_plain_matches_jax_weighted_controls(sampler, k_offset):
    """Against ``einsum("k,ctk->tc", w, u_seq)`` over the u_seq of the
    interpret-mode fused kernel on the same noise; ``k_offset`` runs the
    second half of a sharded batch (no noise-free rollout, pure-noise
    threshold moved)."""
    port, params, cm, jsolver, jparams, jcm = _capacity_pair(sampler)
    state, U = _inputs()
    K_local = K - k_offset
    _, _, ctx = rk.fused_rng_costs(port.model, params, port.cfg,
                                   CostParams(**CP), cm, state, U, KEY,
                                   k_offset=k_offset, K_local=K_local)
    eps = rk.rng_noise(ctx)
    np.testing.assert_array_equal(
        eps.numpy(), kr.kernel_noise(KEY, 0, K, T, _theta(sampler))
        [:, k_offset:].numpy())
    w = np.random.default_rng(3).uniform(0, 1, K_local).astype(np.float32)
    numer = rk.fused_rng_numer(ctx, torch.tensor(w)).numpy()      # (C, T)
    _, ju, _ = jrk.fused_exact_rollout_cost_pallas(
        jsolver.model, jparams, jsolver.cfg, JaxCostParams(**CP), jcm,
        jnp.asarray(STATE), jnp.asarray(U), jnp.asarray(eps.numpy()),
        k_offset=k_offset, interpret=True)
    ref = np.asarray(jnp.einsum("k,ctk->tc", jnp.asarray(w), ju)).T
    scale = np.einsum("k,ctk->ct", np.abs(w), np.abs(np.asarray(ju)))
    assert numer.shape == (2, T)
    assert np.all(np.abs(numer - ref) <= NUMER_RTOL * scale)


@pytest.mark.parametrize("sampler", list(SAMPLERS))
def test_pass2_one_hot_weights_extract_one_rollouts_controls(sampler):
    """w = e_k turns the numerator into rollout k's pre-clamp controls:
    U for rollout 0, nu eps for a pure-noise rollout, U + nu eps
    otherwise, and U on the frozen first step."""
    port, params, cm, *_ = _capacity_pair(sampler)
    state, U = _inputs()
    _, _, ctx = rk.fused_rng_costs(port.model, params, port.cfg, CostParams(),
                                   cm, state, U, KEY)
    du = (rk.rng_noise(ctx) * torch.tensor(port.cfg.exploration_std)).numpy()
    first_pure = int(np.ceil(np.float32(0.99 * K)))
    for k in (0, 1, first_pure, K - 1):
        w = torch.zeros(K)
        w[k] = 1.0
        got = rk.fused_rng_numer(ctx, w).numpy().T                # (T, C)
        if k == 0:
            want = U.numpy().copy()
        elif k >= first_pure:
            want = du[:, k].copy()
        else:
            want = U.numpy() + du[:, k]
        want[0] = U[0].numpy()                 # t < optimization_stride
        np.testing.assert_array_equal(got, want, err_msg=f"k={k}")


@pytest.mark.parametrize("sampler", list(SAMPLERS))
def test_capacity_iteration_matches_jax_iterate(sampler):
    """U_new and all six SolveStats against JAX ``iterate`` on the stream."""
    port, params, cm, jsolver, jparams, jcm = _capacity_pair(sampler)
    state, U = _inputs()
    cp = CostParams(**CP)
    U_new, total, crash = rk.fused_rng_solve_iteration(
        port.model, params, port.cfg, cp, cm, state, U, KEY)
    U_solver, stats = port._iterate_kernel_rng(params, cp, cm, state, U, KEY)
    assert torch.equal(U_new, U_solver)
    U_plain, total_plain, _ = rk.fused_rng_solve_iteration_plain(
        port.model, params, port.cfg, cp, cm, state, U, KEY)
    assert torch.equal(U_plain, U_new) and torch.equal(total_plain, total)
    eps = kr.kernel_noise(KEY, 0, K, T, _theta(sampler)).numpy()
    jU, jstats = jsolver.iterate(jparams, JaxCostParams(**CP), jcm,
                                 jnp.asarray(STATE), jnp.asarray(U),
                                 jnp.asarray(eps))
    np.testing.assert_allclose(U_new.numpy(), np.asarray(jU),
                               rtol=ITER_RTOL, atol=ITER_ATOL)
    _assert_stats(stats, jstats, ITER_RTOL, ITER_ATOL)
    assert 1.0 < float(stats.ess) < K


@pytest.mark.parametrize("sampler", list(SAMPLERS))
def test_three_tick_capacity_scenario_matches_jax(sampler):
    """slide + solve three times in the capacity mode (K=256, T=32,
    ppm=4) against JAX slide + iterate + savitzky_golay +
    nominal_trajectory fed the same per-tick stream: the port's solve
    draws one key per tick from its generator, and a twin generator of
    the same seed gives the JAX side the stream of that key."""
    Kp, Tp = 256, 32
    port, params, cm, jsolver, jparams, jcm = _capacity_pair(
        sampler, K=Kp, T=Tp, ppm=4.0, seed=1234)
    twin = torch.Generator()
    twin.manual_seed(port.cfg.seed)
    cp, jcp = CostParams(desired_speed=5.0), JaxCostParams(desired_speed=5.0)
    jstate = jnp.asarray(SCENARIO_START)
    cs, jcs = port.init_state(), jsolver.init_state()
    for _ in range(3):
        cs = port.slide(cs, 1)
        cs, stats = port.solve(params, cp, cm, SCENARIO_START, cs)
        key = torch.randint(0, 1 << 32, (2,), generator=twin,
                            dtype=torch.int64)
        eps = kr.kernel_noise(key, 0, Kp, Tp, _theta(sampler)).numpy()
        jcs = jsolver.slide(jcs, 1)
        jU, jstats = jsolver.iterate(jparams, jcp, jcm, jstate, jcs.U,
                                     jnp.asarray(eps))
        jU = jmppi.savitzky_golay(jU, jcs.control_hist)
        jss, jctl = jsolver.nominal_trajectory(jparams, jstate, jU)
        jcs = jcs._replace(U=jU, state_solution=jss, control_solution=jctl)
    for name in ("U", "control_hist", "control_solution", "state_solution"):
        np.testing.assert_allclose(getattr(cs, name).numpy(),
                                   np.asarray(getattr(jcs, name)),
                                   rtol=SCENARIO_RTOL, atol=SCENARIO_ATOL,
                                   err_msg=name)
    _assert_stats(stats, jstats, SCENARIO_RTOL, SCENARIO_ATOL)


# ---------------------------------------------------------------------------
# dispatch and refusals
# ---------------------------------------------------------------------------

def test_use_kernel_rng_gates():
    """The JAX package's semantic gates (``tests/test_bf_kernel.py``'s
    cases that apply to the NN model and the exact map); the TPU-only VMEM
    budget is gone, so a map above it qualifies."""
    solver, params, cm, *_ = _pair(K=128, T=16)

    def mk(model=solver.model, cost=MPPICost(), **kw):
        cfg = solver.cfg.replace(**{"kernel_rng": True, **kw})
        return mppi.MPPISolver(model, cost, cfg, device="cpu")

    assert mk()._use_kernel_rng(cm)
    assert not mk(kernel_rng=False)._use_kernel_rng(cm)
    assert mk(noise_sampler="ou", noise_param=0.15)._use_kernel_rng(cm)
    assert mk(noise_sampler="ou", noise_param=1.0)._use_kernel_rng(cm)
    assert not mk(noise_sampler="ou", noise_param=2.5)._use_kernel_rng(cm)
    assert not mk(noise_sampler="ou", noise_param=0.0)._use_kernel_rng(cm)
    assert not mk(noise_sampler="colored")._use_kernel_rng(cm)
    assert not mk(exact_fused=False)._use_kernel_rng(cm)
    wide = NeuralNetDynamics(0.02, layers=(6, 64, 4), device="cpu")
    assert not mk(model=wide)._use_kernel_rng(cm)             # no kernel form
    assert not mk()._use_kernel_rng(object())                 # not a Costmap
    big = make_costmap(np.zeros((1200, 1400, 4), np.float32), (0.0, 140.0),
                       (0.0, 120.0), device="cpu")
    assert big.ch0.numel() * 4 > 6 * 2 ** 20                  # > 6 MB VMEM
    assert mk()._use_kernel_rng(big)


def test_gated_out_solvers_take_the_host_noise_path():
    """kernel_rng=True with colored noise solves on the host-noise path,
    drawing its noise from the sampler, not a key."""
    solver, params, cm, *_ = _pair(K=128, T=16)
    colored = mppi.MPPISolver(solver.model, MPPICost(), solver.cfg.replace(
        kernel_rng=True, noise_sampler="colored"), device="cpu")
    drawn = []
    sample = colored._sample_noise
    colored._sample_noise = lambda gen, shape: drawn.append(shape) or sample(
        gen, shape)
    cs, _ = colored.solve(params, CostParams(), cm, SCENARIO_START,
                          colored.init_state())
    assert drawn == [(16, 128, 2)] and np.isfinite(cs.U.numpy()).all()


def test_capacity_mode_refuses_what_it_cannot_draw():
    port, params, cm, *_ = _capacity_pair("gaussian")
    state, U = _inputs()
    run = lambda cfg=port.cfg, cp=CostParams(), field=cm, key=KEY: \
        rk.fused_rng_costs(port.model, params, cfg, cp, field, state, U, key)
    for theta in (0.0, 2.0, 2.5):
        with pytest.raises(ValueError, match=r"theta in \(0, 2\)"):
            run(port.cfg.replace(noise_sampler="ou", noise_param=theta))
    with pytest.raises(NotImplementedError, match="colored"):
        run(port.cfg.replace(noise_sampler="colored"))
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        run(field=object())
    with pytest.raises(NotImplementedError, match="obstacle"):
        run(cp=CostParams(obstacles=np.zeros((1, 3))))
    for key in (KEY.to(torch.int32), torch.zeros(3, dtype=torch.int64)):
        with pytest.raises(ValueError, match="key"):
            run(key=key)
    assert rk.stream_theta(port.cfg.replace(noise_sampler="ou",
                                            noise_param=1.0)) is None


def test_wrappers_dispatch_by_device_and_count_only_kernel_launches():
    port, params, cm, *_ = _capacity_pair("ou")
    state, U = _inputs()
    before = dict(rk.LAUNCHES)
    port.solve(params, CostParams(), cm, STATE, port.init_state())
    assert dict(rk.LAUNCHES) == before   # CPU: plain
    meta = U.to("meta")
    with pytest.raises(ValueError, match="no rollout kernel"):
        rk.fused_rng_costs(port.model, params, port.cfg, CostParams(), cm,
                           state, meta, KEY.to("meta"))
    _, _, ctx = rk.fused_rng_costs(port.model, params, port.cfg,
                                   CostParams(), cm, state, U, KEY)
    with pytest.raises(ValueError, match="no rollout kernel"):
        rk.fused_rng_numer(ctx, torch.ones(K, device="meta"))


def test_pass2_launch_refuses_a_weight_vector_of_another_length():
    port, params, cm, *_ = _capacity_pair("gaussian")
    state, U = _inputs()
    _, _, ctx = rk.fused_rng_costs(port.model, params, port.cfg,
                                   CostParams(), cm, state, U, KEY)
    with pytest.raises(ValueError, match=r"w must be \(256,\)"):
        rk.prepare_fused_rng_numer(ctx, torch.ones(K + 1))
