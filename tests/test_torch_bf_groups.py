"""Kernel 2's BF warp form and pass 2's semantics, on the CPU.

Kernel 2 runs the BF model one rollout a warp at small K (csrc
``BfWarpDeriv``): lane i forms the basis function phi_i from the source's
table (``c_bf_ops``, ``c_bf_div``), and lanes o = 0..3 sum output o over
the 25 phi, taken by shuffle from lane i, in BfDeriv's order with its
fmaf.  A plain emulation of that split (float32, one rounding an
operation, the fmaf single-rounded) is held bit for bit against the port's
plain basis functions and against the JAX package's (each with its own
arctan, tan and sin), its outputs bit for bit against the fmaf chain over
the plain basis functions and within float32 rounding of both packages'
``phi @ theta``, over seeded states that include u_x <= 0.1, the tan pole
and NaN.

Pass 2 (csrc ``weighted_update_kernel``) is held against the JAX
package's ``fused_rng_numer`` in TPU interpret mode (gaussian and OU,
K = 256, T = 16) where the result cannot depend on the two streams (whose
bits differ): with zero exploration noise, dyadic U and weights, so that
every sum is exact in any order, with whole warps of zero weights, one
non-zero weight, and a NaN in U (NaN where JAX has it).  The stream's
normals are finite at their extremes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from autorally_tpu.config import CostParams as JaxCostParams
from autorally_tpu.models import basis_function as jbf
from autorally_tpu.ops import rollout_kernel as jrk
from autorally_tpu_torch.models.basis_function import (BasisFunctionDynamics,
                                                       car_basis_functions)
from autorally_tpu_torch.ops import kernel_rng as kr
from autorally_tpu_torch.ops import rollout_kernel as rk
from tests.test_torch_chain_geometry import _source_table
from tests.test_torch_solver import _pair

F = np.float32
N = 4096
OPS = _source_table("c_bf_ops", lambda v: int(v, 0))
DIV = _source_table("c_bf_div", lambda v: F(float(v.rstrip("f"))))


def _fma32(a, b, c):
    """float32 fmaf(a, b, c), rounded once: a b is exact in float64, the
    float64 sum's rounding error e is taken exactly (TwoSum), and where the
    float64 sum lies on a float32 midpoint, e says on which side of it the
    exact sum is."""
    a, b, c = (np.asarray(x, F).astype(np.float64) for x in (a, b, c))
    p = a * b
    s = p + c
    bb = s - p
    with np.errstate(invalid="ignore", over="ignore"):
        e = (p - (s - bb)) + (c - bb)
        r = s.astype(F)
        other = np.nextafter(r, np.where(s > r, F(np.inf), F(-np.inf)))
        mid = ((s != r) & (e != 0) & np.isfinite(s)
               & ((r.astype(np.float64) + other.astype(np.float64)) / 2
                  == s))
        side = np.where(e > 0, np.maximum(r, other), np.minimum(r, other))
    return np.where(mid, side, r).astype(F)


def _shared(states, controls, trig):
    """Each lane's values v (csrc ``kBfValues``): 1, u1, ux, uy, yd, roll,
    sin u0, tan, |tan|, tan^3, uy / sux, r13, |r13|, float32 (numpy), from
    BfDeriv's quotients and ``trig`` = (atan, tan, sin) on float32 arrays;
    and whether the car is moving."""
    atan, tan, sin = trig
    roll, ux, uy, yd = (states[:, i] for i in (3, 4, 5, 6))
    u0, u1 = controls[:, 0], controls[:, 1]
    with np.errstate(all="ignore"):
        moving = ux > F(0.1)
        sux = np.where(moving, ux, F(1))
        q1 = uy / sux
        front = atan(q1 + F(0.45) * yd / sux) - u0
        tf = tan(np.where(moving, front, -u0))
        ss = sin(u0)
        r13 = q1 - F(0.35) * yd / sux
        v = [np.ones_like(ux), u1, ux, uy, yd, roll, ss, tf, np.abs(tf),
             tf * tf * tf, q1, r13, np.abs(r13)]
    return v, moving


def _warp_phi(v, moving):
    """The 25 phi as the warp's lanes form them: lane i, phi_i, as ((v[a]
    v[b]) v[c]) / d from the table, 0 where the table gates it and the car
    is not moving: (25, n)."""
    phi = np.empty((25, len(moving)), F)
    with np.errstate(all="ignore"):
        for i in range(25):
            op = OPS[i]
            p = v[op & 15] * v[op >> 4 & 15] * v[op >> 8 & 15] / DIV[i]
            phi[i] = np.where(moving, p, F(0)) if op >> 12 else p
    return phi


def _fma_chain(theta, phi):
    """Output o = fmaf over i of theta[i, o] phi_i, in order from 0 (csrc
    BfDeriv and BfWarpDeriv's summing lanes): (n, 4)."""
    out = []
    for o in range(4):
        acc = np.zeros(phi.shape[1], F)
        for i in range(25):
            acc = _fma32(np.full_like(acc, theta[i, o]), phi[i], acc)
        out.append(acc)
    return np.stack(out, axis=1)


def _states():
    """Seeded states and controls (float32): moving and not (u_x <= 0.1,
    exactly 0.1 included), arguments of tan within 1e-3 of its pole, and
    NaN in each of roll, u_x, u_y, yaw_der and steer."""
    rs = np.random.default_rng(11)
    st = np.zeros((N, 7), F)
    st[:, 3] = rs.normal(0, 0.1, N)
    st[:, 4] = rs.uniform(-1, 12, N)
    st[:, 5] = rs.normal(0, 1.0, N)
    st[:, 6] = rs.normal(0, 1.5, N)
    u = np.stack([rs.normal(0, 0.4, N), rs.normal(0, 0.6, N)], 1).astype(F)
    st[:40, 4] = F(0.1)
    st[40:200, 4] = rs.uniform(-0.5, 0.1, 160)
    # not moving: tan(-steer) at its pole
    u[200:300, 0] = F(-np.pi / 2) + rs.uniform(-1e-3, 1e-3, 100).astype(F)
    st[200:300, 4] = F(0.05)
    # moving: atan(uy / ux + ...) - steer at the pole
    st[300:400, 5:7] = 0.0
    u[300:400, 0] = F(-np.pi / 2) + rs.uniform(-1e-3, 1e-3, 100).astype(F)
    for j, col in enumerate((3, 4, 5, 6)):
        st[400 + 10 * j:410 + 10 * j, col] = np.nan
    u[450:460, 0] = np.nan
    return st, u


def _theta():
    return (0.3 * np.random.default_rng(5).standard_normal((25, 4))).astype(F)


def _same_bits(a, b) -> bool:
    """Equal bit for bit, every NaN equal to every NaN."""
    a, b = np.asarray(a, F), np.asarray(b, F)
    both_nan = np.isnan(a) & np.isnan(b)
    return bool(np.all(both_nan | (a.view(np.int32) == b.view(np.int32))))


# two sums of 25 float32 products in other orders: each within 25 2^-24 of
# sum |theta phi|
RTOL_SUM = 2 * 25 * 2.0 ** -24
TORCH_TRIG = tuple(lambda x, f=f: f(torch.from_numpy(np.asarray(x, F)))
                   .numpy() for f in (torch.atan, torch.tan, torch.sin))
JAX_TRIG = tuple(lambda x, f=f: np.asarray(f(jnp.asarray(x, jnp.float32)))
                 for f in (jnp.arctan, jnp.tan, jnp.sin))


def test_bf_warp_emulation_equals_the_plain_derivative():
    """The warp's basis functions, as the summing lanes gather them, equal
    the port's ``car_basis_functions`` bit for bit; its outputs equal
    the fmaf chain over those basis functions bit for bit (BfDeriv's order)
    and the port's ``phi @ theta`` within float32 rounding of sum |theta
    phi|; NaN exactly where the plain derivative has it."""
    st, u = _states()
    theta = _theta()
    v, moving = _shared(st, u, TORCH_TRIG)
    phi = _warp_phi(v, moving)
    plain_phi = car_basis_functions(torch.from_numpy(st),
                                    torch.from_numpy(u)).numpy().T
    assert _same_bits(phi, plain_phi)
    out = _fma_chain(theta, phi)
    assert _same_bits(out, _fma_chain(theta, plain_phi))
    model = BasisFunctionDynamics(0.02, device="cpu")
    params = model.params_from_jax({"theta": theta,
                                    "control_rngs": np.array(
                                        [[-0.99, 0.99], [-0.99, 0.65]], F)})
    with torch.no_grad():
        ref = model.dynamics(params, torch.from_numpy(st),
                             torch.from_numpy(u)).numpy()
    np.testing.assert_array_equal(np.isnan(out), np.isnan(ref))
    fin = np.isfinite(ref)
    scale = np.abs(plain_phi.T.astype(np.float64)) @ np.abs(theta)
    assert np.all(np.abs(out[fin] - ref[fin]) <= RTOL_SUM * scale[fin])
    # the states reach the cases they are there for
    assert (~moving).sum() >= 200 and np.isnan(out).any()
    assert np.abs(v[7][200:400]).max() > 500          # near tan's pole


def test_bf_warp_emulation_equals_the_jax_derivative():
    """The same split with the JAX package's arctan, tan and sin: its basis
    functions equal the JAX ``car_basis_functions`` bit for bit, its
    outputs the JAX ``BasisFunctionDynamics`` (``phi @ theta`` at HIGHEST
    precision) within float32 rounding of sum |theta phi|."""
    st, u = _states()
    theta = _theta()
    v, moving = _shared(st, u, JAX_TRIG)
    phi = _warp_phi(v, moving)
    jphi = np.asarray(jbf.car_basis_functions(jnp.asarray(st),
                                              jnp.asarray(u))).T
    assert _same_bits(phi, jphi)
    out = _fma_chain(theta, phi)
    jmodel = jbf.BasisFunctionDynamics(0.02)
    ref = np.asarray(jmodel.dynamics({"theta": jnp.asarray(theta)},
                                     jnp.asarray(st), jnp.asarray(u)))
    np.testing.assert_array_equal(np.isnan(out), np.isnan(ref))
    fin = np.isfinite(ref)
    scale = np.abs(jphi.T.astype(np.float64)) @ np.abs(theta)
    assert np.all(np.abs(out[fin] - ref[fin]) <= RTOL_SUM * scale[fin])


def test_fma32_rounds_once():
    """The emulated fmaf against exact rational arithmetic on random
    operands, and where float64 rounds the sum onto a float32 midpoint
    (a b = 1 + 2^-11 + 2^-24, c = +-2^-80): once rounded, up for +, down
    for -; twice rounded, down for both."""
    from fractions import Fraction

    def exact(x, y, z):
        v = Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z))
        lo = F(float(v))
        hi = np.nextafter(lo, F(np.inf) if Fraction(float(lo)) < v
                          else F(-np.inf))
        d_lo, d_hi = abs(Fraction(float(lo)) - v), abs(Fraction(float(hi))
                                                       - v)
        if d_lo != d_hi:
            return lo if d_lo < d_hi else hi
        return lo if int(np.array(lo).view(np.int32)) % 2 == 0 else hi

    rs = np.random.default_rng(2)
    a, b, c = (rs.normal(0, 1, 500).astype(F) for _ in range(3))
    c[:100] = -(a[:100].astype(np.float64) * b[:100]).astype(F)
    got = _fma32(a, b, c)
    assert all(g == exact(x, y, z) for x, y, z, g in zip(a, b, c, got))
    x = F(1 + 2 ** -12)
    for z, up in ((F(2 ** -80), True), (F(-2 ** -80), False)):
        want = F(1 + 2 ** -11 + 2 ** -23) if up else F(1 + 2 ** -11)
        assert _fma32(x, x, z) == want == exact(x, x, z)
        assert F(float(x) * float(x) + float(z)) == F(1 + 2 ** -11)


# -- pass 2 ---------------------------------------------------------------------

KP, TP = 256, 16
SAMPLERS = {"gaussian": {}, "ou": dict(noise_sampler="ou", noise_param=0.15)}


def _pass2_contexts(sampler, U):
    """The port's and the JAX package's pass-2 contexts for K = 256, T = 16,
    zero exploration noise, nominal controls ``U`` (T, 2)."""
    kw = dict(SAMPLERS[sampler], steering_std=0.0, throttle_std=0.0)
    solver, params, cm, jsolver, jparams, jcm = _pair(K=KP, T=TP, **kw)
    cfg = solver.cfg.replace(kernel_rng=True)
    key = torch.tensor([0x2545F491, 0x9E3779B9])
    ctx = rk.RngContext(solver.model, cfg, torch.from_numpy(U), key, 0, KP,
                        rk.stream_theta(cfg))
    jcfg = jsolver.cfg.replace(kernel_rng=True)
    rngs = jnp.reshape(jparams["control_rngs"], (-1, 2))[-2:]
    nu = jnp.asarray(jcfg.exploration_std, dtype=jnp.float32)
    sc = jrk._pack_scalars(jcfg, rngs, nu, jnp.float32(0.0),
                           jnp.zeros(7, jnp.float32), jcm, JaxCostParams())
    seed = jnp.stack([jnp.int32(7), jnp.int32(7)])
    ou_a = 0.0 if sampler == "gaussian" else 1.0 - 0.15
    jctx = (TP, KP, ou_a, pltpu.InterpretParams(), sc, seed, jnp.asarray(U))
    return ctx, jctx


def _dyadic_U():
    U = np.random.default_rng(4).integers(-16, 17, (TP, 2)).astype(F) / 8
    return U


@pytest.mark.parametrize("sampler", list(SAMPLERS))
def test_pass2_semantics_match_jax_interpret_mode(sampler):
    """With zero exploration noise every control is U (pure-noise rollouts:
    0), whatever the stream, and with dyadic U and weights every sum is
    exact: the port's pass 2 equals the JAX ``fused_rng_numer`` (TPU
    interpret mode) exactly with (i) whole warps of zero weights, (ii) one
    non-zero weight, and (iii) a NaN in U, where both are NaN at that entry
    and only there."""
    U = _dyadic_U()
    ctx, jctx = _pass2_contexts(sampler, U)
    rs = np.random.default_rng(9)
    w = rs.choice(np.array([0.5, 1.0, 2.0], F), KP)
    w[32:96] = 0.0                       # two whole warps
    w[160:192] = 0.0
    one = np.zeros(KP, F)
    one[77] = 2.0
    for weights in (w, one):
        got = rk.fused_rng_numer(ctx, torch.from_numpy(weights)).numpy()
        want = np.asarray(jrk.fused_rng_numer(jctx, jnp.asarray(weights)))
        np.testing.assert_array_equal(got, want)
    U_nan = U.copy()
    U_nan[5, 1] = np.nan
    ctx_nan = ctx._replace(U=torch.from_numpy(U_nan))
    jctx_nan = jctx[:6] + (jnp.asarray(U_nan),)
    got = rk.fused_rng_numer(ctx_nan, torch.from_numpy(w)).numpy()
    want = np.asarray(jrk.fused_rng_numer(jctx_nan, jnp.asarray(w)))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got[1, 5]) and np.isnan(got).sum() == 1
    np.testing.assert_array_equal(got[~np.isnan(got)], want[~np.isnan(want)])


def test_stream_is_finite_at_its_extremes():
    """The stream's normals are finite and below 6 in size at the extreme
    uniforms (u1 from 1e-7 to 1, which
    rounds to 1.0 in float32, and every quadrant of the angle), and an OU
    recursion grows by at most 6 a step."""
    r0 = torch.tensor([0, 1, 2 ** 31, 0xFFFFFE00, 0xFFFFFFFF] * 4,
                      dtype=torch.int64)
    r1 = torch.tensor([0] * 5 + [0x3FFFFFFF] * 5 + [0x80000000] * 5
                      + [0xFFFFFFFF] * 5, dtype=torch.int64)
    z = kr.normals_from_bits(r0, r1)
    assert torch.isfinite(z).all() and z.abs().max() < 6
    u1 = (r0 >> 9).to(torch.float32) * kr.CONSTANTS["kTwoM23"] \
        + kr.CONSTANTS["kU1Guard"]
    assert float(u1.max()) == 1.0 and float(kr.stream_log(u1).max()) <= 0
    x = kr.kernel_noise(torch.tensor([3, 4]), 0, 64, 256, theta=1e-6)
    assert torch.isfinite(x).all()
    assert bool((x.abs().amax(dim=1) <= 6 * torch.arange(1, 257)[:, None])
                .all())
