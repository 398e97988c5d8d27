"""BF exact pass 1's redesign (csrc ``fused_rng_bf_kernel``), on the CPU.

Its derivative (``BfConstDivDeriv``) takes the basis functions' quotients
by constants as ``div_const``: q = RN(x r) with r = RN(1/d), e = fma(-q,
d, x), then fma(e, r, q), keeping q where e is 0 or NaN, and falls back to
BfDeriv's IEEE divisions for a step with a factor under ``kBfFactorFloor``.
Here ``div_const`` is emulated in integer arithmetic (each float32 value an
integer multiple of 2^-149, each operation rounded once, to nearest, ties
to even) and held against numpy's float32 division on special values,
every binade's ends and a seeded sample: it may differ only under the
guard's ``kQuotientFloor``, and with the guard it never does.  The new
derivative, emulated so, gives the port's plain basis functions bit for
bit over states with u_x <= 0.1, tan's pole, cubes that overflow, -0, NaN
and factors under the floor.  Its stream a step ahead
(``StreamNoiseAhead``) is emulated in its order and equals the plain
stream, gaussian and OU.  The card checks ``div_const`` on all 2^32 inputs
(``chip_smoke.py`` phase 19)."""

import math
import re
from fractions import Fraction
from pathlib import Path

import numpy as np
import pytest
import torch

from autorally_tpu_torch.models.basis_function import car_basis_functions
from autorally_tpu_torch.ops import kernel_rng as kr
from autorally_tpu_torch.ops.sampling import ou_coefficients
from tests.test_torch_bf_groups import (TORCH_TRIG, _fma_chain, _same_bits,
                                        _shared, _states, _theta)

F = np.float32
SOURCE = (Path(__file__).resolve().parents[1] / "autorally_tpu_torch" / "csrc"
          / "rollout_kernels.cu").read_text()
RECIPS = {int(d): F(float.fromhex(r)) for d, r in re.findall(
    r"ARTT_RECIP\((\d+), (0x[0-9a-f.]+p[-+]?\d+)f\)", SOURCE)}
DIVISORS = [int(d) for d in re.search(
    r"#define ARTT_CONST_DIVISORS \\\n(.*?)\n\n", SOURCE,
    re.S).group(1).replace("\\", "").replace(",", " ").split()]


def _source_float(name):
    return float.fromhex(re.search(
        rf"constexpr float {name} = (0x[0-9a-f.]+p[-+]?\d+)f;",
        SOURCE).group(1))


FLOOR = _source_float("kQuotientFloor")
FACTOR_FLOOR = _source_float("kBfFactorFloor")
SCALE = 149                   # every float32 is an integer times 2^-149


def _units(x) -> int:
    """The finite float32 ``x`` as an integer multiple of 2^-149."""
    n, d = float(x).as_integer_ratio()
    return n * (2 ** SCALE // d)


def _round(v: int, scale: int) -> F:
    """v 2^-scale rounded once to float32, to nearest, ties to even (a 0
    is +0; the callers handle the sign of a zero)."""
    if v == 0:
        return F(0.0)
    a = abs(v)
    ulp = max(a.bit_length() - 1 - scale, -126) - 23     # ulp's exponent
    shift = ulp + scale
    if shift > 0:
        q, rem = divmod(a, 1 << shift)
        half = 1 << (shift - 1)
        if rem > half or (rem == half and q & 1):
            q += 1
    else:
        q, ulp = a, -scale
    with np.errstate(over="ignore"):
        out = F(math.ldexp(q, ulp)) if ulp < 200 else F(np.inf)
    return -out if v < 0 else out


def _rn32(v: Fraction) -> F:
    """A rational rounded once to float32 (to nearest, ties to even)."""
    num, den = v.numerator, v.denominator
    scale = 300
    q, rem = divmod(abs(num) << scale, den)
    # the remainder's share only breaks a tie at the last kept bit
    q = 2 * q + (1 if rem else 0)
    return _round(q if num > 0 else -q, scale + 1)


def div_const(x, d: int) -> F:
    """csrc ``div_const<d>(x)``: three operations, each rounded once."""
    x, r = F(x), RECIPS[d]
    if not np.isfinite(x):
        with np.errstate(invalid="ignore"):
            return F(x * r)           # e is NaN: q = x r is kept
    X, R = _units(x), _units(r)
    q = _round(X * R, 2 * SCALE)
    if q == 0:
        return F(np.copysign(0.0, x))  # q = +-0, e = +0: q is kept
    Q = _units(q)
    E = X - Q * d                     # fma(-q, d, x) in units of 2^-149
    if E == 0:
        return q
    e = _round(E, SCALE)
    return _round(_units(e) * R + Q * 2 ** SCALE, 2 * SCALE)


def div_guarded(x, d: int) -> F:
    """``div_const`` with its guard: IEEE division under kQuotientFloor."""
    x = F(x)
    if abs(x) < FLOOR:
        return F(x / F(d))
    return div_const(x, d)


def _special_inputs(seed: int) -> np.ndarray:
    """+-0, +-inf, NaN, the largest finite float, every power of two, both
    ends of every binade (subnormal and normal), the smallest normal and
    subnormal values, and a seeded sample of bit patterns, over all of
    them and over |x| in [2^-40, 2^40], both signs."""
    rs = np.random.default_rng(seed)
    ends = []
    for e in range(-149, 128):
        lo = F(2.0 ** e)
        ends += [lo, np.nextafter(F(2.0 ** (e + 1)) if e < 127
                                  else F(np.inf), F(0))]
    vals = np.array([0.0, np.inf, np.nan, np.finfo(F).max,
                     np.finfo(F).tiny, np.finfo(F).smallest_subnormal]
                    + ends, F)
    bits = rs.integers(0, 2 ** 32, 600, dtype=np.uint64).astype(np.uint32)
    mid = (rs.uniform(-40, 40, 600).astype(np.float64))
    sample = np.concatenate([bits.view(F), (2.0 ** mid).astype(F)])
    vals = np.concatenate([vals, sample])
    return np.concatenate([vals, -vals])


def test_reciprocals_are_rounded_once_and_every_divisor_has_one():
    """Each r of the source's table is 1/d rounded once to float32, d is
    exact in float32, and the table, the divisors the check runs
    (ARTT_CONST_DIVISORS) and the quotients of BfConstDivDeriv are the
    same 16."""
    assert len(DIVISORS) == 16 == len(set(DIVISORS))
    assert sorted(DIVISORS) == sorted(RECIPS)
    used = {int(d) for d in re.findall(r"Q::template of<(\d+)>\(", SOURCE)}
    assert used == set(DIVISORS)
    for d in DIVISORS:
        assert float(F(d)) == d
        assert RECIPS[d] == _rn32(Fraction(1, d)), d
    assert FLOOR == 2.0 ** -94 and FACTOR_FLOOR == 2.0 ** -23


def test_exact_rounding_agrees_with_fractions():
    """The integer rounding against fractions.Fraction on products and fma
    sums of random float32 values, subnormal results and ties included."""
    rs = np.random.default_rng(3)
    a = rs.standard_normal(300).astype(F) * F(2.0) ** rs.integers(
        -70, 70, 300).astype(F)
    b = rs.standard_normal(300).astype(F)
    for x, y in zip(a, b):
        want = _rn32(Fraction(float(x)) * Fraction(float(y)))
        got = _round(_units(x) * _units(y), 2 * SCALE)
        assert _same_bits(got, want)
        with np.errstate(all="ignore"):
            assert _same_bits(got, F(x * y))       # numpy rounds once too
    # a tie at float32's last bit: 1 + 2^-24 goes to 1, 1 + 3 2^-24 up
    assert _round(2 ** 24 + 1, 24) == F(1.0)
    assert _round(2 ** 24 + 3, 24) == F(1 + 2 ** -22)
    # subnormal: 3 2^-150 rounds to 2 2^-149 (even), 5 2^-151 to 2^-149
    assert _round(3, 150) == F(2.0 ** -148)
    assert _round(5, 151) == F(2.0 ** -149)


@pytest.mark.parametrize("d", sorted(RECIPS))
def test_div_const_equals_ieee_division_above_the_floor(d):
    """div_const(x, d) against float32 x / d on special values, binade ends
    and a seeded sample: equal bit for bit (NaN as NaN, -0 kept, +-inf
    passed through) wherever |x| >= kQuotientFloor; any mismatch lies
    under it (a subnormal quotient); with its guard, equal everywhere."""
    xs = _special_inputs(d)
    with np.errstate(all="ignore"):
        ieee = xs / F(d)
    got = np.array([div_const(x, d) for x in xs], F)
    guarded = np.array([div_guarded(x, d) for x in xs], F)
    same = np.array([_same_bits(g, w) for g, w in zip(got, ieee)])
    assert np.all(np.abs(xs[~same]) < FLOOR)
    assert all(_same_bits(g, w) for g, w in zip(guarded, ieee))
    # the special cases the kernel's select is there for
    for x in (F(0.0), F(-0.0), F(np.inf), F(-np.inf), F(np.nan)):
        assert _same_bits(div_const(x, d), x / F(d))
    assert np.signbit(div_const(F(-0.0), d))


def test_div_const_needs_its_guard_for_subnormal_quotients():
    """Under the floor the three operations can miss by a rounding where
    the quotient is subnormal (inputs found by a seeded search): the guard
    is there for a reason, and takes the IEEE quotient there."""
    for d, x in ((10, "0x1.3a178p-132"), (40, "0x1.e35a8ep-124"),
                 (1200, "0x1.2624p-132"), (64000, "0x1.ede58p-124")):
        x = F(float.fromhex(x))
        assert abs(x) < FLOOR and abs(x / F(d)) < np.finfo(F).tiny
        assert not _same_bits(div_const(x, d), x / F(d))
        assert _same_bits(div_guarded(x, d), x / F(d))


def _factors(v):
    """The factors that BfConstDivDeriv's guard tests: u_x, u_y, yaw_der,
    roll, sin u0, tf, u_y / sux, r13 (``_shared``'s values)."""
    return [v[2], v[3], v[4], v[5], v[6], v[7], v[10], v[11]]


def _const_div_phi(v, moving):
    """BfConstDivDeriv's basis functions (25, n) from ``_shared``'s values:
    its products in BfDeriv's order, its quotients by ``div_const``, and
    BfDeriv's IEEE quotients in a step whose guard fires."""
    one, u1, ux, uy, yd, roll, ss, tf, atf, tf3, q1, r13, ar13 = v
    n = len(moving)
    with np.errstate(all="ignore"):
        tiny = np.zeros(n, bool)
        for f in _factors(v):
            tiny |= (f != 0) & (np.abs(f) < F(FACTOR_FLOOR))
        dividends = {
            1: (ux, 10), 2: (ss * tf, 1200), 3: (ss * tf * atf, 1440000),
            4: (ss * tf3, 1728000000), 5: (yd * uy, 25), 6: (yd, 10),
            7: (uy, 10), 9: (q1, 40), 10: (tf, 1400),
            11: (tf * atf, 1960000), 12: (tf3, 2744000000), 13: (r13, 40),
            14: (r13 * ar13, 1600), 15: (r13 * r13 * r13, 64000),
            16: (yd * ux, 50), 19: (roll * ux, 3), 20: (roll * ux * yd, 5),
            21: (ux * ux, 100), 22: (ux * ux * ux, 1000)}
        phi = np.empty((25, n), F)
        phi[0], phi[8], phi[17], phi[18] = u1, ss, roll, roll * yd
        phi[23], phi[24] = u1 * u1, u1 * u1 * u1
        for i, (x, d) in dividends.items():
            ieee = x / F(d)
            fast = np.array([div_const(a, d) for a in x], F)
            phi[i] = np.where(tiny, ieee, fast)
        for i in (9, 13, 14, 15):
            phi[i] = np.where(moving, phi[i], F(0))
    return phi, tiny


def _pass1_states():
    """``_states()`` (u_x <= 0.1, tan's pole, NaN in each input) with more
    rows: -0 in every state input and the steer, u_x and u_y of 1e13
    (their cubes overflow to inf), and factors under kBfFactorFloor (roll
    1e-30, u_y 1e-9, a steer of 1e-12): 1024 rows."""
    st, u = _states()
    keep = np.r_[0:520, 3592:4096]
    st, u = st[keep].copy(), u[keep].copy()
    st[460:470, 3:7] = F(-0.0)
    u[460:465, 0] = F(-0.0)
    st[470:475, 4] = F(1e13)
    st[475:480, 5] = F(1e13)
    st[480:490, 3] = F(1e-30)
    st[490:500, 5] = F(1e-9)
    u[500:510, 0] = F(1e-12)
    return st, u


def test_const_div_derivative_equals_the_plain_basis_functions():
    """The new derivative's basis functions, emulated, equal the port's
    plain ``car_basis_functions`` bit for bit (so its fmaf sums equal
    BfDeriv's): the guard fires only on the rows with a tiny factor, and
    the cases reach inf, -0 and NaN."""
    st, u = _pass1_states()
    v, moving = _shared(st, u, TORCH_TRIG)
    phi, tiny = _const_div_phi(v, moving)
    plain = car_basis_functions(torch.from_numpy(st),
                                torch.from_numpy(u)).numpy().T
    assert _same_bits(phi, plain)
    theta = _theta()
    assert _same_bits(_fma_chain(theta, phi), _fma_chain(theta, plain))
    assert tiny[480:510].all() and tiny.sum() < 60
    assert np.isinf(phi[22][470:475]).all() and np.isinf(phi[15]).any()
    assert np.signbit(phi[[6, 7, 17]][:, 460:465]).all()
    assert np.isnan(phi).any() and (~moving).sum() >= 100


def test_const_div_quotients_of_extreme_factors():
    """The dividends' forms over factors that states cannot easily reach:
    a tf whose cube overflows (1e13), tf and ss of -0, NaN and inf, and
    factors at and just under kBfFactorFloor, each quotient (with the
    guard's fallback) equal to the IEEE one bit for bit."""
    vals = np.array([1e13, -1e13, -0.0, 0.0, np.nan, np.inf, -np.inf,
                     FACTOR_FLOOR, -FACTOR_FLOOR,
                     np.nextafter(F(FACTOR_FLOOR), F(0)), 0.3, -2.5, 1e-3],
                    F)
    tf, ss = (a.ravel() for a in np.meshgrid(vals, vals))
    n = tf.size
    ones = np.ones(n, F)
    with np.errstate(all="ignore"):
        v = [ones, ones, F(0.5) * ones, ss, tf, ss, ss, tf, np.abs(tf),
             tf * tf * tf, ss, tf, np.abs(tf)]
        phi, _ = _const_div_phi(v, np.ones(n, bool))
        want = {2: ss * tf / F(1200), 4: ss * (tf * tf * tf) / F(1728000000),
                12: tf * tf * tf / F(2744000000),
                11: tf * np.abs(tf) / F(1960000), 20: ss * F(0.5) * tf / F(5)}
    for i, w in want.items():
        assert _same_bits(phi[i], w), i
    assert np.isinf(phi[12]).any() and np.isnan(phi[4]).any()


@pytest.mark.parametrize("theta", [None, 0.15])
def test_stream_ahead_order_equals_the_plain_stream(theta):
    """StreamNoiseAhead's order: step 0's pair drawn before the loop; in
    step t the held pair returned (through the OU carry, each product and
    sum rounded once), and after the step's update step t + 1's pair drawn,
    the last step drawing step T - 1 again, so that nothing past T - 1 is
    drawn: the same stream as ``kernel_rng.kernel_noise``, bit for bit, at
    a k_offset."""
    T, K, k_off = 12, 70, 2 ** 31 + 5
    key = torch.tensor([0x2545F491, 0x9E3779B9], dtype=torch.int64)
    draws = []

    def draw(t):
        t = min(t, T - 1)
        draws.append(t)
        return kr.kernel_normals(key, k_off, K, t + 1)[t]

    a, b = ((0.0, 0.0) if theta is None else ou_coefficients(theta))
    w, x, out = draw(0), None, []
    for t in range(T):
        if a == 0.0:
            out.append(w)
        else:
            x = w if t == 0 else (x * F(a)) + (w * F(b))
            out.append(x)
        w = draw(t + 1)
    got = torch.stack(out)
    want = kr.kernel_noise(key, k_off, K, T, theta)
    assert draws == list(range(T)) + [T - 1]
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
