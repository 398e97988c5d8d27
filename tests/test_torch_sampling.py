"""The port's noise samplers against the JAX package's on the CPU: the OU
recursion and the 1/f^beta shaping fed the same white draws as the JAX
functions draw, the inverse-DFT basis, and the sampler factory."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autorally_tpu.ops import sampling as jsampling
from autorally_tpu_torch.ops import sampling

SHAPE = (32, 512, 2)
# float32 recursions over 32 steps (OU: b may differ by one ulp from the
# JAX package's float32 sqrt; colored: a (T, nf) matmul summed in another
# order): both agree to a few ulp of unit-variance values.
ATOL = 1e-5


@pytest.mark.parametrize("theta", [0.15, 0.5, 1.0, 1.9])
def test_ou_matches_jax_on_the_same_white_draws(theta):
    key = jax.random.PRNGKey(3)
    w = np.asarray(jax.random.normal(key, SHAPE, dtype=jnp.float32))
    ref = np.asarray(jsampling.ou_noise(key, SHAPE, theta))
    got = sampling.ou_recursion(torch.tensor(w), theta).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)
    np.testing.assert_array_equal(got[0], w[0])


def test_ou_coefficients_are_float32_and_stationary():
    a, b = sampling.ou_coefficients(0.15)
    assert a == float(np.float32(0.85))
    assert b == float(np.float32((1.0 - 0.85 * 0.85) ** 0.5))
    assert abs(a * a + b * b - 1.0) < 1e-6
    assert sampling.ou_coefficients(1.0) == (0.0, 1.0)


@pytest.mark.parametrize("T,beta", [(32, 1.0), (31, 2.0), (16, 0.0)])
def test_colored_matches_jax_on_the_same_white_draws(T, beta):
    shape = (T, 256, 2)
    key = jax.random.PRNGKey(4)
    nf = T // 2 + 1
    key_r, key_i = jax.random.split(key)
    re = np.asarray(jax.random.normal(key_r, (nf, 512), dtype=jnp.float32))
    im = np.asarray(jax.random.normal(key_i, (nf, 512), dtype=jnp.float32))
    ref = np.asarray(jsampling.colored_noise(key, shape, beta))
    got = sampling.color_shape(torch.tensor(re), torch.tensor(im), shape,
                               beta).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)
    np.testing.assert_allclose((got * got).mean(axis=0), 1.0, atol=1e-5)


@pytest.mark.parametrize("T,beta", [(100, 1.0), (7, 0.5)])
def test_irfft_basis_equals_jax(T, beta):
    for got, ref in zip(sampling._irfft_basis(T, beta),
                        jsampling._irfft_basis(T, beta)):
        np.testing.assert_array_equal(got, ref)


def test_make_sampler_kinds():
    gen = torch.Generator()
    for kind, param in (("gaussian", 1.0), ("colored", 1.0), ("ou", 0.3)):
        gen.manual_seed(0)
        fn = sampling.make_sampler(kind, param)
        x = fn(gen, SHAPE)
        assert x.shape == SHAPE and x.dtype == torch.float32
        assert torch.isfinite(x).all()
        assert abs(float(x.var()) - 1.0) < 0.1
        gen.manual_seed(0)
        assert torch.equal(fn(gen, SHAPE), x)               # seeded
    with pytest.raises(ValueError, match="unknown sampler"):
        sampling.make_sampler("pink")


def test_host_ou_noise_has_the_ar1_signature():
    """lag-1 autocorrelation within 0.01 of 1 - theta (about 7 standard
    errors of the estimate over 4096 x 2 series of 32 steps)."""
    gen = torch.Generator()
    gen.manual_seed(1)
    x = sampling.ou_noise(gen, (32, 4096, 2), 0.3).numpy()
    rho = (x[1:] * x[:-1]).mean() / (x * x).mean()
    assert abs(rho - 0.7) < 0.01
