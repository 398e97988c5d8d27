"""Exploration noise for MPPI (port of ``autorally_tpu/ops/sampling.py``).

All samplers return ``(T, K, C)`` float32 draws on the generator's device:

- :func:`gaussian_noise`: white N(0, 1), the reference protocol (cuRAND,
  ``mppi_controller.cu:612``);
- :func:`colored_noise`: 1/f^beta noise along the horizon, shaped from
  white half-spectrum draws by an inverse real DFT (:func:`color_shape`);
- :func:`ou_noise`: Ornstein-Uhlenbeck (AR(1)) noise, the recursion
  :func:`ou_recursion` on white draws.  The kernel-RNG passes
  (``ops/kernel_rng.py``, ``csrc/rollout_kernels.cu``) run the same
  recursion on their in-kernel stream.

A ``torch.Generator`` on the solve's device replaces the JAX PRNG key; the
two give different numbers from the same seed, so parity tests feed both
packages the same white draws (the shaping functions take them as input).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def gaussian_noise(generator: torch.Generator,
                   shape: Tuple[int, int, int]) -> torch.Tensor:
    """White Gaussian N(0,1) draws (T, K, C) on the generator's device."""
    return torch.randn(shape, generator=generator, dtype=torch.float32,
                       device=generator.device)


def _irfft_basis(T: int, beta: float):
    """Scaled inverse-real-DFT basis matrices (numpy float32).

    Returns ``(cosM, sinM)`` of shape (T, nf) such that for a half spectrum
    ``re + i*im`` the signal ``x = cosM @ re - sinM @ im`` equals
    ``irfft((re + i*im) * scale, n=T, axis=0)`` with the 1/f^beta amplitude
    ``scale`` folded in."""
    nf = T // 2 + 1
    freqs = np.fft.rfftfreq(T, d=1.0)
    scale = np.empty(nf)
    scale[1:] = freqs[1:] ** (-beta / 2.0)
    # DC keeps the f_min scale, as white noise would
    scale[0] = freqs[1] ** (-beta / 2.0)
    # interior bins count twice (conjugate pair), DC and Nyquist once
    coef = np.full(nf, 2.0)
    coef[0] = 1.0
    if T % 2 == 0:
        coef[-1] = 1.0
    t = np.arange(T)[:, None]
    ang = 2.0 * np.pi * t * freqs[None, :]
    w = (coef * scale / T)[None, :]
    return ((np.cos(ang) * w).astype(np.float32),
            (np.sin(ang) * w).astype(np.float32))


def color_shape(re: torch.Tensor, im: torch.Tensor, shape: Tuple[int, int, int],
                beta: float) -> torch.Tensor:
    """1/f^beta shaping of white half-spectrum draws ``re``, ``im``
    (nf, K*C), nf = T // 2 + 1, into (T, K, C) noise with unit per-sample
    second moment (rms over the horizon, not a mean-removed std: the DC
    offset is part of the exploration signal)."""
    T, K, C = shape
    cosM, sinM = (torch.from_numpy(m).to(re.device)
                  for m in _irfft_basis(T, beta))
    x = (cosM @ re - sinM @ im).reshape(T, K, C)
    rms = torch.sqrt(torch.mean(x * x, dim=0, keepdim=True))
    return x / torch.clamp(rms, min=1e-8)


def colored_noise(generator: torch.Generator, shape: Tuple[int, int, int],
                  beta: float = 1.0) -> torch.Tensor:
    """1/f^beta colored noise along the horizon axis, unit variance
    (beta=0 white, 1 pink, 2 red)."""
    T, K, C = shape
    nf = T // 2 + 1
    re, im = (torch.randn((nf, K * C), generator=generator,
                          dtype=torch.float32, device=generator.device)
              for _ in range(2))
    return color_shape(re, im, shape, beta)


def ou_coefficients(theta: float) -> Tuple[float, float]:
    """The AR(1) coefficients ``(a, b)`` of OU noise with rate ``theta``:
    a = 1 - theta and b = sqrt(1 - a^2), computed in double and rounded to
    float32 (returned as Python floats that float32 holds exactly)."""
    a = 1.0 - float(theta)
    return float(np.float32(a)), float(np.float32((1.0 - a * a) ** 0.5))


def ou_recursion(w: torch.Tensor, theta: float) -> torch.Tensor:
    """OU noise from white draws ``w`` (T, ...): x_0 = w_0,
    x_t = a x_{t-1} + b w_t, each product and the sum rounded to float32
    separately (the kernels' ``__fmul_rn``/``__fadd_rn``)."""
    a, b = ou_coefficients(theta)
    x = torch.empty_like(w)
    x[0] = w[0]
    for t in range(1, w.shape[0]):
        x[t] = x[t - 1] * a + w[t] * b
    return x


def ou_noise(generator: torch.Generator, shape: Tuple[int, int, int],
             theta: float = 0.15) -> torch.Tensor:
    """Ornstein-Uhlenbeck (AR(1)) noise, stationary unit variance: every
    timestep is marginally N(0, 1) while consecutive steps correlate."""
    return ou_recursion(gaussian_noise(generator, shape), theta)


SAMPLERS = {
    "gaussian": lambda gen, shape, p: gaussian_noise(gen, shape),
    "colored": lambda gen, shape, p: colored_noise(gen, shape, p),
    "ou": lambda gen, shape, p: ou_noise(gen, shape, p),
}


def make_sampler(kind: str = "gaussian", param: float = 1.0):
    """Return a ``(generator, shape) -> (T, K, C)`` noise function."""
    if kind not in SAMPLERS:
        raise ValueError(f"unknown sampler {kind!r}; options {list(SAMPLERS)}")
    fn = SAMPLERS[kind]
    return lambda generator, shape: fn(generator, shape, param)
