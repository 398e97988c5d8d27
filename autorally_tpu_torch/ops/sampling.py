"""Exploration noise for MPPI (port of ``autorally_tpu/ops/sampling.py``).

Only the reference protocol, i.i.d. Gaussian draws (cuRAND,
``mppi_controller.cu:612``), is ported; the colored and OU samplers are
still to port (ROADMAP.md, Queue 1 item 4).  A ``torch.Generator`` on the
solve's device replaces the JAX PRNG key; the two give different numbers
from the same seed, so parity tests inject the same noise on both sides.
"""

from __future__ import annotations

from typing import Tuple

import torch


def gaussian_noise(generator: torch.Generator,
                   shape: Tuple[int, int, int]) -> torch.Tensor:
    """White Gaussian N(0,1) draws (T, K, C) on the generator's device."""
    return torch.randn(shape, generator=generator, dtype=torch.float32,
                       device=generator.device)


def make_sampler(kind: str = "gaussian", param: float = 1.0):
    """Return a ``(generator, shape) -> (T, K, C)`` noise function."""
    if kind in ("colored", "ou"):
        raise NotImplementedError(
            f"the {kind!r} sampler is not ported yet (ROADMAP.md, Queue 1 "
            "item 4: colored and OU noise)")
    if kind != "gaussian":
        raise ValueError(f"unknown sampler {kind!r}; options "
                         "['gaussian', 'colored', 'ou']")
    return gaussian_noise
