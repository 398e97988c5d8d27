"""Costmap debug view — the live cost window around the car (port of
``autorally_tpu/costs/debug_view.py``).

Port of ``debugCostKernel`` (``debug_kernels.cuh:39-88``) / the host wrapper
``MPPICosts::getDebugDisplay`` (``costs.cu:271-284``): renders a
(width_m x height_m) window of the track cost centered on the car, with a
heading arrow drawn in vehicle frame (outlined wedge pointing forward).
One vectorized evaluation on the surface's device, in plain tensor ops
(the JAX function is plain ``jnp`` under ``jit``, not a kernel); works with
both the exact :class:`Costmap` and the :class:`NeuralCostmap` field.

Returns a (height_m*ppm, width_m*ppm) float32 image, row 0 at the top
(y decreasing downward), matching the reference's OpenCV display layout.
"""

from __future__ import annotations

import numpy as np
import torch


def debug_cost_view(costmap, x: float, y: float, heading: float,
                    width_m: int = 10, height_m: int = 10,
                    ppm: int = 50) -> torch.Tensor:
    """Render the cost window (getDebugDisplay default 10x10 m @ 50 ppm)
    on the surface's device."""
    dev = costmap.ch0.device if hasattr(costmap, "ch0") else costmap.device
    f32 = dict(dtype=torch.float32, device=dev)
    W = width_m * ppm
    H = height_m * ppm
    YY, XX = torch.meshgrid(torch.arange(H, **f32), torch.arange(W, **f32),
                            indexing="ij")
    x, y, heading = (torch.tensor(v, **f32) for v in (x, y, heading))
    # pixel -> world (debug_kernels.cuh:46-52); a product by 1/ppm rounded
    # to float32, as XLA folds the JAX function's division by the constant
    inv = float(np.float32(1.0 / ppm))
    x_pos = XX * inv - width_m / 2.0 + x
    y_pos = YY * inv - height_m / 2.0 + y

    cost = costmap.lookup_ch0(x_pos, y_pos)

    # heading arrow in vehicle frame (debug_kernels.cuh:62-71)
    ch = torch.cos(heading)
    sh = torch.sin(heading)
    x_t = ch * (x_pos - x) + sh * (y_pos - y)
    y_t = -sh * (x_pos - x) + ch * (y_pos - y)
    dist = 0.25 * torch.abs(x_t) + torch.abs(y_t)
    in_wedge = (dist < 0.15) & (x_t > 0)
    inner = (dist < 0.1) & (x_t > 0.05)
    cost = torch.where(in_wedge, inner.to(torch.float32), cost)

    # flip vertically: row 0 = max y (debug_kernels.cuh:73)
    return torch.flip(cost, dims=(0,))
