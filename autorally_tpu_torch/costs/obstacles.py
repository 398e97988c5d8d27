"""Circular obstacle costs (port of ``autorally_tpu/costs/obstacles.py``).

The reference declares obstacle support but never implemented it
(``costs.cu:296-299``).  As in the JAX package, obstacles are a
fixed-capacity array of circles (x, y, radius), unused slots with radius
-1, and :class:`ObstacleCost` adds, per rollout step, a penalty that ramps
up inside an inflation band around each circle and a crash latch on
penetration, composed into ``track_cost_c`` so that every path picks it
up.  The fused CUDA kernels evaluate the same terms in the kernel
(``ops/rollout_kernel.py``, ``csrc/rollout_kernels.cu``).
"""

from __future__ import annotations

from typing import Tuple

import torch

from autorally_tpu_torch.config import CostParams, resolve_device
from autorally_tpu_torch.costs.mppi_cost import MPPICost


def make_obstacles(circles, capacity: int = 16, device=None) -> torch.Tensor:
    """(N, 3) [x, y, radius] -> (capacity, 3) float32 on ``device`` (``cuda``
    unless given); unused slots get radius -1 (inactive)."""
    circles = torch.as_tensor(circles, dtype=torch.float32).reshape(-1, 3)
    if len(circles) > capacity:
        raise ValueError(f"{len(circles)} obstacles > capacity {capacity}")
    out = torch.full((capacity, 3), -1.0, dtype=torch.float32,
                     device=resolve_device(device))
    out[:len(circles)] = circles
    return out


def obstacle_terms(obstacles, obstacle_coeff: float, inflation: float, x,
                   y, crash) -> Tuple[torch.Tensor, torch.Tensor]:
    """Penalty and crash latch against all circles ``obstacles`` (N, 3):
    the cost ramps linearly from 0 at radius + ``inflation`` to
    ``obstacle_coeff`` at the radius; penetration latches ``crash``.  A NaN
    position gives a NaN cost wherever a circle is active."""
    obstacles = torch.as_tensor(obstacles, dtype=torch.float32,
                                device=x.device)
    ox, oy, orad = obstacles[:, 0], obstacles[:, 1], obstacles[:, 2]
    active = orad > 0
    d = torch.sqrt((x[..., None] - ox) ** 2 + (y[..., None] - oy) ** 2)
    margin = d - orad
    band = torch.clamp(1.0 - margin / inflation, 0.0, 1.0)
    band = torch.where(active, band, torch.zeros_like(band))
    cost = obstacle_coeff * torch.amax(band, dim=-1)
    hit = torch.any(active & (margin <= 0.0), dim=-1)
    return cost, torch.where(hit, torch.ones_like(crash), crash)


class ObstacleCost(MPPICost):
    """MPPICost + circular obstacles.

    ``obstacles``: (N, 3) padded array (see :func:`make_obstacles`);
    ``CostParams.obstacles``, when set, overrides it on every solve (the
    live-update path: a new array each tick, nothing rebuilt).
    ``obstacle_coeff``: penalty scale inside the inflation band;
    ``inflation``: band width (m) beyond the radius where the cost ramps.
    """

    def __init__(self, obstacles, obstacle_coeff: float = 100.0,
                 inflation: float = 1.0, l1_cost: bool = False):
        super().__init__(l1_cost)
        self.obstacles = torch.as_tensor(obstacles, dtype=torch.float32)
        self.obstacle_coeff = float(obstacle_coeff)
        self.inflation = float(inflation)

    def with_obstacles(self, circles, capacity: int = None) -> "ObstacleCost":
        cap = capacity or self.obstacles.shape[0]
        return ObstacleCost(make_obstacles(circles, cap,
                                           device=self.obstacles.device),
                            self.obstacle_coeff, self.inflation, self.l1_cost)

    def circles(self, p: CostParams) -> torch.Tensor:
        """The circles to price: the live ``p.obstacles`` when set, else the
        construction-time array (the JAX solver's ``_obstacle_kwargs``)."""
        return self.obstacles if p.obstacles is None else p.obstacles

    def kernel_kwargs(self, p: CostParams) -> dict:
        """The obstacle arguments of the fused kernels' wrappers."""
        return {"obstacles": self.circles(p),
                "obstacle_coeff": self.obstacle_coeff,
                "inflation": self.inflation}

    def obstacle_cost_c(self, p: CostParams, x, y,
                        crash) -> Tuple[torch.Tensor, torch.Tensor]:
        """:func:`obstacle_terms` of :meth:`circles`."""
        return obstacle_terms(self.circles(p), self.obstacle_coeff,
                              self.inflation, x, y, crash)

    def track_cost_c(self, p: CostParams, costmap, x, y, yaw, crash):
        """Track term + obstacle term at the car's centre."""
        track, crash = super().track_cost_c(p, costmap, x, y, yaw, crash)
        obst, crash = self.obstacle_cost_c(p, x, y, crash)
        return track + obst, crash
