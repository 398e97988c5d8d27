"""Costmap container, ``.npz`` loader and world->map transform (port of
``autorally_tpu/costs/costmap.py``).

The reference samples a CUDA texture with point filtering, clamp
addressing and normalized coordinates (``costs.cu:143-149``).  Here the
4-channel map is an ``(H, W, 4)`` tensor and the lookup is an integer gather
at ``floor(coord * size)``, clamped, with NaN coordinates routed to texel 0.
``ch0`` keeps channel 0 as its own contiguous ``(H, W)`` plane, which the
CUDA rollout kernel reads directly.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from autorally_tpu_torch.config import resolve_device


@dataclasses.dataclass(frozen=True)
class Costmap:
    """4-channel track costmap + projective world->map transform.

    ``data``: (H, W, 4) float32; ``ch0``: contiguous (H, W) channel 0.
    ``r_c1``, ``r_c2``, ``trs``: (3,) columns of the projective transform
    (``costs.cuh:80-85``); ``transform``: the same nine float32 values on
    the host, ``r_c1 + r_c2 + trs``, for the CUDA kernel's launch scalars.
    """

    data: torch.Tensor
    ch0: torch.Tensor
    r_c1: torch.Tensor
    r_c2: torch.Tensor
    trs: torch.Tensor
    transform: Tuple[float, ...]

    @property
    def height(self) -> int:
        return self.data.shape[0]

    @property
    def width(self) -> int:
        return self.data.shape[1]

    @classmethod
    def build(cls, data, r_c1, r_c2, trs, device=None) -> "Costmap":
        """Construct from (H, W, 4) data and the transform columns."""
        dev = resolve_device(device)
        data = torch.as_tensor(np.asarray(data, dtype=np.float32), device=dev)
        cols = [np.asarray(c, dtype=np.float32) for c in (r_c1, r_c2, trs)]
        return cls(data, data[..., 0].contiguous(),
                   *(torch.as_tensor(c, device=dev) for c in cols),
                   tuple(float(v) for c in cols for v in c))

    def world_to_norm(self, x: torch.Tensor, y: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Projective transform of world (x, y) to normalized map coords
        (``coorTransform``, ``costs.cu:351-357``)."""
        u = self.r_c1[0] * x + self.r_c2[0] * y + self.trs[0]
        v = self.r_c1[1] * x + self.r_c2[1] * y + self.trs[1]
        w = self.r_c1[2] * x + self.r_c2[2] * y + self.trs[2]
        return u / w, v / w

    def texel_indices(self, x: torch.Tensor, y: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Clamped texel (row, column) indices of world (x, y): floor, NaN
        -> 0, clamp to the map."""
        u, v = self.world_to_norm(x, y)
        ix = torch.clamp(torch.nan_to_num(torch.floor(u * self.width)),
                         0, self.width - 1).long()
        iy = torch.clamp(torch.nan_to_num(torch.floor(v * self.height)),
                         0, self.height - 1).long()
        return iy, ix

    def lookup(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """Point-sample all 4 channels at world (x, y): (...,) -> (..., 4)."""
        iy, ix = self.texel_indices(x, y)
        return self.data[iy, ix]

    def lookup_ch0(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """Point-sample channel 0 at world (x, y): (...,) -> (...,)."""
        iy, ix = self.texel_indices(x, y)
        return self.ch0[iy, ix]


def _bounds_transform(x_min, x_max, y_min, y_max):
    r_c1 = np.array([1.0 / (x_max - x_min), 0.0, 0.0], dtype=np.float32)
    r_c2 = np.array([0.0, 1.0 / (y_max - y_min), 0.0], dtype=np.float32)
    trs = np.array([-x_min / (x_max - x_min), -y_min / (y_max - y_min), 1.0],
                   dtype=np.float32)
    return r_c1, r_c2, trs


def load_costmap(path: str, device=None) -> Costmap:
    """Load the reference ``.npz`` costmap format (``costs.cu:190-232``)."""
    d = np.load(path)
    x_min, x_max = (float(v) for v in np.ravel(d["xBounds"])[:2])
    y_min, y_max = (float(v) for v in np.ravel(d["yBounds"])[:2])
    ppm = float(np.ravel(d["pixelsPerMeter"])[0])
    width = int((x_max - x_min) * ppm)
    height = int((y_max - y_min) * ppm)
    channels = [np.asarray(d[f"channel{i}"], dtype=np.float32)
                .reshape(height, width) for i in range(4)]
    return Costmap.build(np.stack(channels, axis=-1),
                         *_bounds_transform(x_min, x_max, y_min, y_max),
                         device=device)


def make_costmap(data: np.ndarray, x_bounds, y_bounds, device=None) -> Costmap:
    """Build a Costmap from a (H, W, 4) array and world bounds."""
    return Costmap.build(data, *_bounds_transform(
        float(x_bounds[0]), float(x_bounds[1]),
        float(y_bounds[0]), float(y_bounds[1])), device=device)
