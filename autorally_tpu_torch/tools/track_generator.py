"""Procedural track costmaps (the port's own copy of ``oval_track`` from
``autorally_tpu/tools/track_generator.py``; its arrays are identical).

channel0 is 0 on the track centerline, 1 at the track edge and grows
beyond 1 off-track — the convention the cost's ``boundary_threshold`` crash
check expects (``costs.cu:389-391``, ``params/maps/README.md``).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def oval_track(half_length: float = 25.0, half_width: float = 15.0,
               track_width: float = 5.0, ppm: float = 10.0,
               margin: float = 10.0) -> Tuple[np.ndarray, tuple, tuple]:
    """Procedural oval (ellipse) track: ``(data (H, W, 4), x_bounds,
    y_bounds)``; channel0 is the normalized distance from the centerline."""
    x_min, x_max = -half_length - margin, half_length + margin
    y_min, y_max = -half_width - margin, half_width + margin
    W = int((x_max - x_min) * ppm)
    H = int((y_max - y_min) * ppm)
    xs = x_min + (np.arange(W) + 0.5) / ppm
    ys = y_min + (np.arange(H) + 0.5) / ppm
    X, Y = np.meshgrid(xs, ys)

    # Distance to the ellipse centerline, approximated via the radial
    # parameterization (exact enough for a cost surface).
    theta = np.arctan2(Y / half_width, X / half_length)
    cx = half_length * np.cos(theta)
    cy = half_width * np.sin(theta)
    dist = np.hypot(X - cx, Y - cy)

    data = np.zeros((H, W, 4), dtype=np.float32)
    data[..., 0] = (2.0 * dist / track_width).astype(np.float32)
    return data, (x_min, x_max), (y_min, y_max)
