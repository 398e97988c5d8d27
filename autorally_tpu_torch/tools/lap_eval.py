"""Shared closed-loop lap-evaluation helpers (port of
``autorally_tpu/tools/lap_eval.py``).

The track setup and the episode-metrics extraction that
``autorally_tpu_torch/lap_benchmark.py`` and ``tools/lap_suite.py`` (the
``LAPS_r*.json`` artifact) share: the metric set of the reference's
``lap_stats.py:104-108`` (lap time, max speed, max slip) plus the plant's
off-track fraction (the costmap's own crash criterion,
``costs.cu:389-391``, applied to the executed trajectory).
"""

from __future__ import annotations

import math

import torch

from autorally_tpu_torch.costs.costmap import make_costmap
from autorally_tpu_torch.runtime.telemetry import LapStats
from autorally_tpu_torch.tools import track_generator as tg


def load_track(name: str, ppm: float = 10.0, device=None):
    """-> (costmap on ``device``, start pose (x, y, yaw), lap line,
    crossings a lap).  "ccrf" and "marietta" need the reference's textures
    (``FileNotFoundError`` without them)."""
    if name == "ccrf":
        data, xb, yb = tg.ccrf_track(ppm=ppm)
        start, line, xings = tg.CCRF_START, tg.CCRF_LAP_LINE, 1
    elif name == "marietta":
        data, xb, yb = tg.marietta_track(ppm=ppm)
        start, line, xings = tg.MARIETTA_START, tg.MARIETTA_LAP_LINE, 1
    elif name == "winding":
        data, xb, yb = tg.spline_track(track_width=6.0, ppm=ppm)
        # start at the first waypoint, heading along the first segment;
        # the lap line is the y=0 crossing near the start
        start, line, xings = ((0.0, 0.0, math.atan2(-2.0, 12.0)),
                              (0.0, 0.0, -3.0, 3.0), 2)
    elif name == "oval":
        data, xb, yb = tg.oval_track(half_length=30.0, half_width=18.0,
                                     track_width=6.0, ppm=ppm)
        start, line, xings = ((30.0, 0.0, math.pi / 2),
                              (0.0, 0.0, 25.0, 35.0), 2)
    else:
        raise ValueError(f"unknown track {name!r}")
    return make_costmap(data, xb, yb, device=device), start, line, xings


def episode_metrics(res, cm, lap_line, crossings_per_lap: int, dt: float,
                    boundary_threshold: float) -> dict:
    """Summarize an :class:`~autorally_tpu_torch.runtime.episode.
    EpisodeResult` (read back from the device here).  Lap segmentation
    follows ``lap_benchmark``: a lap line that spans only the corridor is
    crossed once a circuit; the oval's full-width line twice (out and
    back)."""
    states = res.states.detach().cpu().numpy()
    laps = LapStats(line=lap_line)
    for i, s in enumerate(states):
        laps.process_pose(i * dt, s[0], s[1], s[4], s[5])
    segs = [r.lap_time for r in laps.laps]
    full = (segs if crossings_per_lap == 1
            else [segs[i] + segs[i + 1] for i in range(0, len(segs) - 1, 2)])
    max_slip = max((r.max_slip for r in laps.laps), default=0.0)

    xy = torch.as_tensor(states[:, :2], device=cm.ch0.device)
    vals = cm.lookup_ch0(xy[:, 0], xy[:, 1]).cpu().numpy()
    off = vals >= boundary_threshold
    settle = min(200, len(states) // 2)
    return {
        "laps": len(full),
        "lap_times_s": [round(t, 2) for t in full],
        "best_lap_s": round(min(full), 2) if full else None,
        "mean_speed": round(float(states[settle:, 4].mean()), 3),
        "max_speed": round(float(states[:, 4].max()), 3),
        "max_slip": round(float(max_slip), 3),
        "offtrack_frac": round(float(off.mean()), 4),
        "offtrack_ticks": int(off.sum()),
        "rollout_crash_frac": round(
            float(res.crash_frac.detach().cpu().numpy().mean()), 4),
        "mean_ess": round(float(res.ess.detach().cpu().numpy().mean()), 1),
    }
