"""Observability: timing telemetry, watchdog, lap statistics (the port's
copy of ``autorally_tpu/runtime/telemetry.py``, plain Python).

Covers the reference's telemetry surface (SURVEY.md §5):

- :class:`TimingStats` — the running averages published as
  ``pathIntegralTiming`` (run_control_loop.cuh:305-318,
  autorally_plant.cpp:128-141)
- :class:`StatusMonitor` — the ``path_integral_monitor`` watchdog
  (status_monitor.cpp:38-69): error on >0.5 s of status silence
- :class:`LapStats` — the benchmark evaluator (scripts/lap_stats.py):
  start-line-crossing lap detection, per-lap lap_time / max_speed /
  max_slip
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional


def _nearest_rank(sorted_samples, p: float) -> float:
    """Nearest-rank percentile of an ascending list, p in [0, 100]."""
    idx = min(len(sorted_samples) - 1,
              max(0, int(round(p / 100.0 * (len(sorted_samples) - 1)))))
    return sorted_samples[idx]


class TimingStats:
    """Running averages over loop iterations (run_control_loop.cuh:315-318):
    avg = (n-1)/n * avg + sample/n — plus raw tick samples for percentile
    gating (the real-time gate: p99 tick < budget, missed == 0), which the
    reference never recorded.

    Tick samples are kept in a trailing window (default 16384 ticks ≈
    5.5 min at 50 Hz) so an always-on deployment loop cannot grow memory
    without bound; the averages and ``missed_ticks`` remain whole-run.
    Callers that index ``tick_samples_ms`` positionally (the real-time
    gate) run far fewer ticks per pass than the window, so alignment with
    their own per-tick marks is preserved."""

    def __init__(self, window: int = 16384):
        import collections

        self.num_iter = 0
        self.avg_loop_ms = 0.0       # time between pose estimates
        self.avg_tick_ms = 0.0       # optimization tick time
        self.avg_sleep_ms = 0.0
        self.tick_samples_ms = collections.deque(maxlen=window)
        self.missed_samples = collections.deque(maxlen=window)
        # device-wait portion of each tick (async loop: time blocked on
        # the in-flight solve's host copy) — 0.0 for the sync loop
        self.harvest_samples_ms = collections.deque(maxlen=window)
        # published-solution age at harvest (pose time now minus the
        # solution's state anchor) — the async pipeline's staleness; a
        # device that cannot sustain the tick rate shows up here as age
        # greater than depth control periods (appended by the async
        # loop's harvest, empty for the sync loop)
        self.age_samples_s = collections.deque(maxlen=window)
        self.missed_ticks = 0        # whole deadline periods overrun

    def update(self, loop_ms: float, tick_ms: float, sleep_ms: float,
               missed: int = 0, harvest_ms: float = 0.0) -> None:
        self.num_iter += 1
        n = self.num_iter
        self.avg_loop_ms = (n - 1.0) / n * self.avg_loop_ms + loop_ms / n
        self.avg_tick_ms = (n - 1.0) / n * self.avg_tick_ms + tick_ms / n
        self.avg_sleep_ms = (n - 1.0) / n * self.avg_sleep_ms + sleep_ms / n
        self.tick_samples_ms.append(tick_ms)
        self.missed_samples.append(int(missed))
        self.harvest_samples_ms.append(harvest_ms)
        self.missed_ticks += int(missed)

    def tick_percentile_ms(self, p: float) -> float:
        """p in [0, 100]; nearest-rank percentile of windowed tick times."""
        if not self.tick_samples_ms:
            return 0.0
        return _nearest_rank(sorted(self.tick_samples_ms), p)

    def as_dict(self) -> dict:
        s = sorted(self.tick_samples_ms)        # one sort for both ranks
        return {
            "averageTimeBetweenPoses": self.avg_loop_ms,
            "averageOptimizationCycleTime": self.avg_tick_ms,
            "averageSleepTime": self.avg_sleep_ms,
            "tickP50Ms": _nearest_rank(s, 50.0) if s else 0.0,
            "tickP99Ms": _nearest_rank(s, 99.0) if s else 0.0,
            "missedTicks": self.missed_ticks,
        }

    def as_msg(self, stamp: float = 0.0):
        """The ``pathIntegralTiming`` wire message (seconds, like the
        reference publishes — autorally_plant.cpp:128-141)."""
        from autorally_tpu_torch.msgs import PathIntegralTiming

        return PathIntegralTiming(
            average_time_between_poses=self.avg_loop_ms / 1000.0,
            average_optimization_cycle_time=self.avg_tick_ms / 1000.0,
            average_sleep_time=self.avg_sleep_ms / 1000.0,
            stamp=stamp)


class StatusMonitor:
    """Watchdog: OK while heartbeats arrive, error after ``timeout`` seconds
    of silence (status_monitor.cpp:55-69, TIMETOUT_DURATION 0.5 s)."""

    TIMEOUT = 0.5

    def __init__(self):
        self.last_heartbeat: Optional[float] = None
        self.last_status = 1
        self.last_message = "no status received"

    def heartbeat(self, t: float, status: int, message: str = "") -> None:
        self.last_heartbeat = t
        self.last_status = status
        self.last_message = message

    def diagnostic(self, now: float) -> dict:
        """-> {'level': 'ok'|'warn'|'error', 'message': str}."""
        if self.last_heartbeat is None or now - self.last_heartbeat > self.TIMEOUT:
            return {"level": "error",
                    "message": "MPPI not publishing a status"}
        level = {0: "ok", 1: "warn", 2: "error"}.get(self.last_status, "error")
        return {"level": level, "message": self.last_message}


@dataclasses.dataclass
class LapRecord:
    lap_number: int
    lap_time: float
    max_speed: float
    max_slip: float


class LapStats:
    """Lap detection by start-line crossing (lap_stats.py:110-139).

    ``line`` = (slope, intercept, x_min, x_max): a lap boundary is crossed
    when the sign of ``y > slope*x + intercept`` flips while x is inside
    [x_min, x_max].
    """

    def __init__(self, line=(-1.55, 0.29, -1.35, 1.35)):
        self.line = line
        self.last_eval: Optional[bool] = None
        self.start_time: Optional[float] = None
        self.lap_number = 1
        self.max_speed = 0.0
        self.max_slip = 0.0
        self.laps: List[LapRecord] = []

    def process_pose(self, t: float, x: float, y: float,
                     v_x: float, v_y: float) -> Optional[LapRecord]:
        total_v = math.hypot(v_x, v_y)
        if total_v > self.max_speed:
            self.max_speed = total_v
        slip = 0.0
        if v_x > 0.1:
            slip = -math.atan(v_y / abs(v_x))
        if slip > self.max_slip:
            self.max_slip = slip

        slope, intercept, x_min, x_max = self.line
        line_eval = y > slope * x + intercept
        record = None
        if (self.last_eval is not None and line_eval != self.last_eval
                and x_min < x < x_max):
            if self.start_time is None:
                self.start_time = t
            else:
                record = LapRecord(self.lap_number, t - self.start_time,
                                   self.max_speed, self.max_slip)
                self.laps.append(record)
                self.lap_number += 1
                self.start_time = t
                self.max_speed = 0.0
                self.max_slip = 0.0
        self.last_eval = line_eval
        return record

    @staticmethod
    def record_as_msg(record: LapRecord, cfg=None, tag: str = "",
                      stamp: float = 0.0):
        """A completed lap as the ``pathIntegralStats`` wire message —
        lap summary plus the full controller-parameter echo the
        reference attaches (lap_stats.py's published form)."""
        from autorally_tpu_torch.msgs import (LapStats as LapStatsMsg,
                                              PathIntegralParams,
                                              PathIntegralStats)

        lap = LapStatsMsg(lap_number=record.lap_number,
                          lap_time=record.lap_time,
                          max_speed=record.max_speed,
                          max_slip=record.max_slip, stamp=stamp)
        params = PathIntegralParams()
        if cfg is not None:
            params = PathIntegralParams(
                hz=cfg.hz, num_timesteps=cfg.num_timesteps,
                num_iters=cfg.num_iters, gamma=cfg.gamma,
                init_steering=cfg.init_steering,
                init_throttle=cfg.init_throttle,
                steering_var=cfg.steering_std,
                throttle_var=cfg.throttle_std,
                max_throttle=cfg.max_throttle,
                desired_speed=0.0)
        return PathIntegralStats(tag=tag, params=params, stats=lap,
                                 stamp=stamp)
