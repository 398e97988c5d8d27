"""Profiling hooks: device traces and per-stage timing telemetry (port of
``autorally_tpu/runtime/profiling.py``).

The reference's profiling story is NVIDIA Nsight launched around a
ROS-decoupled controller run (``autorally_control/profiler.md``,
``profiler_max_iter``).  Here that is a ``torch.profiler`` trace of the
host and the card, exported as a Chrome trace (open it in Perfetto or
``chrome://tracing``), plus in-band timing percentiles.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List

import numpy as np
import torch


@contextlib.contextmanager
def device_trace(logdir: str):
    """Trace the block with ``torch.profiler`` (CPU and, when a card is
    present, CUDA activities) and export it as a Chrome trace into
    ``logdir``.  Yields the profiler, whose ``events()`` the caller may read
    after the block; its ``trace_path`` attribute names the exported file."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.__enter__()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.__exit__(None, None, None)
        prof.trace_path = os.path.join(
            logdir, f"trace_{os.getpid()}_{time.time_ns()}.json")
        prof.export_chrome_trace(prof.trace_path)


def _wait_for(obj) -> None:
    """Wait until the device work that produced the tensors in ``obj`` (a
    tensor or a nest of lists, tuples, dicts and NamedTuples) is done: an
    event recorded on each card's current stream and waited on, which
    leaves other streams alone."""
    devices = set()

    def visit(o):
        if torch.is_tensor(o):
            if o.device.type == "cuda":
                devices.add(o.device)
        elif isinstance(o, dict):
            for v in o.values():
                visit(v)
        elif isinstance(o, (list, tuple)):
            for v in o:
                visit(v)

    visit(obj)
    for dev in devices:
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(dev))
        ev.synchronize()


class SolveTimer:
    """Latency percentiles for named stages (solve, slide, gains, ...)."""

    def __init__(self):
        self.samples: Dict[str, List[float]] = {}

    @contextlib.contextmanager
    def time(self, name: str, block_on=None):
        """Time a stage; pass the stage's output tensors as ``block_on``
        (or set ``out["result"]`` inside the block) to include the device's
        execution in the measurement."""
        t0 = time.perf_counter()
        out = {}
        yield out
        if block_on is not None or "result" in out:
            _wait_for(out.get("result", block_on))
        self.samples.setdefault(name, []).append(
            (time.perf_counter() - t0) * 1000.0)

    def record(self, name: str, ms: float) -> None:
        self.samples.setdefault(name, []).append(ms)

    def summary(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for name, xs in self.samples.items():
            a = np.asarray(xs)
            out[name] = {
                "count": int(a.size),
                "mean_ms": float(a.mean()),
                "p50_ms": float(np.percentile(a, 50)),
                "p99_ms": float(np.percentile(a, 99)),
                "max_ms": float(a.max()),
            }
        return out

    def report(self) -> str:
        lines = [f"{'stage':<16} {'n':>5} {'mean':>8} {'p50':>8} "
                 f"{'p99':>8} {'max':>8}  (ms)"]
        for name, s in self.summary().items():
            lines.append(f"{name:<16} {s['count']:>5} {s['mean_ms']:>8.2f} "
                         f"{s['p50_ms']:>8.2f} {s['p99_ms']:>8.2f} "
                         f"{s['max_ms']:>8.2f}")
        return "\n".join(lines)


def count_solve_traces(*owners) -> dict:
    """The twin of the JAX package's retrace counter.  The port has no
    tracing JIT: what a changed argument costs it is a new CUDA-graph
    capture.  So this counts captures: it rewraps the ``_capture`` method
    of each owner (an ``AsyncTubeController``, an ``EpisodeRunner``, or a
    ``DDPSolver``, whose run the sequential loop captures once a stream) so
    that every capture increments the returned ``{"n": int}``; the
    zero-capture contracts (gamma updates, the realtime gate's measured
    passes) are asserted against it.  Eager runs (the CPU) capture
    nothing, so there it stays 0."""
    traces = {"n": 0}
    for owner in owners:
        orig = owner._capture

        def counting(*args, _orig=orig, **kw):
            traces["n"] += 1
            return _orig(*args, **kw)

        owner._capture = counting
    return traces
