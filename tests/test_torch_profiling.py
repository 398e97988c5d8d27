"""The port's profiling hooks (``runtime/profiling.py``) on the CPU:
``SolveTimer`` against the JAX package's on the same samples, a device
trace exported as a Chrome trace, and ``count_solve_traces`` counting
captures (none on the CPU, where the tick runs eagerly)."""

import json
import os

import numpy as np
import torch

from autorally_tpu.runtime.profiling import SolveTimer as JaxSolveTimer
from autorally_tpu_torch.runtime.profiling import (SolveTimer,
                                                   count_solve_traces,
                                                   device_trace)
from test_torch_async_loop import START, _build


def test_solve_timer_summary_and_report_equal_jax():
    rs = np.random.default_rng(0)
    ours, ref = SolveTimer(), JaxSolveTimer()
    for name in ("solve", "slide", "gains"):
        for ms in rs.uniform(0.1, 20.0, 37):
            ours.record(name, float(ms))
            ref.record(name, float(ms))
    assert ours.summary() == ref.summary()
    assert ours.report() == ref.report()
    with ours.time("blocked", block_on=torch.ones(3)):
        pass
    with ours.time("result") as out:
        out["result"] = {"a": [torch.zeros(2)]}
    assert ours.summary()["blocked"]["count"] == 1
    assert ours.summary()["result"]["count"] == 1


def test_device_trace_exports_a_chrome_trace(tmp_path):
    with device_trace(str(tmp_path / "trace")) as prof:
        torch.ones(64).cumsum(0)
    assert os.path.dirname(prof.trace_path) == str(tmp_path / "trace")
    with open(prof.trace_path) as f:
        events = json.load(f)["traceEvents"]
    assert any("cumsum" in e.get("name", "") for e in events)
    assert any("cumsum" in e.name for e in prof.events())


class _Owner:
    def __init__(self):
        self.made = []

    def _capture(self, *args):
        self.made.append(args)


def test_count_solve_traces_counts_captures():
    a, b = _Owner(), _Owner()
    traces = count_solve_traces(a, b)
    assert traces == {"n": 0}
    a._capture(1)
    b._capture(2)
    a._capture(3)
    assert traces["n"] == 3 and a.made == [(1,), (3,)] and b.made == [(2,)]
    # the async tube on the CPU runs eagerly: dispatches capture nothing,
    # gamma updates included
    tube, plant, _ = _build()
    traces = count_solve_traces(tube)
    tube.reset(START)
    for g in (0.1, 0.2, None):
        tube.update_cost_params(tube.cost_params.replace(gamma=g))
        assert np.isfinite(tube.dispatch(START, 1).result().ess)
    assert traces["n"] == 0
