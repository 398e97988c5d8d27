"""The port's operator console, telemetry bus and host / card status
(``tools/console.py``, ``runtime/telemetry_bus.py``,
``runtime/system_status.py``) against the JAX package's, mirroring
``tests/test_console.py``; the console attached to a live
``run_tube_mppi --cpu`` run."""

import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from autorally_tpu.runtime import system_status as jstatus
from autorally_tpu.runtime.diagnostics import \
    DiagnosticsAggregator as JaxAggregator
from autorally_tpu.tools.console import ConsoleState as JaxConsoleState
from autorally_tpu_torch import run_tube_mppi
from autorally_tpu_torch.runtime import system_status
from autorally_tpu_torch.runtime.diagnostics import DiagnosticsAggregator
from autorally_tpu_torch.runtime.system_status import (SystemStatusMonitor,
                                                       accelerator_status,
                                                       time_sync_status)
from autorally_tpu_torch.runtime.telemetry import LapRecord
from autorally_tpu_torch.runtime.telemetry_bus import (RunstopReceiver,
                                                       TelemetryBus,
                                                       send_runstop)
from autorally_tpu_torch.tools.console import ConsoleState

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CARD = "NVIDIA H100 80GB HBM3"


def _free_udp_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# -- host and card status ----------------------------------------------------

def test_system_status_samples_host():
    agg = DiagnosticsAggregator(publish_hz=1000.0)
    mon = SystemStatusMonitor(agg, period=0.0)
    snap = mon.sample()
    assert snap["loadavg"] is not None and len(snap["loadavg"]) == 3
    assert snap["memory"]["total_mb"] > 0
    assert 0 <= snap["memory"]["used_pct"] <= 100
    assert snap["disk"]["total_gb"] > 0
    assert snap["network"]["rx_bytes"] >= 0
    time.sleep(0.05)
    snap2 = mon.sample()
    assert snap2["cpu_pct"] is not None and 0 <= snap2["cpu_pct"] <= 100
    report = agg.maybe_publish(now=time.time() + 10)
    assert "memory" in report["components"]["system"]["entries"]
    assert "disk" in report["components"]["system"]["entries"]
    # the JAX monitor's snapshot has the same sections
    assert set(snap) == set(jstatus.SystemStatusMonitor(period=0.0).sample())
    assert mon.maybe_sample(time.time() + 1.0) is not None


def test_time_sync_status_equals_jax():
    ts = time_sync_status()
    ref = jstatus.time_sync_status()
    assert set(ts) == set(ref)
    if ts["available"]:
        assert isinstance(ts["synchronized"], bool)
        assert isinstance(ts["offset_us"], int)
        assert ts["synchronized"] == ref["synchronized"]


def test_accelerator_status_reports_the_cpu_with_the_jax_keys():
    acc = accelerator_status()
    ref = jstatus.accelerator_status()      # the CPU platform here
    assert acc == {"platform": "cpu", "device_count": 1,
                   "devices": [{"id": 0, "kind": "cpu"}]}
    assert ref["platform"] == "cpu"
    assert set(acc) == set(ref)
    assert set(acc["devices"][0]) == set(ref["devices"][0])


def test_accelerator_status_on_a_card(monkeypatch):
    """With a card (``torch.cuda`` stood in for here): the JAX keys, the
    card's name as ``nvidia-smi`` gives it, the allocator's reserved bytes
    against the card's total."""
    class Props:
        total_memory = 80 * 2 ** 30

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i: CARD)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda i: Props())
    monkeypatch.setattr(torch.cuda, "memory_reserved",
                        lambda i: 20 * 2 ** 30)
    acc = accelerator_status()
    assert acc == {"platform": "gpu", "device_count": 1, "devices": [
        {"id": 0, "kind": CARD, "bytes_in_use": 20 * 2 ** 30,
         "bytes_limit": 80 * 2 ** 30, "hbm_used_pct": 25.0}]}


def test_status_diagnostics_equal_jax():
    """The same snapshot pushes the same diagnostics entries on both
    packages' monitors (warn levels at their thresholds)."""
    snaps = [
        {"cpu_pct": 95.0, "memory": {"used_pct": 40.0, "available_mb": 900},
         "disk": {"used_pct": 91.0, "free_gb": 3.0}, "cpu_temp_c": 88.0,
         "battery_pct": 12, "time_sync": {"available": True,
                                          "synchronized": False},
         "accelerator": {"platform": "gpu", "device_count": 1, "devices": [
             {"id": 0, "kind": CARD, "hbm_used_pct": 97.0}]}},
        {"cpu_pct": None, "memory": None, "disk": None, "cpu_temp_c": None,
         "battery_pct": None, "time_sync": {"available": True,
                                            "synchronized": True,
                                            "offset_us": 12},
         "accelerator": {"platform": "cpu", "device_count": 0,
                         "devices": []}},
    ]
    for snap in snaps:
        reports = []
        for agg, mon in ((DiagnosticsAggregator(),
                          system_status.SystemStatusMonitor),
                         (JaxAggregator(), jstatus.SystemStatusMonitor)):
            m = mon(agg, period=5.0)
            m._push_diagnostics(snap)
            reports.append(agg.rollup(now=1.0))
        assert reports[0] == reports[1]


# -- the telemetry bus and the runstop backchannel ---------------------------

def test_telemetry_bus_jsonl_and_udp(tmp_path):
    """Records to the JSONL log and as UDP datagrams; tensors (the solve
    stats, on the card in a run there) become numbers and lists."""
    rx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    rx.bind(("127.0.0.1", 0))
    rx.settimeout(2.0)
    path = str(tmp_path / "run.jsonl")
    bus = TelemetryBus(jsonl_path=path,
                       udp_addr=("127.0.0.1", rx.getsockname()[1]))
    bus.publish("solve", {"tick": 3, "ess": torch.tensor(123.5),
                          "u": torch.tensor([0.25, -0.5]),
                          "crash": np.float32(0.125)})
    bus.publish("lap", {"lap_number": 1, "lap_time": 58.7}, t=4.0)
    bus.close()
    assert bus.published == 2
    lines = [json.loads(line) for line in open(path)]
    assert [line["kind"] for line in lines] == ["solve", "lap"]
    assert lines[0]["ess"] == 123.5 and lines[0]["u"] == [0.25, -0.5]
    assert lines[0]["crash"] == 0.125 and "t" in lines[0]
    assert lines[1]["t"] == 4.0
    datagrams = [json.loads(rx.recv(65536).decode()) for _ in range(2)]
    assert datagrams == lines
    rx.close()


def test_runstop_receiver_conjunction_and_staleness():
    changes = []
    rx = RunstopReceiver(0, on_change=changes.append, stale_s=0.4)
    try:
        assert rx.motion_enabled          # no senders -> default enabled
        send_runstop(rx.port, "ocs", True)
        time.sleep(0.3)
        assert rx.motion_enabled
        send_runstop(rx.port, "safety_box", False)
        deadline = time.time() + 2
        while rx.motion_enabled and time.time() < deadline:
            time.sleep(0.02)
        assert not rx.motion_enabled
        assert changes and changes[-1] is False
        deadline = time.time() + 2
        while not rx.motion_enabled and time.time() < deadline:
            time.sleep(0.05)
        assert rx.motion_enabled
    finally:
        rx.close()


# -- the console ---------------------------------------------------------------

RECORDS = [
    {"kind": "run", "num_rollouts": 1920, "num_timesteps": 100, "hz": 50,
     "plant": "synthetic_oval"},
    {"kind": "solve", "tick": 42, "x": 1.0, "y": -2.0, "speed": 5.3,
     "used": "actual", "ess": 250.0, "gamma": 0.15, "crash_pct": 12.0,
     "traj_cost": 0.5},
    {"kind": "timing", "avg_tick_ms": 4.2, "tickP50Ms": 4.0,
     "tickP99Ms": 26.0, "budget_ms": 20.0, "missedTicks": 0},
    {"kind": "lap", "lap_number": 1, "lap_time": 58.7, "max_speed": 7.9,
     "max_slip": 0.26},
    {"kind": "diag", "level": "warn", "components": {
        "chassis": {"level": "warn", "entries": {
            "serial": {"level": "warn", "message": "late frames"}}},
        "mppi": {"level": "ok", "entries": {
            "status": {"level": "ok", "message": "controller=actual"}}}}},
    {"kind": "system", "cpu_pct": 12.0, "memory": {"used_pct": 40.0},
     "disk": {"used_pct": 60.0},
     "time_sync": {"available": True, "synchronized": True},
     "accelerator": {"device_count": 1, "platform": "gpu"}},
    {"kind": "image", "ascii": ["@@@###", "..::--"], "msv": 118.2,
     "shutter": 3210.5, "gain": 0.01},
]


@pytest.mark.parametrize("color", [False, True], ids=["plain", "color"])
def test_console_render_equals_jax(color):
    """The same records give the JAX console's frame, character for
    character: fresh, then stale (``[STALE]``) once their age passes
    ``stale_s``; and the needles of ``tests/test_console.py``."""
    frames = []
    for cls in (ConsoleState, JaxConsoleState):
        st = cls(stale_s=3.0)
        for rec in RECORDS:
            st.ingest(dict(rec), now=100.0)
        st.motion_enabled = False
        frames.append((st.render(now=101.0, color=color),
                       st.render(now=200.0, color=color), st.records,
                       st.laps))
    assert frames[0] == frames[1]
    if not color:
        fresh, stale = frames[0][:2]
        for needle in ("K=1920", "tick", "speed= 5.30", "ess=  250.0",
                       "p99  26.00", "lap  1", "chassis", "late frames",
                       "clock sync", "1xgpu", "RUNSTOP ENGAGED", "camera",
                       "shutter= 3210.5"):
            assert needle in fresh, (needle, fresh)
        assert "[STALE]" in stale and "[STALE]" not in fresh


def test_operator_publishes_a_lap_with_the_jax_keys(tmp_path):
    """A lap the loop completes reaches the bus as the JAX example's
    ``lap`` record (no seeded run laps in a test's ticks)."""
    path = str(tmp_path / "run.jsonl")
    tube = run_tube_mppi.build(ticks=1, rollouts=32, timesteps=8,
                               device="cpu")
    op = run_tube_mppi.OperatorIO(tube, log=path)
    run_tube_mppi.drive(tube, log=lambda m: None, operator=op)
    op.on_tick(2, tube.actual, "actual", tube.plant.true_state,
               lap=LapRecord(1, 58.5, 6.25, 0.125))
    op.close()
    recs = [json.loads(line) for line in open(path)]
    lap = next(r for r in recs if r["kind"] == "lap")
    assert set(lap) == {"t", "kind", "lap_number", "lap_time", "max_speed",
                        "max_slip"}
    assert (lap["lap_number"], lap["lap_time"], lap["max_speed"],
            lap["max_slip"]) == (1, 58.5, 6.25, 0.125)
    assert [r["kind"] for r in recs].count("solve") == 2


def test_console_attaches_to_live_run(tmp_path):
    """End to end: the console process listens, a live ``run_tube_mppi
    --cpu --camera`` process publishes to it, and the console renders the
    dashboard (solver, diagnostics, the camera panel) and logs every
    record it received in its 5 s from the first (the first tick sends
    every kind but ``lap``)."""
    port = _free_udp_port()
    log = str(tmp_path / "console.jsonl")
    frames = tmp_path / "console.out"     # a file: frames never block it
    with open(frames, "w") as out_file:
        console = subprocess.Popen(
            [sys.executable, "-m", "autorally_tpu_torch.tools.console",
             "--port", str(port), "--duration", "5", "--wait-data", "120",
             "--log", log, "--no-color"],
            cwd=REPO, stdout=out_file, stderr=subprocess.STDOUT)
    try:
        # the console's socket is bound once the port is taken
        deadline = time.time() + 60
        while True:
            probe = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            try:
                probe.bind(("127.0.0.1", port))
            except OSError:
                break
            finally:
                probe.close()
            assert time.time() < deadline and console.poll() is None
            time.sleep(0.05)
        run = subprocess.run(
            [sys.executable, "-m", "autorally_tpu_torch.run_tube_mppi",
             "--cpu", "--ticks", "60", "--rollouts", "64", "--timesteps",
             "16", "--telemetry-port", str(port), "--camera"],
            cwd=REPO, capture_output=True, text=True, timeout=300)
        assert run.returncode == 0, run.stdout + run.stderr
        console.wait(timeout=120)
    finally:
        if console.poll() is None:
            console.kill()
            console.wait()
    out = frames.read_text()
    assert console.returncode == 0, out
    assert "speed=" in out and "diagnostics" in out and "camera" in out
    recs = [json.loads(line) for line in open(log)]
    assert {"run", "solve", "timing", "diag", "system", "image"} <= {
        r["kind"] for r in recs}
    ticks = [r["tick"] for r in recs if r["kind"] == "solve"]
    assert ticks == list(range(1, len(ticks) + 1))
