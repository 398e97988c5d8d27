"""The port's realtime gate (``runtime/realtime_gate.py``) and simulator
node (``tools/sim_node.py``) on the CPU.  The measurement harness
(``_measured_passes``) is held against the JAX package's on scripted
passes: the same ticks, harvest waits and CPU marks give the same voided,
censored and pooled samples.  A short two-process run drives the port's
simulator process over UDP with the async loop, and the car moves; a short
run of the gate itself reports its fields.  No test here holds a
wall-clock budget: the 50 Hz proof is ``chip_smoke.py``'s phase 23 on the
card."""

import gc
import json

import numpy as np
import pytest

from autorally_tpu.runtime import realtime_gate as jgate
from autorally_tpu_torch.runtime import realtime_gate as gate
from autorally_tpu_torch.runtime.telemetry import TimingStats
from autorally_tpu_torch.tools import sim_node
from test_torch_native import free_ports


class _Clock:
    """A stand-in for the ``time`` module: the marks a pass sets."""

    def __init__(self):
        self.now = 0.0
        self.cpu = 0.0

    def monotonic(self):
        return self.now

    def process_time(self):
        return self.cpu


# (tick_ms, harvest_ms, cpu_ms, missed, wall_ms since the previous mark)
PASSES = [
    [(5.0, 0.0, 5.0, 0, 20.0),       # quiet
     (25.0, 0.0, 25.0, 1, 25.0),     # its own overrun, CPU-backed: valid
     (30.0, 0.0, 3.0, 1, 30.0),      # wall without CPU: void
     (8.0, 0.0, 8.0, 2, 20.0),       # a late wake after a short tick:
                                     # censored to 0
     (28.0, 15.0, 12.0, 1, 28.0)],   # a 15 ms harvest off the wall: valid
    [(6.0, 0.0, 6.0, 0, 20.0),
     (40.0, 30.0, 2.0, 1, 40.0),     # 40 - 30 - 2 = 8 < 10: valid, missed
     (6.0, 0.0, 1.0, 0, 20.0),       # a quiet tick with 19 ms of sleep
     (12.0, 0.0, 0.5, 0, 12.0)],     # 11.5 ms unbacked: void
    [(7.0, 0.0, 7.0, 0, 20.0)] * 5,
]


def _run_passes(module, clock, collect_in=None):
    passes = iter(PASSES)

    def run_pass(hook):
        timing = TimingStats()
        for i, (tick, harvest, cpu, missed, wall) in enumerate(next(passes)):
            clock.now += wall / 1000.0
            clock.cpu += cpu / 1000.0
            if collect_in == i:
                gc.collect()
            timing.update(20.0, tick, 0.0, missed=missed, harvest_ms=harvest)
            timing.age_samples_s.append(0.02 * (i + 1))
            hook()
        return timing

    return module._measured_passes(run_pass, hz=50, seconds=0.1,
                                   attempts=3)


def test_measured_passes_void_censor_and_pool_as_jax(monkeypatch):
    clocks = _Clock(), _Clock()
    monkeypatch.setattr(gate, "time", clocks[0])
    monkeypatch.setattr(jgate, "time", clocks[1])
    ours = _run_passes(gate, clocks[0])
    ref = _run_passes(jgate, clocks[1])
    for key in ("valid", "all_ticks", "harvests", "net_ticks", "ages",
                "tainted", "used", "attempts", "missed_raw"):
        assert ours[key] == ref[key], key
    # target_valid = int(0.1 * 50 * 1.5) = 7: the third pass is not needed
    assert ours["used"] == 2
    assert ours["tainted"] == 2
    assert [v for v in ours["valid"]] == [
        (5.0, 0), (25.0, 1), (8.0, 0), (28.0, 1), (6.0, 0), (40.0, 1),
        (6.0, 0)]
    assert ours["missed_raw"] == 1 + 1 + 2 + 1 + 1
    assert ours["net_ticks"][4] == 13.0 and ours["net_ticks"][6] == 10.0
    assert ours["full_collections"] == 0
    summary = gate._summary(ours, 50)
    assert summary["missed"] == 3 and summary["valid_ticks"] == 7
    assert summary["p99_ms"] == gate._pct([v[0] for v in ours["valid"]], 99)
    assert gate._pct([3.0, 1.0, 2.0], 50.0) == jgate._pct([3.0, 1.0, 2.0], 50)
    assert gate._pct([], 50.0) is None
    assert gc.isenabled()


def test_measured_passes_count_full_collections_in_ticks(monkeypatch):
    clock = _Clock()
    monkeypatch.setattr(gate, "time", clock)
    res = _run_passes(gate, clock, collect_in=1)
    # one explicit full collection inside tick 1 of each pass used
    assert res["full_collections"] == res["used"] == 2
    assert gc.isenabled() and gate._measured_passes.__name__ not in [
        getattr(cb, "__name__", "") for cb in gc.callbacks]


def test_sim_node_refuses_physics_and_a_missing_model(tmp_path):
    """The node runs the physics model from a scene description (the
    roslaunch spawn path, as ``tests/test_description.py`` checks for the
    JAX node): ``--physics --urdf --world`` on the CPU, in its own process,
    ends at the world's spawn with no command; the learned-model path
    still refuses a missing model."""
    import os
    import subprocess
    import sys

    from autorally_tpu_torch.sim.description import (DEFAULT_URDF,
                                                     WorldDescription,
                                                     save_world)

    world = str(tmp_path / "w.json")
    save_world(WorldDescription(spawn_x=3.0, spawn_y=4.0, spawn_yaw=0.0,
                                mu=0.5), world)
    log = str(tmp_path / "drive.jsonl")
    pose, ctrl = free_ports(2)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run(
        [sys.executable, "-m", "autorally_tpu_torch.tools.sim_node", "--cpu",
         "--physics", "--urdf", DEFAULT_URDF, "--world", world,
         "--duration", "0.3", "--hz", "20", "--pose-port", str(pose),
         "--control-port", str(ctrl), "--log", log],
        cwd=root, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "on cpu, physics" in out.stdout and "Queue 1" not in out.stdout
    assert "done at t=0.30s pos=(3.00,4.00) speed=0.00 missed=" in out.stdout
    with open(log) as f:
        rows = [json.loads(line) for line in f]
    truth = [r for r in rows if r["topic"] == "ground_truth/state"]
    assert len(truth) == 6 and truth[-1]["x"] == 3.0
    missing = str(tmp_path / "none.npz")
    with pytest.raises(FileNotFoundError, match="none.npz"):
        sim_node.main(["--cpu", "--model", missing])


def test_two_process_drive_moves_the_car():
    """The port's simulator node in its own process (``--cpu``, seeded
    weights) and the async loop on the CPU over UDP at 20 Hz for 30 ticks:
    the poses stream, the commands go back, and the car moves."""
    from autorally_tpu_torch.runtime.async_loop import (
        AsyncLoopConfig, AsyncTubeController, run_control_loop_async)

    hz = 20
    cfg, model, params, solver, cm, cp = gate._oval_stack(64, 16, hz, "cpu")
    tube = AsyncTubeController(solver, params, cp, cm,
                               use_feedback_gains=False)
    rig = gate._Rig(model, params, cfg.dt, cfg.num_timesteps, hz, 20.0,
                    *free_ports(2), use_feedback_gains=False)
    try:
        start = rig.plant.get_state().to_vector()
        timing = run_control_loop_async(
            tube, rig.plant, AsyncLoopConfig(hz=hz, num_timesteps=16,
                                             depth=1, max_iter=30))
        end = rig.plant.get_state().to_vector()
        assert timing.num_iter == 30 and timing.pacer == "native"
        assert rig.plant.pose_count > 15 and len(rig.plant.published) > 10
    finally:
        log = rig.close()
    assert "sim_node: 20 Hz on cpu" in log
    assert np.hypot(end[0] - start[0], end[1] - start[1]) > 0.01
    assert end[4] > 0.01


def test_gate_reports_its_fields_on_the_cpu(capsys):
    """A short run of each gate on the CPU (no budget held), the
    sequential one through ``main``'s JSON line: the fields phase 23
    reads, the native pacer, no capture."""
    ports = [str(p) for p in free_ports(2)]
    assert gate.main(["--cpu", "--seconds", "0.2", "--attempts", "1",
                      "--pose-port", ports[0], "--control-port",
                      ports[1]]) == 0
    seq = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    asy = gate.run_realtime_gate_async(*free_ports(2), seconds=0.2,
                                       attempts=1, warmup_iters=2,
                                       num_rollouts=64, num_timesteps=16,
                                       device="cpu")
    assert seq["num_rollouts"] == 64 and seq["num_timesteps"] == 16
    for res in (seq, asy):
        assert res["pacer"] == "native" and res["captures"] == 0
        assert res["ticks"] == 10 and res["device"] == "cpu"
        assert res["valid_ticks"] + res["tainted_ticks"] == res["ticks"]
        assert res["first_tick_ms"] > 0 and "seeded" in res["weights"]
        assert res["full_collections"] == 0
    for key in ("depth_final", "depth_max", "harvest_p99_ms", "age_p99_s",
                "p99_net_ms", "best_attempt_p99_ms"):
        assert asy[key] is not None, key
