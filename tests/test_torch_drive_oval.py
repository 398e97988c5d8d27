"""The port's closed-loop demo (``python -m autorally_tpu_torch.drive_oval``)
on the CPU at a small rollout count: the oval of ``examples/drive_oval.py``
(a 560 x 800 map), seeded weights, slide + solve + plant step per tick."""

import os
import subprocess
import sys

import numpy as np

from autorally_tpu.tools.track_generator import oval_track
from autorally_tpu_torch import drive_oval

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_drive_builds_the_demo_configuration_and_runs():
    solver, params, cost_params, costmap, note = drive_oval.build(
        rollouts=64, model_path="", device="cpu")
    assert "seeded Glorot init" in note
    assert (costmap.height, costmap.width) == (560, 800)
    data, _, _ = oval_track(half_length=30.0, half_width=18.0,
                            track_width=6.0, ppm=10.0)
    np.testing.assert_array_equal(costmap.data.numpy(), data)
    assert solver.cfg.num_timesteps == 100 and cost_params.desired_speed == 6
    logs = []
    out = drive_oval.drive(solver, params, cost_params, costmap, 4,
                           log=logs.append)
    assert out["solve_ms"].shape == (4,) and out["controls"].shape == (4, 2)
    assert np.isfinite(out["controls"]).all() and np.isfinite(out["state"]).all()
    assert logs[0].startswith("first solve") and "ess=" in logs[-1]


def test_drive_oval_module_entry_point():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run(
        [sys.executable, "-m", "autorally_tpu_torch.drive_oval", "--cpu",
         "--steps", "2", "--rollouts", "32", "--model", "missing.npz"],
        capture_output=True, text=True, timeout=300, cwd=REPO, env=env)
    assert out.returncode == 0, out.stderr
    assert "seeded Glorot init (seed 0); missing.npz not found" in out.stdout
    assert "solve latency" in out.stdout
