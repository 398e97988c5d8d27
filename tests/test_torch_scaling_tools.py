"""The port's scaling and breakdown tools on the CPU
(``autorally_tpu_torch/tools/scaling_bench.py``,
``autorally_tpu_torch/tools/solve_breakdown.py``), each run as a command
with its build cache in a temporary directory.

``scaling_bench --virtual 2`` on gloo CPU ranks: the JSON's keys (the JAX
tool's and ``ranks_per_device``), its K values and its efficiency
arithmetic.  No time threshold: CPU ranks oversubscribe the host's cores,
and their timings are no forecast for a card.  ``solve_breakdown --cpu``
with and without ``--kernel-rng``: the JAX tool's stage keys (read from
its source) and top-level keys."""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
JAX_BREAKDOWN = REPO / "autorally_tpu" / "tools" / "solve_breakdown.py"
SCALING_KEYS = {"platform", "devices_present", "num_timesteps", "virtual",
                "one_dev"}
ROW_KEYS = {"devices", "K", "solves_per_sec", "rollouts_per_sec",
            "efficiency"}
BREAKDOWN_KEYS = {"backend", "K", "T", "model", "pallas", "kernel_rng",
                  "dispatch_floor_ms", "stages_ms", "stages_corrected_ms",
                  "stage_sum_ms", "corrected_sum_ms", "fusion_gain"}


def _tool(tmp_path, module, *args) -> dict:
    env = {**os.environ, "AUTORALLY_TPU_CACHE_DIR": str(tmp_path / "cache")}
    r = subprocess.run([sys.executable, "-m", module, *args], cwd=REPO,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    return json.loads(r.stdout.strip().splitlines()[-1])


def test_scaling_bench_keys_and_efficiency_arithmetic(tmp_path):
    res = _tool(tmp_path, "autorally_tpu_torch.tools.scaling_bench",
                "--virtual", "2", "--devices", "1,2", "--mode", "both",
                "--k-local", "64", "--k-total", "128", "--timesteps", "8",
                "--n", "2", "--batches", "1")
    assert SCALING_KEYS <= set(res)
    assert res["platform"] == "cpu" and res["virtual"] is True
    assert res["devices_present"] == 2 and res["one_dev"] == "inline"
    weak = {r["devices"]: r for r in res["weak"]}
    strong = {r["devices"]: r for r in res["strong"]}
    assert (weak[1]["K"], weak[2]["K"]) == (64, 128)
    assert strong[1]["K"] == strong[2]["K"] == 128
    for r in res["weak"] + res["strong"]:
        assert ROW_KEYS | {"ranks_per_device"} <= set(r)
        assert r["ranks_per_device"] == 1 and r["backend"] == "gloo"
        assert r["solves_per_sec"] > 0
        assert r["rollouts_per_sec"] == pytest.approx(
            r["K"] * r["solves_per_sec"], rel=0.01)
    assert weak[1]["efficiency"] == strong[1]["efficiency"] == 1.0
    assert weak[2]["efficiency"] == pytest.approx(
        weak[2]["solves_per_sec"] / weak[1]["solves_per_sec"], abs=1e-3)
    assert strong[2]["efficiency"] == pytest.approx(
        strong[2]["solves_per_sec"] / (2 * strong[1]["solves_per_sec"]),
        abs=1e-3)


@pytest.mark.parametrize("kernel_rng", [False, True],
                         ids=["host_noise", "kernel_rng"])
def test_solve_breakdown_has_the_jax_tools_stages(tmp_path, kernel_rng):
    args = ["--cpu", "--rollouts", "128", "--timesteps", "8", "--n", "2",
            "--batches", "1"] + (["--kernel-rng"] if kernel_rng else [])
    res = _tool(tmp_path, "autorally_tpu_torch.tools.solve_breakdown", *args)
    stages = set(re.findall(r'rows\["(\w+)"\]',
                            JAX_BREAKDOWN.read_text()))
    want = {s for s in stages if s.startswith("rng_") == kernel_rng
            or s in ("savitzky_golay", "nominal_traj", "slide",
                     "FULL_SOLVE")}
    assert BREAKDOWN_KEYS <= set(res)
    assert set(res["stages_ms"]) == want == set(res["stages_corrected_ms"])
    assert res["kernel_rng"] is kernel_rng and res["backend"] == "cpu"
    assert (res["K"], res["T"]) == (128, 8)
    assert res["stage_sum_ms"] == pytest.approx(
        sum(v for k, v in res["stages_ms"].items() if k != "FULL_SOLVE"),
        abs=1e-3)
    assert res["fusion_gain"] == pytest.approx(
        res["stage_sum_ms"] / res["stages_ms"]["FULL_SOLVE"], abs=0.02)
    assert all(v >= 0 for v in res["stages_corrected_ms"].values())
