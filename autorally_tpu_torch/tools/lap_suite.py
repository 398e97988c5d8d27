"""Lap-benchmark suite -> the versioned ``LAPS_r*.json`` artifact (port of
``autorally_tpu/tools/lap_suite.py``).

Runs a pinned matrix of closed-loop lap configurations, each an episode on
the device (``runtime/episode.py``), and prints one machine-diffable JSON
object whose schema ``tests/test_artifacts.py::validate_laps`` checks.

Default matrix (each x ``--seeds`` seeds):

- CCRF @ 8 m/s, K=1920/T=100 — the ``path_integral_nn.launch`` point —
  under gaussian / colored(beta=1) / OU(theta=0.15) exploration,
- Marietta @ 6 m/s, K=2560 basis-function — ``path_integral_bf.launch``,
- CCRF @ 8 m/s with tube feedback gains under 10% model mismatch,
- CCRF @ 8 m/s with the predicted half of the tube at K/4.

The CCRF and Marietta maps come from the reference's Gazebo textures
(``tools/track_generator.py``); a row whose texture is absent fails with
its ``FileNotFoundError``.  The reference ``.npz`` weights are used where
they exist; otherwise the model's seeded weights (``init_params(0)``), as
stderr and every run's ``weights`` field say.

Usage: ``python -m autorally_tpu_torch.tools.lap_suite [--out
LAPS_r06.json] [--cpu]``
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

from autorally_tpu_torch.config import (REFERENCE_BF_NPZ, REFERENCE_NN_NPZ,
                                        CostParams, MPPIConfig,
                                        resolve_device)
from autorally_tpu_torch.costs import MPPICost
from autorally_tpu_torch.models import BasisFunctionDynamics, NeuralNetDynamics
from autorally_tpu_torch.runtime.episode import EpisodeRunner
from autorally_tpu_torch.solver.mppi import MPPISolver
from autorally_tpu_torch.tools.lap_eval import episode_metrics, load_track


def load_weights(model, path: str):
    """(params, note): the reference weights at ``path`` when that file
    exists, else the model's seeded ``init_params(0)``."""
    if os.path.exists(path):
        return model.load_params(path), path
    return model.init_params(0), f"seeded init_params(0); {path} not found"


def run_config(row: dict, ticks: int, seeds: int, device=None) -> list:
    """The runs of one matrix row, one episode a seed (seeds 2s, 2s + 1),
    on ``device`` (``cuda`` unless given): each run's ``episode_metrics``
    with its seed, wall seconds and weights."""
    dev = resolve_device(device)
    cfg = MPPIConfig(num_rollouts=row["K"], num_timesteps=row["T"],
                     noise_sampler=row.get("noise", "gaussian"),
                     noise_param=row.get("noise_param", 1.0))
    cm, start_pose, lap_line, xings = load_track(row["track"], device=dev)
    bf = row.get("model", "nn") == "bf"
    cls = BasisFunctionDynamics if bf else NeuralNetDynamics
    model = cls(cfg.dt, control_ranges=cfg.control_ranges, device=dev)
    params, weights = load_weights(
        model, REFERENCE_BF_NPZ if bf else REFERENCE_NN_NPZ)
    print(f"lap_suite: {row['name']}: weights {weights}", file=sys.stderr)
    true_model = cls(cfg.dt, control_ranges=cfg.control_ranges, device=dev)
    params_true = params
    if row.get("mismatch"):
        scale = 1.0 + row["mismatch"]
        params_true = ({**params, "theta": params["theta"] * scale} if bf
                       else {**params, "weights": [W * scale for W in
                                                   params["weights"]]})
    solver = MPPISolver(model, MPPICost(), cfg, device=dev)
    solver_pred = (solver.with_rollouts(row["K_pred"])
                   if row.get("K_pred") else None)
    runner = EpisodeRunner(solver, true_model=true_model, n_ticks=ticks,
                           use_feedback_gains=bool(row.get("feedback")),
                           solver_predicted=solver_pred)
    cp = CostParams(desired_speed=row["desired_speed"])
    start = [start_pose[0], start_pose[1], start_pose[2], 0, 0, 0, 0]
    out = []
    for seed in range(seeds):
        t0 = time.time()
        res = runner.run(params, cp, cm, start, params_true=params_true,
                         seed_a=2 * seed, seed_p=2 * seed + 1)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        wall = time.time() - t0
        m = episode_metrics(res, cm, lap_line, xings, cfg.dt,
                            float(cp.boundary_threshold))
        m.update(seed=seed, wall_s=round(wall, 1), weights=weights)
        out.append(m)
    return out


DEFAULT_MATRIX = [
    {"name": "ccrf_nn_gaussian", "track": "ccrf", "K": 1920, "T": 100,
     "desired_speed": 8.0, "noise": "gaussian"},
    {"name": "ccrf_nn_colored", "track": "ccrf", "K": 1920, "T": 100,
     "desired_speed": 8.0, "noise": "colored", "noise_param": 1.0},
    {"name": "ccrf_nn_ou", "track": "ccrf", "K": 1920, "T": 100,
     "desired_speed": 8.0, "noise": "ou", "noise_param": 0.15},
    {"name": "marietta_bf_gaussian", "track": "marietta", "K": 2560,
     "T": 100, "desired_speed": 6.0, "model": "bf"},
    {"name": "ccrf_nn_tube_mismatch10", "track": "ccrf", "K": 1920,
     "T": 100, "desired_speed": 8.0, "feedback": True, "mismatch": 0.1},
    # asymmetric tube budgets: lap quality with the predicted half at K/4
    {"name": "ccrf_nn_asym_kpred4x", "track": "ccrf", "K": 1920,
     "K_pred": 480, "T": 100, "desired_speed": 8.0},
]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None,
                    help="also write the artifact here (stdout always)")
    ap.add_argument("--ticks", type=int, default=3000)
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--round", type=int, default=5)
    ap.add_argument("--only", default=None,
                    help="comma-separated config names to run")
    ap.add_argument("--smoke", action="store_true",
                    help="shrink K/T so the suite runs in seconds on the "
                         "CPU (schema/plumbing checks, not perf evidence)")
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain PyTorch path on the CPU")
    args = ap.parse_args(argv)

    matrix = DEFAULT_MATRIX
    if args.only:
        names = set(args.only.split(","))
        matrix = [r for r in matrix if r["name"] in names]
    if args.smoke:
        matrix = [{**r, "K": 256, "T": 32,
                   **({"K_pred": 64} if r.get("K_pred") else {})}
                  for r in matrix]

    artifact = {"artifact": "laps", "round": args.round,
                "ticks": args.ticks, "seeds": args.seeds,
                "smoke": bool(args.smoke), "rows": []}
    for row in matrix:
        runs = run_config(row, args.ticks, args.seeds,
                          device="cpu" if args.cpu else None)
        artifact["rows"].append({**row, "weights": runs[0]["weights"],
                                 "runs": runs})
    text = json.dumps(artifact)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")


if __name__ == "__main__":
    main()
