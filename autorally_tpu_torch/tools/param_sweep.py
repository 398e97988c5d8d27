"""Vectorized cost-parameter sweep: N closed-loop episodes in one tick
(port of ``autorally_tpu/tools/param_sweep.py``).

The reference tunes cost parameters one dynamic_reconfigure slider at a
time (``costs.cu:75-87``), re-driving the car (or Gazebo) per setting.  The
JAX tool vmaps its jitted episode over a stacked ``CostParams``; here the
stacked ``CostParams`` is a lane axis of the episode
(``runtime/episode.py``): every tick is one captured CUDA graph that runs
all L settings' tube solves through the lane forms of kernel 1 (the exact
map) or kernel 3 (a ``NeuralCostmap``) and kernel 2 (two launches of each
a tick, whatever L is; ``ops/rollout_kernel.py``), the lanes sharing each
solve's noise as the JAX vmap does.  A 12-point grid
costs a fraction of twelve episodes' wall time.

Usage::

    python -m autorally_tpu_torch.tools.param_sweep \\
        --sweep desired_speed=5,6,7 --sweep speed_coeff=2.5,4.25 \\
        --ticks 800 --rollouts 512 [--track winding] [--cpu]

Each ``--sweep field=v1,v2,...`` names a :class:`CostParams` field; the
grid is the cartesian product.  The softmax temperature rides the stacked
``CostParams.gamma``, so ``--sweep gamma=0.05,0.15,0.6`` tunes it across
lanes.  Prints one JSON line per grid point (mean/max speed, distance,
crash %, mean ESS, score), best first, plus a ``BEST`` line; ``--out``
also writes the full result list as JSON.  The weights are the reference
``.npz`` at :data:`MODEL_NPZ` (a missing file raises
``FileNotFoundError``).  On the card the sweep always runs the kernels'
lane forms (``--pallas``, which picks the JAX tool's vmapped Pallas
kernels over its scan path, is accepted and changes nothing: the JAX
tool's two paths agree within 4e-10); ``--cpu`` runs their plain
versions.  Through :func:`run_sweep` (or ``EpisodeRunner.run``, which
takes ``obstacle_traj``) the sweep runs whatever episode its runner runs,
as the JAX tool's vmap does: an ``ObstacleCost`` (a stacked
``CostParams.obstacles`` (L, N, 3) gives each lane its own circles), the
runner's ESS law (a gamma a lane), moving obstacles, a ``NeuralCostmap``,
an MLP of any spec, ``matmul_precision="default"``, and the capacity mode
(a runner whose solver has ``kernel_rng=True``: the lane forms of both
capacity passes, every lane on the solve's one stream).
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import math
import sys
import time

import numpy as np
import torch

from autorally_tpu_torch.config import (REFERENCE_NN_NPZ, CostParams,
                                        MPPIConfig, resolve_device)

# The weights the tool loads (the JAX tool's REFERENCE_NN_NPZ).
MODEL_NPZ = REFERENCE_NN_NPZ


def build_grid(sweeps: dict) -> list:
    """Cartesian product of {field: [values]} as a list of dicts."""
    names = sorted(sweeps)
    return [dict(zip(names, combo))
            for combo in itertools.product(*(sweeps[n] for n in names))]


def stack_cost_params(base: CostParams, grid: list) -> CostParams:
    """Per-point ``CostParams`` stacked into one with a leading lane axis:
    each field a float32 CPU tensor (L, ...); a field that is None in every
    point stays None."""
    lanes = [base.replace(**pt) for pt in grid]
    out = {}
    for f in dataclasses.fields(CostParams):
        vals = [getattr(cp, f.name) for cp in lanes]
        if all(v is None for v in vals):
            continue
        out[f.name] = torch.stack([torch.as_tensor(
            np.asarray(v.cpu() if torch.is_tensor(v) else v, np.float32))
            for v in vals])
    return base.replace(**out)


def run_sweep(runner, params, stacked_cp, costmap, state0,
              params_true=None):
    """All lanes' episodes from ``state0`` in one run of ``runner``
    (controller seeds 0 and 1, as the JAX tool's ``init_state(0)`` /
    ``(1)``); returns the :class:`EpisodeResult` with a leading lane
    axis."""
    return runner.run(params, stacked_cp, costmap, state0,
                      params_true=params_true, seed_a=0, seed_p=1)


def lane_metrics(res, grid, settle: int = 200) -> list:
    """Host-side per-lane summary of the stacked episode telemetry."""
    states = res.states.detach().cpu().numpy()      # (L, n_ticks, S)
    crash = res.crash_frac.detach().cpu().numpy()
    ess = res.ess.detach().cpu().numpy()
    rows = []
    for i, pt in enumerate(grid):
        xy = states[i, :, :2]
        dist = float(np.linalg.norm(np.diff(xy, axis=0), axis=1).sum())
        mean_speed = float(states[i, settle:, 4].mean())
        crash_pct = float(100.0 * crash[i].mean())
        # score: progress made while staying on the track — distance
        # scaled down by the fraction of sampled rollouts crashing
        score = dist * max(0.0, 1.0 - crash_pct / 100.0)
        rows.append({
            **pt,
            "mean_speed": round(mean_speed, 3),
            "max_speed": round(float(states[i, :, 4].max()), 3),
            "distance_m": round(dist, 1),
            "crash_pct": round(crash_pct, 2),
            "mean_ess": round(float(ess[i].mean()), 1),
            "score": round(score, 1),
        })
    return rows


def _parse_sweeps(items) -> dict:
    sweeps = {}
    for it in items:
        name, _, vals = it.partition("=")
        if not vals:
            raise SystemExit(f"--sweep {it!r}: expected field=v1,v2,...")
        sweeps[name.strip()] = [float(v) for v in vals.split(",")]
    return sweeps


def build(args, device=None):
    """The sweep's pieces from parsed flags: ``(grid, runner, params,
    stacked, costmap, start)``."""
    from autorally_tpu_torch.costs import MPPICost, make_costmap
    from autorally_tpu_torch.models import NeuralNetDynamics
    from autorally_tpu_torch.runtime.episode import EpisodeRunner
    from autorally_tpu_torch.solver.mppi import MPPISolver
    from autorally_tpu_torch.tools.track_generator import (oval_track,
                                                           spline_track)

    dev = resolve_device(device)
    sweeps = _parse_sweeps(args.sweep) or {"desired_speed": [5.0, 6.0, 7.0]}
    fields = {f.name for f in dataclasses.fields(CostParams)}
    bad = [f for f in sweeps if f not in fields]
    if bad:
        raise SystemExit(f"unknown CostParams field(s): {bad}; have "
                         f"{sorted(fields)}")
    grid = build_grid(sweeps)
    cfg = MPPIConfig(num_rollouts=args.rollouts,
                     num_timesteps=args.timesteps,
                     use_pallas_rollout=True if args.pallas else False)
    if args.track == "winding":
        data, xb, yb = spline_track(track_width=6.0, ppm=10.0)
        start_pose = (0.0, 0.0, math.atan2(-2.0, 12.0))
    else:
        data, xb, yb = oval_track(half_length=30.0, half_width=18.0,
                                  track_width=6.0, ppm=10.0)
        start_pose = (30.0, 0.0, math.pi / 2)
    cm = make_costmap(data, xb, yb, device=dev)
    model = NeuralNetDynamics(cfg.dt, control_ranges=cfg.control_ranges,
                              device=dev)
    params = model.load_params(MODEL_NPZ)
    solver = MPPISolver(model, MPPICost(), cfg, device=dev)
    runner = EpisodeRunner(solver, n_ticks=args.ticks)
    start = np.array([*start_pose, 0, 0, 0, 0], dtype=np.float32)
    stacked = stack_cost_params(CostParams(), grid)
    return grid, runner, params, stacked, cm, start


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--sweep", action="append", default=[],
                    metavar="FIELD=V1,V2,...", required=False,
                    help="CostParams field values (repeatable; grid = "
                         "cartesian product)")
    ap.add_argument("--ticks", type=int, default=800)
    ap.add_argument("--rollouts", type=int, default=512)
    ap.add_argument("--timesteps", type=int, default=100)
    ap.add_argument("--track", choices=("oval", "winding"), default="oval")
    ap.add_argument("--pallas", action="store_true",
                    help="accepted for the JAX tool's command line: the "
                         "port always runs the lane forms of its kernels "
                         "on the card (the JAX tool's scan and Pallas "
                         "paths agree within 4e-10)")
    ap.add_argument("--out", default=None, help="also write JSON here")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' plain versions)")
    args = ap.parse_args(argv)

    grid, runner, params, stacked, cm, start = build(
        args, "cpu" if args.cpu else None)
    print(f"sweep: {len(grid)} grid points x {args.ticks} ticks x "
          f"K={args.rollouts} — one captured tick", file=sys.stderr)
    t0 = time.time()
    res = run_sweep(runner, params, stacked, cm, start)
    if runner.device.type == "cuda":
        torch.cuda.synchronize(runner.device)
    wall = time.time() - t0
    print(f"{len(grid)} episodes in {wall:.1f}s wall "
          f"({len(grid) * args.ticks / wall:.0f} total ticks/s)",
          file=sys.stderr)

    rows = lane_metrics(res, grid, settle=min(200, args.ticks // 4))
    for r in sorted(rows, key=lambda r: -r["score"]):
        print(json.dumps(r))
    best = max(rows, key=lambda r: r["score"])
    print("BEST " + json.dumps(best))
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"wall_s": wall, "grid": rows, "best": best}, f,
                      indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
