"""Ensemble-vs-single closed-loop A/B under structured model error (port of
``autorally_tpu/tools/ensemble_ab.py``).

BASELINE config #5 pairs the 8-model ensemble with closed-loop eval; the
robust-MPPI lineage (RSS'18, ``params/models/README.md`` in the reference)
motivates ensembles as insurance against *structured* model error, so this
A/B injects that kind: the true plant's steering input row of the first
layer (``weights[0][4, :]``: input order [roll, u_x, u_y, yaw_der, steer,
throttle], ``neural_net_model.cu:202-230``) is scaled by an unknown gain,
i.e. the real car responds to steering differently than the nominal model
believes.

Both controllers get the SAME total rollout budget K:

- **single**: all K rollouts under the nominal model (``MPPISolver``),
- **ensemble**: K split over M members whose steering-gain hypotheses span
  ``gain_lo..gain_hi`` (member 0 = nominal, per
  :class:`~autorally_tpu_torch.solver.ensemble.EnsembleMPPISolver` block
  semantics).

Each arm runs the captured closed-loop episode
(:class:`~autorally_tpu_torch.runtime.episode.EpisodeRunner`) on the
device, ``--seeds`` episodes an arm.  Prints ONE JSON line with both arms'
lap times, speed tracking, rollout crash fraction and off-track fraction,
and their summaries (the JAX tool's keys).  The reference ``.npz`` weights
are used when the file exists, else seeded ones (``init_params(0)``); a
line on the standard error says which.  ``--track ccrf`` and ``marietta``
need the reference's textures (``FileNotFoundError`` without them).

Usage::

    python -m autorally_tpu_torch.tools.ensemble_ab [--track oval]
        [--members 8] [--rollouts 4096] [--ticks 3000] [--seeds 3] [--cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from autorally_tpu_torch.config import (REFERENCE_NN_NPZ, CostParams,
                                        MPPIConfig, resolve_device)
from autorally_tpu_torch.costs import MPPICost
from autorally_tpu_torch.models import NeuralNetDynamics
from autorally_tpu_torch.models.ensemble import stack_params
from autorally_tpu_torch.runtime.episode import EpisodeRunner
from autorally_tpu_torch.solver import EnsembleMPPISolver, MPPISolver
from autorally_tpu_torch.tools.lap_eval import episode_metrics, load_track
from autorally_tpu_torch.tools.lap_suite import load_weights

COLUMNS = {"steer": 4, "throttle": 5}    # MLP input order, nn model


def steer_gain_params(params, gain: float, column: str = "steer"):
    """Nominal params with one first-layer INPUT row scaled: a structured
    actuation-gain error.  The weights are input-major (``weights[0]`` is
    (in=6, out)), so the steering input is row 4."""
    W = list(params["weights"])
    W0 = W[0].clone()
    W0[COLUMNS[column], :] *= gain
    return {**params, "weights": [W0] + W[1:]}


def run_arm(runner, params_ctrl, cost_params, cm, start, params_true,
            seed, lap_line, crossings_per_lap, dt, boundary_threshold):
    """One episode (seeds 2 seed, 2 seed + 1): its ``episode_metrics`` and
    wall seconds."""
    t0 = time.time()
    res = runner.run(params_ctrl, cost_params, cm, start,
                     params_true=params_true,
                     seed_a=2 * seed, seed_p=2 * seed + 1)
    if runner.device.type == "cuda":
        torch.cuda.synchronize(runner.device)
    m = episode_metrics(res, cm, lap_line, crossings_per_lap, dt,
                        boundary_threshold)
    m["wall_s"] = round(time.time() - t0, 1)
    return m


def build(args, device=None):
    """The A/B's pieces from parsed flags: ``(config, arms, run_args)``;
    ``arms`` is ``[(name, runner, params_ctrl)]`` for "single" and
    "ensemble", ``run_args`` the rest of :func:`run_arm`'s arguments
    after the seed: (cost_params, costmap, start, params_true, lap_line,
    crossings_per_lap, dt, boundary_threshold)."""
    dev = resolve_device(device)
    cfg = MPPIConfig(num_rollouts=args.rollouts,
                     num_timesteps=args.timesteps)
    cm, start_pose, lap_line, xings = load_track(args.track, device=dev)
    model = NeuralNetDynamics(cfg.dt, control_ranges=cfg.control_ranges,
                              device=dev)
    params, weights = load_weights(model, REFERENCE_NN_NPZ)
    print(f"ensemble_ab: weights {weights}", file=sys.stderr)
    true_model = NeuralNetDynamics(cfg.dt, control_ranges=cfg.control_ranges,
                                   device=dev)
    params_true = steer_gain_params(params, args.true_gain, args.column)

    # member 0 = the canonical model; the remaining members span the full
    # gain_lo..gain_hi range
    gains = [1.0] + list(np.linspace(args.gain_lo, args.gain_hi,
                                     args.members - 1))
    stacked = stack_params([steer_gain_params(params, g, args.column)
                            for g in gains])
    single = MPPISolver(model, MPPICost(), cfg, device=dev)
    ens = EnsembleMPPISolver(model, MPPICost(), cfg,
                             num_members=args.members, device=dev)
    cost_params = CostParams(desired_speed=args.desired_speed)
    start = np.array([start_pose[0], start_pose[1], start_pose[2],
                      0, 0, 0, 0], dtype=np.float32)
    config = {
        "track": args.track, "K": args.rollouts, "T": args.timesteps,
        "members": args.members, "true_gain": args.true_gain,
        "column": args.column,
        "member_gains": [round(float(g), 3) for g in gains],
        "desired_speed": args.desired_speed, "ticks": args.ticks,
        "seeds": args.seeds,
    }
    arms = [(arm, EpisodeRunner(solver, true_model=true_model,
                                n_ticks=args.ticks), p_ctrl)
            for arm, solver, p_ctrl in (("single", single, params),
                                        ("ensemble", ens, stacked))]
    run_args = (cost_params, cm, start, params_true, lap_line, xings,
                cfg.dt, float(cost_params.boundary_threshold))
    return config, arms, run_args


def summarize(out: dict) -> dict:
    """Each arm's summary over its episodes, into ``out``."""
    for arm in ("single", "ensemble"):
        rows = out[arm]
        out[f"{arm}_summary"] = {
            "mean_offtrack_frac": round(
                float(np.mean([r["offtrack_frac"] for r in rows])), 4),
            "mean_speed": round(
                float(np.mean([r["mean_speed"] for r in rows])), 3),
            "total_laps": int(sum(r["laps"] for r in rows)),
            "best_lap_s": min([r["best_lap_s"] for r in rows
                               if r["best_lap_s"] is not None],
                              default=None),
        }
    return out


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ticks", type=int, default=3000)
    ap.add_argument("--rollouts", type=int, default=4096,
                    help="TOTAL rollout budget (shared by both arms)")
    ap.add_argument("--timesteps", type=int, default=100)
    ap.add_argument("--members", type=int, default=8)
    ap.add_argument("--desired-speed", type=float, default=8.0)
    ap.add_argument("--true-gain", type=float, default=0.55,
                    help="true plant's actuation gain vs the nominal model")
    ap.add_argument("--column", choices=("steer", "throttle"),
                    default="steer",
                    help="which control channel the gain error hits")
    ap.add_argument("--gain-lo", type=float, default=0.5)
    ap.add_argument("--gain-hi", type=float, default=1.2)
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--track", choices=("oval", "ccrf", "marietta"),
                    default="ccrf")
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain PyTorch path on the CPU")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    config, arms, run_args = build(args, "cpu" if args.cpu else None)
    out = {"config": config, "single": [], "ensemble": []}
    for arm, runner, p_ctrl in arms:
        for seed in range(args.seeds):
            out[arm].append(run_arm(runner, p_ctrl, *run_args[:4], seed,
                                    *run_args[4:]))
    print(json.dumps(summarize(out)))


if __name__ == "__main__":
    main()
