"""Lap-time benchmark on the port: closed-loop laps at the device's speed
(the port's ``examples/lap_benchmark.py``).

The reference's quantitative evaluation is ``lap_stats.py`` — lap time,
max speed, max slip per lap.  Here the whole tube-MPPI closed loop (dual
controllers, arbitration, plant propagation) runs on the device as the
captured episode of :class:`~autorally_tpu_torch.runtime.episode.
EpisodeRunner`, and the same start-line-crossing lap detector scores the
trajectory.  The reference ``.npz`` weights are used where ``--model``
names an existing file (by default the model's reference file); otherwise
seeded weights, and the first line says which.  The JAX example's
``--plot`` is not ported: it needs matplotlib, which is not a dependency
of the port.

Usage::

    python -m autorally_tpu_torch.lap_benchmark [--ticks 4000]
        [--rollouts 1920] [--track oval|winding|ccrf|marietta] [--bf]
        [--feedback] [--ess-target FRAC] [--cpu] ...
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from autorally_tpu_torch.config import (REFERENCE_BF_NPZ, REFERENCE_NN_NPZ,
                                        CostParams, MPPIConfig,
                                        resolve_device)
from autorally_tpu_torch.costs import MPPICost
from autorally_tpu_torch.models import BasisFunctionDynamics, NeuralNetDynamics
from autorally_tpu_torch.runtime.episode import EpisodeRunner
from autorally_tpu_torch.runtime.telemetry import LapStats
from autorally_tpu_torch.solver.mppi import MPPISolver
from autorally_tpu_torch.tools.lap_eval import load_track
from autorally_tpu_torch.tools.lap_suite import load_weights


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ticks", type=int, default=4000)
    ap.add_argument("--rollouts", type=int, default=1920)
    ap.add_argument("--pred-rollouts", type=int, default=None,
                    help="asymmetric tube: rollout count for the "
                         "predicted-state controller (default: same as "
                         "--rollouts)")
    ap.add_argument("--timesteps", type=int, default=100)
    ap.add_argument("--desired-speed", type=float, default=6.0)
    ap.add_argument("--seed", type=int, default=0,
                    help="episode seed pair = (2*seed, 2*seed+1); a new "
                         "seed replays the captured episode")
    ap.add_argument("--ess-target", type=float, default=None,
                    metavar="FRAC",
                    help="adaptive softmax temperature holding ESS at "
                         "FRAC*K inside the episode (the EssTuner law)")
    ap.add_argument("--feedback", action="store_true",
                    help="apply DDP feedback gains K(x - x_des) through the "
                         "interpolated publication pipeline "
                         "(autorally_plant.cpp:215-250)")
    ap.add_argument("--pose-substeps", type=int, default=1,
                    help="plant integration substeps per control tick "
                         "(pose rate / control rate)")
    ap.add_argument("--mismatch", type=float, default=0.0,
                    help="scale the true-plant model weights by (1+x) to "
                         "study tube feedback under model error")
    ap.add_argument("--bf", action="store_true",
                    help="basis-function dynamics (path_integral_bf role)")
    ap.add_argument("--model", default=None,
                    help="reference .npz weights (default: the model's "
                         "reference file; seeded weights when missing)")
    ap.add_argument("--noise", choices=("gaussian", "colored", "ou"),
                    default="gaussian",
                    help="exploration-noise sampler (ops/sampling.py)")
    ap.add_argument("--noise-param", type=float, default=1.0,
                    help="beta for colored noise / theta for OU")
    ap.add_argument("--track",
                    choices=("oval", "winding", "ccrf", "marietta"),
                    default="oval",
                    help="'winding' = synthetic spline circuit; 'ccrf' / "
                         "'marietta' = the real circuits from the "
                         "reference's Gazebo textures")
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain PyTorch path on the CPU")
    args = ap.parse_args(argv)

    dev = resolve_device("cpu" if args.cpu else None)
    cfg = MPPIConfig(num_rollouts=args.rollouts,
                     num_timesteps=args.timesteps,
                     noise_sampler=args.noise,
                     noise_param=args.noise_param)
    cm, start_pose, lap_line, crossings_per_lap = load_track(args.track,
                                                             device=dev)
    cls = BasisFunctionDynamics if args.bf else NeuralNetDynamics
    model = cls(cfg.dt, control_ranges=cfg.control_ranges, device=dev)
    params, weights = load_weights(model, args.model or (
        REFERENCE_BF_NPZ if args.bf else REFERENCE_NN_NPZ))
    true_model = cls(cfg.dt / args.pose_substeps,
                     control_ranges=cfg.control_ranges, device=dev)
    solver = MPPISolver(model, MPPICost(), cfg, device=dev)
    solver_pred = (solver.with_rollouts(args.pred_rollouts)
                   if args.pred_rollouts is not None else None)
    runner = EpisodeRunner(solver, true_model=true_model,
                           n_ticks=args.ticks,
                           use_feedback_gains=args.feedback,
                           pose_substeps=args.pose_substeps,
                           ess_target_frac=args.ess_target,
                           solver_predicted=solver_pred)
    params_true = params
    if args.mismatch:
        scale = 1 + args.mismatch
        params_true = ({**params, "theta": params["theta"] * scale}
                       if args.bf else
                       {**params, "weights": [W * scale for W in
                                              params["weights"]]})
    print(f"model weights: {weights}")
    print(f"feedback_gains={args.feedback} pose_substeps="
          f"{args.pose_substeps} mismatch={args.mismatch} "
          f"noise={args.noise}"
          + (f"({args.noise_param})" if args.noise != "gaussian" else ""))

    start = np.array([start_pose[0], start_pose[1], start_pose[2],
                      0, 0, 0, 0], dtype=np.float32)
    cost_params = CostParams(desired_speed=args.desired_speed)

    t0 = time.time()
    res = runner.run(params, cost_params, cm, start, params_true=params_true,
                     seed_a=2 * args.seed, seed_p=2 * args.seed + 1)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.time() - t0
    sim_s = args.ticks * cfg.dt
    print(f"{args.ticks} control ticks ({sim_s:.0f} sim-seconds) in "
          f"{wall:.1f}s wall — {args.ticks/wall:.0f} closed-loop ticks/s "
          f"({sim_s/wall:.1f}x realtime"
          + ("; the capture included)" if dev.type == "cuda" else ")"))

    states = res.states.cpu().numpy()
    used = res.used_actual.cpu().numpy()
    laps = LapStats(line=lap_line)
    for i, s in enumerate(states):
        rec = laps.process_pose(i * cfg.dt, s[0], s[1], s[4], s[5])
        if rec:
            print(f"  crossing {rec.lap_number}: segment {rec.lap_time:.2f}s "
                  f"max_speed={rec.max_speed:.2f} m/s "
                  f"max_slip={rec.max_slip:.3f} rad")
    # oval/winding: the line is crossed twice per circuit (out and back);
    # ccrf/marietta: once
    segs = [r.lap_time for r in laps.laps]
    if crossings_per_lap == 1:
        full_laps = segs
    else:
        full_laps = [segs[i] + segs[i + 1]
                     for i in range(0, len(segs) - 1, 2)]
    if full_laps:
        print(f"LAPS: {len(full_laps)}  times: "
              f"{['%.2fs' % t for t in full_laps]}")
    settle = min(200, len(states) // 2)       # skip the standing start
    print(f"speed: mean {states[settle:, 4].mean():.2f} "
          f"max {states[:, 4].max():.2f} m/s (desired {args.desired_speed})")
    print(f"controller usage: actual {int(used.sum())}"
          f" / predicted {args.ticks - int(used.sum())}")
    print(f"mean ESS {float(res.ess.cpu().numpy().mean()):.0f}  "
          f"mean crash% "
          f"{100 * float(res.crash_frac.cpu().numpy().mean()):.1f}")
    if args.ess_target is not None:
        g = res.gamma.cpu().numpy()
        print(f"adaptive gamma: {g[0]:.3f} -> {g[-1]:.3f} "
              f"(range {g.min():.3f}-{g.max():.3f}, "
              f"target ESS {args.ess_target * cfg.num_rollouts:.0f})")


if __name__ == "__main__":
    main()
