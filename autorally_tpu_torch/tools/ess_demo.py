"""ESS-tuner measurement harness (port of
``autorally_tpu/tools/ess_demo.py``).

Two modes, both on the reconstructed CCRF circuit at the reference
operating point (K=1920, T=100) unless overridden:

- ``--mode host``: the deployed shape — a host loop calling the solve,
  reading ``SolveStats.ess`` back each tick and feeding
  :class:`~autorally_tpu_torch.runtime.ess_tuner.EssTuner` through
  ``CostParams.gamma``.  Reports band occupancy, gamma path, solve wall
  time, and the count of CUDA-graph captures in the tuned loop
  (``count_solve_traces``: the solve runs eagerly, so it must stay 0 —
  the JAX tool counts its jit traces, which must be 1).
- ``--mode episode``: the same law carried on the device inside the
  captured episode (``EpisodeRunner(ess_target_frac=...)``) — adaptation
  with zero host involvement, at device speed.

Each mode also runs the fixed-gamma control case and prints one JSON
line with both.  ``--track`` picks another circuit than the reference's
CCRF (whose texture lives in the reference checkout:
``FileNotFoundError`` without it; ``tools/lap_eval.load_track``); the
start is the track's start pose at 2 m/s, as the JAX tool starts on CCRF.

Usage::

    python -m autorally_tpu_torch.tools.ess_demo --mode host [--cpu]
    python -m autorally_tpu_torch.tools.ess_demo --mode episode \\
        [--track oval] [--model PATH]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from autorally_tpu_torch.config import (REFERENCE_NN_NPZ, CostParams,
                                        MPPIConfig, resolve_device)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _build(args):
    from autorally_tpu_torch.costs import MPPICost
    from autorally_tpu_torch.models import NeuralNetDynamics
    from autorally_tpu_torch.solver.mppi import MPPISolver
    from autorally_tpu_torch.tools.lap_eval import load_track

    dev = resolve_device("cpu" if args.cpu else None)
    cfg = MPPIConfig(num_rollouts=args.rollouts,
                     num_timesteps=args.timesteps)
    cm, (sx, sy, heading), _, _ = load_track(args.track, device=dev)
    model = NeuralNetDynamics(cfg.dt, control_ranges=cfg.control_ranges,
                              device=dev)
    params = model.load_params(args.model)
    solver = MPPISolver(model, MPPICost(), cfg, device=dev)
    start = np.array([sx, sy, heading, 0.0, 2.0, 0.0, 0.0],
                     dtype=np.float32)
    return cfg, cm, model, params, solver, start


def run_host(args) -> dict:
    from autorally_tpu_torch.runtime.ess_tuner import EssTuner
    from autorally_tpu_torch.runtime.plant import SyntheticPlant
    from autorally_tpu_torch.runtime.profiling import count_solve_traces

    cfg, cm, model, params, solver, start = _build(args)
    traces = count_solve_traces()

    def loop(tuner):
        plant = SyntheticPlant(model, params, start, cfg.dt,
                               cfg.num_timesteps, use_feedback_gains=False)
        plant.receive_state_vector(0.0, start)
        cp = CostParams(desired_speed=args.desired_speed)
        if tuner is not None:
            cp = tuner.seed(cp)
        cs = solver.init_state()
        state = start
        ess_h, gamma_h, dt_h = [], [], []
        for _ in range(args.ticks):
            t0 = time.perf_counter()
            cs, stats = solver.solve(params, cp, cm, state, cs)
            ess = float(stats.ess)
            dt_h.append(time.perf_counter() - t0)
            ess_h.append(ess)
            if tuner is not None:
                cp = cp.replace(gamma=float(np.float32(tuner.update(ess))))
                gamma_h.append(tuner.gamma)
            plant.set_solution(cs.state_solution.cpu().numpy(),
                               cs.control_solution.cpu().numpy(), None,
                               plant.get_last_pose_time(), "actual")
            plant.step_sim(1)
            state = plant.get_state().to_vector()
            cs = solver.slide(cs, 1)
        return ess_h, gamma_h, dt_h

    warm = max(args.ticks // 8, 1)
    tuner = EssTuner(cfg, target_frac=args.target_frac)
    target = tuner.target

    def summary(ess_h, dt_h):
        e = np.asarray(ess_h[warm:])
        return {"ess_p50": float(np.median(e)),
                "ess_min": float(e.min()), "ess_max": float(e.max()),
                "band_frac": float(np.mean((e >= target / 2)
                                           & (e <= target * 2))),
                "solve_ms_p50": float(np.median(dt_h[warm:]) * 1e3)}

    ess_t, gam_t, dt_t = loop(tuner)
    traces_tuned = traces["n"]          # must be 0: the solve is eager
    ess_f, _, dt_f = loop(None)
    res = {"mode": "host", "K": cfg.num_rollouts, "T": cfg.num_timesteps,
           "ticks": args.ticks, "target_ess": target,
           "tuned": {**summary(ess_t, dt_t),
                     "gamma_final": gam_t[-1],
                     "gamma_range": [float(np.min(gam_t)),
                                     float(np.max(gam_t))]},
           "fixed": summary(ess_f, dt_f),
           "traces_tuned": traces_tuned,
           "traces_total": traces["n"]}
    print(json.dumps(res))
    return res


def run_episode(args) -> dict:
    from autorally_tpu_torch.runtime.episode import EpisodeRunner

    cfg, cm, model, params, solver, start = _build(args)
    cp = CostParams(desired_speed=args.desired_speed)
    warm = max(args.ticks // 8, 1)
    target = args.target_frac * cfg.num_rollouts
    out = {"mode": "episode", "K": cfg.num_rollouts,
           "T": cfg.num_timesteps, "ticks": args.ticks,
           "target_ess": target}
    for name, kw in (("tuned", dict(ess_target_frac=args.target_frac)),
                     ("fixed", {})):
        runner = EpisodeRunner(solver, n_ticks=args.ticks, **kw)
        res = runner.run(params, cp, cm, start)       # capture + run
        _sync(solver.device)
        t0 = time.perf_counter()
        res = runner.run(params, cp, cm, start)
        _sync(solver.device)
        dt = time.perf_counter() - t0
        ess = res.ess.cpu().numpy()[warm:]
        out[name] = {
            "ticks_per_sec": round(args.ticks / dt, 1),
            "ess_p50": float(np.median(ess)),
            "ess_band_frac": float(np.mean((ess >= target / 2)
                                           & (ess <= target * 2))),
            "gamma_final": float(res.gamma[-1]),
            "speed_p50": float(np.median(res.states.cpu().numpy()[warm:,
                                                                  4])),
        }
    print(json.dumps(out))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mode", choices=("host", "episode"), default="host")
    ap.add_argument("--ticks", type=int, default=150)
    ap.add_argument("--rollouts", type=int, default=1920)
    ap.add_argument("--timesteps", type=int, default=100)
    ap.add_argument("--target-frac", type=float, default=0.25)
    ap.add_argument("--desired-speed", type=float, default=8.0)
    ap.add_argument("--model", default=REFERENCE_NN_NPZ)
    ap.add_argument("--track", default="ccrf",
                    choices=("ccrf", "marietta", "oval", "winding"))
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    return (run_host if args.mode == "host" else run_episode)(args)


if __name__ == "__main__":
    main()
