"""Closed-loop MPPI demo on the port: drive the car around a synthetic oval.

The port's ``examples/drive_oval.py``: MPPI replanning at 50 Hz, executing
the first control of each plan on a synthetic plant integrated with the
same model (the reference's ``debug_mode`` self-propagation,
``run_control_loop.cuh:296-302``).  Loads ``--model`` when that file
exists, otherwise uses seeded weights, and says which.  ``--bf`` drives the
25-basis-function model (``path_integral_bf``: K=2560 by default).
``--neural-costmap`` distils the track into a neural field on the device
(``fit_neural_costmap``'s defaults) and prices the rollouts on it.
``--obstacles 'x,y,r;x,y,r'`` adds circular obstacles (``ObstacleCost``,
coefficient 150, inflation 0.75 m, as ``examples/drive_oval.py``).

Usage::

    python -m autorally_tpu_torch.drive_oval [--steps 300] [--cpu]
        [--model PATH] [--rollouts K] [--bf] [--neural-costmap]
        [--obstacles 'x,y,r;...']
"""

from __future__ import annotations

import argparse
import math
import os
import time

import numpy as np
import torch

from autorally_tpu_torch.config import (REFERENCE_BF_NPZ, REFERENCE_NN_NPZ,
                                        CostParams, MPPIConfig,
                                        resolve_device)
from autorally_tpu_torch.costs import (MPPICost, ObstacleCost,
                                       fit_neural_costmap, make_costmap,
                                       make_obstacles)
from autorally_tpu_torch.models import BasisFunctionDynamics, NeuralNetDynamics
from autorally_tpu_torch.solver.mppi import MPPISolver
from autorally_tpu_torch.tools.track_generator import oval_track

# Start on the right side of the oval, pointing up (+y), at rest.
START = (30.0, 0.0, math.pi / 2, 0.0, 0.0, 0.0, 0.0)

# model -> (class, default rollouts, reference weights, seeded init's name):
# BASELINE configs #1 (path_integral_nn, K=1920) and #2 (path_integral_bf,
# K=2560).
MODELS = {"nn": (NeuralNetDynamics, 1920, REFERENCE_NN_NPZ, "Glorot init"),
          "bf": (BasisFunctionDynamics, 2560, REFERENCE_BF_NPZ,
                 "theta ~ N(0, 0.01^2)")}
# The obstacle band of examples/drive_oval.py, tuned for the 6 m lane.
OBSTACLE_COEFF, OBSTACLE_INFLATION = 150.0, 0.75


def oval_costmap(device=None):
    """The demo's oval: half-length 30 m, half-width 18 m, 6 m wide,
    10 px/m, a 560 x 800 map."""
    data, xb, yb = oval_track(half_length=30.0, half_width=18.0,
                              track_width=6.0, ppm=10.0)
    return make_costmap(data, xb, yb, device=device)


def build(rollouts: int = None, desired_speed: float = 6.0,
          model_path: str = None, device=None, neural_costmap: bool = False,
          fit_kwargs=None, model: str = "nn", obstacles=None, cfg=None,
          cost_params=None):
    """The demo's (solver, params, cost_params, costmap, note): the
    ``path_integral_nn`` configuration (``model="nn"``, K=1920) or the
    ``path_integral_bf`` one (``model="bf"``, K=2560) on the 560 x 800 oval
    map, or, with ``neural_costmap``, on a field fitted to it on the device
    (``fit_neural_costmap(costmap, **fit_kwargs)``; the note gives the
    fit's quality).  ``obstacles``: circles [[x, y, r], ...] priced by an
    ``ObstacleCost`` (16 slots, the demo's coefficients).  ``cfg`` and
    ``cost_params``, when given, replace the demo's (T=100 and K
    ``rollouts``; ``desired_speed``): ``run_tube_mppi`` passes a launch
    file's or its own."""
    dev = resolve_device(device)
    cls, default_k, default_path, init_name = MODELS[model]
    rollouts = default_k if rollouts is None else rollouts
    model_path = default_path if model_path is None else model_path
    if cfg is None:
        cfg = MPPIConfig(num_rollouts=rollouts, num_timesteps=100, hz=50)
    if cost_params is None:
        cost_params = CostParams(desired_speed=desired_speed)
    costmap = oval_costmap(dev)
    fit_note = ""
    if neural_costmap:
        costmap, metrics = fit_neural_costmap(costmap, device=dev,
                                              **(fit_kwargs or {}))
        fit_note = (f"\nneural costmap fit: mae={metrics['mae']:.3f} "
                    f"boundary_flip_rate="
                    f"{metrics['boundary_flip_rate']:.3%}")
    dyn = cls(cfg.dt, control_ranges=cfg.control_ranges, device=dev)
    if model_path and os.path.exists(model_path):
        params = dyn.load_params(model_path)
        note = f"model weights: {model_path}"
    else:
        params = dyn.init_params(0)
        note = (f"model weights: seeded {init_name} (seed 0); "
                f"{model_path} not found")
    if obstacles is None:
        cost = MPPICost(cfg.l1_cost)
    else:
        cost = ObstacleCost(make_obstacles(obstacles, device=dev),
                            OBSTACLE_COEFF, OBSTACLE_INFLATION, cfg.l1_cost)
        note += f"\nobstacles: {[list(map(float, c)) for c in obstacles]}"
    solver = MPPISolver(dyn, cost, cfg, device=dev)
    return solver, params, cost_params, costmap, note + fit_note


def drive(solver, params, cost_params, costmap, steps: int, log=print,
          tick_params=None):
    """Run ``steps`` ticks of slide + solve + plant step after one untimed
    first solve.  ``tick_params(step, state)``, when given, returns each
    tick's ``CostParams`` (the live-update path: moving obstacles through
    ``CostParams.obstacles``, as ``examples/two_car_demo.py`` does).
    Returns a dict of the run's results (per-tick solve latencies in ms,
    laps, final state, last stats, and the controller state after the last
    solve)."""
    cfg, model = solver.cfg, solver.model
    cs = solver.init_state()
    state = np.array(START, dtype=np.float32)

    t0 = time.perf_counter()
    cs, _ = solver.solve(params, cost_params, costmap, state, cs)
    cs.control_solution[0].cpu()
    log(f"first solve: {time.perf_counter() - t0:.3f}s")

    prev_angle = math.atan2(state[1], state[0])
    total_angle = 0.0
    solve_ms, controls = [], []
    stats = None
    for step in range(steps):
        if tick_params is not None:
            cost_params = tick_params(step, state)
        t0 = time.perf_counter()
        cs = solver.slide(cs, cfg.optimization_stride)
        cs, stats = solver.solve(params, cost_params, costmap, state, cs)
        u = cs.control_solution[0].cpu().numpy()            # waits for the solve
        solve_ms.append((time.perf_counter() - t0) * 1e3)
        controls.append(u)

        # synthetic plant: integrate the model (debug-mode self-propagation)
        s_next, _ = model.update_state(
            params, torch.as_tensor(state, device=solver.device),
            torch.as_tensor(u, device=solver.device))
        state = s_next.cpu().numpy()

        angle = math.atan2(state[1], state[0])
        d = angle - prev_angle
        if d > math.pi:
            d -= 2 * math.pi
        elif d < -math.pi:
            d += 2 * math.pi
        total_angle += d
        prev_angle = angle

        if step % 50 == 0 or step == steps - 1:
            log(f"step {step:4d}  pos=({state[0]:+7.2f},{state[1]:+7.2f}) "
                f"speed={state[4]:5.2f} m/s  steer={u[0]:+.3f} "
                f"throttle={u[1]:+.3f}  "
                f"traj_cost={float(stats.trajectory_cost):9.1f} "
                f"ess={float(stats.ess):7.1f} "
                f"crash%={float(stats.crash_frac) * 100:4.1f}")
    return {"solve_ms": np.array(solve_ms), "controls": np.array(controls),
            "laps": abs(total_angle) / (2 * math.pi), "state": state,
            "stats": stats, "control_state": cs}


def parse_circles(text: str):
    """'x,y,r;x,y,r' -> [[x, y, r], ...] (ValueError on a malformed one)."""
    circles = [[float(v) for v in c.split(",")]
               for c in text.split(";") if c.strip()]
    if not circles or any(len(c) != 3 for c in circles):
        raise ValueError("each circle needs exactly x,y,r")
    return circles


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain PyTorch path on the CPU")
    ap.add_argument("--model", default=None,
                    help="reference .npz weights (default: the model's "
                         "reference file; seeded weights when missing)")
    ap.add_argument("--rollouts", type=int, default=None,
                    help="K (default 1920, or 2560 with --bf)")
    ap.add_argument("--desired-speed", type=float, default=6.0)
    ap.add_argument("--bf", action="store_true",
                    help="use the 25-basis-function dynamics model "
                         "(path_integral_bf)")
    ap.add_argument("--neural-costmap", action="store_true",
                    help="distil the track into a neural field and price "
                         "the rollouts on it (the fused field kernel)")
    ap.add_argument("--obstacles", default=None,
                    help="semicolon-separated circles 'x,y,r;x,y,r' priced "
                         "in the fused kernels")
    args = ap.parse_args()
    try:
        circles = (None if args.obstacles is None
                   else parse_circles(args.obstacles))
    except ValueError as e:
        ap.error(f"--obstacles expects 'x,y,r;x,y,r': {e}")

    solver, params, cost_params, costmap, note = build(
        args.rollouts, args.desired_speed, args.model,
        device="cpu" if args.cpu else None,
        neural_costmap=args.neural_costmap,
        model="bf" if args.bf else "nn", obstacles=circles)
    print(note)
    out = drive(solver, params, cost_params, costmap, args.steps)
    st = out["solve_ms"][1:] if len(out["solve_ms"]) > 1 else out["solve_ms"]
    print(f"\nlaps completed: {out['laps']:.2f}")
    print(f"solve latency: mean {st.mean():.2f} ms  p50 "
          f"{np.percentile(st, 50):.2f} p99 {np.percentile(st, 99):.2f} ms  "
          f"({1000.0 / st.mean():.0f} solves/s; 20 ms budget @ 50 Hz)")
    print(f"final speed: {out['state'][4]:.2f} m/s "
          f"(desired {args.desired_speed})")


if __name__ == "__main__":
    main()
