"""Two-vehicle interaction demo on the port: mutual avoidance via live
obstacles (the twin of ``examples/two_car_demo.py``).

The reference's multi-vehicle story is XBee pose sharing between cars
(``autorally_core/src/xbee/``) with no planner integration.  Here the
shared pose closes the loop: each car runs its own tube-MPPI solver and
treats the other as live circular obstacles placed along its
constant-velocity prediction, updated every tick through
``CostParams.obstacles`` (the fused kernels price them; nothing is rebuilt).
Scenarios:

- ``--scenario follow`` (default): a slow leader on the racing line, a
  fast follower closing from behind.  The follower yields and keeps a safe
  gap (adaptive-cruise-like) — vanilla MPPI has no lane-change prior, so it
  follows rather than commits to a pass.
- ``--scenario pass``: the leader is DISABLED (parked on the racing line);
  the follower must plan around it and continue.

The weights are the reference ``.npz`` at :data:`MODEL_NPZ` (a missing
file raises ``FileNotFoundError``).

Usage::

    python -m autorally_tpu_torch.two_car_demo [--scenario pass]
        [--no-avoid] [--cpu]
"""

from __future__ import annotations

import argparse
import math

import numpy as np
import torch

from autorally_tpu_torch.config import REFERENCE_NN_NPZ, resolve_device

# The weights the demo loads (the JAX example's MODEL_NPZ).
MODEL_NPZ = REFERENCE_NN_NPZ

CAR_RADIUS = 0.6      # physical circle around ONE vehicle (m)
# Planner circles use the Minkowski sum of both cars' extents: the crash
# latch fires at margin <= 0, i.e. CENTER distance <= radius, and two
# cars of radius r physically collide at center distance 2r.
OBS_RADIUS = 2 * CAR_RADIUS


def run_two_cars(ticks=900, rollouts=256, timesteps=40, desired_speed=5.0,
                 slow_speed=2.0, avoid=True, seed=0, parked=False,
                 device=None):
    """Host-loop two-car scenario on ``device`` (``cuda`` unless given
    another); returns (states_a, states_b) arrays of shape (ticks, 7) — A
    fast (desired_speed), B slow (slow_speed) or parked (``parked=True``:
    B never moves — the disabled vehicle)."""
    from autorally_tpu_torch.config import CostParams, MPPIConfig
    from autorally_tpu_torch.costs import (MPPICost, ObstacleCost,
                                           make_costmap, make_obstacles)
    from autorally_tpu_torch.models import NeuralNetDynamics
    from autorally_tpu_torch.solver.mppi import MPPISolver
    from autorally_tpu_torch.tools.track_generator import oval_track

    dev = resolve_device(device)
    cfg = MPPIConfig(num_rollouts=rollouts, num_timesteps=timesteps)
    data, xb, yb = oval_track(half_length=30.0, half_width=18.0,
                              track_width=8.0, ppm=4.0)
    cm = make_costmap(data, xb, yb, device=dev)
    model = NeuralNetDynamics(cfg.dt, control_ranges=cfg.control_ranges,
                              device=dev)
    params = model.load_params(MODEL_NPZ)

    if avoid:
        cost = ObstacleCost(make_obstacles([], capacity=4, device=dev),
                            obstacle_coeff=300.0, inflation=1.5)
    else:
        cost = MPPICost()
    solver_a = MPPISolver(model, cost, cfg, device=dev)
    solver_b = MPPISolver(model, cost, cfg, device=dev)
    cp_a = CostParams(desired_speed=desired_speed)
    cp_b = CostParams(desired_speed=slow_speed)

    # both counter-clockwise; B starts ~13 m ahead of A along the ellipse
    # centerline (theta=0.45 rad), cruising slow — A closes in and has to
    # go around.  Ellipse point (30 cos t, 18 sin t), CCW tangent heading.
    th = 0.45
    bx, by = 30.0 * math.cos(th), 18.0 * math.sin(th)
    byaw = math.atan2(18.0 * math.cos(th), -30.0 * math.sin(th))
    s_a = np.array([30.0, 0.0, math.pi / 2, 0, 2.0, 0, 0], dtype=np.float32)
    s_b = np.array([bx, by, byaw, 0, slow_speed, 0, 0], dtype=np.float32)
    cs_a = solver_a.init_state(seed)
    cs_b = solver_b.init_state(seed + 1)

    horizon_s = timesteps * cfg.dt

    def other_obstacle(cp, s_self, s_other):
        """Circles along the other car's constant-velocity prediction —
        a static circle is wrong by v*T over the horizon, so cover the
        swept path at t = 0, T/2, T.  A car BEHIND me is ignored (the
        trailing vehicle owns the avoidance — the mirror rule; otherwise
        the leader sees the follower's prediction cone sweep over it and
        brakes for traffic it should ignore)."""
        if not avoid:
            return cp
        # always four slots (inactive = radius -1), as the JAX example
        # keeps its CostParams' structure from tick to tick
        obs = np.full((4, 3), -1.0, dtype=np.float32)
        bearing = math.atan2(s_other[1] - s_self[1],
                             s_other[0] - s_self[0]) - s_self[2]
        if math.cos(bearing) >= 0.0:           # ignore a car behind me
            yaw, ux, uy = s_other[2], s_other[4], s_other[5]
            vx = math.cos(yaw) * ux - math.sin(yaw) * uy
            vy = math.sin(yaw) * ux + math.cos(yaw) * uy
            for i, frac in enumerate((0.0, 0.5, 1.0)):
                obs[i] = [s_other[0] + vx * frac * horizon_s,
                          s_other[1] + vy * frac * horizon_s, OBS_RADIUS]
        return cp.replace(obstacles=torch.from_numpy(obs).to(dev))

    def step(s, cs):
        u = cs.control_solution[0]
        return model.update_state(params, torch.from_numpy(s).to(dev),
                                  u)[0].cpu().numpy()

    if parked:
        s_b[4] = 0.0                       # disabled vehicle: at rest

    states_a, states_b = [], []
    for _ in range(ticks):
        cs_a = solver_a.slide(cs_a, cfg.optimization_stride)
        cs_a, _ = solver_a.solve(params, other_obstacle(cp_a, s_a, s_b), cm,
                                 s_a, cs_a)
        s_a = step(s_a, cs_a)
        if not parked:
            cs_b = solver_b.slide(cs_b, cfg.optimization_stride)
            cs_b, _ = solver_b.solve(params, other_obstacle(cp_b, s_b, s_a),
                                     cm, s_b, cs_b)
            s_b = step(s_b, cs_b)
        states_a.append(s_a)
        states_b.append(s_b.copy())
    return np.asarray(states_a), np.asarray(states_b)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ticks", type=int, default=900)
    ap.add_argument("--rollouts", type=int, default=256)
    ap.add_argument("--timesteps", type=int, default=40)
    ap.add_argument("--desired-speed", type=float, default=5.0)
    ap.add_argument("--slow-speed", type=float, default=2.0)
    ap.add_argument("--scenario", choices=("follow", "pass"),
                    default="follow")
    ap.add_argument("--no-avoid", action="store_true",
                    help="drop the mutual-obstacle term (baseline)")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)

    sa, sb = run_two_cars(ticks=args.ticks, rollouts=args.rollouts,
                          timesteps=args.timesteps,
                          desired_speed=args.desired_speed,
                          slow_speed=args.slow_speed,
                          avoid=not args.no_avoid,
                          parked=(args.scenario == "pass"),
                          device="cpu" if args.cpu else None)
    d = np.hypot(sa[:, 0] - sb[:, 0], sa[:, 1] - sb[:, 1])
    i_min = int(np.argmin(d))
    # progress around the oval = unwrapped angle; A passing B shows as
    # A's final angle exceeding B's
    ang = lambda s: np.unwrap(np.arctan2(s[:, 1] / 18.0, s[:, 0] / 30.0))
    passed = ang(sa)[-1] > ang(sb)[-1]
    print(f"scenario={args.scenario} "
          f"avoidance={'ON' if not args.no_avoid else 'OFF'}")
    print(f"min inter-car distance: {d.min():.2f} m at tick {i_min} "
          f"(A at ({sa[i_min,0]:.1f},{sa[i_min,1]:.1f}), "
          f"B at ({sb[i_min,0]:.1f},{sb[i_min,1]:.1f}))")
    if args.scenario == "pass":
        print(f"passed the disabled vehicle: {passed}")
    else:
        gap = d[len(d) // 2:]
        print(f"following gap (2nd half): min {gap.min():.2f} "
              f"mean {gap.mean():.2f} m — collision-free: "
              f"{bool(d.min() > 2 * CAR_RADIUS)}")
    print(f"mean speeds: A {sa[100:,4].mean():.2f}  B {sb[100:,4].mean():.2f}"
          f" m/s (desired A {args.desired_speed} / B {args.slow_speed})")


if __name__ == "__main__":
    main()
