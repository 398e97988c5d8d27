"""The closed ML loop on the port: drive -> log -> train -> hot-swap -> drive
better (port of ``examples/ml_loop_demo.py``).

The reference splits this across rosbag record, the ml_pipeline scripts and
a controller restart with the new ``.npz``.  Here the whole cycle runs in
one process against the independent four-wheel physics simulator
(``sim/``), so the data is honest: the dynamics model never sees its own
rollouts as ground truth.

1. **Drive** the oval in lockstep with the physics plant (the tube loop's
   two controllers, no feedback gains), writing the sim-node-format
   multi-topic JSONL log (ground truth with a quaternion orientation,
   chassis commands at half rate, wheel speeds at a fifth).
2. **Ingest + train**: the multi-topic pipeline (``ml/ingest.py``) merges
   the log, and the dynamics MLP is fine-tuned on it (``ml/train.py``)
   from the driving weights.
3. **Hot-swap** the trained weights into the running loop through the
   plant's update queue (``push_model_params``; nothing is rebuilt), and
   drive again.
4. **Compare**: speed-tracking error and one-step prediction RMSE, before
   and after.

The controllers and the physics run on the card unless ``--cpu`` is given.
The model is the reference ``.npz`` when it exists, else seeded weights
(Glorot, seed 0), and the demo says which.

Run::

    python -m autorally_tpu_torch.ml_loop_demo [--ticks 1500] [--epochs 60]
        [--rollouts 768] [--timesteps 60] [--cpu]
"""

from __future__ import annotations

import argparse
import json
import math
import os
import tempfile
import time

import numpy as np

from autorally_tpu_torch.config import (REFERENCE_NN_NPZ, CostParams,
                                        MPPIConfig, resolve_device)
from autorally_tpu_torch.tools.sim_node import log_topics

START = (30.0, 0.0, math.pi / 2, 0.0, 0.0, 0.0, 0.0)
FEATURES = ["roll", "u_x", "u_y", "yaw_mder", "steering", "throttle"]
LABELS = ["roll_der", "u_x_der", "u_y_der", "yaw_mder_der"]


def write_log_record(f, t, s7, u, wheels, i):
    """One sim-node-format multi-topic tick (``tools/sim_node.py --log``)."""
    log_topics(f, i, t, s7, u, wheels)


class MLLoop:
    """The demo's loop: the oval (``drive_oval.oval_costmap``), a
    6-32-32-4 MLP solver at K ``rollouts`` and T ``timesteps``, the two
    controllers of the tube loop (the predicted one seeded 7) and the
    physics plant from :data:`START`, all on ``device``.  ``params0``
    replaces the model's weights (else the reference ``.npz`` when it
    exists, else seeded ones); ``note`` says which."""

    def __init__(self, rollouts: int = 768, timesteps: int = 60,
                 desired_speed: float = 6.0, device=None, params0=None,
                 model_path: str = REFERENCE_NN_NPZ, cfg=None,
                 model=None):
        from autorally_tpu_torch.costs import MPPICost
        from autorally_tpu_torch.drive_oval import oval_costmap
        from autorally_tpu_torch.models import NeuralNetDynamics
        from autorally_tpu_torch.runtime import Controller
        from autorally_tpu_torch.sim import SimVehiclePlant
        from autorally_tpu_torch.solver.mppi import MPPISolver

        self.device = resolve_device(device)
        self.cfg = cfg or MPPIConfig(num_rollouts=rollouts,
                                     num_timesteps=timesteps)
        self.desired_speed = desired_speed
        self.model = model or NeuralNetDynamics(
            self.cfg.dt, control_ranges=self.cfg.control_ranges,
            device=self.device)
        if params0 is not None:
            self.note = "model weights: given"
        elif model_path and os.path.exists(model_path):
            params0 = self.model.load_params(model_path)
            self.note = f"model weights: {model_path}"
        else:
            params0 = self.model.init_params(0)
            self.note = "model weights: seeded Glorot init (seed 0)" + (
                f"; {model_path} not found" if model_path else "")
        self.params0 = params0
        self.solver = MPPISolver(self.model, MPPICost(self.cfg.l1_cost),
                                 self.cfg, device=self.device)
        cost_params = CostParams(desired_speed=desired_speed)
        costmap = oval_costmap(self.device)
        self.actual = Controller(self.solver, params0, cost_params, costmap)
        self.predicted = Controller(self.solver, params0, cost_params,
                                    costmap, seed=7)
        start = np.array(START, dtype=np.float32)
        self.plant = SimVehiclePlant(start, self.cfg.dt,
                                     self.cfg.num_timesteps,
                                     device=self.device,
                                     use_feedback_gains=False,
                                     throttle_max=self.cfg.max_throttle)
        self.plant.receive_state_vector(0.0, start)

    def drive(self, ticks: int, logf=None) -> dict:
        """``ticks`` lockstep ticks of ``run_control_loop`` (each tick's
        record written to ``logf`` when given).  Returns the mean speed and
        speed error after the first fifth (the launch transient), the
        path the car covered (m), the wall seconds and the loop's
        ``TimingStats``."""
        from autorally_tpu_torch.runtime import (ControlLoopConfig,
                                                 run_control_loop)

        plant = self.plant
        speeds, errs, xy = [], [], [plant.true_state[:2]]

        def on_tick(i, chosen, used, state):
            xy.append(plant.true_state[:2])
            speeds.append(float(state[4]))
            errs.append(abs(float(state[4]) - self.desired_speed))
            if logf is not None and plant.published:
                u = plant.published[-1][1:3]
                write_log_record(logf, plant.sim_time, plant.true_state,
                                 u, plant.wheel_speeds(), i)

        lcfg = ControlLoopConfig(hz=self.cfg.hz,
                                 num_timesteps=self.cfg.num_timesteps,
                                 use_feedback_gains=False, max_iter=ticks)
        t0 = time.perf_counter()
        timing = run_control_loop(self.predicted, self.actual, plant, lcfg,
                                  on_tick=on_tick)
        wall = time.perf_counter() - t0
        warm = len(speeds) // 5          # skip the launch transient
        return {"mean_speed": float(np.mean(speeds[warm:])),
                "mean_speed_err": float(np.mean(errs[warm:])),
                "path_m": float(np.linalg.norm(np.diff(xy, axis=0),
                                               axis=1).sum()),
                "ticks": len(speeds), "wall_s": wall, "timing": timing}

    def fine_tune(self, log_path: str, epochs: int) -> dict:
        """Ingest the log and fine-tune the driving weights on it.  Returns
        the trained weights (``params1``), the one-step RMSE of the old and
        the new weights on the whole log, and its rows."""
        from autorally_tpu_torch.ml import (DynamicsDataset, TrainConfig,
                                            ingest_log,
                                            instantaneous_errors,
                                            train_dynamics)

        df = ingest_log(log_path)
        feats = df.to_numpy(FEATURES)
        labels = df.to_numpy(LABELS)
        train, val = DynamicsDataset(feats, labels).split(0.2, 0)
        rmse0 = instantaneous_errors(self.model, self.params0, feats,
                                     labels)["rmse"]
        params1, _ = train_dynamics(
            self.model, self.params0, train, val,
            TrainConfig(epochs=epochs, batch_size=128, lr=1e-3),
            verbose=False)
        rmse1 = instantaneous_errors(self.model, params1, feats,
                                     labels)["rmse"]
        return {"params1": params1, "rmse0": rmse0, "rmse1": rmse1,
                "rows": len(df)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--ticks", type=int, default=1500,
                    help="control ticks per driving phase")
    ap.add_argument("--rollouts", type=int, default=768)
    ap.add_argument("--timesteps", type=int, default=60)
    ap.add_argument("--epochs", type=int, default=60)
    ap.add_argument("--desired-speed", type=float, default=6.0)
    ap.add_argument("--log", default=os.path.join(tempfile.gettempdir(),
                                                  "ml_loop_drive.jsonl"))
    args = ap.parse_args(argv)

    loop = MLLoop(args.rollouts, args.timesteps, args.desired_speed,
                  device="cpu" if args.cpu else None)
    print(f"ml_loop_demo on {loop.device}: K={args.rollouts} "
          f"T={args.timesteps}; {loop.note}")
    metrics = {}

    def report(name, m):
        metrics[name] = {k: v for k, v in m.items() if k != "timing"}
        print(f"{name}: mean speed {m['mean_speed']:.2f} m/s  |err| "
              f"{m['mean_speed_err']:.3f}  ({m['wall_s']:.1f}s wall, "
              f"{m['ticks'] / m['wall_s']:.1f} ticks/s)")

    # -- phase 1: drive the physics plant, recording the log ----------------
    with open(args.log, "w") as f:
        report("before", loop.drive(args.ticks, logf=f))

    # -- phase 2: ingest + fine-tune ---------------------------------------
    fit = loop.fine_tune(args.log, args.epochs)
    rmse0, rmse1 = fit["rmse0"], fit["rmse1"]
    print(f"ingested {fit['rows']} merged rows from {args.log}")
    print(f"one-step RMSE  driving: {rmse0.mean():.4f}  fine-tuned: "
          f"{rmse1.mean():.4f}")

    # -- phase 3: hot-swap into the running loop and keep driving ----------
    loop.plant.push_model_params(fit["params1"])
    report("after", loop.drive(args.ticks))

    better_fit = float(rmse1.mean()) < float(rmse0.mean())
    metrics["model_fit_improved"] = better_fit
    metrics["speed_tracking_improved"] = (
        metrics["after"]["mean_speed_err"]
        < metrics["before"]["mean_speed_err"])
    print(json.dumps(metrics, indent=2))
    return 0 if better_fit else 1


if __name__ == "__main__":
    raise SystemExit(main())
