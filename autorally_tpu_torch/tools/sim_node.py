"""Standalone simulator node, the Gazebo stand-in process (port of
``autorally_tpu/tools/sim_node.py``).

The reference closes its loop across processes: the controller binary and
the Gazebo simulator exchange pose and command over ROS pub/sub.  This node
is that architecture without ROS: a separate OS process that integrates the
vehicle in real time (the native pacer), publishes pose records over UDP at
the control rate and applies whatever actuation commands arrive: the
counterpart of ``autorally_gazebo`` and the ground-truth republisher for
``runtime/udp_plant.py``'s ``UdpPlant``.

Run::

    python -m autorally_tpu_torch.tools.sim_node --pose-port 47800 \\
        --control-port 47801 [--model PATH | --physics [--urdf PATH]
        [--world PATH]] [--cpu] [--hz 50] [--log PATH]

``--model`` is a ``.npz`` in the reference format
(``NeuralNetDynamics.from_npz``); without it the node loads the reference
weights and raises ``FileNotFoundError`` naming them when they are absent.
``--physics`` integrates the independent four-wheel physics model
(``sim/``) instead, built from ``--urdf`` (default the bundled
``assets/autorally_platform.urdf``): the closest equivalent of running
against Gazebo.  ``--world`` (a world JSON) gives the spawn pose, which
overrides ``--start``, and a surface friction that overrides the URDF's.
The step runs on the card (the physics period one replayed CUDA graph), or
on the CPU with ``--cpu`` (one thread, so that it leaves the cores to the
controller).

Wire formats match ``UdpPlant(fmt='state')``: pose out = 8 float32 [t, x,
y, yaw, roll, u_x, u_y, yaw_mder]; command in = 3 float32 [t, steering,
throttle].
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys

import numpy as np
import torch

from autorally_tpu_torch.config import REFERENCE_NN_NPZ as DEFAULT_MODEL
from autorally_tpu_torch.config import resolve_device


def log_topics(log, i: int, t: float, state: np.ndarray,
               u: np.ndarray, wheels=None) -> None:
    """Rosbag-record-style rows at distinct rates: ground-truth odometry
    with a quaternion orientation each tick, chassis actuation every second
    tick, wheel speeds every fifth (``wheels`` [lf, rf, lb, rb], else the
    body speed for all four)."""
    secs = int(t)
    nsecs = int(round((t - secs) * 1e9))
    hy, hr = 0.5 * float(state[2]), 0.5 * float(state[3])
    cy, sy = math.cos(hy), math.sin(hy)
    cr, sr = math.cos(hr), math.sin(hr)
    # q = qz(yaw) * qx(roll), pitch = 0 (R = Rz Ry Rx convention)
    log.write(json.dumps({
        "topic": "ground_truth/state", "secs": secs, "nsecs": nsecs,
        "x": float(state[0]), "y": float(state[1]), "z": 0.0,
        "qx": cy * sr, "qy": sy * sr, "qz": sy * cr, "qw": cy * cr,
        "u_x": float(state[4]), "u_y": float(state[5]),
        "yaw_mder": float(state[6])}) + "\n")
    if i % 2 == 0:
        log.write(json.dumps({
            "topic": "chassisState", "secs": secs, "nsecs": nsecs,
            "steering": float(u[0]), "throttle": float(u[1]),
            "frontBrake": 0.0}) + "\n")
    if i % 5 == 0:
        w = ([float(state[4])] * 4 if wheels is None
             else [float(v) for v in wheels])
        log.write(json.dumps({
            "topic": "wheelSpeeds", "secs": secs, "nsecs": nsecs,
            "lfSpeed": w[0], "rfSpeed": w[1], "lbSpeed": w[2],
            "rbSpeed": w[3]}) + "\n")


def teacher_drive_log(path: str, model, params, seconds: float = 60.0,
                      hz: int = 50, start=(0.0, 0.0, 0.0, 0.0, 2.0, 0.0, 0.0)
                      ) -> str:
    """Write a ``seconds`` long drive log at ``hz`` in :func:`log_topics`'
    format, the state integrated by ``model`` (``update_state`` at 1/hz, on
    the device of ``params``) under sinusoidal controls [0.25 sin(0.37 t),
    0.4 + 0.2 sin(0.13 t)], as the JAX package's ML tests synthesise
    theirs: a training log made from a known teacher, for the ML pipeline
    where no recorded log is at hand.  Returns ``path``."""
    dev = params["control_rngs"].device
    dt = 1.0 / hz
    s = torch.tensor(start, dtype=torch.float32, device=dev)
    t = 0.0
    with open(path, "w") as f, torch.no_grad():
        for i in range(int(seconds * hz)):
            u = np.array([0.25 * math.sin(0.37 * t),
                          0.4 + 0.2 * math.sin(0.13 * t)], dtype=np.float32)
            s, _ = model.update_state(params, s, torch.from_numpy(u).to(dev))
            t += dt
            log_topics(f, i, t, s.cpu().numpy(), u)
    return path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--pose-port", type=int, default=47800,
                    help="UDP port the controller listens for poses on")
    ap.add_argument("--control-port", type=int, default=47801,
                    help="UDP port this node listens for commands on")
    ap.add_argument("--model", default=None,
                    help=f"reference-format .npz (default {DEFAULT_MODEL})")
    ap.add_argument("--physics", action="store_true",
                    help="integrate the independent four-wheel physics "
                         "model (sim/) instead of the learned dynamics: "
                         "the Gazebo-oracle configuration")
    ap.add_argument("--urdf", default=None,
                    help="vehicle description file for --physics (default "
                         "the bundled assets/autorally_platform.urdf)")
    ap.add_argument("--world", default=None,
                    help="world JSON (spawn pose + surface friction "
                         "override); overrides --start")
    ap.add_argument("--hz", type=int, default=50)
    ap.add_argument("--duration", type=float, default=30.0,
                    help="seconds of simulated driving (<=0: forever)")
    ap.add_argument("--start", default="30,0,1.5708,0,0,0,0",
                    help="initial state CSV [x,y,yaw,roll,ux,uy,yaw_mder]")
    ap.add_argument("--cpu", action="store_true",
                    help="step on the CPU, one thread")
    ap.add_argument("--log", default=None,
                    help="write a multi-topic JSONL log (the 'rosbag "
                         "record' role): ground_truth/state at the sim "
                         "rate, chassisState at half rate, wheelSpeeds at "
                         "a fifth; feeds ml.ingest")
    args = ap.parse_args(argv)

    if not args.physics:
        path = args.model or DEFAULT_MODEL
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"sim_node: no dynamics model at {path} (pass --model PATH "
                f"or --physics; the reference weights are not in the "
                f"repository)")
    if args.cpu:
        torch.set_num_threads(1)
    dev = resolve_device("cpu" if args.cpu else None)

    from autorally_tpu_torch.runtime.native import Pacer, Ring, UdpLink

    dt = 1.0 / args.hz
    state = np.array([float(v) for v in args.start.split(",")],
                     dtype=np.float32)
    world = None
    if args.world is not None:
        from autorally_tpu_torch.sim.description import load_world

        world = load_world(args.world)
        state = np.zeros(7, dtype=np.float32)
        state[0], state[1], state[2] = (world.spawn_x, world.spawn_y,
                                        world.spawn_yaw)

    wheels = None
    if args.physics:
        from autorally_tpu_torch.sim.description import (
            DEFAULT_URDF, load_urdf, vehicle_params_from_description)
        from autorally_tpu_torch.sim.plant import (VehiclePeriod,
                                                   host_controller_state)
        from autorally_tpu_torch.sim.vehicle import (init_sim_state,
                                                     sim_state_to_numpy)

        urdf = args.urdf or DEFAULT_URDF
        overrides = {}
        if world is not None and world.mu is not None:
            overrides["mu"] = world.mu
        vp = vehicle_params_from_description(load_urdf(urdf), **overrides)
        period = VehiclePeriod(vp, init_sim_state(
            x=float(state[0]), y=float(state[1]), yaw=float(state[2]),
            vx=float(state[4]), device=dev), dt, 20, dev)
        period.prepare()                 # the graph, before the pacer starts
        what = f"physics {urdf}"

        def step(s7, u):
            nonlocal wheels
            host = sim_state_to_numpy(period.step([u[0], u[1], 0.0]))
            wheels = host.omega * 0.095
            return host_controller_state(host)
    else:
        from autorally_tpu_torch.models import NeuralNetDynamics

        model, params = NeuralNetDynamics.from_npz(path, dt, device=dev)
        what = f"model {path}"

        def step(s7, u):
            s_next, _ = model.update_state(
                params, torch.from_numpy(s7).to(dev),
                torch.from_numpy(u).to(dev))
            return s_next.cpu().numpy()
    ctrl_ring = Ring(capacity=64, record_len=3)
    ctrl_link = UdpLink(args.control_port, ctrl_ring)
    pacer = Pacer(dt)
    u = np.zeros(2, dtype=np.float32)
    t = 0.0
    n_ticks = int(args.duration * args.hz) if args.duration > 0 else -1
    log = open(args.log, "w") if args.log else None
    print(f"sim_node: {args.hz} Hz on {dev}, {what}, "
          f"pose->127.0.0.1:{args.pose_port}, cmd<-:{args.control_port}",
          flush=True)
    try:
        i = 0
        with torch.no_grad():
            while n_ticks < 0 or i < n_ticks:
                pacer.wait()
                rec = ctrl_ring.pop_latest()
                if rec is not None:
                    u = np.asarray(rec[1:3], dtype=np.float32)
                state = step(state, u)
                t += dt
                UdpLink.send(args.pose_port,
                             np.concatenate([[t], state]).astype(np.float32))
                if log is not None:
                    log_topics(log, i, t, state, u, wheels)
                i += 1
    except KeyboardInterrupt:
        pass
    finally:
        ctrl_link.close()
        missed = pacer.missed
        pacer.close()
        if log is not None:
            log.close()
    print(f"sim_node: done at t={t:.2f}s pos=({state[0]:.2f},"
          f"{state[1]:.2f}) speed={state[4]:.2f} missed={missed}",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
