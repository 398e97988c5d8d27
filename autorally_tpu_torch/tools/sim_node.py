"""Standalone simulator node, the Gazebo stand-in process (port of
``autorally_tpu/tools/sim_node.py``, the learned-model path).

The reference closes its loop across processes: the controller binary and
the Gazebo simulator exchange pose and command over ROS pub/sub.  This node
is that architecture without ROS: a separate OS process that integrates a
learned dynamics model in real time (the native pacer), publishes pose
records over UDP at the control rate and applies whatever actuation
commands arrive: the counterpart of ``autorally_gazebo`` and the
ground-truth republisher for ``runtime/udp_plant.py``'s ``UdpPlant``.

Run::

    python -m autorally_tpu_torch.tools.sim_node --pose-port 47800 \\
        --control-port 47801 [--model PATH] [--cpu] [--hz 50]

``--model`` is a ``.npz`` in the reference format
(``NeuralNetDynamics.from_npz``); without it the node loads the reference
weights and raises ``FileNotFoundError`` naming them when they are absent.
The step is the model's ``update_state`` on the card, or on the CPU with
``--cpu`` (one thread, so that it leaves the cores to the controller).
``--physics``, ``--urdf`` and ``--world`` need the four-wheel physics
model (``sim/vehicle.py``), which is not ported yet: they exit naming
ROADMAP.md Queue 1 item 11.

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

PHYSICS_ITEM = "Queue 1 item 11 (sim/vehicle.py)"


def log_topics(log, i: int, t: float, state: np.ndarray,
               u: np.ndarray) -> None:
    """Rosbag-record-style rows at distinct rates: ground-truth odometry
    with a quaternion orientation each tick, chassis actuation every second
    tick, wheel speeds (the body speed) every fifth."""
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
        w = float(state[4])
        log.write(json.dumps({
            "topic": "wheelSpeeds", "secs": secs, "nsecs": nsecs,
            "lfSpeed": w, "rfSpeed": w, "lbSpeed": w, "rbSpeed": w}) + "\n")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--pose-port", type=int, default=47800,
                    help="UDP port the controller listens for poses on")
    ap.add_argument("--control-port", type=int, default=47801,
                    help="UDP port this node listens for commands on")
    ap.add_argument("--model", default=None,
                    help=f"reference-format .npz (default {DEFAULT_MODEL})")
    for opt in ("--physics", "--urdf", "--world"):
        ap.add_argument(opt, nargs="?", const=True, default=None,
                        help=f"not ported: {PHYSICS_ITEM}")
    ap.add_argument("--hz", type=int, default=50)
    ap.add_argument("--duration", type=float, default=30.0,
                    help="seconds of simulated driving (<=0: forever)")
    ap.add_argument("--start", default="30,0,1.5708,0,0,0,0",
                    help="initial state CSV [x,y,yaw,roll,ux,uy,yaw_mder]")
    ap.add_argument("--cpu", action="store_true",
                    help="step the model on the CPU, one thread")
    ap.add_argument("--log", default=None,
                    help="write a multi-topic JSONL log (the 'rosbag "
                         "record' role)")
    args = ap.parse_args(argv)
    for opt in ("physics", "urdf", "world"):
        if getattr(args, opt) is not None:
            ap.error(f"--{opt} is not ported yet (ROADMAP.md, "
                     f"{PHYSICS_ITEM})")

    path = args.model or DEFAULT_MODEL
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"sim_node: no dynamics model at {path} (pass --model PATH; "
            f"the reference weights are not in the repository)")
    if args.cpu:
        torch.set_num_threads(1)
    dev = resolve_device("cpu" if args.cpu else None)

    from autorally_tpu_torch.models import NeuralNetDynamics
    from autorally_tpu_torch.runtime.native import Pacer, Ring, UdpLink

    dt = 1.0 / args.hz
    model, params = NeuralNetDynamics.from_npz(path, dt, device=dev)
    state = np.array([float(v) for v in args.start.split(",")],
                     dtype=np.float32)
    ctrl_ring = Ring(capacity=64, record_len=3)
    ctrl_link = UdpLink(args.control_port, ctrl_ring)
    pacer = Pacer(dt)
    u = np.zeros(2, dtype=np.float32)
    t = 0.0
    n_ticks = int(args.duration * args.hz) if args.duration > 0 else -1
    log = open(args.log, "w") if args.log else None
    print(f"sim_node: {args.hz} Hz on {dev}, model {path}, "
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
                s_next, _ = model.update_state(
                    params, torch.from_numpy(state).to(dev),
                    torch.from_numpy(u).to(dev))
                state = s_next.cpu().numpy()
                t += dt
                UdpLink.send(args.pose_port,
                             np.concatenate([[t], state]).astype(np.float32))
                if log is not None:
                    log_topics(log, i, t, state, u)
                i += 1
    except KeyboardInterrupt:
        pass
    finally:
        ctrl_link.close()
        pacer.close()
        if log is not None:
            log.close()
    print(f"sim_node: done at t={t:.2f}s pos=({state[0]:.2f},"
          f"{state[1]:.2f}) speed={state[4]:.2f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
