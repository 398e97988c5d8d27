"""UDP-networked plant: pose estimates in, actuation commands out (port of
``autorally_tpu/runtime/udp_plant.py``).

The distributed-process equivalent of ``AutorallyPlant``'s ROS wiring: the
reference subscribes pose over TCP (tcpNoDelay, ``autorally_plant.cpp:
65-66``) and publishes ``chassisCommand``; here the transport is the native
UDP float-record link (``runtime/native.py``) with a background poller
thread playing the ROS callback thread: it drains the freshest pose from
the lock-free ring, runs the solution interpolation and feedback pipeline
(``BasePlant``) and sends the resulting command.

Wire formats (little-endian float32 records on loopback UDP):

- pose, ``fmt='state'`` (8 floats): [t, x, y, yaw, roll, u_x, u_y,
  yaw_mder]
- pose, ``fmt='odom'`` (12 floats): [t, x, y, z, qw, qx, qy, qz, vx, vy,
  vz, yaw_rate]: the full quaternion -> Euler / unwrap / body-velocity
  pipeline
- control (3 floats): [t, steering, throttle]
"""

from __future__ import annotations

import threading
from typing import Optional

import numpy as np

from autorally_tpu_torch.runtime.native import Pacer, Ring, UdpLink
from autorally_tpu_torch.runtime.plant import BasePlant


class UdpPlant(BasePlant):
    def __init__(self, dt: float, num_timesteps: int,
                 pose_port: int = 47800, control_port: int = 47801,
                 fmt: str = "state", poll_hz: float = 200.0, **kw):
        super().__init__(dt, num_timesteps, **kw)
        if fmt not in ("state", "odom"):
            raise ValueError(fmt)
        self.fmt = fmt
        self.control_port = control_port
        self.ring = Ring(capacity=256, record_len=8 if fmt == "state" else 12)
        self.link = UdpLink(pose_port, self.ring)
        self._poll_hz = poll_hz
        self._running = False
        self._thread: Optional[threading.Thread] = None

    # -- poller (the ROS callback thread's role) -----------------------------

    def start(self) -> None:
        self._running = True
        self._thread = threading.Thread(target=self._poll_loop, daemon=True)
        self._thread.start()

    def _poll_loop(self) -> None:
        pacer = Pacer(1.0 / self._poll_hz)
        try:
            while self._running:
                pacer.wait()
                self.poll_once()
        finally:
            pacer.close()

    def poll_once(self) -> Optional[tuple]:
        """Drain the freshest pose, run the control pipeline and send the
        command.  Returns the published (steering, throttle) or None."""
        rec = self.ring.pop_latest()
        if rec is None:
            return None
        if self.fmt == "state":
            out = self.receive_state_vector(float(rec[0]), rec[1:8])
        else:
            out = self.receive_pose(
                t=float(rec[0]), x=float(rec[1]), y=float(rec[2]),
                z=float(rec[3]),
                quat=(float(rec[4]), float(rec[5]), float(rec[6]),
                      float(rec[7])),
                world_vel=(float(rec[8]), float(rec[9]), float(rec[10])),
                yaw_rate=float(rec[11]))
        if out is not None:
            UdpLink.send(self.control_port, np.array(
                [self.last_pose_time, out[0], out[1]], dtype=np.float32))
        return out

    def stop(self) -> None:
        self._running = False
        if self._thread is not None:
            self._thread.join(timeout=2.0)
        self.link.close()
