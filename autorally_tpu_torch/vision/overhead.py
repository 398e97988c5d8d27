"""Overhead-vision ground truth: the ``ssl_vision`` rig without ROS (the
port's copy of ``autorally_tpu/vision/overhead.py``).

The reference's ML pipeline needs real-world ground-truth poses, which
it gets from an SSL-Vision overhead-camera system broadcasting per-robot
detections over UDP (``scripts/ssl_vision/README.md``;
``sensor_noise.py:10-47`` binds the client and collects
x/y/orientation measurements).  This module is that data path,
framework-native:

- :class:`OverheadDetection` + a compact binary codec — the detection
  packet (SSL-Vision convention: positions in millimeters, orientation
  in radians, per-camera capture time, confidence);
- :class:`OverheadClient` — binds UDP and collects measurements
  (``get_ssl_measurements``'s role, including the stationary
  noise-quantification workflow);
- :class:`SyntheticOverheadCamera` — a simulated rig observing a true
  state with calibratable Gaussian pixel noise and detection dropout,
  so the whole path is testable (and tunable) without hardware;
- :class:`OverheadPoseBridge` — detections -> 7-state pose rows with
  finite-difference velocities, feeding either a live plant
  (ground-truth pose source) or the JSONL multi-topic log the ML
  ingest pipeline consumes (``ml/ingest.py``).
"""

from __future__ import annotations

import dataclasses
import json
import math
import socket
import struct
import time
from typing import Callable, Dict, List, Optional

import numpy as np

_MAGIC = 0x5B
_FMT = "<BBdBffff"          # magic, camera_id, t_capture, robot_id,
#                             x_mm, y_mm, orientation, confidence
_SIZE = struct.calcsize(_FMT)


@dataclasses.dataclass
class OverheadDetection:
    camera_id: int
    t_capture: float
    robot_id: int
    x_mm: float              # SSL-Vision reports millimeters
    y_mm: float
    orientation: float       # radians
    confidence: float = 1.0

    def encode(self) -> bytes:
        return struct.pack(_FMT, _MAGIC, self.camera_id, self.t_capture,
                           self.robot_id, self.x_mm, self.y_mm,
                           self.orientation, self.confidence)

    @classmethod
    def decode(cls, buf: bytes) -> "OverheadDetection":
        if len(buf) != _SIZE:
            raise ValueError(f"detection packet is {len(buf)} bytes, "
                             f"expected {_SIZE}")
        magic, cam, t, rid, x, y, o, c = struct.unpack(_FMT, buf)
        if magic != _MAGIC:
            raise ValueError(f"bad detection magic 0x{magic:02x}")
        return cls(cam, t, rid, x, y, o, c)


class SyntheticOverheadCamera:
    """Simulated overhead rig: observes ``(x, y, yaw)`` in meters and
    emits SSL-convention detections over UDP with Gaussian measurement
    noise and dropout.

    ``noise_mm`` / ``noise_rad`` default to the order the reference's
    VCR-lab rig measured (``stationary_robot_hist.png``: a few mm, a few
    milliradians).
    """

    def __init__(self, port: int, camera_id: int = 0, robot_id: int = 0,
                 noise_mm: float = 2.0, noise_rad: float = 0.004,
                 dropout: float = 0.0, seed: int = 0,
                 host: str = "127.0.0.1"):
        self.addr = (host, port)
        self.camera_id = camera_id
        self.robot_id = robot_id
        self.noise_mm = noise_mm
        self.noise_rad = noise_rad
        self.dropout = dropout
        self._rng = np.random.RandomState(seed)
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)

    def observe(self, t: float, x_m: float, y_m: float, yaw: float
                ) -> bool:
        """Emit one detection of the true pose; returns False when the
        frame was dropped."""
        if self.dropout and self._rng.random_sample() < self.dropout:
            return False
        det = OverheadDetection(
            camera_id=self.camera_id, t_capture=t,
            robot_id=self.robot_id,
            x_mm=x_m * 1000.0 + self._rng.randn() * self.noise_mm,
            y_mm=y_m * 1000.0 + self._rng.randn() * self.noise_mm,
            orientation=yaw + self._rng.randn() * self.noise_rad)
        self._sock.sendto(det.encode(), self.addr)
        return True

    def close(self) -> None:
        self._sock.close()


class OverheadClient:
    """Receives detections; the ``get_ssl_measurements`` role
    (``sensor_noise.py:10-47``)."""

    def __init__(self, port: int, host: str = "127.0.0.1",
                 timeout: float = 2.0):
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._sock.bind((host, port))
        self._sock.settimeout(timeout)

    def receive(self) -> OverheadDetection:
        buf, _ = self._sock.recvfrom(64)
        return OverheadDetection.decode(buf)

    def collect(self, count: int, robot_id: Optional[int] = None
                ) -> List[OverheadDetection]:
        """Collect ``count`` detections (optionally for one robot id)."""
        out: List[OverheadDetection] = []
        while len(out) < count:
            det = self.receive()
            if robot_id is None or det.robot_id == robot_id:
                out.append(det)
        return out

    def stationary_noise(self, count: int = 100,
                         robot_id: Optional[int] = None
                         ) -> Dict[str, Dict[str, float]]:
        """Quantify the rig's noise with the vehicle stationary — the
        reference's validation workflow (``sensor_noise.py``), through
        the shared stats helper."""
        from autorally_tpu_torch.ml.ode_compare import \
            sensor_noise_stats

        dets = self.collect(count, robot_id)
        log = np.array([[d.x_mm, d.y_mm, d.orientation] for d in dets])
        return sensor_noise_stats(log, ("x_mm", "y_mm", "orientation"))

    def close(self) -> None:
        self._sock.close()


class OverheadPoseBridge:
    """Detections -> 7-state pose rows (x, y, yaw, roll, u_x, u_y,
    yaw_mder) with finite-difference body velocities.

    ``on_state(t, state_vector)`` receives each derived row — plug in
    ``plant.receive_state_vector`` for a live ground-truth pose source,
    or leave it unset and use :meth:`log_jsonl` to write the multi-topic
    JSONL rows the ML ingest pipeline consumes (the rig's
    data-collection role).

    ``collect_rows``: keep JSONL rows in memory for :meth:`log_jsonl`
    (default).  Disable for long-lived live-pose use with no logging, or
    the row list grows without bound at camera rate."""

    def __init__(self, on_state: Optional[Callable] = None,
                 smooth: float = 0.5, collect_rows: bool = True):
        self.on_state = on_state
        self.smooth = float(smooth)          # EMA factor on velocities
        self.collect_rows = bool(collect_rows)
        self._prev: Optional[OverheadDetection] = None
        self._vel = np.zeros(3)              # vx_w, vy_w, yaw_rate
        self.rows: List[dict] = []

    def push(self, det: OverheadDetection) -> Optional[np.ndarray]:
        x, y, yaw = det.x_mm / 1000.0, det.y_mm / 1000.0, det.orientation
        if self._prev is not None:
            dt = det.t_capture - self._prev.t_capture
            if dt <= 0:
                return None                  # reordered/duplicate frame
            raw = np.array([
                (det.x_mm - self._prev.x_mm) / 1000.0 / dt,
                (det.y_mm - self._prev.y_mm) / 1000.0 / dt,
                _ang_diff(det.orientation, self._prev.orientation) / dt,
            ])
            a = self.smooth
            self._vel = a * self._vel + (1 - a) * raw
        self._prev = det
        # world -> body frame (autorally_plant.cpp:208-210)
        c, s = math.cos(yaw), math.sin(yaw)
        u_x = c * self._vel[0] + s * self._vel[1]
        u_y = -s * self._vel[0] + c * self._vel[1]
        state = np.array([x, y, yaw, 0.0, u_x, u_y, -self._vel[2]],
                         dtype=np.float32)
        if not self.collect_rows:
            if self.on_state is not None:
                self.on_state(det.t_capture, state)
            return state
        # yaw_mder = -yaw_rate, the PLANT convention (plant.py:152,
        # autorally_plant.cpp:212) — the same column sim_node.py logs, so
        # a model trained from bridge logs sees the same sign as the live
        # state[6] it is deployed against (round-3 advisor finding).
        self.rows.append({
            "topic": "/overhead/state", "secs": int(det.t_capture),
            "nsecs": int((det.t_capture % 1.0) * 1e9),
            "x_pos": x, "y_pos": y, "yaw": yaw, "roll": 0.0,
            "u_x": float(u_x), "u_y": float(u_y),
            "yaw_mder": float(-self._vel[2]),
        })
        if self.on_state is not None:
            self.on_state(det.t_capture, state)
        return state

    def log_jsonl(self, path: str) -> int:
        """Append the collected rows as a JSONL multi-topic log
        (``ml/ingest.read_jsonl_topics`` format); returns rows written."""
        with open(path, "a") as f:
            for row in self.rows:
                f.write(json.dumps(row) + "\n")
        n = len(self.rows)
        self.rows = []
        return n


def _ang_diff(a: float, b: float) -> float:
    return (a - b + math.pi) % (2 * math.pi) - math.pi
