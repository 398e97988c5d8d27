"""Multi-vehicle network — the XBee mesh role over UDP.

The reference links vehicles and a base station through XBee radios:
the coordinator broadcasts the base station's runstop decision and RTK
corrections to every registered vehicle, each vehicle transmits its
odometry, and the coordinator relays it to the others
(``autorally_core/src/xbee/XbeeCoordinator.cpp``, ``XbeeNode.cpp``).
A vehicle that stops hearing runstop broadcasts for a second disables
motion (XbeeNode heartbeat staleness).

This is that topology over UDP JSON datagrams (the transport a GPU
deployment actually has; XBee's 100-byte frame packing and RTCM3
chunk reassembly are radio-link artifacts with no role here):

- :class:`VehicleNetworkCoordinator` — registry + fan-out hub: accepts
  ``hi`` registrations, rebroadcasts every vehicle's pose to the other
  vehicles, broadcasts the base runstop at ``runstop_hz``, and relays
  RTK correction frames from the base GPS to every vehicle (the
  XbeeCoordinator ``transmitRTCM`` role — plug
  :meth:`broadcast_correction` into ``GpsBase.on_correction``).
- :class:`VehicleNetworkNode` — per-vehicle endpoint: registers,
  transmits the local pose at a capped rate, exposes the latest pose of
  every *other* vehicle (the ``m_recOdomPublishers`` role — e.g. to
  feed :class:`autorally_tpu_torch.costs.obstacles.ObstacleCost` with
  moving obstacles), receives corrections (``on_correction`` — plug
  ``GpsRover.handle_correction`` in), and the coordinator's runstop
  with 1 s staleness-to-stop.
"""

from __future__ import annotations

import base64
import json
import socket
import threading
import time
from typing import Callable, Dict, Optional, Tuple

RUNSTOP_STALE_S = 1.0


class _UdpEndpoint:
    def __init__(self, port: int, host: str = "127.0.0.1"):
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.sock.bind((host, port))
        self.sock.settimeout(0.2)
        self.port = self.sock.getsockname()[1]
        self._running = False
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self._running = True
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _loop(self) -> None:
        while self._running:
            try:
                data, addr = self.sock.recvfrom(65536)
            except socket.timeout:
                continue
            except OSError:
                break
            try:
                msg = json.loads(data.decode())
            except (ValueError, UnicodeDecodeError):
                continue
            self.handle(msg, addr)

    def handle(self, msg: dict, addr) -> None:    # pragma: no cover
        raise NotImplementedError

    def send(self, msg: dict, addr) -> None:
        try:
            self.sock.sendto(json.dumps(msg).encode(), addr)
        except OSError:
            pass

    def close(self) -> None:
        self._running = False
        try:
            self.sock.close()
        except OSError:
            pass
        if self._thread is not None:
            self._thread.join(timeout=1.0)


class VehicleNetworkCoordinator(_UdpEndpoint):
    """Base-station hub (XbeeCoordinator role): registration, pose
    relay, runstop broadcast."""

    def __init__(self, port: int = 0, runstop_hz: float = 5.0,
                 host: str = "127.0.0.1"):
        super().__init__(port, host)
        self.vehicles: Dict[str, Tuple[tuple, float]] = {}  # name->(addr,t)
        self.motion_enabled = False
        self._lock = threading.Lock()
        self._runstop_period = 1.0 / runstop_hz
        self._bc_thread: Optional[threading.Thread] = None

    def start(self) -> None:
        super().start()
        self._bc_thread = threading.Thread(target=self._broadcast_loop,
                                           daemon=True)
        self._bc_thread.start()

    def set_runstop(self, motion_enabled: bool) -> None:
        """The base station's decision (runstopCallback role)."""
        self.motion_enabled = bool(motion_enabled)

    def handle(self, msg: dict, addr) -> None:
        kind = msg.get("kind")
        name = str(msg.get("vehicle", "?"))
        now = time.time()
        with self._lock:
            if kind == "hi":                      # registration/heartbeat
                self.vehicles[name] = (addr, now)
            elif kind == "pose":
                self.vehicles[name] = (addr, now)
                peers = [(n, a) for n, (a, _) in self.vehicles.items()
                         if n != name]
                for _, peer_addr in peers:
                    self.send(msg, peer_addr)     # relay (processXbeeOdom)

    def _broadcast_loop(self) -> None:
        while self._running:
            with self._lock:
                targets = list(self.vehicles.values())
            msg = {"kind": "runstop", "sender": "coordinator",
                   "motionEnabled": self.motion_enabled}
            for addr, _ in targets:
                self.send(msg, addr)
            time.sleep(self._runstop_period)

    def broadcast_correction(self, msg_type: int, frame: bytes) -> int:
        """Relay one RTCM3 correction frame to every registered vehicle
        (XbeeCoordinator's RTCM broadcast; chunk reassembly is a radio
        artifact — UDP carries the frame whole).  Signature matches
        ``GpsBase.on_correction``.  Returns the number of recipients."""
        with self._lock:
            targets = [a for a, _ in self.vehicles.values()]
        payload = {"kind": "rtcm3", "type": msg_type,
                   "data": base64.b64encode(frame).decode()}
        for addr in targets:
            self.send(payload, addr)
        return len(targets)

    def active_vehicles(self, stale_s: float = 5.0) -> list:
        now = time.time()
        with self._lock:
            return sorted(n for n, (_, t) in self.vehicles.items()
                          if now - t <= stale_s)


class VehicleNetworkNode(_UdpEndpoint):
    """Per-vehicle endpoint (XbeeNode role)."""

    def __init__(self, vehicle: str, coordinator: Tuple[str, int],
                 port: int = 0, transmit_hz: float = 5.0,
                 on_peer_pose: Optional[Callable[[str, dict], None]] = None,
                 on_correction: Optional[Callable[[bytes], None]] = None,
                 host: str = "127.0.0.1"):
        super().__init__(port, host)
        self.vehicle = vehicle
        self.coordinator = coordinator
        self.transmit_period = 1.0 / transmit_hz
        self.on_peer_pose = on_peer_pose
        self.on_correction = on_correction
        self.corrections_received = 0
        self.peer_poses: Dict[str, dict] = {}
        self._last_runstop: Optional[float] = None
        self._runstop_enabled = False
        self._last_tx = 0.0
        self._lock = threading.Lock()

    def start(self) -> None:
        super().start()
        self.send({"kind": "hi", "vehicle": self.vehicle},
                  self.coordinator)                # m_hiTimer registration

    def handle(self, msg: dict, addr) -> None:
        kind = msg.get("kind")
        if kind == "runstop":
            self._last_runstop = time.time()
            self._runstop_enabled = bool(msg.get("motionEnabled", False))
        elif kind == "rtcm3":
            try:
                frame = base64.b64decode(msg.get("data", ""))
            except (ValueError, TypeError):
                return
            self.corrections_received += 1
            if self.on_correction is not None:
                self.on_correction(frame)      # -> GpsRover.handle_correction
        elif kind == "pose":
            sender = str(msg.get("vehicle", "?"))
            if sender == self.vehicle:
                return
            with self._lock:
                self.peer_poses[sender] = msg
            if self.on_peer_pose is not None:
                self.on_peer_pose(sender, msg)

    def transmit_pose(self, t: float, x: float, y: float, yaw: float,
                      vx: float, vy: float) -> bool:
        """Send the local pose via the coordinator, rate-capped like the
        XBee odometry transmit timer.  Returns True if sent."""
        now = time.time()
        if now - self._last_tx < self.transmit_period:
            return False
        self._last_tx = now
        self.send({"kind": "pose", "vehicle": self.vehicle, "t": t,
                   "x": x, "y": y, "yaw": yaw, "vx": vx, "vy": vy},
                  self.coordinator)
        return True

    @property
    def motion_enabled(self) -> bool:
        """Coordinator's runstop with staleness-to-stop (XbeeNode
        m_lastrunstop: silence > 1 s disables motion)."""
        if (self._last_runstop is None
                or time.time() - self._last_runstop > RUNSTOP_STALE_S):
            return False
        return self._runstop_enabled

    def peers(self) -> Dict[str, dict]:
        with self._lock:
            return dict(self.peer_poses)
