"""Telemetry bus: machine-readable run log + live UDP feed + runstop
backchannel (the port's copy of ``autorally_tpu/runtime/telemetry_bus.py``).

The reference's observability transport is ROS pub/sub: every node
publishes ``/diagnostics``, ``pathIntegralStats``, ``pathIntegralTiming``,
``runstop`` topics and the OCS GUI subscribes (``ocs/qnode.cpp:86-133``).
Here the transport is a single JSON-over-UDP feed plus an append-only
JSONL run log:

- :class:`TelemetryBus` — ``publish(kind, record)`` stamps wall time,
  appends one JSON line to the run log (the machine-readable artifact the
  reference never wrote), and best-effort datagrams the same line to the
  console (:mod:`autorally_tpu_torch.tools.console`).
- :class:`RunstopReceiver` — listens for ``{"sender", "motionEnabled"}``
  datagrams and exposes the conjunction over fresh senders, mirroring the
  reference's runstop semantics (every RunStop message source must say
  motion is enabled; any stale or false sender stops the vehicle —
  ``AutoRallyChassis.cpp`` runstop handling / ``SafeSpeed`` min-over-
  senders).  Wire ``on_change`` to ``plant.set_runstop``.
"""

from __future__ import annotations

import json
import socket
import threading
import time
from typing import Callable, Optional, Tuple

import torch


class TelemetryBus:
    """One-way telemetry out: JSONL file and/or UDP JSON datagrams."""

    def __init__(self, jsonl_path: Optional[str] = None,
                 udp_addr: Optional[Tuple[str, int]] = None):
        self._file = open(jsonl_path, "a") if jsonl_path else None
        self._udp_addr = udp_addr
        self._sock = None
        if udp_addr is not None:
            self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            self._sock.setblocking(False)
        self._lock = threading.Lock()
        self.published = 0

    def publish(self, kind: str, record: dict,
                t: Optional[float] = None) -> None:
        line = {"t": time.time() if t is None else t, "kind": kind}
        line.update(record)
        data = json.dumps(line, default=_jsonable)
        with self._lock:
            if self._file is not None:
                self._file.write(data + "\n")
                self._file.flush()
            if self._sock is not None:
                try:
                    self._sock.sendto(data.encode(), self._udp_addr)
                except OSError:
                    pass                      # console absent: never block
            self.published += 1

    def close(self) -> None:
        with self._lock:
            if self._file is not None:
                self._file.close()
                self._file = None
            if self._sock is not None:
                self._sock.close()
                self._sock = None


def _jsonable(obj):
    if isinstance(obj, torch.Tensor):         # solve stats on the device
        obj = obj.detach()
        return float(obj) if obj.dim() == 0 else obj.cpu().tolist()
    try:
        return float(obj)                     # numpy scalars
    except (TypeError, ValueError):
        return str(obj)


class RunstopReceiver:
    """Runstop-in over UDP: motion is enabled only while every sender
    heard within ``stale_s`` agrees it is (and at least one has been
    heard at all, unless ``default_enabled``)."""

    def __init__(self, port: int, on_change: Optional[Callable[[bool], None]]
                 = None, stale_s: float = 1.0, default_enabled: bool = True,
                 host: str = "127.0.0.1"):
        self.stale_s = stale_s
        self.default_enabled = default_enabled
        self.on_change = on_change
        self._senders: dict = {}              # name -> (t, enabled)
        self._lock = threading.Lock()
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._sock.bind((host, port))
        self._sock.settimeout(0.2)
        self.port = self._sock.getsockname()[1]
        self._running = True
        self._last = None
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _loop(self) -> None:
        while self._running:
            try:
                data, _ = self._sock.recvfrom(4096)
            except socket.timeout:
                data = None
            except OSError:
                break
            if data:
                try:
                    msg = json.loads(data.decode())
                    sender = str(msg.get("sender", "anonymous"))
                    enabled = bool(msg.get("motionEnabled", False))
                    with self._lock:
                        self._senders[sender] = (time.time(), enabled)
                except (ValueError, UnicodeDecodeError):
                    pass
            cur = self.motion_enabled
            if cur != self._last:
                self._last = cur
                if self.on_change is not None:
                    self.on_change(cur)

    @property
    def motion_enabled(self) -> bool:
        now = time.time()
        with self._lock:
            fresh = [en for (t, en) in self._senders.values()
                     if now - t <= self.stale_s]
        if not fresh:
            return self.default_enabled
        return all(fresh)

    def close(self) -> None:
        self._running = False
        try:
            self._sock.close()
        except OSError:
            pass
        self._thread.join(timeout=1.0)


def send_runstop(port: int, sender: str, motion_enabled: bool,
                 host: str = "127.0.0.1") -> None:
    """Fire one runstop datagram (the OCS runstop-publisher role)."""
    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        sock.sendto(json.dumps({"sender": sender,
                                "motionEnabled": motion_enabled}).encode(),
                    (host, port))
    finally:
        sock.close()
