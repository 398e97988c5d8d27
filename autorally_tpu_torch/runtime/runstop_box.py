"""Hardware runstop-box serial link (the port's copy of
``autorally_tpu/runtime/runstop_box.py``, plain Python).

Port of the reference RunStop node (``autorally_core/src/RunStop/
RunStop.cpp:84-147``): the physical runstop box streams text frames
``#RunStop:<STATE>\\r\\n`` with STATE in {GREEN, YELLOW, RED} over
serial; only GREEN enables motion, and silence longer than one second
forces motion off with a diagnostics error ("No recent data from runstop
box").  The node republishes a runstop message at 5 Hz.

Framing matches ``RunStop::processData`` exactly: scan to the first
``#``, require a complete ``\\r\\n``-terminated frame, take the text
after the last ``:`` as the state, drain every complete frame per poll.
Output goes wherever the caller points it — typically a plant's
``set_runstop`` and/or a :class:`TelemetryBus` — instead of a ROS topic.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

from autorally_tpu_torch.runtime.serial_device import (SerialDeviceThreaded,
                                                      scan_hash_frames)

STALE_S = 1.0                 # RunStop.cpp:138 — no data for 1 s => stop
PUBLISH_HZ = 5.0              # runstopRate default (RunStop.cpp:62)
SENDER = "RUNSTOP"            # frame_id/sender (RunStop.cpp:76-78)


class RunStopBox:
    """Reads runstop frames from a serial fd and publishes motion-enable.

    ``on_runstop(sender, motion_enabled, stamp)`` fires at ``publish_hz``;
    ``diagnostics`` (a ``Diagnostics`` component, if given) receives the
    stale-data error."""

    def __init__(self, fd: int,
                 on_runstop: Optional[Callable[[str, bool, float], None]]
                 = None,
                 diagnostics=None, publish_hz: float = PUBLISH_HZ):
        self.fd = fd
        self.on_runstop = on_runstop
        self.diag = diagnostics
        self.period = 1.0 / publish_hz
        self.state = "RED"                      # RunStop.cpp:57 initial
        self.last_message_time: Optional[float] = None
        self._buf = ""
        self._running = False
        self._device = None    # SerialDeviceThreaded once start()ed
        self._publisher: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        self.published = 0

    # -- framing (RunStop::processData, RunStop.cpp:84-115) ------------------

    def process_bytes(self, data: bytes) -> None:
        with self._lock:
            frames, self._buf = scan_hash_frames(
                self._buf + data.decode(errors="replace"))
            for message in frames:
                colon = message.find(":")
                self.state = message[colon + 1:]
                self.last_message_time = time.time()

    @property
    def motion_enabled(self) -> bool:
        """GREEN and fresh; YELLOW/RED/garbage/stale all stop
        (RunStop.cpp:123-142)."""
        if (self.last_message_time is None
                or time.time() - self.last_message_time > STALE_S):
            return False
        return self.state == "GREEN"

    # -- threads -------------------------------------------------------------

    def start(self) -> None:
        self._running = True
        self._device = SerialDeviceThreaded(self.fd, diagnostics=self.diag,
                                            name="runstop_box")
        self._device.register_data_callback(
            lambda: self.process_bytes(self._device.take()))
        self._device.start()
        self._publisher = threading.Thread(target=self._publish_loop,
                                           daemon=True)
        self._publisher.start()

    def _publish_loop(self) -> None:
        while self._running:
            stale = (self.last_message_time is None
                     or time.time() - self.last_message_time > STALE_S)
            if stale and self.diag is not None:
                self.diag.diag_error("runstop",
                                     "No recent data from runstop box")
            elif self.diag is not None:
                self.diag.diag_ok("runstop", f"state {self.state}")
                self.diag.tick("runstop Status")
            if self.on_runstop is not None:
                try:
                    self.on_runstop(SENDER, self.motion_enabled, time.time())
                except Exception:
                    pass                  # a consumer bug must not kill
                                          # the safety publisher
            self.published += 1
            time.sleep(self.period)

    def stop(self) -> None:
        self._running = False
        if self._device is not None:
            self._device.stop()
        if self._publisher is not None:
            self._publisher.join(timeout=1.0)
