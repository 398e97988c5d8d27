"""Camera hardware-trigger link — the camera_trigger role (port's copy).

Port of ``autorally_core/src/camera_trigger/CameraTrigger.cpp``: a
microcontroller strobes the cameras' trigger lines; over serial it
streams ``#pps:<count>,fps:<actual>\r\n`` status frames and accepts
``#fps:<n>\r\n`` rate commands (``configCallback``, :141-152).  This
module parses the status stream into diagnostics (PPS count, actual
FPS vs requested) and sends rate changes; transport is the shared
:class:`SerialDeviceThreaded` (pty-testable, like every serial device
here)."""

from __future__ import annotations

from typing import Optional

from autorally_tpu_torch.runtime.serial_device import (SerialDeviceThreaded,
                                                      scan_hash_frames)

DEFAULT_FPS = 40               # camera_trigger_params.cfg default


class CameraTrigger:
    """Parses trigger-box status frames and commands the trigger rate."""

    def __init__(self, fd: int, diagnostics=None,
                 trigger_fps: int = DEFAULT_FPS):
        self.diag = diagnostics
        self.trigger_fps = trigger_fps
        self.pps_count: Optional[int] = None
        self.actual_fps: Optional[float] = None
        self.bad_tokens = 0
        self._buf = ""
        self.device = SerialDeviceThreaded(fd, diagnostics=diagnostics,
                                           name="camera_trigger")
        self.device.register_data_callback(
            lambda: self.process_bytes(self.device.take()))

    def start(self) -> None:
        self.device.start()
        self.set_fps(self.trigger_fps)

    def stop(self) -> None:
        self.device.stop()

    # -- outgoing --------------------------------------------------------------

    def set_fps(self, fps: int) -> None:
        """``#fps:<n>\\r\\n`` to the firmware (``configCallback``)."""
        self.trigger_fps = int(fps)
        self.device.write_port(f"#fps:{self.trigger_fps}\r\n".encode())
        if self.diag is not None:
            self.diag.diag("Requested triggering FPS",
                           str(self.trigger_fps))

    # -- incoming (findMessage + triggerDataCallback) ----------------------------

    def process_bytes(self, data: bytes) -> None:
        frames, self._buf = scan_hash_frames(self._buf + data.decode(
            errors="replace"))
        for msg in frames:
            self._process_message(msg)

    def _process_message(self, msg: str) -> None:
        for token in msg.replace("\n", ",").split(","):
            if ":" not in token:
                continue
            key, _, value = token.partition(":")
            if key == "pps":
                try:
                    self.pps_count = int(value)
                except ValueError:
                    self._bad(token)
                    continue
                if self.diag is not None:
                    self.diag.diag("PPS count", value)
                    self.diag.tick("pps info")
            elif key == "fps":
                try:
                    self.actual_fps = float(value)
                except ValueError:
                    self._bad(token)
                    continue
                if self.diag is not None:
                    self.diag.diag("Actual triggering FPS", value)
                    self.diag.tick("fps info")
            else:
                self._bad(token)

    def _bad(self, token: str) -> None:
        self.bad_tokens += 1
        if self.diag is not None:
            self.diag.diag_warn("CameraTrigger got a bad token", token)
