"""Threaded serial I/O base layer (the port's copy of
``autorally_tpu/runtime/serial_device.py``, plain Python).

The reference routes every serial sensor (chassis, GPS, runstop box)
through a shared stack: ``SerialCommon`` (termios port configuration +
writes), ``SerialInterfaceThreaded`` (a select()-based reader thread
with a 1 s timeout that appends to a mutex-guarded buffer and fires a
data callback, plus mutex-serialized writes and connected/settings
diagnostics) — ``autorally_core/src/SerialSensorInterface/
SerialCommon.cpp``, ``SerialInterfaceThreaded.cpp:129-292``.

This module is that stack for this framework.  Device modules
(:class:`~autorally_tpu_torch.runtime.runstop_box.RunStopBox`,
:class:`~autorally_tpu_torch.vision.camera_trigger.CameraTrigger`) own
*protocol*; this layer owns *transport*: framing-agnostic buffered reads,
thread-safe writes, staleness diagnostics, and clean shutdown.  Tests drive it
through a pty — the reference's own technique
(``serialSensorInterfaceTest.cpp:36``).
"""

from __future__ import annotations

import dataclasses
import os
import select
import threading
from typing import Callable, Optional

NO_DATA_TIMEOUT_S = 1.0        # SerialInterfaceThreaded.cpp:149 select tv


@dataclasses.dataclass
class SerialSettings:
    """The six per-port parameters the reference reads from the launch
    config (``SerialInterfaceThreaded.cpp:105-118``)."""

    baud: int = 115200
    parity: str = "none"       # none | even | odd
    stop_bits: int = 1         # 1 | 2
    data_bits: int = 8         # 7 | 8
    hardware_flow: bool = False
    software_flow: bool = False


def configure_port(fd: int, settings: SerialSettings) -> None:
    """Apply raw-mode termios settings (``SerialCommon::connect`` role).

    Raises ``ValueError`` on unsupported settings and ``termios.error``
    on a non-tty fd — callers surface both through diagnostics."""
    import termios

    try:
        speed = getattr(termios, f"B{settings.baud}")
    except AttributeError:
        raise ValueError(f"unsupported baud rate {settings.baud}")

    iflag = termios.IGNPAR if settings.parity == "none" else termios.INPCK
    if settings.software_flow:
        iflag |= termios.IXON | termios.IXOFF
    cflag = termios.CLOCAL | termios.CREAD
    if settings.data_bits == 8:
        cflag |= termios.CS8
    elif settings.data_bits == 7:
        cflag |= termios.CS7
    else:
        raise ValueError(f"unsupported data bits {settings.data_bits}")
    if settings.parity == "even":
        cflag |= termios.PARENB
    elif settings.parity == "odd":
        cflag |= termios.PARENB | termios.PARODD
    elif settings.parity != "none":
        raise ValueError(f"unsupported parity {settings.parity!r}")
    if settings.stop_bits == 2:
        cflag |= termios.CSTOPB
    elif settings.stop_bits != 1:
        raise ValueError(f"unsupported stop bits {settings.stop_bits}")
    if settings.hardware_flow:
        cflag |= getattr(termios, "CRTSCTS", 0)

    attrs = termios.tcgetattr(fd)
    attrs[0] = iflag
    attrs[1] = 0                                # oflag: raw
    attrs[2] = cflag
    attrs[3] = 0                                # lflag: raw
    attrs[4] = speed
    attrs[5] = speed
    termios.tcsetattr(fd, termios.TCSANOW, attrs)


def open_serial_port(device: str,
                     settings: Optional[SerialSettings] = None,
                     baud: Optional[int] = None) -> int:
    """Open + configure a serial device, returning the raw fd."""
    if settings is None:
        settings = SerialSettings(baud=baud or 115200)
    fd = os.open(device, os.O_RDWR | os.O_NOCTTY)
    try:
        configure_port(fd, settings)
    except Exception:
        os.close(fd)
        raise
    return fd


class SerialDeviceThreaded:
    """Buffered reader thread + serialized writes over one fd.

    Mirrors ``SerialInterfaceThreaded``'s contract:

    - a ``select()`` loop with a 1 s timeout reads up to 512 bytes at a
      time into ``self.data`` (guarded by ``self.lock``) and fires the
      registered data callback *in the reader thread*;
    - a full quiet second raises a diagnostics warning ("No data within
      previous second", ``SerialInterfaceThreaded.cpp:186``);
    - writes take a write mutex (``writePort``) — ``write_try`` is the
      non-blocking variant (``writePortTry``);
    - ``status_tick()`` publishes connected/settings health
      (``diagnosticStatus`` role).

    The fd may be a real serial port (use :func:`open_serial_port`), a
    pty end, or any pipe-like fd — the protocol layers don't care.
    """

    def __init__(self, fd: int, diagnostics=None, name: str = "serial"):
        self.fd = fd
        self.diag = diagnostics
        self.name = name
        self.data = b""                       # m_data role
        self.lock = threading.Lock()          # m_dataMutex role
        self._write_lock = threading.Lock()   # m_writeMutex role
        self._callback: Optional[Callable[[], None]] = None
        self._alive = False
        self._thread: Optional[threading.Thread] = None
        self._got_data_in_window = False

    # -- lifecycle ------------------------------------------------------------

    def start(self) -> None:
        if self._alive:
            return
        self._alive = True
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=f"serial-{self.name}")
        self._thread.start()

    def stop(self) -> None:
        self._alive = False
        if self._thread is not None:
            self._thread.join(timeout=2.0 * NO_DATA_TIMEOUT_S)
            self._thread = None

    def close(self) -> None:
        self.stop()
        try:
            os.close(self.fd)
        except OSError:
            pass

    def __enter__(self) -> "SerialDeviceThreaded":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    @property
    def connected(self) -> bool:
        return self._alive

    # -- reader ---------------------------------------------------------------

    def register_data_callback(self, cb: Callable[[], None]) -> None:
        """``cb`` runs in the reader thread after each append to
        ``self.data``; it drains/parses under ``self.lock`` itself
        (``registerDataCallback`` contract)."""
        self._callback = cb

    def clear_data_callback(self) -> None:
        self._callback = None

    def take(self, n: Optional[int] = None) -> bytes:
        """Atomically remove and return the first ``n`` buffered bytes
        (all of them if ``n`` is None) — the common drain pattern."""
        with self.lock:
            if n is None:
                out, self.data = self.data, b""
            else:
                out, self.data = self.data[:n], self.data[n:]
        return out

    def _run(self) -> None:
        while self._alive:
            try:
                ready, _, _ = select.select([self.fd], [], [],
                                            NO_DATA_TIMEOUT_S)
            except (OSError, ValueError):
                self._diag_error("select() error")
                return
            if not ready:
                if self.diag is not None:
                    self.diag.diag_warn(
                        self.name, "No data within previous second")
                continue
            try:
                chunk = os.read(self.fd, 512)
            except OSError:
                self._diag_error("read() error")
                return
            if not chunk:                      # EOF: peer closed the pty
                return
            with self.lock:
                self.data += chunk
            if self._callback is not None:
                try:
                    self._callback()
                except Exception:              # cleaner shutdown, :174-181
                    if not self._alive:
                        return
                    raise

    # -- writer ---------------------------------------------------------------

    def write_port(self, data: bytes) -> int:
        """Blocking serialized write; -1 when not connected."""
        if not self._alive:
            return -1
        with self._write_lock:
            try:
                return os.write(self.fd, data)
            except OSError:
                return -1

    def write_try(self, data: bytes) -> int:
        """Non-blocking variant: skips (returns -1) if another writer
        holds the lock (``writePortTry``)."""
        if not self._alive or not self._write_lock.acquire(blocking=False):
            return -1
        try:
            return os.write(self.fd, data)
        except OSError:
            return -1
        finally:
            self._write_lock.release()

    # -- diagnostics ----------------------------------------------------------

    def status_tick(self) -> None:
        """Periodic health entry (``diagnosticStatus`` role)."""
        if self.diag is None:
            return
        if self.connected:
            self.diag.diag_ok(self.name, "Connected")
        else:
            self.diag.diag_error(self.name, "Not connected")

    def _diag_error(self, msg: str) -> None:
        if self.diag is not None:
            self.diag.diag_error(self.name, msg)


def scan_hash_frames(buf: str, max_partial: int = 4096):
    """Scan a ``#``-prefixed, CRLF-terminated serial text stream.

    The framing shared by the runstop box (``RunStop::processData``,
    ``RunStop.cpp:84-115``) and the camera trigger (``findMessage``):
    frames look like ``#key:value\\r\\n``.  Returns ``(frames, rest)``
    where ``frames`` are the complete payloads (leading ``#`` stripped,
    CRLF excluded) and ``rest`` is the unconsumed tail to carry into the
    next read.  Garbage before a ``#`` is discarded, and a partial frame
    that grows past ``max_partial`` without its CRLF (wrong-baud noise)
    is dropped to the next ``#`` — the buffer can never grow unboundedly
    on a line that never frames.
    """
    frames = []
    while True:
        start = buf.find("#")
        if start == -1:
            return frames, ""
        if start:
            buf = buf[start:]
        end = buf.find("\r\n")
        if end == -1:
            if len(buf) > max_partial:
                nxt = buf.find("#", 1)
                if nxt == -1:
                    return frames, ""
                buf = buf[nxt:]
                continue
            return frames, buf
        frames.append(buf[1:end])
        buf = buf[end + 2:]
