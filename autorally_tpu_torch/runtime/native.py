"""ctypes bindings for the native real-time runtime (the port's copy of
``autorally_tpu/runtime/native.py``).

Provides :class:`Ring` (lock-free SPSC float-record buffer), :class:`Pacer`
(absolute-deadline loop pacing, ``clock_nanosleep`` on ``TIMER_ABSTIME``)
and :class:`UdpLink` (binary float-record transport over loopback UDP, the
role ROS pub/sub plays for the reference).

The library is ``native/artpu_rt.cpp``, compiled at first use by ``g++``
with ``native/Makefile``'s flags into
``autorally_tpu_torch/_build/libartpu_rt.so`` (listed in ``.gitignore``);
``native/`` itself is only read.  A failed build or load raises with the
compiler's output wherever the caller needs the library;
``native_available()`` answers whether it loads.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_ROOT = Path(__file__).resolve().parent.parent.parent
SOURCE = _ROOT / "native" / "artpu_rt.cpp"
BUILD_DIR = _ROOT / "autorally_tpu_torch" / "_build"
SO_PATH = BUILD_DIR / "libartpu_rt.so"
# native/Makefile's CXXFLAGS and link step
CXX_FLAGS = ("-O2", "-std=c++17", "-Wall", "-fPIC", "-pthread", "-shared")

_LIB: Optional[ctypes.CDLL] = None
_LOCK = threading.Lock()

_V, _SZ, _U64 = ctypes.c_void_p, ctypes.c_size_t, ctypes.c_uint64
_FP = ctypes.POINTER(ctypes.c_float)
# name -> (restype, argtypes)
SIGNATURES = {
    "artpu_ring_create": (_V, [_SZ, _SZ]),
    "artpu_ring_destroy": (None, [_V]),
    "artpu_ring_push": (ctypes.c_int, [_V, _FP]),
    "artpu_ring_pop": (ctypes.c_int, [_V, _FP]),
    "artpu_ring_pop_latest": (ctypes.c_int, [_V, _FP]),
    "artpu_ring_dropped": (_U64, [_V]),
    "artpu_pace_create": (_V, [ctypes.c_int64]),
    "artpu_pace_destroy": (None, [_V]),
    "artpu_pace_wait": (ctypes.c_int, [_V]),
    "artpu_pace_ticks": (_U64, [_V]),
    "artpu_pace_missed": (_U64, [_V]),
    "artpu_udp_rx_start": (_V, [ctypes.c_uint16, _V, _SZ]),
    "artpu_udp_rx_stop": (None, [_V]),
    "artpu_udp_rx_received": (_U64, [_V]),
    "artpu_udp_send": (ctypes.c_int, [ctypes.c_uint16, _FP, _SZ]),
}


def _build() -> None:
    """Compile the library into ``SO_PATH`` (atomically: a concurrent
    loader sees the old file or the new one); raises with the compiler's
    output."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cxx = os.environ.get("CXX", "g++")
    try:
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, str(SOURCE)],
                              capture_output=True, text=True)
    except FileNotFoundError as e:
        os.unlink(tmp)
        raise RuntimeError(f"native runtime: {cxx} not found ({e})") from e
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"native runtime: {cxx} failed for "
                           f"{SOURCE.name}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, SO_PATH)


def load() -> ctypes.CDLL:
    """The native library, built first when its ``.so`` is missing."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            if not SO_PATH.exists():
                _build()
            lib = ctypes.CDLL(str(SO_PATH))
            for name, (res, args) in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype, fn.argtypes = res, args
            _LIB = lib
    return _LIB


def native_available() -> bool:
    """Whether the library builds and loads here."""
    try:
        load()
    except (RuntimeError, OSError):
        return False
    return True


def _floats(rec) -> tuple:
    """A contiguous float32 copy of ``rec`` and its pointer (the array
    stays referenced by the caller for as long as the pointer is used)."""
    rec = np.ascontiguousarray(rec, dtype=np.float32)
    return rec, rec.ctypes.data_as(_FP)


class Ring:
    """Lock-free SPSC ring of fixed-size float records (latest-wins)."""

    def __init__(self, capacity: int, record_len: int):
        self._lib = load()
        self.record_len = int(record_len)
        self._h = self._lib.artpu_ring_create(capacity, self.record_len)
        self._buf = (ctypes.c_float * self.record_len)()

    def push(self, rec: np.ndarray) -> bool:
        """Returns True if an old record was dropped to make room."""
        rec, ptr = _floats(rec)
        if rec.size != self.record_len:
            raise ValueError(f"record of {rec.size} floats, ring holds "
                             f"{self.record_len}")
        return bool(self._lib.artpu_ring_push(self._h, ptr))

    def pop(self) -> Optional[np.ndarray]:
        if self._lib.artpu_ring_pop(self._h, self._buf):
            return np.ctypeslib.as_array(self._buf).copy()
        return None

    def pop_latest(self) -> Optional[np.ndarray]:
        """Drain; return the newest record (None if empty)."""
        if self._lib.artpu_ring_pop_latest(self._h, self._buf):
            return np.ctypeslib.as_array(self._buf).copy()
        return None

    @property
    def dropped(self) -> int:
        return int(self._lib.artpu_ring_dropped(self._h))

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.artpu_ring_destroy(self._h)
            self._h = None

    def __del__(self):
        self.close()


class Pacer:
    """Absolute-deadline loop pacing (``clock_nanosleep`` TIMER_ABSTIME):
    the first deadline is one period after construction."""

    def __init__(self, period_s: float):
        self._lib = load()
        self._h = self._lib.artpu_pace_create(int(period_s * 1e9))

    def wait(self) -> int:
        """Sleep to the next deadline; returns missed whole periods."""
        return int(self._lib.artpu_pace_wait(self._h))

    @property
    def ticks(self) -> int:
        return int(self._lib.artpu_pace_ticks(self._h))

    @property
    def missed(self) -> int:
        return int(self._lib.artpu_pace_missed(self._h))

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.artpu_pace_destroy(self._h)
            self._h = None

    def __del__(self):
        self.close()


class UdpLink:
    """Loopback UDP float-record transport into a :class:`Ring` (a receive
    thread in the library pushes every datagram of the ring's record
    length)."""

    def __init__(self, port: int, ring: Ring):
        self._lib = load()
        self.port = int(port)
        self._ring = ring                 # the receive thread writes into it
        self._h = self._lib.artpu_udp_rx_start(self.port, ring._h,
                                               ring.record_len)
        if not self._h:
            raise OSError(f"failed to bind UDP port {self.port}")

    @staticmethod
    def send(port: int, rec: np.ndarray) -> None:
        rec, ptr = _floats(rec)
        if load().artpu_udp_send(int(port), ptr, rec.size) != 0:
            raise OSError("udp send failed")

    @property
    def received(self) -> int:
        return int(self._lib.artpu_udp_rx_received(self._h))

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.artpu_udp_rx_stop(self._h)
            self._h = None

    def __del__(self):
        self.close()
