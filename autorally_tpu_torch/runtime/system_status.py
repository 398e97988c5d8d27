"""Host / accelerator / time-sync telemetry (the port's copy of
``autorally_tpu/runtime/system_status.py``; the accelerator section reads
``torch.cuda``).

The reference runs two telemetry nodes feeding ``/diagnostics``:

- ``systemStatus`` (``autorally_core/src/systemStatus/systemStatus.py``):
  wireless link quality (iwconfig), battery (acpi), compute-box power
  rails (m4ctl), CPU and GPU temperature (nvml) — all shelled out to
  vendor tools.
- ``chronyStatus`` (``autorally_core/src/chronyStatus/chronyStatus.py``):
  chrony tracking/sources parsed from ``chronyc`` output.

This module re-designs both without shelling out: host metrics come
straight from ``/proc`` and ``/sys`` (load, CPU utilization, memory, disk,
thermal zones, battery, network counters, wireless link quality when
present), the accelerator section queries ``torch.cuda`` (device inventory
+ per-card memory held — the nvml role), and time synchronization reads the
kernel NTP discipline directly via ``adjtimex(2)`` (the authoritative
source chrony itself steers; no chrony dependency).  Every probe degrades
to ``None`` instead of failing on hosts without the hardware, matching the
reference's "valid" flags.
"""

from __future__ import annotations

import ctypes
import glob
import os
import time
from typing import Optional

import torch


# ---------------------------------------------------------------------------
# host probes (/proc, /sys)
# ---------------------------------------------------------------------------

def read_loadavg() -> Optional[tuple]:
    try:
        with open("/proc/loadavg") as f:
            parts = f.read().split()
        return float(parts[0]), float(parts[1]), float(parts[2])
    except (OSError, ValueError, IndexError):
        return None


def _read_proc_stat() -> Optional[tuple]:
    """(busy_jiffies, total_jiffies) from the aggregate cpu line."""
    try:
        with open("/proc/stat") as f:
            line = f.readline()
        vals = [int(v) for v in line.split()[1:]]
        idle = vals[3] + (vals[4] if len(vals) > 4 else 0)   # idle + iowait
        total = sum(vals)
        return total - idle, total
    except (OSError, ValueError, IndexError):
        return None


def read_meminfo() -> Optional[dict]:
    try:
        kv = {}
        with open("/proc/meminfo") as f:
            for line in f:
                k, v = line.split(":", 1)
                kv[k] = int(v.split()[0])            # kB
        total = kv["MemTotal"]
        avail = kv.get("MemAvailable", kv.get("MemFree", 0))
        return {"total_mb": total // 1024, "available_mb": avail // 1024,
                "used_pct": round(100.0 * (total - avail) / max(1, total), 1)}
    except (OSError, ValueError, KeyError):
        return None


def read_disk(path: str = "/") -> Optional[dict]:
    try:
        st = os.statvfs(path)
        total = st.f_blocks * st.f_frsize
        free = st.f_bavail * st.f_frsize
        return {"total_gb": round(total / 1e9, 1),
                "free_gb": round(free / 1e9, 1),
                "used_pct": round(100.0 * (total - free) / max(1, total), 1)}
    except OSError:
        return None


def read_cpu_temp() -> Optional[float]:
    """Max thermal-zone temperature in Celsius (the CPU-temp role)."""
    best = None
    for p in glob.glob("/sys/class/thermal/thermal_zone*/temp"):
        try:
            with open(p) as f:
                t = int(f.read().strip()) / 1000.0
            best = t if best is None else max(best, t)
        except (OSError, ValueError):
            continue
    return best


def read_battery() -> Optional[int]:
    """Battery percentage (the acpi PowerStatus role), None if no battery."""
    for p in glob.glob("/sys/class/power_supply/*/capacity"):
        try:
            with open(p) as f:
                return int(f.read().strip())
        except (OSError, ValueError):
            continue
    return None


def read_network() -> Optional[dict]:
    """Total rx/tx bytes over non-loopback interfaces, plus wireless link
    quality from /proc/net/wireless when present (the WirelessStatus
    role, systemStatus.py:60-72, without shelling to iwconfig)."""
    try:
        rx = tx = 0
        with open("/proc/net/dev") as f:
            for line in f.readlines()[2:]:
                name, rest = line.split(":", 1)
                if name.strip() == "lo":
                    continue
                vals = rest.split()
                rx += int(vals[0])
                tx += int(vals[8])
        out = {"rx_bytes": rx, "tx_bytes": tx}
    except (OSError, ValueError, IndexError):
        return None
    try:
        with open("/proc/net/wireless") as f:
            lines = f.readlines()[2:]
        if lines:
            tok = lines[0].split()
            out["wireless_link_quality"] = float(tok[2].rstrip("."))
    except (OSError, ValueError, IndexError):
        pass
    return out


# ---------------------------------------------------------------------------
# kernel time-sync discipline (the chronyStatus role)
# ---------------------------------------------------------------------------

_STA_UNSYNC = 0x0040
_TIME_ERROR = 5


class _Timex(ctypes.Structure):
    # linux struct timex (x86_64/aarch64 layout; trailing reserved ints)
    _fields_ = [
        ("modes", ctypes.c_uint),
        ("offset", ctypes.c_long),
        ("freq", ctypes.c_long),
        ("maxerror", ctypes.c_long),
        ("esterror", ctypes.c_long),
        ("status", ctypes.c_int),
        ("constant", ctypes.c_long),
        ("precision", ctypes.c_long),
        ("tolerance", ctypes.c_long),
        ("time_sec", ctypes.c_long),
        ("time_usec", ctypes.c_long),
        ("tick", ctypes.c_long),
        ("ppsfreq", ctypes.c_long),
        ("jitter", ctypes.c_long),
        ("shift", ctypes.c_int),
        ("stabil", ctypes.c_long),
        ("jitcnt", ctypes.c_long),
        ("calcnt", ctypes.c_long),
        ("errcnt", ctypes.c_long),
        ("stbcnt", ctypes.c_long),
        ("tai", ctypes.c_int),
        ("_reserved", ctypes.c_int * 11),
    ]


def time_sync_status() -> dict:
    """Read the kernel NTP discipline via adjtimex(2) — the state chrony
    (or any NTP daemon) steers.  ``synchronized`` is the STA_UNSYNC flag;
    offset/maxerror are the kernel's own estimates (chronyc 'tracking'
    role, chronyStatus.py:66-77, without the chrony dependency)."""
    try:
        libc = ctypes.CDLL(None, use_errno=True)
        tx = _Timex()
        tx.modes = 0                              # read-only query
        state = libc.adjtimex(ctypes.byref(tx))
        if state < 0:
            return {"available": False}
        return {
            "available": True,
            "synchronized": not (tx.status & _STA_UNSYNC)
                            and state != _TIME_ERROR,
            "clock_state": int(state),
            "offset_us": int(tx.offset),          # us unless STA_NANO
            "maxerror_us": int(tx.maxerror),
            "esterror_us": int(tx.esterror),
        }
    except Exception:
        return {"available": False}


# ---------------------------------------------------------------------------
# accelerator inventory (the nvml role)
# ---------------------------------------------------------------------------

def accelerator_status() -> dict:
    """The CUDA device inventory and the memory this process holds on each
    card (``torch.cuda``: the caching allocator's reserved bytes against the
    card's total), under the JAX package's keys (``platform``,
    ``device_count``, ``devices[]`` with ``id``, ``kind``, ``bytes_in_use``,
    ``bytes_limit``, ``hbm_used_pct``) so that the console renders both.
    With no card it reports the CPU, as the JAX package does there: a
    status report, nothing moves because of it."""
    if not torch.cuda.is_available():
        return {"platform": "cpu", "device_count": 1,
                "devices": [{"id": 0, "kind": "cpu"}]}
    n = torch.cuda.device_count()
    out = {"platform": "gpu", "device_count": n, "devices": []}
    for i in range(n):
        entry = {"id": i, "kind": torch.cuda.get_device_name(i)}
        limit = torch.cuda.get_device_properties(i).total_memory
        entry["bytes_in_use"] = int(torch.cuda.memory_reserved(i))
        entry["bytes_limit"] = int(limit)
        entry["hbm_used_pct"] = round(
            100.0 * entry["bytes_in_use"] / limit, 1)
        out["devices"].append(entry)
    return out


# ---------------------------------------------------------------------------
# the monitor node
# ---------------------------------------------------------------------------

class SystemStatusMonitor:
    """Periodic sampler feeding a :class:`DiagnosticsAggregator` component
    named ``system`` — the systemStatus + chronyStatus node pair as one
    object.  Thresholds mirror their warn semantics: high load / memory /
    disk / temperature and an unsynchronized clock degrade the level."""

    def __init__(self, diagnostics=None, period: float = 5.0,
                 include_accelerator: bool = True):
        self.diag = (diagnostics.component("system")
                     if diagnostics is not None else None)
        self.period = period
        self.include_accelerator = include_accelerator
        self._last_sample = 0.0
        self._last_stat = _read_proc_stat()
        self.last: Optional[dict] = None

    def sample(self, now: Optional[float] = None) -> dict:
        """Collect one snapshot (and push it into diagnostics)."""
        now = time.time() if now is None else now
        cpu_pct = None
        cur = _read_proc_stat()
        if cur and self._last_stat and cur[1] > self._last_stat[1]:
            busy = cur[0] - self._last_stat[0]
            total = cur[1] - self._last_stat[1]
            cpu_pct = round(100.0 * busy / max(1, total), 1)
        self._last_stat = cur

        snap = {
            "loadavg": read_loadavg(),
            "cpu_pct": cpu_pct,
            "memory": read_meminfo(),
            "disk": read_disk(),
            "cpu_temp_c": read_cpu_temp(),
            "battery_pct": read_battery(),
            "network": read_network(),
            "time_sync": time_sync_status(),
        }
        if self.include_accelerator:
            snap["accelerator"] = accelerator_status()
        self.last = snap
        self._push_diagnostics(snap)
        self._last_sample = now
        return snap

    def maybe_sample(self, now: Optional[float] = None) -> Optional[dict]:
        now = time.time() if now is None else now
        if now - self._last_sample >= self.period:
            return self.sample(now)
        return None

    def _push_diagnostics(self, snap: dict) -> None:
        if self.diag is None:
            return
        d = self.diag
        mem, disk = snap["memory"], snap["disk"]
        if snap["cpu_pct"] is not None:
            (d.diag_warn if snap["cpu_pct"] > 90 else d.diag_ok)(
                "cpu", f"{snap['cpu_pct']:.0f}% busy")
        if mem:
            (d.diag_warn if mem["used_pct"] > 90 else d.diag_ok)(
                "memory", f"{mem['used_pct']:.0f}% used "
                f"({mem['available_mb']} MB free)")
        if disk:
            (d.diag_warn if disk["used_pct"] > 90 else d.diag_ok)(
                "disk", f"{disk['used_pct']:.0f}% used "
                f"({disk['free_gb']} GB free)")
        if snap["cpu_temp_c"] is not None:
            t = snap["cpu_temp_c"]
            (d.diag_warn if t > 85 else d.diag_ok)("cpu_temp", f"{t:.0f} C")
        if snap["battery_pct"] is not None:
            b = snap["battery_pct"]
            (d.diag_warn if b < 20 else d.diag_ok)("battery", f"{b}%")
        ts = snap["time_sync"]
        if ts.get("available"):
            if ts.get("synchronized"):
                d.diag_ok("time_sync",
                          f"synchronized (offset {ts['offset_us']} us)")
            else:
                d.diag_warn("time_sync", "clock not synchronized")
        acc = snap.get("accelerator")
        if acc is not None:
            if acc["device_count"] == 0:
                d.diag_warn("accelerator", "no devices visible")
            else:
                pcts = [dev.get("hbm_used_pct") for dev in acc["devices"]
                        if dev.get("hbm_used_pct") is not None]
                worst = max(pcts) if pcts else None
                msg = (f"{acc['device_count']}x {acc['platform']}"
                       + (f", HBM {worst:.0f}%" if worst is not None else ""))
                (d.diag_warn if (worst or 0) > 95 else d.diag_ok)(
                    "accelerator", msg)
