"""Diagnostics aggregation — keyed status messages with periodic rollup (the
port's copy of ``autorally_tpu/runtime/diagnostics.py``, plain Python).

Port of the reference ``Diagnostics`` base class
(``autorally_core/include/autorally_core/Diagnostics.h`` /
``src/Diagnostics/``): components report keyed OK/WARN/ERROR entries
plus "tick" heartbeat counters; the aggregator publishes a 1 Hz rollup
whose overall level is the worst component level (what the OCS dashboard
consumes in the reference).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

OK, WARN, ERROR = 0, 1, 2
_LEVEL_NAMES = {OK: "ok", WARN: "warn", ERROR: "error"}


@dataclasses.dataclass
class DiagEntry:
    level: int
    message: str
    stamp: float


class Diagnostics:
    """Per-component keyed diagnostics (diag/diag_ok/diag_warn/diag_error
    + tick in the reference API)."""

    def __init__(self, name: str, hardware_id: str = ""):
        self.name = name
        self.hardware_id = hardware_id
        self.entries: Dict[str, DiagEntry] = {}
        self.ticks: Dict[str, int] = {}

    def diag(self, key: str, value: str, level: int = OK,
             now: Optional[float] = None) -> None:
        self.entries[key] = DiagEntry(level, value, now or time.time())

    def diag_ok(self, key: str, msg: str = "") -> None:
        self.diag(key, msg, OK)

    def diag_warn(self, key: str, msg: str = "") -> None:
        self.diag(key, msg, WARN)

    def diag_error(self, key: str, msg: str = "") -> None:
        self.diag(key, msg, ERROR)

    def tick(self, key: str) -> None:
        """Heartbeat counter (rates reported at rollup)."""
        self.ticks[key] = self.ticks.get(key, 0) + 1

    @property
    def level(self) -> int:
        return max((e.level for e in self.entries.values()), default=OK)


class DiagnosticsAggregator:
    """Collects components; 1 Hz rollup with worst-level summary."""

    def __init__(self, publish_hz: float = 1.0,
                 on_publish: Optional[Callable[[dict], None]] = None):
        self.components: Dict[str, Diagnostics] = {}
        self.period = 1.0 / publish_hz
        self.on_publish = on_publish
        self._last_publish = 0.0
        self.history: List[dict] = []

    def register(self, diag: Diagnostics) -> Diagnostics:
        self.components[diag.name] = diag
        return diag

    def component(self, name: str) -> Diagnostics:
        if name not in self.components:
            self.register(Diagnostics(name))
        return self.components[name]

    def rollup(self, now: Optional[float] = None) -> dict:
        now = now or time.time()
        comps = {}
        worst = OK
        for name, d in self.components.items():
            worst = max(worst, d.level)
            comps[name] = {
                "level": _LEVEL_NAMES[d.level],
                "entries": {k: {"level": _LEVEL_NAMES[e.level],
                                "message": e.message}
                            for k, e in d.entries.items()},
                "ticks": dict(d.ticks),
            }
        return {"stamp": now, "level": _LEVEL_NAMES[worst],
                "components": comps}

    def maybe_publish(self, now: Optional[float] = None) -> Optional[dict]:
        now = now or time.time()
        if now - self._last_publish < self.period:
            return None
        self._last_publish = now
        report = self.rollup(now)
        self.history.append(report)
        if self.on_publish:
            self.on_publish(report)
        # reset tick counters per publish interval (rate semantics)
        for d in self.components.values():
            d.ticks.clear()
        return report
