"""Bandwidth-limited image republisher — the ImageRepublisher role (port's
copy).

The reference republishes camera frames at reduced rate/size so the
operator station can watch over wireless
(``autorally_core/src/ImageRepublisher/``).  Same job here: cap the
forward rate, downsample by integer striding (no cv2 dependency), and
hand frames to a callback (e.g. the telemetry bus or an OCS socket)."""

from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np


class ImageRepublisher:
    def __init__(self, on_frame: Callable[[np.ndarray, float], None],
                 max_hz: float = 5.0, scale: int = 4,
                 clock: Callable[[], float] = time.time):
        if scale < 1:
            raise ValueError("scale must be >= 1")
        self.on_frame = on_frame
        self.period = 1.0 / max_hz
        self.scale = scale
        self.clock = clock
        self.forwarded = 0
        self.dropped = 0
        self._last: Optional[float] = None

    def ready(self) -> bool:
        """Whether the next :meth:`process` call would forward — lets a
        caller skip expensive frame annotation (overlays) for frames the
        rate cap will drop anyway."""
        now = self.clock()
        return self._last is None or now - self._last >= self.period

    def process(self, frame: np.ndarray) -> bool:
        """Forward the frame if the rate budget allows; returns whether
        it was forwarded."""
        now = self.clock()
        if self._last is not None and now - self._last < self.period:
            self.dropped += 1
            return False
        self._last = now
        small = frame[::self.scale, ::self.scale]
        self.on_frame(np.ascontiguousarray(small), now)
        self.forwarded += 1
        return True
