"""Camera auto exposure/gain — the CameraAutoBalance role (port's copy).

Port of the reference's MSV (mean-sample-value) exposure controller
(``autorally_core/src/CameraAutoBalance/CameraAutoBalance.cpp:150-215``):
a luminance histogram over a region of interest (decimated 5x, BGR
weights 0.114/0.587/0.299) yields the MSV statistic; a multiplicative
control law drives shutter first and gain second toward a gray
reference, within a +-3 tolerance band:

- underexposed (error > tol): raise shutter ``u *= 1 + k*e`` until it
  saturates at ``max_shutter``, then raise gain;
- overexposed (error < -tol): lower gain until it reaches ``min_gain``,
  then lower shutter.

The hardware adjusters (FLIR Spinnaker / PtGrey Flycapture,
``SpinnakerAdjuster.cpp``/``FlycaptureAdjuster.cpp``) are SDK bindings
with no role off the vehicle; any object with ``set_shutter``/
``set_gain`` plugs in — :class:`SimulatedCamera` is the test/demo
implementation whose measured image brightness responds to
shutter x gain, closing the control loop without hardware.

The histogram path is vectorized numpy (a host-side 50-60 Hz task over
a ~0.5 MP ROI, beside the controller on the card; the reference likewise
runs it on the CPU beside the GPU controller).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

# defaults: camera_auto_balance_params.cfg + camera_auto_balance_flir.launch
MSV_REFERENCE = 120.0
MSV_TOLERANCE = 3.0            # CameraAutoBalance.cpp:56
DECIMATION = 5                 # :131 (histogram call)
EPS_SHUTTER = 1e-3             # :57
EPS_GAIN = 1e-1                # :58


@dataclasses.dataclass
class AutoBalanceConfig:
    """Launch/dynamic-reconfigure parameters (FLIR defaults)."""

    min_shutter: float = 100.0
    max_shutter: float = 10000.0
    min_gain: float = 0.01
    max_gain: float = 18.0
    k_shutter: float = 1e-3
    k_gain: float = 1e-3
    msv_reference: float = MSV_REFERENCE
    calibration_step: int = 1              # control every Nth frame
    roi: Tuple[int, int, int, int] = (0, 500, 1280, 1000)  # x0 y0 x1 y1


def luminance_histogram(image: np.ndarray,
                        roi: Optional[Tuple[int, int, int, int]] = None,
                        decimation: int = DECIMATION) -> np.ndarray:
    """256-bin luminance histogram over a decimated ROI
    (``CameraAutoBalance::histogram``, :189-210).

    ``image`` is HxWx3 BGR uint8 (the reference's cv::Mat layout) or
    HxW grayscale.  Decimation samples every Nth row/column, matching
    the reference's stride-5 walk."""
    if roi is not None:
        x0, y0, x1, y1 = roi
        image = image[y0:y1, x0:x1]
    sub = image[::decimation, ::decimation]
    if sub.ndim == 3:
        lum = (0.114 * sub[..., 0].astype(np.float64)
               + 0.587 * sub[..., 1]
               + 0.299 * sub[..., 2]).astype(np.int64)
    else:
        lum = sub.astype(np.int64)
    return np.bincount(np.clip(lum.reshape(-1), 0, 255),
                       minlength=256)[:256]


def msv(hist: np.ndarray) -> float:
    """Mean sample value: sum((i+1) h_i) / sum(h_i)
    (``CameraAutoBalance::MSV``, :170-187)."""
    total = float(hist.sum())
    if total == 0:
        return 0.0
    return float(((np.arange(256) + 1) * hist).sum() / total)


class CameraAutoBalance:
    """The exposure control loop (``autoExposureControl``, :150-168).

    ``adjuster`` needs ``set_shutter(v)`` and ``set_gain(v)``; both are
    initialized to their minima on construction
    (``cameraParametersInitialization``, :109-116)."""

    def __init__(self, adjuster, config: Optional[AutoBalanceConfig] = None):
        self.cfg = config or AutoBalanceConfig()
        self.adjuster = adjuster
        self.shutter = self.cfg.min_shutter
        self.gain = self.cfg.min_gain
        self.msv_error = 0.0
        self.frame_counter = 0
        self.adjustments = 0
        adjuster.set_shutter(self.shutter)
        adjuster.set_gain(self.gain)

    def process_frame(self, image: np.ndarray) -> Optional[float]:
        """Handle one frame (``imageCallback``): runs the controller on
        every ``calibration_step``-th frame; returns the measured MSV
        when it ran, None when skipped."""
        run = (self.frame_counter % self.cfg.calibration_step) == 0
        self.frame_counter += 1
        if not run:
            return None
        value = msv(luminance_histogram(image, self.cfg.roi))
        self._control(value)
        return value

    def _control(self, value: float) -> None:
        c = self.cfg
        self.msv_error = c.msv_reference - value
        e = self.msv_error
        if e > MSV_TOLERANCE:                       # underexposed
            if abs(c.max_shutter - self.shutter) < EPS_SHUTTER:
                self._set_gain(self.gain * (1 + c.k_gain * e))
            else:
                self._set_shutter(self.shutter * (1 + c.k_shutter * e))
        elif e < -MSV_TOLERANCE:                    # overexposed
            if abs(c.min_gain - self.gain) < EPS_GAIN:
                self._set_shutter(self.shutter * (1 + c.k_shutter * e))
            else:
                self._set_gain(self.gain * (1 + c.k_gain * e))

    def _set_shutter(self, value: float) -> None:
        self.shutter = float(np.clip(value, self.cfg.min_shutter,
                                     self.cfg.max_shutter))
        self.adjuster.set_shutter(self.shutter)
        self.adjustments += 1

    def _set_gain(self, value: float) -> None:
        self.gain = float(np.clip(value, self.cfg.min_gain,
                                  self.cfg.max_gain))
        self.adjuster.set_gain(self.gain)
        self.adjustments += 1


class SimulatedCamera:
    """Adjuster + image source whose brightness responds to
    shutter x gain — stands in for the Spinnaker/Flycapture SDK
    adjusters so the exposure loop can be closed in tests and demos."""

    def __init__(self, scene_radiance: float = 0.05,
                 shape: Tuple[int, int] = (64, 96), seed: int = 0):
        self.scene_radiance = scene_radiance
        self.shape = shape
        self.shutter = 0.0
        self.gain = 0.0
        self._rng = np.random.default_rng(seed)

    def set_shutter(self, value: float) -> None:
        self.shutter = value

    def set_gain(self, value: float) -> None:
        self.gain = value

    def capture(self) -> np.ndarray:
        """BGR frame: mean level = radiance * shutter * gain, with scene
        texture and sensor noise, clipped to 8 bits."""
        h, w = self.shape
        level = self.scene_radiance * self.shutter * max(self.gain, 1e-6)
        texture = 0.35 * level * np.sin(
            np.linspace(0, 6.0, w))[None, :, None]
        noise = self._rng.normal(0.0, 1.0, (h, w, 3))
        frame = level + texture + noise
        return np.clip(frame, 0, 255).astype(np.uint8)
