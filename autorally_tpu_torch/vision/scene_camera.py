"""Synthetic scene camera — frames with real track content (the port's copy
of ``autorally_tpu/vision/scene_camera.py``, numpy on the host).

The reference renders stereo frames in Gazebo
(``autoRallyPlatform.urdf.xacro:521-560``, ``multicamera`` plugin) that feed
CameraAutoBalance, the ImageRepublisher and the OCS image view; this module
is the producer side of that loop — no Gazebo, just the costmap the
controller already owns.

:class:`SceneRenderer` is a forward-facing pinhole ground-plane
rasterizer: each below-horizon pixel's ray is intersected with the
ground plane, the world point sampled from the costmap's channel 0 (a
direct nearest-texel numpy sample of a host copy taken once, at
construction, so the host loop never reads the card), and mapped to a
material *reflectance* — asphalt ribbon with a bright centerline, boundary
curb band, grass beyond, sky above the horizon.  Scene *illumination* is
1.0 except inside configurable shadow discs (world-frame circles), so
driving into a shaded section genuinely darkens the rendered frames.

:class:`SceneCamera` closes the exposure loop with scene content: it is
both the frame source and the adjuster target
(``set_shutter``/``set_gain``) for
:class:`~autorally_tpu_torch.vision.auto_balance.CameraAutoBalance` — pixel
value = radiance x shutter x gain + sensor noise, so the MSV statistic
responds to WHERE the car is, not to a scalar brightness knob (as
``SimulatedCamera``'s does).

The renderer is vectorized numpy at QVGA-ish sizes — a 50-60 Hz host
task beside the controller on the card, exactly where the reference runs
its camera stack.  It takes the port's :class:`Costmap` (tensors on any
device) or any object with the same ``data``, ``r_c1``, ``r_c2`` and
``trs`` arrays.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

# material reflectances (fraction of illumination returned), BGR
SKY = np.array([0.95, 0.80, 0.65])        # bright, blue-ish
ASPHALT = np.array([0.22, 0.22, 0.24])
CENTERLINE = np.array([0.85, 0.85, 0.85])
CURB = np.array([0.30, 0.30, 0.75])       # red-ish boundary band
GRASS = np.array([0.18, 0.42, 0.16])
FAR = np.array([0.35, 0.45, 0.40])        # beyond max_range haze


@dataclasses.dataclass
class SceneConfig:
    width: int = 160
    height: int = 120
    hfov_deg: float = 90.0
    cam_height: float = 0.6               # chassis-mount height (m)
    pitch_deg: float = 12.0               # downward tilt
    max_range: float = 40.0
    # world-frame shadow discs: (x, y, radius_m, illumination 0..1)
    shadows: Sequence[Tuple[float, float, float, float]] = ()
    sensitivity: float = 2.4e-3           # counts per (radiance*shutter*gain)
    noise_std: float = 1.0
    seed: int = 0


def _host(a) -> np.ndarray:
    """An array on the host (a tensor on any device is copied there)."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


class SceneRenderer:
    """Pinhole ground-plane rasterizer over a costmap."""

    def __init__(self, costmap, cfg: Optional[SceneConfig] = None):
        self.cfg = cfg or SceneConfig()
        c = self.cfg
        # costmap channel 0 + world transform as plain numpy, copied from
        # the card once
        self._ch0 = _host(costmap.data[..., 0])
        self._r_c1 = _host(costmap.r_c1)
        self._r_c2 = _host(costmap.r_c2)
        self._trs = _host(costmap.trs)
        H, W = c.height, c.width
        f = (W / 2.0) / math.tan(math.radians(c.hfov_deg) / 2.0)
        u = (np.arange(W) - (W - 1) / 2.0) / f
        v = (np.arange(H) - (H - 1) / 2.0) / f
        self._u, self._v = np.meshgrid(u, v)       # (H, W) tangents
        self._pitch = math.radians(c.pitch_deg)

    def radiance(self, pose: Sequence[float]) -> np.ndarray:
        """(H, W, 3) float BGR radiance for camera pose (x, y, yaw)."""
        c = self.cfg
        x0, y0, yaw = float(pose[0]), float(pose[1]), float(pose[2])
        sp, cp = math.sin(self._pitch), math.cos(self._pitch)
        # camera-frame ray (forward=+x, right=+y, down=+z), pitch about y
        dz = self._v * cp + sp                     # downward component
        dx_c = cp - self._v * sp                   # forward component
        ground = dz > 1e-6
        t = np.where(ground, c.cam_height / np.where(ground, dz, 1.0), 0.0)
        fwd = t * dx_c                             # forward dist to hit
        rgt = t * self._u
        in_range = ground & (fwd > 0) & (np.hypot(fwd, rgt) < c.max_range)

        # forward = (cos yaw, sin yaw); right-hand = (sin yaw, -cos yaw)
        cy, sy = math.cos(yaw), math.sin(yaw)
        wx = x0 + fwd * cy + rgt * sy
        wy = y0 + fwd * sy - rgt * cy

        # nearest-texel costmap sample (the controller's texture
        # semantics; NaN-free by construction)
        u = self._r_c1[0] * wx + self._r_c2[0] * wy + self._trs[0]
        v = self._r_c1[1] * wx + self._r_c2[1] * wy + self._trs[1]
        Hm, Wm = self._ch0.shape
        ix = np.clip((u * Wm).astype(np.int32), 0, Wm - 1)
        iy = np.clip((v * Hm).astype(np.int32), 0, Hm - 1)
        val = self._ch0[iy, ix]

        refl = np.empty(val.shape + (3,), dtype=np.float64)
        refl[:] = GRASS
        on = val <= 1.0
        refl[on] = ASPHALT
        refl[on & (val < 0.08)] = CENTERLINE       # painted centerline
        refl[(val > 0.65) & (val <= 1.0)] = CURB   # boundary band
        refl[~in_range] = FAR
        refl[~ground | (fwd <= 0)] = SKY

        illum = np.ones(val.shape)
        for (sx, sy_, r, f_) in c.shadows:
            d2 = (wx - sx) ** 2 + (wy - sy_) ** 2
            illum = np.where(in_range & (d2 < r * r), illum * f_, illum)
        # sky/far keep full illumination
        illum = np.where(in_range, illum, 1.0)
        return refl * illum[..., None]


class SceneCamera:
    """Frame source + exposure adjuster over a :class:`SceneRenderer`.

    Use as the ``adjuster`` of :class:`CameraAutoBalance` AND as the
    frame producer::

        cam = SceneCamera(SceneRenderer(costmap, cfg))
        ab = CameraAutoBalance(cam, AutoBalanceConfig(roi=None ...))
        frame = cam.capture(pose)
        ab.process_frame(frame)
    """

    def __init__(self, renderer: SceneRenderer):
        self.renderer = renderer
        self.shutter = 0.0
        self.gain = 0.0
        self._rng = np.random.default_rng(renderer.cfg.seed)

    def set_shutter(self, value: float) -> None:
        self.shutter = float(value)

    def set_gain(self, value: float) -> None:
        self.gain = float(value)

    def capture(self, pose: Sequence[float]) -> np.ndarray:
        """Render + expose one BGR uint8 frame at ``pose``."""
        c = self.renderer.cfg
        radiance = self.renderer.radiance(pose)
        level = (radiance * c.sensitivity * self.shutter
                 * max(self.gain, 1e-6) * 255.0)
        noise = self._rng.normal(0.0, c.noise_std, level.shape)
        return np.clip(level + noise, 0, 255).astype(np.uint8)


def project_points(renderer: SceneRenderer, cam_pose: Sequence[float],
                   world_xy: np.ndarray) -> np.ndarray:
    """Project world ground points into pixel coordinates.

    ``world_xy``: (N, 2).  Returns (N, 3) columns [u, v, visible] —
    the inverse of the rasterizer's ray-ground intersection, used to
    overlay the planned trajectory on rendered frames (the OCS image
    masks role, ``autorally_core/src/ocs/``).
    """
    c = renderer.cfg
    x0, y0, yaw = (float(cam_pose[0]), float(cam_pose[1]),
                   float(cam_pose[2]))
    dx = world_xy[:, 0] - x0
    dy = world_xy[:, 1] - y0
    cy, sy = math.cos(yaw), math.sin(yaw)
    fwd = dx * cy + dy * sy                     # camera-frame forward
    rgt = dx * sy - dy * cy                     # right-hand (sin, -cos)
    sp, cp = math.sin(renderer._pitch), math.cos(renderer._pitch)
    h = c.cam_height
    # invert the rasterizer's ray-ground mapping: with ray components
    # dz = v*cp + sp (down), dx_c = cp - v*sp (forward), dy_c = u and
    # ground hit t = h/dz, fwd = t*dx_c, rgt = t*u:
    #   v = (h*cp - fwd*sp) / (fwd*cp + h*sp)
    #   u = rgt * (v*cp + sp) / h
    denom = fwd * cp + h * sp
    safe = denom > 1e-6
    v_t = np.where(safe, (h * cp - fwd * sp) / np.where(safe, denom, 1.0),
                   0.0)
    u_t = rgt * (v_t * cp + sp) / h
    H, W = c.height, c.width
    f = (W / 2.0) / math.tan(math.radians(c.hfov_deg) / 2.0)
    u_px = u_t * f + (W - 1) / 2.0
    v_px = v_t * f + (H - 1) / 2.0
    vis = (safe & (fwd > 0.2) & (u_px >= 0) & (u_px < W)
           & (v_px >= 0) & (v_px < H))
    return np.stack([u_px, v_px, vis.astype(np.float64)], axis=1)


PATH_COLOR = np.array([60, 240, 60], dtype=np.uint8)     # BGR green


def draw_path(frame: np.ndarray, renderer: SceneRenderer,
              cam_pose: Sequence[float], states: np.ndarray,
              thickness: int = 1) -> np.ndarray:
    """Overlay the nominal trajectory (``state_solution`` (T, S) or any
    (N, >=2) world path, a tensor on any device or an array) on a rendered
    frame — the reference publishes its nominal path for display
    (``autorally_plant.cpp:311-351``); here it lands IN the camera view.
    Returns a copy with the overlay."""
    out = frame.copy()
    pts = project_points(renderer, cam_pose, _host(states)[:, :2])
    H, W = out.shape[:2]
    for u, v, vis in pts:
        if not vis:
            continue
        x0, x1 = max(int(u) - thickness, 0), min(int(u) + thickness + 1, W)
        y0, y1 = max(int(v) - thickness, 0), min(int(v) + thickness + 1, H)
        out[y0:y1, x0:x1] = PATH_COLOR
    return out


ASCII_RAMP = " .:-=+*#%@"


def ascii_frame(frame: np.ndarray, cols: int = 48,
                rows: int = 14) -> list:
    """Downsample a frame to an ASCII luminance view (OCS image panel,
    terminal edition).  Returns a list of strings."""
    if frame.ndim == 3:
        lum = (0.114 * frame[..., 0].astype(np.float64)
               + 0.587 * frame[..., 1] + 0.299 * frame[..., 2])
    else:
        lum = frame.astype(np.float64)
    H, W = lum.shape
    ys = np.linspace(0, H - 1, rows).astype(int)
    xs = np.linspace(0, W - 1, cols).astype(int)
    sub = lum[np.ix_(ys, xs)]
    idx = np.clip((sub / 255.0 * (len(ASCII_RAMP) - 1)).astype(int),
                  0, len(ASCII_RAMP) - 1)
    return ["".join(ASCII_RAMP[j] for j in r) for r in idx]
