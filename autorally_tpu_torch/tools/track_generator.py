"""Track costmaps (the port's own copy of the track builders of
``autorally_tpu/tools/track_generator.py``; their arrays are identical).

channel0 is 0 on the track centerline, 1 at the track edge and grows
beyond 1 off-track — the convention the cost's ``boundary_threshold`` crash
check expects (``costs.cu:389-391``, ``params/maps/README.md``).

Procedural tracks (:func:`oval_track`, :func:`straight_track`,
:func:`spline_track`) and the reference's two real circuits rasterized
from its Gazebo ground textures (:func:`ccrf_track`,
:func:`marietta_track`), which live in the reference checkout's
``autorally_description`` directory (found through the
``AUTORALLY_DESCRIPTION`` environment variable, else relative to the
working directory); a missing texture raises ``FileNotFoundError``.  The
reference's offline map tooling: :func:`gen_costmap_from_image`
(``scripts/track_generator.py``: image -> ``.npz``; PIL is imported when
it is called) and :func:`convert_legacy_txt`
(``scripts/track_converter.py``: legacy ``.txt`` -> ``.npz``), and the
command line :func:`main` (``oval``, ``spline``, ``image``, ``convert``),
which writes the same ``.npz`` files as the JAX package's.
"""

from __future__ import annotations

import argparse
import ast
import os
from typing import Tuple

import numpy as np

from autorally_tpu_torch.costs.costmap import (Costmap, make_costmap,
                                               save_costmap)


def oval_track(half_length: float = 25.0, half_width: float = 15.0,
               track_width: float = 5.0, ppm: float = 10.0,
               margin: float = 10.0) -> Tuple[np.ndarray, tuple, tuple]:
    """Procedural oval (ellipse) track: ``(data (H, W, 4), x_bounds,
    y_bounds)``; channel0 is the normalized distance from the centerline."""
    x_min, x_max = -half_length - margin, half_length + margin
    y_min, y_max = -half_width - margin, half_width + margin
    W = int((x_max - x_min) * ppm)
    H = int((y_max - y_min) * ppm)
    xs = x_min + (np.arange(W) + 0.5) / ppm
    ys = y_min + (np.arange(H) + 0.5) / ppm
    X, Y = np.meshgrid(xs, ys)

    # Distance to the ellipse centerline, approximated via the radial
    # parameterization (exact enough for a cost surface).
    theta = np.arctan2(Y / half_width, X / half_length)
    cx = half_length * np.cos(theta)
    cy = half_width * np.sin(theta)
    dist = np.hypot(X - cx, Y - cy)

    data = np.zeros((H, W, 4), dtype=np.float32)
    data[..., 0] = (2.0 * dist / track_width).astype(np.float32)
    return data, (x_min, x_max), (y_min, y_max)


def straight_track(length: float = 200.0, track_width: float = 8.0,
                   ppm: float = 10.0, margin: float = 10.0
                   ) -> Tuple[np.ndarray, tuple, tuple]:
    """Infinite-straightaway costmap along +x (for speed/regression tests)."""
    x_min, x_max = -margin, length + margin
    y_min, y_max = -track_width / 2 - margin, track_width / 2 + margin
    W = int((x_max - x_min) * ppm)
    H = int((y_max - y_min) * ppm)
    ys = y_min + (np.arange(H) + 0.5) / ppm
    channel0 = (2.0 * np.abs(ys) / track_width).astype(np.float32)
    data = np.zeros((H, W, 4), dtype=np.float32)
    data[..., 0] = channel0[:, None]
    return data, (x_min, x_max), (y_min, y_max)


#: A winding closed circuit in the spirit of the reference's CCRF kart
#: track: alternating left/right curves, a hairpin, and two straights,
#: ~175 m lap length.
WINDING_WAYPOINTS = (
    (0.0, 0.0), (12.0, -2.0), (24.0, 0.0), (32.0, 6.0), (34.0, 14.0),
    (28.0, 20.0), (20.0, 18.0), (14.0, 22.0), (14.0, 30.0), (22.0, 34.0),
    (30.0, 32.0), (38.0, 34.0), (42.0, 40.0), (38.0, 46.0), (28.0, 46.0),
    (16.0, 44.0), (6.0, 46.0), (-2.0, 42.0), (-6.0, 34.0), (-4.0, 26.0),
    (-8.0, 18.0), (-10.0, 10.0), (-6.0, 2.0),
)


def spline_track(waypoints=WINDING_WAYPOINTS, track_width: float = 6.0,
                 ppm: float = 10.0, margin: float = 10.0,
                 samples_per_meter: float = 20.0
                 ) -> Tuple[np.ndarray, tuple, tuple]:
    """Closed circuit through waypoints via a periodic cubic spline:
    channel0 is the normalized distance to the spline centerline, as in
    :func:`oval_track`."""
    from scipy.interpolate import CubicSpline
    from scipy.spatial import cKDTree

    wp = np.asarray(waypoints, dtype=np.float64)
    pts = np.vstack([wp, wp[:1]])                # close the loop
    seg = np.hypot(*np.diff(pts, axis=0).T)
    t = np.concatenate([[0.0], np.cumsum(seg)])
    cs_x = CubicSpline(t, pts[:, 0], bc_type="periodic")
    cs_y = CubicSpline(t, pts[:, 1], bc_type="periodic")
    s = np.linspace(0.0, t[-1], int(t[-1] * samples_per_meter),
                    endpoint=False)
    center = np.stack([cs_x(s), cs_y(s)], axis=1)

    x_min = center[:, 0].min() - margin
    x_max = center[:, 0].max() + margin
    y_min = center[:, 1].min() - margin
    y_max = center[:, 1].max() + margin
    W = int((x_max - x_min) * ppm)
    H = int((y_max - y_min) * ppm)
    xs = x_min + (np.arange(W) + 0.5) / ppm
    ys = y_min + (np.arange(H) + 0.5) / ppm
    X, Y = np.meshgrid(xs, ys)
    grid = np.stack([X.ravel(), Y.ravel()], axis=1)
    dist, _ = cKDTree(center).query(grid, k=1)
    data = np.zeros((H, W, 4), dtype=np.float32)
    data[..., 0] = (2.0 * dist.reshape(H, W) / track_width).astype(np.float32)
    return data, (x_min, x_max), (y_min, y_max)


# The reference's Gazebo textures (autorally_description/urdf/textures).
_DESCRIPTION = os.environ.get("AUTORALLY_DESCRIPTION", "autorally_description")
_TEXTURES = os.path.join(_DESCRIPTION, "urdf", "textures")

#: The CCRF circuit: the blended ground texture paints the drivable
#: corridor (alpha 0 where the track shows through) on a 45 x 60 m plane
#: (models/blended_track_ccrf/model.sdf) placed at (-22.5, -18.5)
#: (urdf/worlds/ccrf_track.world); only the flipped row-major mapping (row
#: 0 = -y) lands the ribbon on the barrier mesh.
CCRF_TEXTURE = os.path.join(_TEXTURES, "blended_texture_ccrf.png")
CCRF_PLANE = (45.0, 60.0)
CCRF_POSE = (-22.5, -18.5)

#: Start pose on the CCRF main straight and the lap line perpendicular to
#: the corridor there (from :func:`ccrf_start` on the built map, frozen);
#: one lap is one crossing.
CCRF_START = (-25.55, -7.75, -2.2717)
CCRF_LAP_LINE = (-0.8438, -29.31, -28.55, -22.55)

#: The Marietta street track (``populated_marietta.world``): the same
#: encoding on a 90 x 90 m plane, built in the plane's local frame.
MARIETTA_TEXTURE = os.path.join(_TEXTURES, "blended_texture_marietta.png")
MARIETTA_START = (-11.745, -1.3275, 1.7876)
MARIETTA_LAP_LINE = (0.2203, 1.26, -14.745, -8.745)


def _texture_track(texture_path: str, plane: Tuple[float, float],
                   pose: Tuple[float, float], ppm: float, margin: float
                   ) -> Tuple[np.ndarray, tuple, tuple]:
    """Drivable-ribbon texture -> reference-convention costmap
    ``(data (H, W, 4) float32, x_bounds, y_bounds)``: on the track,
    channel0 is 1 minus the distance to the boundary over the corridor's
    half-width at the nearest medial-axis point (0 on the centerline, 1 at
    the edge); off the track it is 1 + the distance to the track in
    meters.  The texture is padded with off-track texels before the crop,
    so that no track touches the map's border.  Raises
    ``FileNotFoundError`` when the texture is absent."""
    if not os.path.exists(texture_path):
        raise FileNotFoundError(
            f"track texture {texture_path!r} not found: it is the reference "
            "checkout's autorally_description texture (set "
            "AUTORALLY_DESCRIPTION to that directory)")
    from PIL import Image
    from scipy import ndimage
    from scipy.spatial import cKDTree

    img = np.array(Image.open(texture_path))
    if img.ndim != 3 or img.shape[2] != 4:
        raise ValueError(f"expected RGBA texture, got {img.shape}")
    # row-major with +y up: the mapping that lands the ribbon on the walls
    mask = np.flipud(img[..., 3] < 128)
    tex_ppm = mask.shape[1] / plane[0]
    # one pixels-per-meter scale throughout: demand isotropy
    tex_ppm_y = mask.shape[0] / plane[1]
    if abs(tex_ppm_y - tex_ppm) > 1e-3 * tex_ppm:
        raise ValueError(
            f"anisotropic texture: {tex_ppm:.4f} px/m in x vs "
            f"{tex_ppm_y:.4f} px/m in y for {texture_path!r}; "
            "resample the texture to square pixels first")
    x00 = pose[0] - plane[0] / 2.0
    y00 = pose[1] - plane[1] / 2.0

    rows, cols = np.where(mask)
    pad = int(round(margin * tex_ppm))
    # beyond the ground plane there is no track: pad off-track before the
    # crop, or the clamped lookup would extend a track texel on the border
    mask = np.pad(mask, pad, constant_values=False)
    rows = rows + pad
    cols = cols + pad
    x00 -= pad / tex_ppm
    y00 -= pad / tex_ppm
    r0 = max(int(rows.min()) - pad, 0)
    r1 = min(int(rows.max()) + pad, mask.shape[0])
    c0 = max(int(cols.min()) - pad, 0)
    c1 = min(int(cols.max()) + pad, mask.shape[1])
    f = max(1, int(round(tex_ppm / ppm)))
    r1 -= (r1 - r0) % f
    c1 -= (c1 - c0) % f
    m = mask[r0:r1, c0:c1]
    H, W = m.shape
    if f > 1:
        m = m.reshape(H // f, f, W // f, f).mean(axis=(1, 3)) >= 0.5
    out_ppm = tex_ppm / f

    dt_in = ndimage.distance_transform_edt(m) / out_ppm
    dt_out = ndimage.distance_transform_edt(~m) / out_ppm
    # medial axis ~ local maxima of the inside distance field; a pixel's
    # half-width is the distance at its nearest medial point
    medial = m & (dt_in >= ndimage.maximum_filter(dt_in, size=3) - 1e-9)
    mr, mc = np.where(medial)
    tr, tc = np.where(m)
    _, nearest = cKDTree(np.stack([mr, mc], 1)).query(
        np.stack([tr, tc], 1), k=1)
    local_halfw = np.maximum(dt_in[mr[nearest], mc[nearest]], 1e-3)

    channel0 = (1.0 + dt_out).astype(np.float32)
    channel0[tr, tc] = np.clip(1.0 - dt_in[tr, tc] / local_halfw,
                               0.0, 1.0).astype(np.float32)
    data = np.zeros(m.shape + (4,), dtype=np.float32)
    data[..., 0] = channel0
    xb = (x00 + c0 / tex_ppm, x00 + c1 / tex_ppm)
    yb = (y00 + r0 / tex_ppm, y00 + r1 / tex_ppm)
    return data, xb, yb


def ccrf_track(ppm: float = 10.0, margin: float = 8.0,
               texture_path: str = CCRF_TEXTURE
               ) -> Tuple[np.ndarray, tuple, tuple]:
    """The CCRF circuit's costmap in the Gazebo world frame (the
    ``path_integral_nn.launch`` operating point; :func:`_texture_track`)."""
    return _texture_track(texture_path, CCRF_PLANE, CCRF_POSE, ppm, margin)


def marietta_track(ppm: float = 10.0, margin: float = 8.0,
                   texture_path: str = MARIETTA_TEXTURE
                   ) -> Tuple[np.ndarray, tuple, tuple]:
    """The Marietta street track's costmap in the ground plane's local
    frame (the ``path_integral_bf.launch`` operating point)."""
    return _texture_track(texture_path, (90.0, 90.0), (0.0, 0.0), ppm,
                          margin)


def ccrf_start(data: np.ndarray, xb: tuple, yb: tuple,
               anchor: Tuple[float, float] = (-24.0, -9.0)
               ) -> Tuple[tuple, tuple]:
    """A start pose on the CCRF main straight (the deepest on-track pixel
    within 2 m of ``anchor``, heading along the corridor's principal axis)
    and the lap line perpendicular to it there: ``((x, y, heading),
    (slope, intercept, x_min, x_max))``.  CCRF_START and CCRF_LAP_LINE
    come from it."""
    from scipy import ndimage

    m = data[..., 0] <= 1.0
    ppm = m.shape[1] / (xb[1] - xb[0])
    dt = ndimage.distance_transform_edt(m) / ppm
    ys, xs = np.where(m)
    wx = xb[0] + (xs + 0.5) / ppm
    wy = yb[0] + (ys + 0.5) / ppm
    sel = np.hypot(wx - anchor[0], wy - anchor[1]) < 2.0
    cand = int(np.argmax(np.where(sel, dt[ys, xs], -1.0)))
    sx, sy = float(wx[cand]), float(wy[cand])
    deep = dt[ys, xs] > 0.6 * np.percentile(dt[ys, xs], 97)
    near = deep & (np.hypot(wx - sx, wy - sy) < 5.0)
    pts = np.stack([wx[near], wy[near]], 1)
    pts -= pts.mean(0)
    _, _, vt = np.linalg.svd(pts, full_matrices=False)
    dx, dy = float(vt[0, 0]), float(vt[0, 1])
    heading = float(np.arctan2(dy, dx))
    slope = -dx / dy                       # line perpendicular to travel
    intercept = sy - slope * sx
    return ((sx, sy, heading),
            (round(slope, 4), round(intercept, 2), sx - 3.0, sx + 3.0))


def make_ccrf_costmap(device=None, **kw) -> Costmap:
    return make_costmap(*ccrf_track(**kw), device=device)


def make_marietta_costmap(device=None, **kw) -> Costmap:
    return make_costmap(*marietta_track(**kw), device=device)


def make_oval_costmap(device=None, **kw) -> Costmap:
    return make_costmap(*oval_track(**kw), device=device)


def make_spline_costmap(device=None, **kw) -> Costmap:
    return make_costmap(*spline_track(**kw), device=device)


def make_straight_costmap(device=None, **kw) -> Costmap:
    return make_costmap(*straight_track(**kw), device=device)


def gen_costmap_from_image(input_img: str, config_file: str,
                           output_name: str) -> None:
    """Image -> ``.npz`` costmap (parity with ``scripts/track_generator.py``):
    per-channel offset/normalize, channel remap, optional vertical flip.
    The config file is the reference's Python dict literal."""
    from PIL import Image

    with open(config_file, "r") as f:
        cfg = ast.literal_eval(f.read())

    img = Image.open(input_img).rotate(cfg["imageRotation"])
    data = np.array(img, dtype=np.float32)
    for i, ch in enumerate("rgba"):
        data[:, :, i] = ((data[:, :, i] + cfg[f"{ch}Offset"])
                         / cfg[f"{ch}Normalizer"])
    costmap = np.copy(data)
    for i in range(4):
        costmap[:, :, cfg["channelMap"][i]] = data[:, :, i]
    if cfg["flip"]:
        for i in range(4):
            costmap[:, :, i] = np.flipud(costmap[:, :, i])
    save_costmap(costmap, cfg["xBounds"], cfg["yBounds"],
                 cfg["pixelsPerMeter"], output_name)


def convert_legacy_txt(input_txt: str, output_name: str) -> None:
    """Legacy ``.txt`` costmap -> ``.npz`` (parity with
    ``scripts/track_converter.py``): whitespace-separated
    [x_min x_max y_min y_max ppm v0 v1 ...] with channel 0 data only."""
    with open(input_txt) as f:
        cmap = f.read().split(" ")
    x_bounds = np.array(cmap[0:2], dtype=np.float32)
    y_bounds = np.array(cmap[2:4], dtype=np.float32)
    ppm = float(cmap[4])
    channel0 = np.array([c for c in cmap[5:] if c.strip()], dtype=np.float32)
    H = int((y_bounds[1] - y_bounds[0]) * ppm)
    W = int((x_bounds[1] - x_bounds[0]) * ppm)
    data = np.zeros((H, W, 4), dtype=np.float32)
    data[..., 0] = channel0.reshape(H, W)
    save_costmap(data, x_bounds, y_bounds, ppm, output_name)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="Generate a costmap .npz")
    sub = p.add_subparsers(dest="cmd", required=True)

    po = sub.add_parser("oval", help="synthetic oval track")
    po.add_argument("-o", "--output", default="oval_costmap.npz")
    po.add_argument("--half-length", type=float, default=25.0)
    po.add_argument("--half-width", type=float, default=15.0)
    po.add_argument("--track-width", type=float, default=5.0)
    po.add_argument("--ppm", type=float, default=10.0)

    pi = sub.add_parser("image", help="image -> costmap (reference parity)")
    pi.add_argument("-i", "--input", required=True)
    pi.add_argument("-c", "--config", required=True)
    pi.add_argument("-o", "--output", default="map.npz")

    pc = sub.add_parser("convert", help="legacy .txt -> .npz")
    pc.add_argument("-i", "--input", required=True)
    pc.add_argument("-o", "--output", default="map.npz")

    ps = sub.add_parser("spline", help="closed spline circuit through "
                                       "waypoints (default: the winding "
                                       "CCRF-role circuit)")
    ps.add_argument("-o", "--output", default="spline_costmap.npz")
    ps.add_argument("--waypoints", default=None,
                    help="semicolon-separated 'x,y' pairs; default = the "
                         "built-in winding circuit")
    ps.add_argument("--track-width", type=float, default=6.0)
    ps.add_argument("--ppm", type=float, default=10.0)

    args = p.parse_args(argv)
    if args.cmd == "convert":
        convert_legacy_txt(args.input, args.output)
        print(f"wrote {args.output}")
        return
    if args.cmd == "oval":
        data, xb, yb = oval_track(half_length=args.half_length,
                                  half_width=args.half_width,
                                  track_width=args.track_width, ppm=args.ppm)
        save_costmap(data, xb, yb, args.ppm, args.output)
        print(f"wrote {args.output}: {data.shape[1]}x{data.shape[0]} px")
    elif args.cmd == "spline":
        wps = WINDING_WAYPOINTS
        if args.waypoints:
            try:
                wps = [tuple(float(v) for v in c.split(","))
                       for c in args.waypoints.split(";") if c.strip()]
                if len(wps) < 3 or any(len(w) != 2 for w in wps):
                    raise ValueError("need >= 3 'x,y' pairs")
            except ValueError as e:
                p.error(f"--waypoints expects 'x,y;x,y;...' "
                        f"(>= 3 pairs): {e}")
        data, xb, yb = spline_track(waypoints=wps,
                                    track_width=args.track_width,
                                    ppm=args.ppm)
        save_costmap(data, xb, yb, args.ppm, args.output)
        print(f"wrote {args.output}: {data.shape[1]}x{data.shape[0]} px")
    else:
        gen_costmap_from_image(args.input, args.config, args.output)


if __name__ == "__main__":
    main()
