"""The port's camera stack (``autorally_tpu_torch/vision``) against the JAX
package's, mirroring ``tests/test_vision.py``, ``tests/test_overhead_vision.py``
and ``tests/test_scene_camera.py``.  Both are the same numpy arithmetic, so
histograms, MSV, the shutter / gain sequences, rendered frames and console
panels must be equal exactly; the scene is rendered from a port ``Costmap``
(tensors) as well as from a JAX one."""

import dataclasses
import math
import os
import pty
import socket
import time

import numpy as np
import pytest
import torch

from autorally_tpu.costs.costmap import make_costmap as jax_make_costmap
from autorally_tpu.tools.console import ConsoleState as JaxConsoleState
from autorally_tpu.tools.track_generator import oval_track
from autorally_tpu.vision import auto_balance as jab
from autorally_tpu.vision import overhead as joverhead
from autorally_tpu.vision import scene_camera as jscene
from autorally_tpu.vision.image_republisher import \
    ImageRepublisher as JaxRepublisher
from autorally_tpu_torch.costs import make_costmap
from autorally_tpu_torch.runtime.diagnostics import Diagnostics
from autorally_tpu_torch.runtime.serial_device import (SerialSettings,
                                                       configure_port)
from autorally_tpu_torch.tools.console import ConsoleState
from autorally_tpu_torch.vision import (AutoBalanceConfig, CameraAutoBalance,
                                        CameraTrigger, ImageRepublisher,
                                        OverheadClient, OverheadDetection,
                                        OverheadPoseBridge, SimulatedCamera,
                                        SyntheticOverheadCamera,
                                        luminance_histogram, msv)
from autorally_tpu_torch.vision import auto_balance as ab
from autorally_tpu_torch.vision import scene_camera as scene
from autorally_tpu_torch.vision.scene_camera import (SceneCamera,
                                                     SceneConfig,
                                                     SceneRenderer,
                                                     ascii_frame, draw_path,
                                                     project_points)

POSE = (30.0, 0.0, math.pi / 2)
SHADOW_CFG = dict(width=160, height=120, shadows=((30.0, 14.0, 8.0, 0.22),),
                  noise_std=0.5)
AB_CFG = dict(roi=(0, 60, 160, 120), k_shutter=2e-3, k_gain=2e-3,
              max_shutter=30000.0)


@pytest.fixture(scope="module")
def maps():
    """The oval at 4 px/m as a port ``Costmap`` (tensors) and a JAX one."""
    data, xb, yb = oval_track(half_length=30.0, half_width=18.0,
                              track_width=6.0, ppm=4.0)
    return make_costmap(data, xb, yb, device="cpu"), jax_make_costmap(
        data, xb, yb)


# -- auto balance (tests/test_vision.py) -------------------------------------

def test_histogram_and_msv_equal_jax():
    rs = np.random.default_rng(3)
    for shape, roi, dec in (((20, 20, 3), (0, 0, 20, 20), 1),
                            ((120, 160, 3), (0, 60, 160, 120), 5),
                            ((64, 96), None, 3)):
        img = rs.integers(0, 256, shape, dtype=np.uint8)
        h = luminance_histogram(img, roi, dec)
        np.testing.assert_array_equal(h, jab.luminance_histogram(img, roi,
                                                                 dec))
        assert msv(h) == jab.msv(h)
    img = np.zeros((20, 20, 3), np.uint8)
    img[:, :, 1] = 100
    h = luminance_histogram(img, roi=(0, 0, 20, 20), decimation=1)
    assert h.sum() == 400 and h[58] == 400       # int(0.587 * 100)
    h = np.zeros(256, np.int64)
    h[99] = 10
    assert msv(h) == 100.0 and msv(np.zeros(256)) == 0.0


class RecordingAdjuster:
    def __init__(self):
        self.calls = []

    def set_shutter(self, v):
        self.calls.append(("shutter", v))

    def set_gain(self, v):
        self.calls.append(("gain", v))


def _flat(level: int) -> np.ndarray:
    return np.full((16, 16, 3), level, np.uint8)


def _branches(mod):
    """Each branch of the control law (``tests/test_vision.py``'s cases)
    from module ``mod``: the adjuster's calls and the controller's state."""
    out = []
    cfg = lambda **kw: mod.AutoBalanceConfig(
        **{"roi": (0, 0, 16, 16), "calibration_step": 1, **kw})
    bal = mod.CameraAutoBalance(RecordingAdjuster(), cfg())
    bal.process_frame(_flat(10))                 # underexposed: shutter
    out.append((bal.shutter, bal.gain, bal.adjustments))
    bal.shutter = bal.cfg.max_shutter
    bal.process_frame(_flat(10))                 # saturated: gain
    out.append((bal.shutter, bal.gain))
    bal.shutter, bal.gain = 5000.0, 2.0
    bal.process_frame(_flat(250))                # overexposed: gain first
    out.append((bal.shutter, bal.gain))
    bal.gain = bal.cfg.min_gain
    bal.process_frame(_flat(250))                # then shutter
    out.append((bal.shutter, bal.gain))
    n0 = bal.adjustments
    bal.process_frame(_flat(119))                # inside the band
    out.append(bal.adjustments - n0)
    stepped = mod.CameraAutoBalance(RecordingAdjuster(),
                                    cfg(calibration_step=3))
    out.append([stepped.process_frame(_flat(10)) is None for _ in range(4)])
    return out, bal.adjuster.calls


def test_control_law_branches_equal_jax():
    ours, ref = _branches(ab), _branches(jab)
    assert ours == ref
    (s0, g0, n), sat, over, handoff, band, skipped = ours[0]
    assert s0 > 100.0 and g0 == 0.01 and n == 1
    assert sat[1] > 0.01 and sat[0] == 10000.0
    assert over[1] < 2.0 and over[0] == 5000.0
    assert handoff[0] < 5000.0
    assert band == 0 and skipped == [False, True, True, False]


def test_closed_loop_sequence_equals_jax_on_simulated_camera():
    """400 + 400 frames on the simulated camera (the sun behind a cloud
    halfway): the port's MSV, shutter and gain sequences are the JAX
    package's, and the loop converges as ``tests/test_vision.py`` asks."""
    seqs = []
    for mod, cam_cls in ((ab, SimulatedCamera), (jab, jab.SimulatedCamera)):
        cam = cam_cls(scene_radiance=0.05, shape=(32, 48))
        bal = mod.CameraAutoBalance(cam, mod.AutoBalanceConfig(
            roi=(0, 0, 48, 32), calibration_step=1, k_shutter=5e-3,
            k_gain=5e-3))
        seq = []
        for k in range(800):
            if k == 400:
                cam.scene_radiance = 0.015
            seq.append((bal.process_frame(cam.capture()), bal.shutter,
                        bal.gain))
        seqs.append(seq)
    assert seqs[0] == seqs[1]
    for k in (399, 799):
        assert abs(120.0 - seqs[0][k][0]) <= 10.0


def test_camera_trigger_protocol_over_pty():
    master, slave = pty.openpty()
    configure_port(slave, SerialSettings())
    diag = Diagnostics("trigger")
    trig = CameraTrigger(slave, diagnostics=diag, trigger_fps=40)
    trig.start()
    try:
        assert os.read(master, 64) == b"#fps:40\r\n"
        os.write(master, b"#pps:17,fps:39.8\r\n#junk:1\r\n")
        deadline = time.time() + 5.0
        while time.time() < deadline and trig.bad_tokens == 0:
            time.sleep(0.01)
        assert trig.pps_count == 17
        assert trig.actual_fps == pytest.approx(39.8)
        assert trig.bad_tokens == 1
        assert diag.entries["PPS count"].message == "17"
        assert diag.ticks == {"pps info": 1, "fps info": 1}
        trig.set_fps(60)
        assert os.read(master, 64) == b"#fps:60\r\n"
    finally:
        trig.stop()
        os.close(master)
        os.close(slave)


def test_image_republisher_rate_and_scale_equal_jax():
    frames = np.random.default_rng(5).integers(0, 256, (12, 64, 96, 3),
                                               dtype=np.uint8)
    runs = []
    for cls in (ImageRepublisher, JaxRepublisher):
        out, t = [], [0.0]
        rep = cls(lambda f, ts: out.append((f, ts)), max_hz=5.0, scale=4,
                  clock=lambda: t[0])
        got = []
        for k, f in enumerate(frames):
            t[0] = 0.07 * k
            got.append((rep.ready(), rep.process(f)))
        runs.append((got, rep.forwarded, rep.dropped, out))
    (got, fwd, drop, out), (jgot, jfwd, jdrop, jout) = runs
    assert got == jgot and (fwd, drop) == (jfwd, jdrop) == (4, 8)
    assert out[0][0].shape == (16, 24, 3)
    for (a, ta), (b, tb) in zip(out, jout):
        np.testing.assert_array_equal(a, b)
        assert ta == tb
    with pytest.raises(ValueError):
        ImageRepublisher(lambda f, ts: None, scale=0)


# -- overhead vision (tests/test_overhead_vision.py) -------------------------

def test_detection_codec_equals_jax():
    d = OverheadDetection(camera_id=1, t_capture=12.5, robot_id=3,
                          x_mm=1234.5, y_mm=-678.0, orientation=0.75,
                          confidence=0.9)
    jd = joverhead.OverheadDetection(1, 12.5, 3, 1234.5, -678.0, 0.75, 0.9)
    assert d.encode() == jd.encode()
    assert (dataclasses.astuple(OverheadDetection.decode(jd.encode()))
            == dataclasses.astuple(joverhead.OverheadDetection.decode(
                d.encode())))
    with pytest.raises(ValueError):
        OverheadDetection.decode(d.encode()[:-1])
    with pytest.raises(ValueError):
        OverheadDetection.decode(b"\x00" + d.encode()[1:])


def _client():
    client = OverheadClient(0)
    return client, client._sock.getsockname()[1]


def test_stationary_noise_equals_jax():
    """200 stationary detections from one seeded rig, received by both
    packages' clients: the same noise statistics (the port's through
    ``ml/ode_compare.sensor_noise_stats``), at the rig's configured
    noise."""
    stats = []
    for client_cls in (OverheadClient, joverhead.OverheadClient):
        client = client_cls(0)
        port = client._sock.getsockname()[1]
        cam = SyntheticOverheadCamera(port, noise_mm=3.0, noise_rad=0.005,
                                      seed=7)
        try:
            for i in range(200):
                cam.observe(i * 0.02, x_m=1.0, y_m=-2.0, yaw=0.3)
            stats.append(client.stationary_noise(200))
        finally:
            cam.close()
            client.close()
    assert stats[0] == stats[1]
    assert stats[0]["x_mm"]["std"] == pytest.approx(3.0, rel=0.3)
    assert stats[0]["orientation"]["std"] == pytest.approx(0.005, rel=0.3)


def test_pose_bridge_equals_jax_and_feeds_ingest(tmp_path):
    """A vehicle turning while it drives, seen from overhead: the port's
    bridge gives the JAX bridge's states and JSONL rows, its live
    ``yaw_mder`` is the logged one, and the rows flow through the port's
    ML ingest."""
    from autorally_tpu_torch.ml.ingest import read_jsonl_topics

    live = []
    ours = OverheadPoseBridge(smooth=0.5,
                              on_state=lambda t, s: live.append(s.copy()))
    ref = joverhead.OverheadPoseBridge(smooth=0.5)
    for i in range(50):
        t = i * 0.02
        th = 1.5 * t
        args = (0, t, 0, 2000.0 * math.cos(th), 2000.0 * math.sin(th), th)
        a = ours.push(OverheadDetection(*args))
        b = ref.push(joverhead.OverheadDetection(*args))
        np.testing.assert_array_equal(a, b)
    assert ours.push(OverheadDetection(0, 0.5, 0, 0.0, 0.0, 0.0)) is None
    assert ours.rows == ref.rows
    log = str(tmp_path / "overhead.jsonl")
    assert ours.log_jsonl(log) == 50
    df = read_jsonl_topics(log)["/overhead/state"]
    assert len(df) == 50
    np.testing.assert_allclose(df["yaw_mder"], [s[6] for s in live],
                               rtol=0, atol=1e-6)


def test_bridge_feeds_the_port_plant_as_pose_source():
    from autorally_tpu_torch.runtime.plant import BasePlant

    T = 16
    plant = BasePlant(dt=0.02, num_timesteps=T)
    plant.set_solution(np.zeros((T, 7), np.float32),
                       np.tile([0.1, 0.2], (T, 1)).astype(np.float32),
                       None, ts=0.0)
    bridge = OverheadPoseBridge(on_state=plant.receive_state_vector,
                                collect_rows=False)
    for i in range(10):
        t = 0.02 * (i + 1)
        bridge.push(OverheadDetection(0, t, 0, x_mm=t * 1000.0, y_mm=0.0,
                                      orientation=0.0))
    assert plant.pose_count == 10 and len(plant.published) > 0
    assert bridge.rows == []


def test_dropout_and_multi_robot_filtering():
    client, port = _client()
    cam_a = SyntheticOverheadCamera(port, robot_id=0)
    cam_b = SyntheticOverheadCamera(port, robot_id=1)
    try:
        for i in range(30):
            cam_a.observe(i * 0.02, 0.0, 0.0, 0.0)
            cam_b.observe(i * 0.02, 5.0, 5.0, 1.0)
        dets = client.collect(20, robot_id=1)
        assert all(d.robot_id == 1 for d in dets)
        assert np.median([d.x_mm for d in dets]) == pytest.approx(
            5000.0, abs=50.0)
    finally:
        cam_a.close()
        cam_b.close()
        client.close()
    sent = []
    for cls in (SyntheticOverheadCamera, joverhead.SyntheticOverheadCamera):
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as sink:
            sink.bind(("127.0.0.1", 0))
            cam = cls(sink.getsockname()[1], dropout=0.5, seed=3)
            sent.append([cam.observe(i * 0.02, 0, 0, 0) for i in range(200)])
            cam.close()
    assert sent[0] == sent[1] and 60 < sum(sent[0]) < 140


# -- the scene camera (tests/test_scene_camera.py) ---------------------------

def test_renderer_equals_jax_from_both_costmaps(maps):
    """The port's renderer on a port ``Costmap`` (tensors) and on a JAX one
    gives the JAX renderer's radiance exactly, at poses on and off the
    track, with and without shadows; and shows the track."""
    cm, jcm = maps
    for cfg in (dict(), dict(shadows=((30.0, 10.0, 6.0, 0.25),))):
        ref = jscene.SceneRenderer(jcm, jscene.SceneConfig(**cfg))
        for r in (SceneRenderer(cm, SceneConfig(**cfg)),
                  SceneRenderer(jcm, SceneConfig(**cfg))):
            for pose in (POSE, (30.0, 6.0, math.pi / 2), (0.0, 0.0, 0.0),
                         (30.0, 0.0, -math.pi / 2)):
                np.testing.assert_array_equal(r.radiance(pose),
                                              ref.radiance(pose))
    lum = SceneRenderer(cm).radiance(POSE).mean(axis=2)
    assert lum[:20].mean() > 0.6 and np.median(lum[-30:]) < 0.35
    assert lum[-30:].max() > 0.7


def test_exposure_into_shadow_equals_jax(maps):
    """Converge in the lit section, drive into a shaded one and hold: the
    frames, MSV, shutter and gain equal the JAX loop's at every step, the
    MSV drops on entry and the exposure rises to pull it back."""
    cm, jcm = maps
    runs = []
    for cam, ab in (
            (SceneCamera(SceneRenderer(cm, SceneConfig(**SHADOW_CFG))),
             lambda c: CameraAutoBalance(c, AutoBalanceConfig(**AB_CFG))),
            (jscene.SceneCamera(jscene.SceneRenderer(
                jcm, jscene.SceneConfig(**SHADOW_CFG))),
             lambda c: jab.CameraAutoBalance(c, jab.AutoBalanceConfig(
                 **AB_CFG)))):
        bal = ab(cam)
        seq, last = [], None
        for k in range(500):
            pose = (30.0, -6.0, math.pi / 2) if k < 200 else (
                30.0, 14.0, math.pi / 2)
            last = cam.capture(pose)
            seq.append((bal.process_frame(last), bal.shutter, bal.gain))
        runs.append((seq, last))
    (seq, frame), (jseq, jframe) = runs
    assert seq == jseq
    np.testing.assert_array_equal(frame, jframe)
    v_lit, v_enter, v_shadow = seq[199][0], seq[200][0], seq[-1][0]
    assert v_enter < v_lit - 10.0 and v_shadow > v_enter + 10.0
    assert seq[-1][1] * seq[-1][2] > 1.5 * seq[199][1] * seq[199][2]


def test_frames_flow_to_the_console_panel_like_jax(maps):
    """SceneCamera -> ImageRepublisher -> record -> console: the port's
    panel is the JAX one, character for character, with scene structure
    (sky rows brighter than the road)."""
    cm, jcm = maps
    panels = []
    for mod, cm_, cons, rep_cls in ((scene, cm, ConsoleState,
                                     ImageRepublisher),
                                    (jscene, jcm, JaxConsoleState,
                                     JaxRepublisher)):
        cam = mod.SceneCamera(mod.SceneRenderer(cm_, mod.SceneConfig()))
        cam.set_shutter(1000.0)
        cam.set_gain(0.5)
        state, clock = cons(), [0.0]

        def on_frame(small, ts, state=state, cam=cam, mod=mod):
            state.ingest({"kind": "image", "ascii": mod.ascii_frame(small),
                          "msv": 120.0, "shutter": cam.shutter,
                          "gain": cam.gain}, now=ts)

        rep = rep_cls(on_frame, max_hz=5.0, scale=2, clock=lambda: clock[0])
        frames = 0
        for i in range(20):
            clock[0] = i * 0.02
            frames += rep.process(cam.capture(POSE))
        assert frames == 2 and rep.dropped == 18
        panels.append(state.render(now=clock[0], color=False))
    assert panels[0] == panels[1]
    rows = [ln for ln in panels[0].splitlines() if ln.startswith("  |")]
    ramp = " .:-=+*#%@"
    level = lambda s: np.mean([ramp.index(c) for c in s.strip("|  ")
                               if c in ramp])
    assert len(rows) >= 10 and level(rows[0]) > level(rows[-1])


def test_projection_inverts_rasterizer(maps):
    cm, _ = maps
    cfg = SceneConfig(width=160, height=120)
    r = SceneRenderer(cm, cfg)
    sp, cp = math.sin(r._pitch), math.cos(r._pitch)
    px = [(40, 90), (80, 100), (120, 80), (80, 119)]
    f = (cfg.width / 2.0) / math.tan(math.radians(cfg.hfov_deg) / 2.0)
    world = []
    for ux, vy in px:
        u_t = (ux - (cfg.width - 1) / 2.0) / f
        v_t = (vy - (cfg.height - 1) / 2.0) / f
        t = cfg.cam_height / (v_t * cp + sp)
        fwd, rgt = t * (cp - v_t * sp), t * u_t
        world.append([POSE[0] + fwd * math.cos(POSE[2])
                      + rgt * math.sin(POSE[2]),
                      POSE[1] + fwd * math.sin(POSE[2])
                      - rgt * math.cos(POSE[2])])
    pts = project_points(r, POSE, np.array(world))
    assert pts[:, 2].all()
    np.testing.assert_allclose(pts[:, :2], np.array(px, float), atol=0.51)
    np.testing.assert_array_equal(pts, jscene.project_points(
        jscene.SceneRenderer(maps[1]), POSE, np.array(world)))


def test_draw_path_overlays_the_plan_from_a_tensor(maps):
    """The plan ahead of the car lands in the frame as overlay pixels, the
    same from a ``state_solution`` tensor (T, 7) as from its numpy copy and
    as the JAX overlay's."""
    cm, jcm = maps
    cam = SceneCamera(SceneRenderer(cm, SceneConfig()))
    cam.set_shutter(1000.0)
    cam.set_gain(0.5)
    frame = cam.capture(POSE)
    ys = np.linspace(1.0, 10.0, 25)
    plan = np.zeros((25, 7), np.float32)
    plan[:, 0], plan[:, 1] = 30.0, ys
    out = draw_path(frame, cam.renderer, POSE, torch.from_numpy(plan))
    np.testing.assert_array_equal(out, draw_path(frame, cam.renderer, POSE,
                                                 plan))
    np.testing.assert_array_equal(out, jscene.draw_path(
        frame, jscene.SceneRenderer(jcm), POSE, plan))
    marked = (out == scene.PATH_COLOR).all(axis=2)
    assert marked.sum() >= 20
    assert not (frame == scene.PATH_COLOR).all(axis=2).any()
    rows = np.where(marked.any(axis=1))[0]
    assert rows.max() - rows.min() > 20
    assert ascii_frame(out) == jscene.ascii_frame(out)
