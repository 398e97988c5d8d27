"""The port's lap tools against the JAX package's on the CPU: the track
builders (``tools/track_generator.py``) bit for bit, ``load_track``,
``episode_metrics`` on one set of states, the textured circuits' refusal
without their textures, and ``tools/lap_suite.py`` end to end at smoke
size with an artifact that ``validate_laps`` accepts."""

import json
import math
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autorally_tpu.runtime.episode import EpisodeResult as JaxEpisodeResult
from autorally_tpu.tools import lap_eval as jlap_eval
from autorally_tpu.tools import track_generator as jtg
from autorally_tpu_torch.runtime.episode import EpisodeResult
from autorally_tpu_torch.tools import lap_eval, lap_suite
from autorally_tpu_torch.tools import track_generator as tg
from test_artifacts import validate_laps


def _same_map(data_bounds, jdata_bounds):
    (d, xb, yb), (jd, jxb, jyb) = data_bounds, jdata_bounds
    assert d.dtype == jd.dtype == np.float32
    np.testing.assert_array_equal(d, jd)
    assert (xb, yb) == (jxb, jyb)


def _same_costmap(cm, jcm):
    np.testing.assert_array_equal(cm.data.numpy(), np.asarray(jcm.data))
    for name in ("r_c1", "r_c2", "trs"):
        np.testing.assert_array_equal(getattr(cm, name).numpy(),
                                      np.asarray(getattr(jcm, name)))


@pytest.mark.parametrize("kind", ["straight", "spline", "spline_custom"])
def test_track_builders_equal_jax(kind):
    if kind == "straight":
        kw = dict(length=60.0, track_width=7.0, ppm=5.0)
        _same_map(tg.straight_track(**kw), jtg.straight_track(**kw))
        _same_costmap(tg.make_straight_costmap(device="cpu", **kw),
                      jtg.make_straight_costmap(**kw))
    elif kind == "spline":
        assert tg.WINDING_WAYPOINTS == jtg.WINDING_WAYPOINTS
        _same_map(tg.spline_track(ppm=4.0), jtg.spline_track(ppm=4.0))
        _same_costmap(tg.make_spline_costmap(device="cpu", ppm=3.0),
                      jtg.make_spline_costmap(ppm=3.0))
    else:
        kw = dict(waypoints=((0, 0), (20, 0), (20, 15), (0, 12)),
                  track_width=4.0, ppm=3.0, margin=5.0)
        _same_map(tg.spline_track(**kw), jtg.spline_track(**kw))
        kw = dict(half_length=20.0, half_width=12.0, ppm=3.0)
        _same_costmap(tg.make_oval_costmap(device="cpu", **kw),
                      jtg.make_oval_costmap(**kw))


@pytest.mark.parametrize("name", ["oval", "winding"])
def test_load_track_equals_jax(name):
    cm, start, line, xings = lap_eval.load_track(name, ppm=4.0,
                                                 device="cpu")
    jcm, jstart, jline, jxings = jlap_eval.load_track(name, ppm=4.0)
    _same_costmap(cm, jcm)
    assert (start, line, xings) == (jstart, jline, jxings)


def test_episode_metrics_equal_jax():
    """Five laps of the oval's centerline at a varying speed, a stretch off
    the track, and telemetry: the same metrics on both sides."""
    cm, _, line, xings = lap_eval.load_track("oval", ppm=4.0, device="cpu")
    jcm = jlap_eval.load_track("oval", ppm=4.0)[0]
    n, dt = 1500, 0.02
    rs = np.random.default_rng(3)
    phase = np.cumsum(np.full(n, 5 * 2 * math.pi / n))
    radius = np.where((np.arange(n) > 600) & (np.arange(n) < 700), 1.2, 1.0)
    states = np.zeros((n, 7), np.float32)
    states[:, 0] = 30.0 * radius * np.cos(phase)
    states[:, 1] = 18.0 * radius * np.sin(phase)
    states[:, 4] = 5.0 + rs.uniform(-1, 1, n)
    states[:, 5] = rs.uniform(-0.5, 0.5, n)
    tele = {f: rs.uniform(0, 1, n).astype(np.float32)
            for f in ("trajectory_cost", "ess", "crash_frac", "gamma")}
    used = rs.uniform(size=n) < 0.5
    controls = np.zeros((n, 2), np.float32)
    res = EpisodeResult(states=torch.tensor(states),
                        controls=torch.tensor(controls),
                        used_actual=torch.tensor(used),
                        **{k: torch.tensor(v) for k, v in tele.items()})
    jres = JaxEpisodeResult(states=jnp.asarray(states),
                            controls=jnp.asarray(controls),
                            used_actual=jnp.asarray(used),
                            **{k: jnp.asarray(v) for k, v in tele.items()})
    m = lap_eval.episode_metrics(res, cm, line, xings, dt, 0.65)
    jm = jlap_eval.episode_metrics(jres, jcm, line, xings, dt, 0.65)
    assert m == jm
    assert m["laps"] >= 1 and m["best_lap_s"] is not None
    assert 0 < m["offtrack_frac"] < 1


@pytest.mark.parametrize("name", ["ccrf", "marietta"])
def test_textured_tracks_need_their_textures(name):
    path = {"ccrf": tg.CCRF_TEXTURE, "marietta": tg.MARIETTA_TEXTURE}[name]
    if os.path.exists(path):
        pytest.skip(f"{path} is present: the track builds")
    with pytest.raises(FileNotFoundError, match=os.path.basename(path)):
        lap_eval.load_track(name, device="cpu")
    for a, b in (("CCRF_START", "CCRF_START"),
                 ("CCRF_LAP_LINE", "CCRF_LAP_LINE"),
                 ("MARIETTA_START", "MARIETTA_START"),
                 ("MARIETTA_LAP_LINE", "MARIETTA_LAP_LINE"),
                 ("CCRF_PLANE", "CCRF_PLANE"), ("CCRF_POSE", "CCRF_POSE")):
        assert getattr(tg, a) == getattr(jtg, b)


OVAL_ROW = {"name": "oval_nn_gaussian", "track": "oval", "K": 1920,
            "T": 100, "desired_speed": 6.0, "noise": "gaussian"}


def test_lap_suite_smoke_artifact(tmp_path, monkeypatch, capsys):
    """``main`` at smoke size on the CPU for an oval row (the default
    matrix's rows need the CCRF and Marietta textures): the artifact on
    stdout and in ``--out`` passes ``validate_laps``, with the seeded
    weights named."""
    monkeypatch.setattr(lap_suite, "DEFAULT_MATRIX",
                        lap_suite.DEFAULT_MATRIX + [OVAL_ROW])
    out = tmp_path / "laps.json"
    lap_suite.main(["--smoke", "--cpu", "--ticks", "20", "--seeds", "1",
                    "--only", OVAL_ROW["name"], "--out", str(out),
                    "--round", "6"])
    cap = capsys.readouterr()
    printed = json.loads(cap.out.strip().splitlines()[-1])
    assert printed == json.loads(out.read_text())
    validate_laps(printed)
    (row,) = printed["rows"]
    assert (row["K"], row["T"], printed["smoke"]) == (256, 32, True)
    assert row["weights"].startswith("seeded init_params(0)")
    assert "seeded init_params(0)" in cap.err
    assert len(row["runs"]) == 1 and row["runs"][0]["seed"] == 0


def test_run_config_rows_and_refusals(monkeypatch):
    """A winding row with the BF model, gains and mismatch, and an
    asymmetric row, through ``run_config``; a textured row fails with its
    ``FileNotFoundError``; the default device is the card."""
    runs = lap_suite.run_config(
        {"name": "winding_bf", "track": "winding", "K": 64, "T": 16,
         "desired_speed": 5.0, "model": "bf", "feedback": True,
         "mismatch": 0.1}, ticks=4, seeds=2, device="cpu")
    assert [r["seed"] for r in runs] == [0, 1]
    for r in runs:
        assert np.isfinite(r["mean_speed"]) and 0 <= r["offtrack_frac"] <= 1
    runs = lap_suite.run_config({**OVAL_ROW, "K": 64, "T": 16, "K_pred": 32},
                                ticks=3, seeds=1, device="cpu")
    assert runs[0]["laps"] == 0
    if not os.path.exists(tg.CCRF_TEXTURE):
        with pytest.raises(FileNotFoundError):
            lap_suite.run_config({**lap_suite.DEFAULT_MATRIX[0], "K": 64,
                                  "T": 16}, ticks=2, seeds=1, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no GPU"):
        lap_suite.run_config(OVAL_ROW, ticks=2, seeds=1)


def test_lap_benchmark_on_the_cpu(capsys, monkeypatch):
    """``lap_benchmark`` on the CPU with every episode option: the report's
    lines, the adaptive gamma among them; without ``--cpu`` it asks for
    the card and raises without one."""
    from autorally_tpu_torch import lap_benchmark

    lap_benchmark.main(["--cpu", "--ticks", "6", "--rollouts", "64",
                        "--timesteps", "12", "--pred-rollouts", "32",
                        "--feedback", "--pose-substeps", "2",
                        "--mismatch", "0.1", "--ess-target", "0.25",
                        "--noise", "ou", "--noise-param", "0.15",
                        "--track", "winding", "--seed", "1"])
    out = capsys.readouterr().out
    for line in ("model weights: seeded init_params(0)",
                 "feedback_gains=True pose_substeps=2 mismatch=0.1 "
                 "noise=ou(0.15)", "6 control ticks", "speed: mean",
                 "controller usage: actual", "mean ESS",
                 "adaptive gamma: 0.150 -> "):
        assert line in out, line
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no GPU"):
        lap_benchmark.main(["--ticks", "2"])
