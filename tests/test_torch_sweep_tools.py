"""The rest of the port's tools on the CPU, each against its JAX
counterpart: ``costs/debug_view.debug_cost_view`` on the exact map and on
a neural field, ``tools/ess_demo.py`` in both modes and
``two_car_demo.run_two_cars`` on a synthetic track with a seeded ``.npz``
(both packages' solves taking their noise from one table, picked by the
subkey, as ``tests/test_torch_episode.py`` injects it; the JAX example's
``MODEL_NPZ`` patched, nothing in ``examples/`` edited), and the track
converters and command line of ``tools/track_generator.py`` on a tiny
generated image and legacy text."""

import importlib.util
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import autorally_tpu.io.compile_cache as jax_compile_cache
import autorally_tpu.ops.sampling as jax_sampling
import autorally_tpu.tools.track_generator as jax_tg
from autorally_tpu.costs.costmap import make_costmap as jax_make_costmap
from autorally_tpu.costs.debug_view import debug_cost_view as jax_view
from autorally_tpu.costs.neural_costmap import NeuralCostmap as JaxField
from autorally_tpu.models import NeuralNetDynamics as JaxNN
from autorally_tpu.tools import ess_demo as jax_ess
from autorally_tpu_torch import two_car_demo
from autorally_tpu_torch.costs import make_costmap
from autorally_tpu_torch.costs.debug_view import debug_cost_view
from autorally_tpu_torch.costs.neural_costmap import NeuralCostmap
from autorally_tpu_torch.solver import mppi as port_mppi
from autorally_tpu_torch.tools import ess_demo
from autorally_tpu_torch.tools import track_generator as tg

NOISE_TABLE = 16
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_example(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", os.path.join(ROOT, "examples", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _inject_tables(monkeypatch, T, Ks):
    """Every solver both packages build draws each solve's noise from one
    table of its K, picked by the subkey's second word."""
    rs = np.random.default_rng(11)
    tables = {k: rs.standard_normal((NOISE_TABLE, T, k, 2)).astype(
        np.float32) for k in Ks}
    jtables = {k: jnp.asarray(v) for k, v in tables.items()}
    monkeypatch.setattr(port_mppi, "make_sampler", lambda *a: (
        lambda gen, shape: torch.tensor(tables[shape[1]][
            (gen.initial_seed() & 0xFFFFFFFF) % NOISE_TABLE])))
    monkeypatch.setattr(jax_sampling, "make_sampler", lambda *a: (
        lambda key, shape: jtables[shape[1]][key[1] % NOISE_TABLE]))


def _seeded_npz(path, seed=3):
    JaxNN(0.02).save_params(JaxNN(0.02).init_params(
        jax.random.PRNGKey(seed)), path)
    return path


# -- debug_view --------------------------------------------------------------

VIEWS = [(30.0, 0.0, math.pi / 2), (-12.3, 17.9, 2.7), (29.2, -3.1, -0.4)]


def _field():
    """A seeded 34-16-1 field on the oval's transform (both packages)."""
    rs = np.random.default_rng(5)
    data, xb, yb = tg.oval_track(ppm=2.0)
    cm = jax_make_costmap(data, xb, yb)
    weights = [rs.normal(0, 0.3, (34, 16)).astype(np.float32),
               rs.normal(0, 0.3, (16, 1)).astype(np.float32)]
    biases = [rs.normal(0, 0.1, 16).astype(np.float32),
              np.float32([0.4])]
    freqs = (2 * np.pi * 2.0 ** np.arange(8)).astype(np.float32)
    jf = JaxField(tuple(jnp.asarray(w) for w in weights),
                  tuple(jnp.asarray(b) for b in biases), jnp.asarray(freqs),
                  cm.r_c1, cm.r_c2, cm.trs)
    return jf, NeuralCostmap.from_jax(jax.tree_util.tree_map(np.asarray, jf),
                                      device="cpu")


@pytest.mark.parametrize("surface", ["exact", "field"])
def test_debug_cost_view_matches_jax(surface):
    """The window around the car on both surfaces: every pixel equal on
    the exact map (within 1e-5 on the field, whose Fourier features and
    products round in another order in XLA), but where the heading wedge's
    edge falls within a rounding of a pixel centre (the two packages'
    cos/sin may differ in the last bit): at most 0.1 % of the pixels."""
    if surface == "exact":
        data, xb, yb = tg.oval_track(ppm=10.0)
        ours_s, ref_s = (make_costmap(data, xb, yb, device="cpu"),
                         jax_make_costmap(data, xb, yb))
        tol = 0.0
    else:
        ref_s, ours_s = _field()
        tol = 1e-5
    for x, y, heading in VIEWS:
        img = debug_cost_view(ours_s, x, y, heading, width_m=6, height_m=4,
                              ppm=20)
        ref = np.asarray(jax_view(ref_s, x, y, heading, width_m=6,
                                  height_m=4, ppm=20))
        assert img.shape == ref.shape == (80, 120)
        assert img.dtype == torch.float32
        off = ~np.isclose(img.numpy(), ref, rtol=tol, atol=tol)
        assert off.sum() <= img.numel() // 1000, (x, y, heading, off.sum())
        # the wedge is drawn: ones inside, zeros on its rim
        assert (img.numpy() == 1.0).any() and (img.numpy() == 0.0).any()


# -- ess_demo ----------------------------------------------------------------

ESS_ARGS = ["--ticks", "8", "--rollouts", "64", "--timesteps", "16",
            "--target-frac", "0.25", "--desired-speed", "5"]


@pytest.mark.parametrize("mode", ["host", "episode"])
def test_ess_demo_matches_jax(mode, monkeypatch, capsys, tmp_path):
    """Both modes on the oval (the JAX tool's CCRF circuit patched to the
    same oval and start): the JAX tool's JSON keys and configuration, and
    its ESS, gamma and speed values; the solve's wall times and the
    capture / trace counts are each package's own."""
    npz = _seeded_npz(str(tmp_path / "seeded.npz"))
    _inject_tables(monkeypatch, 16, (64,))
    monkeypatch.setattr(jax_compile_cache, "enable_persistent_cache",
                        lambda *a, **k: None)
    monkeypatch.setattr(jax_tg, "ccrf_track", lambda: jax_tg.oval_track(
        half_length=30.0, half_width=18.0, track_width=6.0, ppm=10.0))
    monkeypatch.setattr(jax_tg, "CCRF_START", (30.0, 0.0, math.pi / 2))
    args = ESS_ARGS + ["--mode", mode, "--model", npz]
    ours = ess_demo.main(args + ["--cpu", "--track", "oval"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == (
        json.loads(json.dumps(ours)))
    jax_ess.main(args + ["--cpu"])
    ref = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(ours) == set(ref)
    for key in ("mode", "K", "T", "ticks", "target_ess"):
        assert ours[key] == ref[key], key
    timing = {"solve_ms_p50", "ticks_per_sec"}
    for arm in ("tuned", "fixed"):
        assert set(ours[arm]) == set(ref[arm]), arm
        for key, v in ref[arm].items():
            if key in timing:
                continue
            np.testing.assert_allclose(ours[arm][key], v, rtol=1e-4,
                                       atol=1e-5, err_msg=f"{arm} {key}")
    if mode == "host":
        # the port's solve is eager: no capture in the tuned loop (the JAX
        # tool counts its one jit trace)
        assert ours["traces_tuned"] == ours["traces_total"] == 0
        assert ref["traces_tuned"] == 1
        assert ours["tuned"]["gamma_range"][0] < ours["tuned"][
            "gamma_range"][1]


def test_ess_demo_needs_the_ccrf_texture(tmp_path):
    with pytest.raises(FileNotFoundError):
        ess_demo.main(ESS_ARGS + ["--cpu", "--model", _seeded_npz(
            str(tmp_path / "w.npz"))])


# -- two_car_demo -------------------------------------------------------------

@pytest.mark.parametrize("parked", [False, True], ids=["follow", "pass"])
def test_run_two_cars_matches_jax(parked, monkeypatch, tmp_path):
    """Both cars' states tick by tick against the JAX example's on a
    seeded ``.npz`` (the example's ``MODEL_NPZ`` patched): the states
    within 1e-4 relative / 1e-5 absolute (each tick's solves, as
    ``tests/test_torch_solver.py`` holds them, and the circles built on
    the host from the states)."""
    npz = _seeded_npz(str(tmp_path / "seeded.npz"))
    _inject_tables(monkeypatch, 16, (64,))
    example = _jax_example("two_car_demo")
    monkeypatch.setattr(example, "MODEL_NPZ", npz)
    monkeypatch.setattr(two_car_demo, "MODEL_NPZ", npz)
    kw = dict(ticks=12, rollouts=64, timesteps=16, desired_speed=4.5,
              parked=parked)
    ours = two_car_demo.run_two_cars(device="cpu", **kw)
    ref = example.run_two_cars(**kw)
    for a, b in zip(ours, ref):
        assert a.shape == b.shape == (12, 7)
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)
    assert np.isfinite(ours[0]).all()
    if parked:
        np.testing.assert_array_equal(ours[1][:, :2],
                                      np.repeat(ours[1][:1, :2], 12, 0))
    assert two_car_demo.CAR_RADIUS == example.CAR_RADIUS
    assert two_car_demo.OBS_RADIUS == example.OBS_RADIUS


def test_two_cars_need_the_weights(monkeypatch, tmp_path):
    monkeypatch.setattr(two_car_demo, "MODEL_NPZ",
                        str(tmp_path / "absent.npz"))
    with pytest.raises(FileNotFoundError, match="absent.npz"):
        two_car_demo.main(["--cpu", "--ticks", "1", "--rollouts", "64",
                           "--timesteps", "8"])


# -- track_generator's converters and command line ------------------------

def _npz_equal(a, b):
    with np.load(a) as x, np.load(b) as y:
        assert sorted(x.files) == sorted(y.files)
        for name in x.files:
            np.testing.assert_array_equal(x[name], y[name], name)


@pytest.mark.parametrize("flip", [False, True])
def test_gen_costmap_from_image_matches_jax(tmp_path, flip):
    from PIL import Image

    rs = np.random.default_rng(2)
    img = rs.integers(0, 256, (6, 8, 4), dtype=np.uint8)
    path = tmp_path / "track.png"
    Image.fromarray(img, "RGBA").save(path)
    cfg = {"imageRotation": 0, "rOffset": -10.0, "rNormalizer": 200.0,
           "gOffset": 0.0, "gNormalizer": 255.0, "bOffset": 5.0,
           "bNormalizer": 100.0, "aOffset": 0.0, "aNormalizer": 1.0,
           "channelMap": [2, 0, 1, 3], "flip": flip,
           "xBounds": [-2.0, 2.0], "yBounds": [-1.5, 1.5],
           "pixelsPerMeter": 2.0}
    (tmp_path / "cfg.txt").write_text(repr(cfg))
    tg.gen_costmap_from_image(str(path), str(tmp_path / "cfg.txt"),
                              str(tmp_path / "ours.npz"))
    jax_tg.gen_costmap_from_image(str(path), str(tmp_path / "cfg.txt"),
                                  str(tmp_path / "ref.npz"))
    _npz_equal(tmp_path / "ours.npz", tmp_path / "ref.npz")
    with np.load(tmp_path / "ours.npz") as z:
        ch = z["channel0"].reshape(6, 8)
    g = (img[..., 1].astype(np.float32) + 0.0) / 255.0   # g -> channel 0
    np.testing.assert_allclose(ch, np.flipud(g) if flip else g, rtol=1e-6)


def test_convert_legacy_txt_matches_jax(tmp_path):
    rs = np.random.default_rng(4)
    vals = rs.uniform(0, 2, 3 * 4).astype(np.float32)
    text = " ".join(["-1", "1", "0", "1.5", "2"] + [repr(float(v))
                                                    for v in vals]) + " "
    (tmp_path / "map.txt").write_text(text)
    tg.convert_legacy_txt(str(tmp_path / "map.txt"),
                          str(tmp_path / "ours.npz"))
    jax_tg.convert_legacy_txt(str(tmp_path / "map.txt"),
                              str(tmp_path / "ref.npz"))
    _npz_equal(tmp_path / "ours.npz", tmp_path / "ref.npz")
    with np.load(tmp_path / "ours.npz") as z:
        np.testing.assert_array_equal(z["channel0"], vals)
        assert z["pixelsPerMeter"][0] == 2.0


@pytest.mark.parametrize("argv", [
    ["oval", "--half-length", "6", "--half-width", "4", "--ppm", "2"],
    ["spline", "--ppm", "2", "--waypoints", "0,0;8,1;9,8;1,9"],
], ids=["oval", "spline"])
def test_main_writes_the_jax_tools_files(tmp_path, monkeypatch, capsys,
                                         argv):
    tg.main(argv + ["-o", str(tmp_path / "ours.npz")])
    ours = capsys.readouterr().out
    monkeypatch.setattr("sys.argv", ["track_generator"] + argv
                        + ["-o", str(tmp_path / "ref.npz")])
    jax_tg.main()
    ref = capsys.readouterr().out
    assert ours.replace("ours", "ref") == ref
    _npz_equal(tmp_path / "ours.npz", tmp_path / "ref.npz")
    with pytest.raises(SystemExit):
        tg.main(["spline", "--waypoints", "0,0;1,1"])
