"""The port's ``tools/ensemble_ab.py`` on the CPU, against the JAX tool:
``steer_gain_params`` bit for bit, one short ``run_arm`` on the oval for
each arm, and ``main --track oval``'s JSON (the JAX tool's keys and
config; the JAX tool run on seeded weights, as the port's runs without the
reference ``.npz``)."""

import json

import jax
import numpy as np
import pytest
import torch

import autorally_tpu.io.compile_cache as jax_compile_cache
from autorally_tpu.models import NeuralNetDynamics as JaxNN
from autorally_tpu.tools import ensemble_ab as jab
from autorally_tpu_torch.models import NeuralNetDynamics
from autorally_tpu_torch.tools import ensemble_ab as ab

SMALL = ["--track", "oval", "--members", "4", "--rollouts", "64",
         "--timesteps", "8", "--ticks", "6", "--seeds", "1"]


@pytest.mark.parametrize("column", ["steer", "throttle"])
def test_steer_gain_params_matches_jax(column):
    jparams = JaxNN(0.02).init_params(jax.random.PRNGKey(2))
    params = NeuralNetDynamics(0.02, device="cpu").params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams))
    for gain in (0.55, 1.2, 0.0):
        got = ab.steer_gain_params(params, gain, column)
        ref = jab.steer_gain_params(jparams, gain, column)
        for a, b in zip(got["weights"] + got["biases"],
                        ref["weights"] + ref["biases"]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        row = ab.COLUMNS[column]
        assert ab.COLUMNS == jab.COLUMNS
        # the nominal params are left as they were
        np.testing.assert_array_equal(params["weights"][0].numpy(),
                                      np.asarray(jparams["weights"][0]))
        others = [r for r in range(6) if r != row]
        assert torch.equal(got["weights"][0][others],
                           params["weights"][0][others])


def test_run_arm_on_the_oval():
    """Each arm's episode on the CPU: the JAX tool's metric keys plus the
    wall seconds, finite speeds."""
    args = ab.parse_args(SMALL)
    config, arms, run_args = ab.build(args, "cpu")
    assert [a for a, *_ in arms] == ["single", "ensemble"]
    assert config["member_gains"][0] == 1.0 and len(
        config["member_gains"]) == 4
    for arm, runner, p_ctrl in arms:
        m = ab.run_arm(runner, p_ctrl, *run_args[:4], 0, *run_args[4:])
        assert {"laps", "mean_speed", "offtrack_frac", "rollout_crash_frac",
                "mean_ess", "wall_s"} <= set(m), arm
        assert np.isfinite(m["mean_speed"]) and 0.0 <= m["offtrack_frac"] <= 1


def test_main_json_matches_the_jax_tool(monkeypatch, capsys):
    """``main --track oval``: one JSON line with the JAX tool's keys, its
    config and each run's keys (the values differ: the two packages draw
    their noise from different generators)."""
    ab.main(SMALL + ["--cpu"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    monkeypatch.setattr(jax_compile_cache, "enable_persistent_cache",
                        lambda *a, **k: None)
    monkeypatch.setattr(JaxNN, "load_params", lambda self, path:
                        self.init_params(jax.random.PRNGKey(0)))
    jab.main(SMALL + ["--cpu"])
    ref = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(out) == set(ref)
    assert out["config"] == ref["config"]
    for arm in ("single", "ensemble"):
        assert set(out[f"{arm}_summary"]) == set(ref[f"{arm}_summary"])
        assert len(out[arm]) == len(ref[arm]) == 1
        assert set(out[arm][0]) == set(ref[arm][0])


def test_unported_tracks_need_the_textures():
    for track in ("ccrf", "marietta"):
        with pytest.raises(FileNotFoundError):
            ab.main(["--track", track, "--cpu", "--ticks", "2",
                     "--rollouts", "64", "--timesteps", "8"])
