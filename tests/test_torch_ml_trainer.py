"""The port's ML trainer (``autorally_tpu_torch/ml/trainer.py``) against
the JAX package's ``run`` on the CPU: the same synthesised drive log and
config (``nn_layers`` [6, 24, 4], ``standardize_data``, 5 epochs), the JAX
init carried by ``params_from_jax``; the files each writes, the best
validation loss and the multi-step results.  Then the exported model
loads at its own spec (``NeuralNetDynamics.from_npz``) and drives the
solver's plain path; the command line reads a JSON config where PyYAML is
missing."""

import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

from autorally_tpu.ml import trainer as jtrainer
from autorally_tpu.models import NeuralNetDynamics as JaxNN
from autorally_tpu_torch.config import CostParams, MPPIConfig
from autorally_tpu_torch.costs import MPPICost
from autorally_tpu_torch.drive_oval import START, oval_costmap
from autorally_tpu_torch.ml import trainer
from autorally_tpu_torch.models import NeuralNetDynamics
from autorally_tpu_torch.solver.mppi import MPPISolver
from autorally_tpu_torch.tools.sim_node import teacher_drive_log

LAYERS = [6, 24, 4]
# best validation loss: 5 epochs of float32 Adam steps in another rounding
# order (tests/test_torch_ml.py holds the per-epoch losses at 1e-4)
LOSS_RTOL = 1e-4
# the exported raw-space weights: the trained ones (atol 2e-4 there) scaled
# by the label scalers (std up to ~3)
WEIGHT_ATOL = 1e-3
# the multi-step position errors: H Euler steps of those weights
MULTI_RTOL, MULTI_ATOL = 2e-3, 1e-4


def _config(log, out, **kw):
    cfg = dict(trainer.DEFAULTS)
    cfg.update(log_jsonl=log, results_dir=str(out), epochs=5,
               standardize_data=True, horizons=[10, 25],
               nn_layers=list(LAYERS), **kw)
    return cfg


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages' ``run`` on one log and config, the port's init the
    JAX one's."""
    tmp = tmp_path_factory.mktemp("trainer")
    teacher = NeuralNetDynamics(0.02, device="cpu")
    log = teacher_drive_log(str(tmp / "drive.jsonl"), teacher,
                            teacher.init_params(0), seconds=25.0)
    jcfg = _config(log, tmp / "jax")
    jres = jtrainer.run(jcfg)
    jinit = JaxNN(0.02, layers=LAYERS).init_params(jax.random.PRNGKey(0))
    mp = pytest.MonkeyPatch()
    mp.setattr(NeuralNetDynamics, "init_params",
               lambda self, seed: self.params_from_jax(
                   jax.tree_util.tree_map(np.asarray, jinit)))
    try:
        cfg = _config(log, tmp / "port")
        res = trainer.run(cfg, device="cpu")
    finally:
        mp.undo()
    return cfg, res, jcfg, jres


def _npz(cfg, name):
    return np.load(os.path.join(cfg["results_dir"], name))


def test_dataset_and_scalers_equal_jax(runs):
    cfg, _, jcfg, _ = runs
    for name in ("dataset.npz", "scalers.npz"):
        got, want = _npz(cfg, name), _npz(jcfg, name)
        assert sorted(got.files) == sorted(want.files)
        for k in want.files:
            assert got[k].dtype == want[k].dtype, (name, k)
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert _npz(cfg, "dataset.npz")["inputs"].shape == (1250, 6)
    for name in ("final_data.csv", "model.npz", "results.json",
                 "multistep_h10.npz", "multistep_h25.npz"):
        assert os.path.exists(os.path.join(cfg["results_dir"], name))


def test_best_val_loss_weights_and_multistep_match_jax(runs):
    cfg, res, jcfg, jres = runs
    assert set(res) == set(jres)
    np.testing.assert_allclose(res["best_val_loss"], jres["best_val_loss"],
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(res["instantaneous_rmse"],
                               jres["instantaneous_rmse"], rtol=MULTI_RTOL)
    got, want = _npz(cfg, "model.npz"), _npz(jcfg, "model.npz")
    assert sorted(got.files) == sorted(want.files)
    for k in want.files:
        np.testing.assert_allclose(got[k], want[k], rtol=0,
                                   atol=WEIGHT_ATOL, err_msg=k)
    for h in ("10", "25"):
        for k, v in jres["multistep"][h].items():
            np.testing.assert_allclose(res["multistep"][h][k], v,
                                       rtol=MULTI_RTOL, atol=MULTI_ATOL,
                                       err_msg=f"{h} {k}")
        g, w = _npz(cfg, f"multistep_h{h}.npz"), _npz(jcfg,
                                                      f"multistep_h{h}.npz")
        for k in w.files:
            np.testing.assert_allclose(g[k], w[k], rtol=MULTI_RTOL,
                                       atol=MULTI_ATOL, err_msg=f"{h} {k}")
    with open(os.path.join(cfg["results_dir"], "results.json")) as f:
        assert json.load(f) == json.loads(json.dumps(res))


def test_exported_model_loads_at_its_spec_and_drives(runs):
    """``from_npz`` gives the trained spec; three solves on the plain path
    (the CPU) stay finite."""
    cfg, *_ = runs
    model, params = NeuralNetDynamics.from_npz(
        os.path.join(cfg["results_dir"], "model.npz"), 0.02, device="cpu")
    assert model.layers == tuple(LAYERS)
    solver = MPPISolver(model, MPPICost(), MPPIConfig(num_rollouts=64,
                                                      num_timesteps=16),
                        device="cpu")
    cs = solver.init_state()
    state = torch.tensor(START, dtype=torch.float32)
    for _ in range(3):
        cs = solver.slide(cs, 1)
        cs, stats = solver.solve(params, CostParams(desired_speed=6.0),
                                 oval_costmap("cpu"), state, cs)
    assert torch.isfinite(cs.U).all() and float(stats.ess) >= 1.0


def test_phases_switch_off_and_reload(runs, tmp_path):
    """``preprocess_data`` and ``train_model`` off: the run reloads the
    dataset and the model it wrote and tests the same model."""
    cfg, res, *_ = runs
    again = dict(cfg, preprocess_data=False, train_model=False)
    out = trainer.run(again, device="cpu")
    assert set(out) == {"instantaneous_rmse", "multistep"}
    np.testing.assert_allclose(out["instantaneous_rmse"],
                               res["instantaneous_rmse"], rtol=1e-6)


def test_main_reads_yaml_or_json_and_runs_on_the_cpu(runs, tmp_path,
                                                     monkeypatch, capsys):
    cfg, *_ = runs
    conf = dict(log_jsonl=cfg["log_jsonl"], results_dir=str(tmp_path / "o"),
                epochs=1, nn_layers=[6, 16, 4], horizons=[5])
    path = tmp_path / "config.yml"
    path.write_text(json.dumps(conf))
    assert trainer.load_config(str(path))["epochs"] == 1
    path.write_text("epochs: 2\nnn_layers: [6, 16, 4]\n")
    assert trainer.load_config(str(path))["epochs"] == 2
    monkeypatch.setitem(sys.modules, "yaml", None)      # as on the GPU box
    path.write_text(json.dumps(conf))
    loaded = trainer.load_config(str(path))
    assert loaded["nn_layers"] == [6, 16, 4] and loaded["seed"] == 0
    trainer.main(["--config", str(path), "--cpu"])
    out = capsys.readouterr().out
    printed = json.loads(out[out.index("{"):])
    assert os.path.exists(tmp_path / "o" / "model.npz")
    with open(tmp_path / "o" / "results.json") as f:
        assert json.load(f) == printed
    assert set(printed["multistep"]) == {"5"}
