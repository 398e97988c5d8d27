"""The port's ML pipeline (``autorally_tpu_torch/ml``) against the JAX
package's (``autorally_tpu/ml``) on the CPU: the losses, training (Adam
and AdamW, the JAX init carried by ``params_from_jax``, the same numpy
batches), standardization folding, the one-step and multi-step errors, the
ODE cross-check and sensor noise statistics, ingestion of a synthesised
multi-topic log and of per-topic CSVs (the port's numpy tables against the
JAX package's DataFrames, column by column), the torch interchange, the
reference config and the plots.  The log comes from a seeded 6-32-32-4
teacher (``tools/sim_node.teacher_drive_log``), as the JAX package's own
ML tests synthesise theirs."""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autorally_tpu.ml import dataset as jdataset
from autorally_tpu.ml import evaluate as jevaluate
from autorally_tpu.ml import ingest as jingest
from autorally_tpu.ml import ode_compare as jode
from autorally_tpu.ml import reference_config as jref
from autorally_tpu.ml import torch_interop as jinterop
from autorally_tpu.ml import train as jtrain
from autorally_tpu.models import NeuralNetDynamics as JaxNN
from autorally_tpu_torch.ml import dataset, evaluate, ingest, ode_compare
from autorally_tpu_torch.ml import plots, reference_config, torch_interop
from autorally_tpu_torch.ml import train
from autorally_tpu_torch.models import NeuralNetDynamics
from autorally_tpu_torch.tools.sim_node import teacher_drive_log

DT = 0.02
LAYERS = (6, 24, 4)
# float32 losses of the same batches through another autodiff, Adam's
# update in another rounding order: a few epochs stay within 1e-4
LOSS_RTOL = 1e-4
WEIGHT_ATOL = 2e-4
# one float32 forward of the same weights, sums in another order
PRED_RTOL, PRED_ATOL = 1e-5, 1e-6
# H Euler steps of that forward
MULTI_RTOL, MULTI_ATOL = 1e-4, 1e-5


def _pair(layers=LAYERS, seed=0):
    """(port model, params, JAX model, JAX params): the JAX init carried
    over by ``params_from_jax``."""
    jmodel = JaxNN(DT, layers=layers)
    jparams = jmodel.init_params(jax.random.PRNGKey(seed))
    model = NeuralNetDynamics(DT, layers=layers, device="cpu")
    params = model.params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                          jparams))
    return model, params, jmodel, jparams


@pytest.fixture(scope="module")
def drive_log(tmp_path_factory):
    teacher = NeuralNetDynamics(DT, device="cpu")
    path = str(tmp_path_factory.mktemp("log") / "drive.jsonl")
    return teacher_drive_log(path, teacher, teacher.init_params(0),
                             seconds=20.0)


@pytest.fixture(scope="module")
def table(drive_log):
    return ingest.ingest_log(drive_log), jingest.ingest_log(drive_log)


def _columns_equal(port_table, frame, rtol=0.0):
    """The port's table equals the DataFrame column by column: the same
    names in the same order and the same values (both run the same numpy
    and scipy operations; ``rtol`` where the inputs came through pandas'
    CSV parser, whose fast float parser may miss the correctly rounded
    value by an ulp, where the port's parses with Python's ``float``: the
    splines and the arc tangents carry such an ulp to about 1e-12)."""
    assert port_table.columns == list(frame.columns)
    assert len(port_table) == len(frame)
    for c in frame.columns:
        np.testing.assert_allclose(port_table[c], frame[c].to_numpy(),
                                   rtol=rtol, atol=0, err_msg=c)


# -- losses ------------------------------------------------------------------

def test_smooth_l1_and_weighted_loss_match_jax():
    """Elementwise smooth-L1 on both sides of |x| = 1 and the weighted
    float32 mean (the reference's scaling of outputs and labels)."""
    rs = np.random.default_rng(0)
    pred = (3 * rs.standard_normal((64, 4))).astype(np.float32)
    target = rs.standard_normal((64, 4)).astype(np.float32)
    got = train.smooth_l1(torch.tensor(pred), torch.tensor(target))
    want = jtrain.smooth_l1(jnp.asarray(pred), jnp.asarray(target))
    d = np.abs(pred - target)
    assert (d < 1).any() and (d >= 1).any()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    w = (1.0, 1.0, 1.0, 0.5)
    got = train.weighted_loss(torch.tensor(pred), torch.tensor(target), w)
    want = jtrain.weighted_loss(jnp.asarray(pred), jnp.asarray(target), w)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


# -- training -----------------------------------------------------------------

@pytest.mark.parametrize("weight_decay", [0.0, 1e-3], ids=["adam", "adamw"])
def test_train_dynamics_matches_jax(table, weight_decay):
    """3 epochs on the log's standardized inputs and labels from the JAX
    init: the per-epoch train and validation losses and the best weights
    against ``train_dynamics`` of the JAX package (optax)."""
    port_table, _ = table
    inputs = port_table.to_numpy(["roll", "u_x", "u_y", "yaw_mder",
                                  "steering", "throttle"])
    labels = port_table.to_numpy(["roll_der", "u_x_der", "u_y_der",
                                  "yaw_mder_der"])
    x, y = dataset.standardize(inputs)[0], dataset.standardize(labels)[0]
    tr, va = dataset.DynamicsDataset(x, y).split(0.2, 0)
    jtr, jva = jdataset.DynamicsDataset(x, y).split(0.2, 0)
    model, params, jmodel, jparams = _pair()
    cfg = dict(epochs=3, weight_decay=weight_decay, seed=4)
    best, hist = train.train_dynamics(model, params, tr, va,
                                      train.TrainConfig(**cfg),
                                      verbose=False)
    jbest, jhist = jtrain.train_dynamics(jmodel, jparams, jtr, jva,
                                         jtrain.TrainConfig(**cfg),
                                         verbose=False)
    for k in ("train", "val"):
        assert len(hist[k]) == 3
        np.testing.assert_allclose(hist[k], jhist[k], rtol=LOSS_RTOL,
                                   err_msg=k)
    assert hist["val"][-1] < hist["val"][0]
    for a, b in zip(best["weights"] + best["biases"],
                    jbest["weights"] + jbest["biases"]):
        assert not a.requires_grad
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=WEIGHT_ATOL)
    assert best["control_rngs"] is params["control_rngs"]
    # the held weights were not trained in place
    np.testing.assert_array_equal(model.weights[0].numpy(),
                                  np.asarray(jparams["weights"][0]))


def test_fold_standardization_exact_to_float32_rounding():
    """Folded raw-space model == unstandardize(NN(standardize(x))), and the
    folded weights equal the JAX package's to float32 rounding."""
    model, params, _, jparams = _pair(layers=(6, 16, 4), seed=3)
    rs = np.random.RandomState(0)
    f_mean = rs.randn(6).astype(np.float32)
    f_std = (0.5 + rs.rand(6)).astype(np.float32)
    l_mean = rs.randn(4).astype(np.float32)
    l_std = (0.5 + rs.rand(4)).astype(np.float32)
    folded = train.fold_standardization(params, f_mean, f_std, l_mean, l_std)
    jfolded = jtrain.fold_standardization(jparams, f_mean, f_std, l_mean,
                                          l_std)
    for a, b in zip(folded["weights"] + folded["biases"],
                    jfolded["weights"] + jfolded["biases"]):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-7,
                                   atol=2e-7)
    x = torch.tensor(rs.randn(32, 6).astype(np.float32))
    want = (train.predict(model, params, (x - torch.tensor(f_mean))
                          / torch.tensor(f_std)) * torch.tensor(l_std)
            + torch.tensor(l_mean))
    got = train.predict(model, folded, x)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


# -- evaluation --------------------------------------------------------------

def test_instantaneous_and_multistep_errors_match_jax(table):
    port_table, frame = table
    model, params, jmodel, jparams = _pair(seed=1)
    cols = ["roll", "u_x", "u_y", "yaw_mder", "steering", "throttle"]
    labels = ["roll_der", "u_x_der", "u_y_der", "yaw_mder_der"]
    inputs = port_table.to_numpy(cols)
    lab = port_table.to_numpy(labels)
    got = evaluate.instantaneous_errors(model, params, inputs, lab)
    want = jevaluate.instantaneous_errors(jmodel, jparams, inputs, lab)
    for k in ("errors", "mean_abs", "rmse"):
        assert got[k].dtype == np.asarray(want[k]).dtype
        np.testing.assert_allclose(got[k], want[k], rtol=PRED_RTOL,
                                   atol=PRED_ATOL, err_msg=k)
    states = port_table.to_numpy(["x_pos", "y_pos", "yaw", "roll", "u_x",
                                  "u_y", "yaw_mder"])
    controls = port_table.to_numpy(["steering", "throttle"])
    for h in (1, 10, 25):
        got = evaluate.multistep_errors(model, params, states, controls, h)
        want = jevaluate.multistep_errors(jmodel, jparams, states, controls,
                                          h)
        assert set(got) == set(want)
        for k in want:
            assert got[k].shape == np.asarray(want[k]).shape, k
            np.testing.assert_allclose(got[k], want[k], rtol=MULTI_RTOL,
                                       atol=MULTI_ATOL, err_msg=f"{h} {k}")
    with pytest.raises(ValueError, match="shorter than horizon"):
        evaluate.multistep_errors(model, params, states[:5], controls[:5], 5)


@pytest.mark.parametrize("ramp", [False, True])
def test_compare_nn_to_ode_matches_jax(ramp):
    model, params, jmodel, jparams = _pair(seed=2)
    kw = dict(steering=0.2, throttle=0.5, time_horizon=0.5, dt=0.01,
              init_cond=np.array([0, 0, 0.3, 0, 2.0, 0.1, 0], np.float32),
              linear_varying_ctrls=ramp)
    got = ode_compare.compare_nn_to_ode(model, params, **kw)
    want = jode.compare_nn_to_ode(jmodel, jparams, **kw)
    assert got["nn"].shape == (50, 7)
    np.testing.assert_array_equal(got["ode"], want["ode"])
    np.testing.assert_array_equal(got["controls"], want["controls"])
    np.testing.assert_allclose(got["nn"], want["nn"], rtol=MULTI_RTOL,
                               atol=MULTI_ATOL)
    np.testing.assert_allclose(got["final_divergence"],
                               want["final_divergence"], rtol=MULTI_RTOL,
                               atol=MULTI_ATOL)
    np.testing.assert_array_equal(
        ode_compare.analytic_vehicle_ode(kw["init_cond"], 0.2, 0.5),
        jode.analytic_vehicle_ode(kw["init_cond"], 0.2, 0.5))


def test_sensor_noise_stats_match_jax():
    rs = np.random.default_rng(3)
    log = 0.01 * rs.standard_normal((500, 3)) + np.array([1.0, -2.0, 0.5])
    names = ("x", "y", "yaw")
    assert ode_compare.sensor_noise_stats(log, names) == \
        jode.sensor_noise_stats(log, names)
    assert ode_compare.sensor_noise_stats(log[:, 0]) == \
        jode.sensor_noise_stats(log[:, 0])


# -- ingestion ---------------------------------------------------------------

def test_ingest_log_matches_jax_column_by_column(table):
    port_table, frame = table
    assert len(port_table) == 1000
    _columns_equal(port_table, frame)
    assert (np.diff(port_table["time"]) > 0).all()
    assert np.abs(port_table["steering"]).max() <= 1.0


def test_ingest_log_total_data_and_topic_errors_match_jax(drive_log):
    _columns_equal(ingest.ingest_log(drive_log, total_data=12.0),
                   jingest.ingest_log(drive_log, total_data=12.0))
    spec = [dict(t) for t in ingest.SIM_NODE_TOPICS[1:]]
    for mod in (ingest, jingest):
        with pytest.raises(ValueError, match="first resampled topic"):
            mod.ingest_log(drive_log, topics=spec)
        with pytest.raises(ValueError, match="not present"):
            mod.ingest_log(drive_log, topics=[{"name": "absent"}])


def test_read_jsonl_topics_splits_orders_and_fills_like_pandas(tmp_path):
    p = str(tmp_path / "log.jsonl")
    # out of order, a field missing from one record, a line not JSON
    with open(p, "w") as f:
        for rec in ({"topic": "a", "secs": 2, "nsecs": 0, "v": 2, "w": 1.5},
                    {"topic": "b", "secs": 1, "nsecs": 0, "w": 9},
                    {"topic": "a", "secs": 1, "nsecs": 5e8, "v": 1}):
            f.write(json.dumps(rec) + "\n")
        f.write("not json\n")
    frames = ingest.read_jsonl_topics(p)
    jframes = jingest.read_jsonl_topics(p)
    assert set(frames) == set(jframes) == {"a", "b"}
    for k in frames:
        assert frames[k].columns == list(jframes[k].columns)
        for c in jframes[k].columns:
            np.testing.assert_array_equal(frames[k][c],
                                          jframes[k][c].to_numpy(), c)
    assert frames["a"]["v"].tolist() == [1, 2]          # reordered


def test_topic_steps_and_clip_helpers_match_jax():
    import pandas as pd

    yaws = np.linspace(-2.5, 2.5, 40)
    rolls = 0.2 * np.sin(yaws * 3)
    half_y, half_r = 0.5 * yaws, 0.5 * rolls
    quats = np.stack([np.cos(half_y) * np.sin(half_r),
                      np.sin(half_y) * np.sin(half_r),
                      np.sin(half_y) * np.cos(half_r),
                      np.cos(half_y) * np.cos(half_r)], 1)
    cols = {k: quats[:, i] for i, k in enumerate(("qx", "qy", "qz", "qw"))}
    cols["time"] = np.linspace(0.0, 3.9, 40)
    td = ingest.TopicData(ingest.Table(cols))
    jtd = jingest.TopicData(pd.DataFrame(cols))
    for t in (td, jtd):
        t.quaternion_to_euler("qx", "qy", "qz", "qw")
        t.get_data_derivative(["yaw"])
        t.trim_sequence(2.0)
        t.trunc(["roll"], 0.1, -0.1)
    _columns_equal(td.df, jtd.df)
    np.testing.assert_allclose(td.df["yaw"], yaws[:21], atol=1e-9)
    a = {"time": np.linspace(0.3, 10.2, 100), "v": np.ones(100)}
    b = {"time": np.linspace(0.9, 9.1, 80), "w": 2 * np.ones(80)}
    got = ingest.clip_start_end_times("time", ingest.Table(a),
                                      ingest.Table(b))
    want = jingest.clip_start_end_times("time", pd.DataFrame(a),
                                        pd.DataFrame(b))
    for g, w in zip(got, want):
        _columns_equal(g, w)
        np.testing.assert_array_equal(g.index, w.index.to_numpy())


def test_reference_csvs_ingest_like_jax(drive_log, tmp_path):
    """The reference path: per-topic CSVs named by a ``topics:`` spec, read
    with numpy and run through the same pipeline."""
    frames = jingest.read_jsonl_topics(drive_log)
    topics = [dict(t) for t in jingest.SIM_NODE_TOPICS]
    for i, spec in enumerate(topics):
        spec["filename"] = f"topic{i}.csv"
        # shuffled rows: the reader restores the stamp order
        frames[spec["name"]].sample(frac=1.0, random_state=i).to_csv(
            tmp_path / spec["filename"], index=False)
    _columns_equal(reference_config.ingest_reference_csvs(str(tmp_path),
                                                          topics),
                   jref.ingest_reference_csvs(str(tmp_path), topics),
                   rtol=1e-9)
    with pytest.raises(FileNotFoundError, match="process_bag"):
        reference_config.read_csv_topics(str(tmp_path / "none"), topics)


def test_load_reference_config_and_the_pyyaml_message(tmp_path,
                                                      monkeypatch):
    path = tmp_path / "config.yml"
    path.write_text("feature_cols: [roll, u_x]\nlabel_cols: [roll_der]\n"
                    "nn_layers: [6, 64, 64, 64, 64, 4]\ntopics: []\n"
                    "epochs: 7\n")
    got = reference_config.load_reference_config(str(path))
    assert got == jref.load_reference_config(str(path))
    assert got["nn_layers"] == [6, 64, 64, 64, 64, 4] and got["epochs"] == 7
    path.write_text("feature_cols: [roll]\n")
    with pytest.raises(ValueError, match="missing required keys"):
        reference_config.load_reference_config(str(path))
    monkeypatch.setitem(sys.modules, "yaml", None)
    with pytest.raises(ImportError, match="PyYAML"):
        reference_config.load_reference_config(str(path))


def test_dataset_batches_split_and_csv_match_jax(tmp_path):
    rs = np.random.default_rng(4)
    x = rs.standard_normal((203, 6)).astype(np.float32)
    y = rs.standard_normal((203, 4)).astype(np.float32)
    ds, jds = dataset.DynamicsDataset(x, y), jdataset.DynamicsDataset(x, y)
    for (a, b), (ja, jb) in zip(ds.batches(64, seed=5),
                                jds.batches(64, seed=5), strict=True):
        np.testing.assert_array_equal(a, ja)
        np.testing.assert_array_equal(b, jb)
    for part, jpart in zip(ds.split(0.2, 1), jds.split(0.2, 1)):
        np.testing.assert_array_equal(part.inputs, jpart.inputs)
    np.testing.assert_array_equal(dataset.standardize(x)[0],
                                  jdataset.standardize(x)[0])
    path = tmp_path / "data.csv"
    names = list(dataset.STATE_COLS + dataset.CTRL_COLS) + [
        c + "_der" for c in dataset.STATE_COLS]
    np.savetxt(path, np.concatenate([x, y], 1), delimiter=",",
               header=",".join(names), comments="")
    got, want = (d.DynamicsDataset.from_csv(str(path))
                 for d in (dataset, jdataset))
    np.testing.assert_array_equal(got.inputs, want.inputs)
    np.testing.assert_array_equal(got.labels, want.labels)
    t = np.linspace(0, 2, 101)
    st = np.stack([np.sin(k * t) for k in range(1, 8)], 1)
    ctl = np.stack([np.cos(t), t], 1)
    for a, b in zip(dataset.preprocess_trajectory(t, st, ctl),
                    jdataset.preprocess_trajectory(t, st, ctl)):
        np.testing.assert_array_equal(a, b)


# -- torch interchange -------------------------------------------------------

def test_torch_interchange_round_trip_matches_jax(tmp_path):
    layers = (6, 16, 16, 4)
    model = NeuralNetDynamics(DT, layers=layers, device="cpu")
    jmodel = JaxNN(DT, layers=layers)
    torch.manual_seed(0)
    module = torch_interop.setup_torch_model(layers)
    assert [type(m).__name__ for m in module] == [
        type(m).__name__ for m in jinterop.setup_torch_model(layers)]
    params = torch_interop.torch_to_params(module, model)
    jparams = jinterop.torch_to_params(module, jmodel)
    for a, b in zip(params["weights"] + params["biases"] + [
            params["control_rngs"]], jparams["weights"] + jparams["biases"]
            + [jparams["control_rngs"]]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    back = torch_interop.params_to_torch(params, model)
    x = torch.randn(8, 6, dtype=torch.float64)
    torch.testing.assert_close(back(x), module(x), rtol=1e-6, atol=1e-6)
    # a reference .pt state dict (nn0/nn1/nn2 naming), wrapped and bare
    sd = {f"nn{i}.{k}": v for i, m in enumerate(
        m for m in module if isinstance(m, torch.nn.Linear))
        for k, v in m.state_dict().items()}
    for obj in ({"model_state_dict": sd}, sd, module):
        path = str(tmp_path / "m.pt")
        torch.save(obj, path)
        got = torch_interop.load_torch_checkpoint(path, model)
        want = jinterop.load_torch_checkpoint(path, jmodel)
        for a, b in zip(got["weights"] + got["biases"],
                        want["weights"] + want["biases"]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    with pytest.raises(ValueError, match="Linear layers"):
        torch_interop.torch_to_params(
            torch_interop.setup_torch_model((6, 16, 4)), model)


# -- plots --------------------------------------------------------------------

def test_plots_write_files_or_name_matplotlib(table, tmp_path, monkeypatch):
    port_table, _ = table
    paths = plots.state_variable_plots(port_table, ["u_x", "roll"],
                                       str(tmp_path / "pre"))
    paths.append(plots.training_curve_plot({"train": [1.0, 0.5],
                                            "val": [1.1, 0.6]},
                                           str(tmp_path)))
    err = np.abs(np.random.default_rng(0).standard_normal((20, 11, 7)))
    paths += plots.multi_step_error_plots(err, np.arange(1, 12) * DT,
                                          str(tmp_path))
    assert len(paths) == 5 and all(os.path.getsize(p) > 0 for p in paths)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="matplotlib"):
        plots.training_curve_plot({"train": [1.0], "val": [1.0]},
                                  str(tmp_path))
