"""Three-phase ML pipeline driver: preprocess -> train -> test (port of
``autorally_tpu/ml/trainer.py``).

CLI equivalent of the reference ``ml_pipeline/trainer.py:244-264`` driven
by a config with the same phase switches (``config.yml``):

.. code-block:: yaml

    preprocess_data: true
    train_model: true
    test_model: true
    # EITHER a multi-topic JSONL drive log (tools/sim_node.py --log,
    # the rosbag path: ingestion + per-topic resample/merge)...
    log_jsonl: logs/drive.jsonl
    topics:                          # optional; defaults to the sim-node
      ...                           # spec (ml/ingest.py SIM_NODE_TOPICS)
    total_data: 60                   # seconds to keep (optional)
    # ...OR a pre-merged CSV (the reference's intermediate format):
    data_csv: logs/run1.csv          # t,x,y,yaw,roll,u_x,u_y,yaw_mder,steering,throttle
    standardize_data: true           # scalers folded into the exported npz
    make_plots: true                 # needs matplotlib
    results_dir: ml_results
    nn_layers: [6, 32, 32, 4]
    epochs: 300
    batch_size: 64
    lr: 0.005
    loss_weights: [1.0, 1.0, 1.0, 0.5]
    state_step: 0.02                 # model dt
    horizons: [10, 50, 100]          # multi-step eval horizons

Run: ``python -m autorally_tpu_torch.ml.trainer --config config.yml
[--cpu]``.  The config is YAML where PyYAML is installed, else JSON (which
is YAML too); the GPU machine has no PyYAML.  Training and evaluation run
on the card unless ``--cpu`` (``run(cfg, device="cpu")``).

Standardization (``standardize_data``) leaves no side files to carry: the
fitted scalers are folded into the first/last layer weights
(:func:`autorally_tpu_torch.ml.train.fold_standardization`), so the
exported ``model.npz`` always consumes raw states, loads with
``NeuralNetDynamics.from_npz`` at its own spec and can hot-swap straight
into a running controller.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

DEFAULTS = dict(
    preprocess_data=True, train_model=True, test_model=True,
    results_dir="ml_results", nn_layers=[6, 32, 32, 4], epochs=300,
    batch_size=64, lr=5e-3, weight_decay=0.0,
    loss_weights=[1.0, 1.0, 1.0, 0.5], state_step=0.02,
    horizons=[10, 50, 100], val_frac=0.2, seed=0,
    standardize_data=False, make_plots=False,
    log_jsonl=None, topics=None, total_data=None, data_csv=None,
    feature_cols=["roll", "u_x", "u_y", "yaw_mder", "steering", "throttle"],
    label_cols=["roll_der", "u_x_der", "u_y_der", "yaw_mder_der"],
    state_cols=["x_pos", "y_pos", "yaw", "roll", "u_x", "u_y", "yaw_mder"],
    ctrl_cols=["steering", "throttle"],
)


def load_config(path):
    """DEFAULTS updated by the config at ``path``: YAML where PyYAML is
    installed, else JSON."""
    with open(path) as f:
        text = f.read()
    try:
        import yaml
    except ImportError:
        cfg = json.loads(text)
    else:
        cfg = yaml.safe_load(text)
    out = dict(DEFAULTS)
    out.update(cfg or {})
    return out


def _load_training_table(cfg):
    """Phase-1 data acquisition -> (t, states, controls, inputs, labels).

    JSONL drive logs go through the full multi-topic ingest pipeline
    (``ml/ingest.py``); ``reference_csv_dir`` ingests a reference user's
    per-topic CSVs (their ``process_bag.py`` output) through the same
    pipeline driven by their own ``config.yml`` topics spec
    (``ml/reference_config.py``); plain CSVs are the reference's
    pre-merged intermediate format and load directly."""
    df = None
    if cfg.get("log_jsonl"):
        from autorally_tpu_torch.ml.ingest import ingest_log

        df = ingest_log(cfg["log_jsonl"], topics=cfg.get("topics"),
                        total_data=cfg.get("total_data"))
    elif cfg.get("reference_csv_dir"):
        from autorally_tpu_torch.ml.reference_config import \
            ingest_reference_csvs

        if not cfg.get("topics"):
            raise ValueError(
                "reference_csv_dir requires a 'topics:' spec (the one "
                "from the reference config.yml — see "
                "ml/reference_config.load_reference_config)")
        df = ingest_reference_csvs(cfg["reference_csv_dir"],
                                   cfg["topics"],
                                   total_data=cfg.get("total_data"))
    if df is not None:
        df.to_csv(os.path.join(cfg["results_dir"], "final_data.csv"))
        t = df["time"].astype(np.float64)
        states = df.to_numpy(cfg["state_cols"])
        controls = df.to_numpy(cfg["ctrl_cols"])
        inputs = df.to_numpy(cfg["feature_cols"])
        labels = df.to_numpy(cfg["label_cols"])
        if cfg.get("make_plots"):
            from autorally_tpu_torch.ml.plots import state_variable_plots

            state_variable_plots(
                df, cfg["state_cols"] + cfg["ctrl_cols"]
                + cfg["label_cols"],
                os.path.join(cfg["results_dir"], "preprocess_plots"))
        return t, states, controls, inputs, labels

    from autorally_tpu_torch.ml.dataset import preprocess_trajectory

    raw = np.loadtxt(cfg["data_csv"], delimiter=",", skiprows=1)
    t = raw[:, 0]
    states = raw[:, 1:8].astype(np.float32)
    controls = raw[:, 8:10].astype(np.float32)
    inputs, labels = preprocess_trajectory(t, raw[:, 1:8], raw[:, 8:10])
    return t, states, controls, inputs, labels


def run(cfg: dict, device=None) -> dict:
    """The three phases of ``cfg`` (DEFAULTS and its overrides), the model
    trained and evaluated on ``device`` (``cuda`` unless given); writes
    ``dataset.npz``, ``scalers.npz``, ``final_data.csv``, ``model.npz``,
    ``multistep_h*.npz`` and ``results.json`` into ``results_dir`` and
    returns the results."""
    from autorally_tpu_torch.config import resolve_device
    from autorally_tpu_torch.ml import (DynamicsDataset, TrainConfig,
                                        instantaneous_errors,
                                        multistep_errors, standardize,
                                        train_dynamics)
    from autorally_tpu_torch.ml.train import fold_standardization
    from autorally_tpu_torch.models import NeuralNetDynamics

    dev = resolve_device(device)
    os.makedirs(cfg["results_dir"], exist_ok=True)
    results = {}

    # -- phase 1: preprocess (trainer.py preprocess_data) --------------------
    if cfg["preprocess_data"]:
        t, states, controls, inputs, labels = _load_training_table(cfg)
        np.savez(os.path.join(cfg["results_dir"], "dataset.npz"),
                 inputs=inputs, labels=labels, states=states,
                 controls=controls, t=t)
    else:
        d = np.load(os.path.join(cfg["results_dir"], "dataset.npz"))
        t, states, controls = d["t"], d["states"], d["controls"]
        inputs, labels = d["inputs"], d["labels"]

    model = NeuralNetDynamics(cfg["state_step"], layers=cfg["nn_layers"],
                              device=dev)

    # -- phase 2: train (trainer.py train_model) -----------------------------
    model_npz = os.path.join(cfg["results_dir"], "model.npz")
    if cfg["train_model"]:
        train_in, train_lb = inputs, labels
        scalers = None
        if cfg["standardize_data"]:
            # standardize features AND labels (trainer.py:120-133), but
            # fold the scalers back into the weights after training so
            # the exported model is raw-space (no pickle side files)
            train_in, f_mean, f_std = standardize(inputs)
            train_lb, l_mean, l_std = standardize(labels)
            scalers = (f_mean, f_std, l_mean, l_std)
            np.savez(os.path.join(cfg["results_dir"], "scalers.npz"),
                     feature_mean=f_mean, feature_std=f_std,
                     label_mean=l_mean, label_std=l_std)

        train, val = DynamicsDataset(train_in, train_lb).split(
            cfg["val_frac"], cfg["seed"])
        init = model.init_params(cfg["seed"])
        tcfg = TrainConfig(epochs=cfg["epochs"], batch_size=cfg["batch_size"],
                           lr=cfg["lr"], weight_decay=cfg["weight_decay"],
                           loss_weights=tuple(cfg["loss_weights"]),
                           seed=cfg["seed"])
        params, history = train_dynamics(model, init, train, val, tcfg)
        if scalers is not None:
            params = fold_standardization(params, *scalers)
        model.save_params(params, model_npz)      # reference interchange
        results["best_val_loss"] = min(history["val"])
        results["model_npz"] = model_npz
        if cfg.get("make_plots"):
            from autorally_tpu_torch.ml.plots import training_curve_plot

            training_curve_plot(history, cfg["results_dir"])
    else:
        params = model.load_params(model_npz)

    # -- phase 3: test (trainer.py test_model) -------------------------------
    if cfg["test_model"]:
        inst = instantaneous_errors(model, params, inputs, labels)
        results["instantaneous_rmse"] = inst["rmse"].tolist()
        results["multistep"] = {}
        for h in cfg["horizons"]:
            ms = multistep_errors(model, params, states.astype(np.float32),
                                  controls.astype(np.float32), horizon=h)
            results["multistep"][str(h)] = {
                "pos_error_mean_final": float(ms["pos_error_mean"][-1]),
                "pos_error_p90_final": float(ms["pos_error_p90"][-1]),
            }
            np.savez(os.path.join(cfg["results_dir"], f"multistep_h{h}.npz"),
                     pos_error_mean=ms["pos_error_mean"],
                     pos_error_median=ms["pos_error_median"],
                     pos_error_p90=ms["pos_error_p90"],
                     state_rmse=ms["state_rmse"])
        if cfg.get("make_plots") and cfg["horizons"]:
            from autorally_tpu_torch.ml.plots import multi_step_error_plots

            h = max(cfg["horizons"])
            ms = multistep_errors(model, params, states.astype(np.float32),
                                  controls.astype(np.float32), horizon=h)
            multi_step_error_plots(
                np.abs(ms["state_errors"]),
                np.arange(1, h + 1) * cfg["state_step"],
                cfg["results_dir"])

    with open(os.path.join(cfg["results_dir"], "results.json"), "w") as f:
        json.dump(results, f, indent=2)
    return results


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--cpu", action="store_true",
                    help="train and evaluate on the CPU (default: the GPU)")
    args = ap.parse_args(argv)
    results = run(load_config(args.config),
                  device="cpu" if args.cpu else None)
    print(json.dumps(results, indent=2))


if __name__ == "__main__":
    main()
