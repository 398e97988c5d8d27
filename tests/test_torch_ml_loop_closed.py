"""The closed drive->log->train->hot-swap loop on the port against the
independent physics plant (the twin of ``tests/test_ml_loop_closed.py``),
on the CPU at test scale: K=96, T=24, 300 lockstep ticks on seeded
6-32-32-4 weights (the JAX package's ``init_params(PRNGKey(0))`` carried
over by ``params_from_jax``; the reference weights are not in the
repository).  The log's lines are the JAX demo's, fine-tuning on the
physics log must fit it better than the driving weights, and the swap
through the plant's update queue must reach both controllers bit for bit.
The demo's entry point (``ml_loop_demo.main``) runs once at a small size.

The JAX test's "the car moved" bound (1 m/s) belongs to the reference
weights.  Measured with these seeded weights on this configuration: the
JAX loop's car covers 0.42 m of path (|speed| at most 0.27 m/s), the
port's 0.54 m (0.37 m/s); one-step RMSE 0.190 -> 0.126 (JAX) and 0.192 ->
0.120 (the port) after 15 epochs.  The port's bound is 0.2 m of path."""

import io
import json
import math

import jax
import numpy as np
import pytest
import torch

from autorally_tpu.models import NeuralNetDynamics as JaxNN
from autorally_tpu_torch import ml_loop_demo
from autorally_tpu_torch.config import CostParams, MPPIConfig
from autorally_tpu_torch.costs import MPPICost
from autorally_tpu_torch.costs.costmap import make_costmap
from autorally_tpu_torch.ml import (DynamicsDataset, TrainConfig,
                                    ingest_log, instantaneous_errors,
                                    train_dynamics)
from autorally_tpu_torch.models import NeuralNetDynamics
from autorally_tpu_torch.runtime import (ControlLoopConfig, Controller,
                                         run_control_loop)
from autorally_tpu_torch.sim import SimVehiclePlant
from autorally_tpu_torch.solver.mppi import MPPISolver
from autorally_tpu_torch.tools.track_generator import oval_track
from examples.ml_loop_demo import write_log_record as jax_write_log_record

TICKS = 300
MIN_PATH = 0.2


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The closed loops' small CPU solves on one thread: beside the other
    test workers, more threads only contend for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_write_log_record_writes_the_jax_demos_lines():
    rng = np.random.RandomState(2)
    ours, ref = io.StringIO(), io.StringIO()
    for i in range(12):
        t = 0.02 * (i + 1) + 1.0 * (i // 5)
        s7 = rng.randn(7).astype(np.float32)
        u = (float(rng.uniform(-1, 1)), float(rng.uniform(-1, 1)))
        wheels = np.abs(rng.randn(4)).astype(np.float32)
        ml_loop_demo.write_log_record(ours, t, s7, u, wheels, i)
        jax_write_log_record(ref, t, s7, u, wheels, i)
    assert ours.getvalue() == ref.getvalue()
    topics = [json.loads(line)["topic"]
              for line in ours.getvalue().splitlines()]
    assert topics.count("ground_truth/state") == 12
    assert topics.count("chassisState") == 6
    assert topics.count("wheelSpeeds") == 3


def test_drive_log_train_hotswap_loop(tmp_path):
    cfg = MPPIConfig(num_rollouts=96, num_timesteps=24)
    data, xb, yb = oval_track(ppm=2.0)
    cm = make_costmap(data, xb, yb, device="cpu")
    jmodel = JaxNN(cfg.dt, control_ranges=cfg.control_ranges)
    model = NeuralNetDynamics(cfg.dt, control_ranges=cfg.control_ranges,
                              device="cpu")
    params0 = model.params_from_jax(jax.tree_util.tree_map(
        np.asarray, jmodel.init_params(jax.random.PRNGKey(0))))
    solver = MPPISolver(model, MPPICost(), cfg, device="cpu")
    cp = CostParams(desired_speed=4.0)
    actual = Controller(solver, params0, cp, cm)
    predicted = Controller(solver, params0, cp, cm, seed=5)

    start = np.array([30.0, 0.0, math.pi / 2, 0, 0, 0, 0],
                     dtype=np.float32)
    plant = SimVehiclePlant(start, cfg.dt, cfg.num_timesteps, device="cpu",
                            use_feedback_gains=False)
    plant.receive_state_vector(0.0, start)

    # phase 1: drive the physics plant in lockstep, recording the log
    log = str(tmp_path / "drive.jsonl")
    xy = []
    with open(log, "w") as f:
        def on_tick(i, chosen, used, state):
            xy.append(plant.true_state[:2].copy())
            if plant.published:
                u = plant.published[-1][1:3]
                ml_loop_demo.write_log_record(
                    f, plant.sim_time, plant.true_state, u,
                    plant.wheel_speeds(), i)

        lcfg = ControlLoopConfig(hz=cfg.hz, num_timesteps=cfg.num_timesteps,
                                 use_feedback_gains=False, max_iter=TICKS)
        run_control_loop(predicted, actual, plant, lcfg, on_tick=on_tick)
    path = np.sum(np.linalg.norm(np.diff(np.asarray(xy), axis=0), axis=1))
    assert path > MIN_PATH, path             # the physics vehicle moved

    # phase 2: ingest the multi-topic log, fine-tune the model
    df = ingest_log(log)
    assert len(df) > 200
    feats = df.to_numpy(ml_loop_demo.FEATURES)
    labels = df.to_numpy(ml_loop_demo.LABELS)
    rmse0 = instantaneous_errors(model, params0, feats, labels)["rmse"]
    train, val = DynamicsDataset(feats, labels).split(0.2, 0)
    params1, _ = train_dynamics(
        model, params0, train, val,
        TrainConfig(epochs=15, batch_size=64, lr=1e-3), verbose=False)
    rmse1 = instantaneous_errors(model, params1, feats, labels)["rmse"]
    assert rmse1.mean() < rmse0.mean(), (rmse1, rmse0)

    # phase 3: hot-swap into the running loop; both controllers must
    # consume the new weights, bit for bit
    plant.push_model_params(params1)
    lcfg2 = ControlLoopConfig(hz=cfg.hz, num_timesteps=cfg.num_timesteps,
                              use_feedback_gains=False, max_iter=5)
    run_control_loop(predicted, actual, plant, lcfg2)
    for ctrl in (actual, predicted):
        for key in ("weights", "biases"):
            for got, want in zip(ctrl.model_params[key], params1[key]):
                assert torch.equal(got, want)
    moved = max(float((a - b).abs().max())
                for a, b in zip(params1["weights"], params0["weights"]))
    assert moved > 1e-6                      # training moved them


def test_ml_loop_demo_main_runs_on_the_cpu(tmp_path, capsys):
    log = str(tmp_path / "drive.jsonl")
    rc = ml_loop_demo.main(["--cpu", "--ticks", "25", "--epochs", "20",
                            "--rollouts", "32", "--timesteps", "8",
                            "--log", log])
    out = capsys.readouterr().out
    assert "ml_loop_demo on cpu: K=32 T=8; model weights: seeded" in out
    assert "before: mean speed" in out and "after: mean speed" in out
    assert "ingested" in out and "one-step RMSE" in out
    metrics = json.loads(out[out.index("{"):])
    assert metrics["before"]["ticks"] == metrics["after"]["ticks"] == 25
    assert rc == (0 if metrics["model_fit_improved"] else 1)
    with open(log) as f:
        assert sum('"ground_truth/state"' in line for line in f) >= 24


def test_ml_loop_on_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no GPU"):
        ml_loop_demo.MLLoop(32, 8)
