"""The whole slice on the CPU: ``run_tube_mppi`` with the run log, the scene
camera and the runstop port at once, against the JAX example's log under the
same options and against the JAX tube loop on the same weights and noise."""

import json
import os
import socket
import subprocess
import sys
import time

import numpy as np

from autorally_tpu.models import NeuralNetDynamics as JaxNN
from autorally_tpu_torch import run_tube_mppi
from autorally_tpu_torch.runtime.telemetry_bus import send_runstop
from tests.test_torch_runtime import (FLAT_MAP, LOOP_ATOL, LOOP_RTOL,
                                      _tube_pair)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K, T, TICKS = 128, 24, 60
RUNSTOP_ON, RUNSTOP_OFF = 20, 35     # the runstop holds after ticks 20-34
KINDS = {"run", "solve", "timing", "diag", "system", "image"}
LAP_KEYS = {"t", "kind", "lap_number", "lap_time", "max_speed", "max_slip"}


def _free_udp_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _keys_by_kind(recs) -> dict:
    out = {}
    for r in recs:
        out.setdefault(r["kind"], set()).update(r)
    return out


def _wait(pred, what, timeout=5.0):
    deadline = time.time() + timeout
    while not pred():
        assert time.time() < deadline, what
        time.sleep(0.005)


def _jax_states(side):
    """The JAX tube loop's measured state each tick, with the plant's runstop
    engaged and released at the same ticks as the port's run."""
    actual, predicted, syn, lcfg, lp = side
    states = []

    def on_tick(i, chosen, used, state):
        states.append(np.array(state))
        if i == RUNSTOP_ON:
            syn.set_runstop(True)
        elif i == RUNSTOP_OFF:
            syn.set_runstop(False)

    lp.run_control_loop(predicted, actual, syn, lcfg, on_tick=on_tick)
    return np.array(states), np.array(syn.published)


def _jax_example_log(tmp_path) -> list:
    """``examples/run_tube_mppi.py`` with the same options, on seeded
    weights written in the reference's ``.npz`` layout."""
    jm = JaxNN(0.02)
    import jax

    npz = str(tmp_path / "seeded_nn.npz")
    jm.save_params(jm.init_params(jax.random.PRNGKey(0)), npz)
    log = str(tmp_path / "jax.jsonl")
    run = subprocess.run(
        [sys.executable, "examples/run_tube_mppi.py", "--cpu", "--ticks",
         str(TICKS), "--rollouts", str(K), "--timesteps", str(T), "--model",
         npz, "--log", log, "--camera", "--runstop-port",
         str(_free_udp_port())],
        cwd=REPO, capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stdout + run.stderr
    return _records(log)


def test_run_tube_mppi_with_log_camera_and_runstop(tmp_path, monkeypatch,
                                                   capsys):
    """``main([... --cpu --log --camera --runstop-port 0])`` at K=128, T=24,
    60 ticks on the tube of ``_tube_pair`` (the same weights, map and
    injected noise as the JAX side), a runstop sent over UDP at tick 20
    and released at tick 35:

    - the log holds every record kind and key set of the JAX example's log
      under the same options (the port's car makes no lap in 60 ticks);
    - 60 ``solve`` records whose x, y and speed equal the JAX tube loop's
      measured states within ``test_tube_loop_matches_jax``'s tolerance
      (rtol 1e-4, atol 1e-6: LOOP_RTOL / LOOP_ATOL), the JAX plant's
      runstop engaged at the same ticks;
    - the published throttle is at most 0 while the runstop holds and the
      same as the JAX plant's throughout;
    - ``image`` records at 5 Hz of the plant's clock (1.2 s: 6 frames)."""
    pair = _tube_pair(costmap=FLAT_MAP, max_iter=TICKS)
    actual, predicted, syn, lcfg, _ = pair["port"]
    tube = run_tube_mppi.Tube(actual, predicted, syn, lcfg, actual.solver.cfg,
                              "the tube of _tube_pair")
    monkeypatch.setattr(run_tube_mppi, "build", lambda **kw: tube)
    on_tick = run_tube_mppi.OperatorIO.on_tick

    def operator_tick(self, i, chosen, used, state, lap=None):
        on_tick(self, i, chosen, used, state, lap)
        # the OCS holds the runstop with a datagram every tick, then
        # releases it; each waits until the receiver has applied it
        if RUNSTOP_ON <= i < RUNSTOP_OFF:
            send_runstop(self.runstop.port, "ocs", False)
            _wait(lambda: syn.runstop, "runstop not applied")
        elif i == RUNSTOP_OFF:
            send_runstop(self.runstop.port, "ocs", True)
            _wait(lambda: not syn.runstop, "runstop not released")

    monkeypatch.setattr(run_tube_mppi.OperatorIO, "on_tick", operator_tick)
    log = str(tmp_path / "port.jsonl")
    run_tube_mppi.main(["--cpu", "--ticks", str(TICKS), "--log", log,
                        "--camera", "--runstop-port", "0"])
    out = capsys.readouterr().out
    assert "runstop: listening on UDP port" in out
    assert f"controls published: {TICKS}" in out

    recs = _records(log)
    ours = _keys_by_kind(recs)
    assert set(ours) == KINDS
    # a lap needs two crossings of the start line: the JAX example's car
    # (another map and noise) may wobble across it; the port's lap record
    # is held by tests/test_torch_console.py
    ref = _keys_by_kind(_jax_example_log(tmp_path))
    assert ref.pop("lap", LAP_KEYS) == LAP_KEYS
    assert ours == ref

    solves = [r for r in recs if r["kind"] == "solve"]
    assert [r["tick"] for r in solves] == list(range(1, TICKS + 1))
    states, jpub = _jax_states(pair["jax"])
    got = np.array([[r["x"], r["y"], r["speed"]] for r in solves])
    np.testing.assert_allclose(got, states[:, [0, 1, 4]], rtol=LOOP_RTOL,
                               atol=LOOP_ATOL)
    pub = np.array(syn.published)
    np.testing.assert_allclose(pub, jpub, rtol=LOOP_RTOL, atol=LOOP_ATOL)
    # the plant publishes a tick's control after the tick
    held = pub[RUNSTOP_ON - 1:RUNSTOP_OFF - 1, 2]
    assert (held <= 0.0).all() and (pub[:RUNSTOP_ON - 1, 2] > 0.0).any()

    images = [r for r in recs if r["kind"] == "image"]
    assert len(images) == 6
    assert all(len(r["ascii"]) == 14 for r in images)
