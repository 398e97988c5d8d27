"""The port's multi-host helpers (``autorally_tpu_torch/parallel/multihost.py``)
on gloo CPU ranks: the twins of ``tests/test_multihost.py``.

``parallel/launch.py``'s ``multihost_program`` runs on 4 spawned ranks in
two topologies, 2 "hosts" x 2 ranks and 4 x 1 (``LOCAL_WORLD_SIZE`` 2 and
1): ``initialize`` (a second call), the sharded solve on
``multihost_rollout_mesh()``, the ensemble on
``multihost_ensemble_mesh()``, and the primary's result file.  Both
topologies must reproduce the single-process solve on the shards' noise:
the noise is keyed by the global shard index.  K=256, T=16, the seeded
MLP on the ppm=2 oval."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from autorally_tpu.tools.track_generator import oval_track
from autorally_tpu_torch.config import CostParams
from autorally_tpu_torch.models.ensemble import stack_params
from autorally_tpu_torch.ops import kernel_rng as kr
from autorally_tpu_torch.parallel import launch, multihost
from tests.test_torch_solver import _pair

K, T, N = 256, 16, 4
START = np.array([0.0, -15.0, 0.0, 0.0, 2.0, 0.0, 0.0], np.float32)
# tests/test_multihost.py's tolerances
U_RTOL, U_ATOL, STAT_RTOL = 1e-5, 1e-6, 1e-4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", params=[2, 1], ids=["2hosts_x_2ranks",
                                                   "4hosts_x_1rank"])
def worker_results(request, tmp_path_factory):
    per_host = request.param
    out = tmp_path_factory.mktemp("multihost")
    solver, params, *_ = _pair(K=K, T=T)
    n_hosts = N // per_host
    members = stack_params([params] + [
        {**params, "biases": [b + 0.05 * (m + 1) for b in params["biases"]]}
        for m in range(n_hosts - 1)])
    spec = dict(cfg=dict(num_rollouts=K, num_timesteps=T),
                params=launch.to_numpy(params),
                members=launch.to_numpy(members),
                costmap=oval_track(ppm=2.0), state=START,
                out_dir=str(out))
    results = launch.run(launch.multihost_program, N, (spec,),
                         env={"LOCAL_WORLD_SIZE": str(per_host)},
                         timeout=240)
    return per_host, out, results


def test_sharded_solve_matches_single_process(worker_results):
    """The 4-rank solve against ``MPPISolver``'s solve from the same state
    fed the shards' noise, concatenated in global shard order."""
    _, out, _ = worker_results
    primary = np.load(out / "primary_result.npz")
    solver, params, cm, *_ = _pair(K=K, T=T)
    cs = solver.init_state()
    _, sub = kr.split(cs.key)
    eps = torch.cat([solver._sample_noise(
        solver._noise_generator(kr.fold_in(sub, i)), (T, K // N, 2))
        for i in range(N)], dim=1)
    cs2, stats = solver._solve_drawn(params, CostParams(), cm,
                                     torch.tensor(START), cs, [eps])
    np.testing.assert_allclose(primary["U"], cs2.U.numpy(), rtol=U_RTOL,
                               atol=U_ATOL)
    for k in ("baseline", "normalizer", "ess", "trajectory_cost"):
        np.testing.assert_allclose(float(primary[k]),
                                   getattr(stats, k).item(), rtol=STAT_RTOL,
                                   err_msg=k)


def test_replicas_agree_and_io_routed_to_primary(worker_results):
    per_host, out, results = worker_results
    primary = np.load(out / "primary_result.npz")
    replica = np.load(out / "replica_1.npz")
    np.testing.assert_array_equal(primary["U"], replica["U"])
    np.testing.assert_array_equal(primary["eU"], replica["eU"])
    assert not (out / "replica_0.npz").exists()
    assert [r["primary"] for r in results] == [True, False, False, False]
    for r in results[1:]:
        np.testing.assert_array_equal(r["U"], results[0]["U"])
        np.testing.assert_array_equal(r["eU"], results[0]["eU"])
    # ranks ordered by (host, local rank)
    np.testing.assert_array_equal(results[0]["rollout_ranks"], np.arange(N))


def test_ensemble_mesh_shape_and_finite_result(worker_results):
    per_host, out, results = worker_results
    primary = np.load(out / "primary_result.npz")
    assert results[0]["ensemble_shape"] == {"ensemble": N // per_host,
                                            "rollouts": per_host}
    np.testing.assert_array_equal(results[0]["ensemble_ranks"],
                                  np.arange(N).reshape(N // per_host,
                                                       per_host))
    assert primary["eU"].shape == (T, 2)
    assert np.isfinite(primary["eU"]).all()


def test_initialize_does_nothing_for_one_process():
    multihost.initialize()
    multihost.initialize(coordinator="127.0.0.1:1", num_processes=1,
                         process_id=0)
    assert not dist.is_initialized()
    assert multihost.is_primary()
    mesh = multihost.multihost_rollout_mesh()
    assert mesh.shape == {"rollouts": 1} and not mesh.has_collectives


def test_initialize_raises_on_a_bad_coordinator():
    """A wrong coordinator raises within the 5 s timeout rather than leave
    the process single-host."""
    code = (
        "from autorally_tpu_torch.parallel.multihost import initialize\n"
        "try:\n"
        "    initialize(coordinator='127.0.0.1:1', num_processes=2,"
        " process_id=1, initialization_timeout=5, backend='gloo')\n"
        "except Exception as e:\n"
        "    print('RAISED', type(e).__name__); raise SystemExit(0)\n"
        "print('SILENT-SINGLE-HOST', flush=True)\n"
        "raise SystemExit(1)\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=60, cwd=REPO)
    assert r.returncode == 0 and "RAISED" in r.stdout, r.stdout + r.stderr
