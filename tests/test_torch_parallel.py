"""The port's sharded solvers (``autorally_tpu_torch/parallel``) on gloo CPU
ranks, against the single-process solvers and the JAX package.

The sharded runs are ``parallel/launch.py``'s ``sharded_programs`` on 1, 2
and 4 spawned ranks (one launch each; a ``file://`` rendezvous, gloo on
the CPU); the ranks import the port alone.  Sizes: K=256 (128 for the ensemble), T=16, the
seeded MLP (the JAX ``init_params`` carried with ``params_from_jax``) on
the ppm=2 oval.

- ``kernel_rng.fold_in`` bit for bit ``jax.random.fold_in``;
- the mesh helpers, the backend rule and the refusals;
- one shard: the inline body bit for bit the collectives on one rank, and
  ``MPPISolver``'s iteration on ``fold_in(sub, 0)``'s draw;
- host noise on 2 and 4 ranks: against ``MPPISolver.iterate`` on the
  shards' noise concatenated (``tests/test_sharding.py``'s tolerances:
  rtol 1e-4 / atol 1e-5, the baseline rtol 1e-5), against the JAX
  ``MPPISolver.iterate`` on the same noise (``tests/test_torch_solver.py``'s
  tolerances), every rank's U and controller state bit for bit equal;
- the capacity mode on 2 ranks: against the JAX
  ``ShardedMPPISolver._sharded_rng_iterate`` on a 2-device slice of the
  8-device CPU mesh (its kernels in TPU interpret mode; zero exploration
  noise, since the JAX kernels' own PRNG cannot be reproduced: the pure-noise
  band's zero controls then carry the global numbering), and with noise
  against the JAX host-noise rollouts of each shard on the port's stream,
  combined by the same min and sums in numpy;
- the ensemble on a 2 x 2 mesh against ``EnsembleMPPISolver.iterate`` and
  the JAX ``MPPISolver(EnsembleDynamics).iterate`` on the member-block
  noise."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from autorally_tpu.config import CostParams as JaxCostParams
from autorally_tpu.parallel import ShardedMPPISolver as JaxSharded
from autorally_tpu.parallel import rollout_mesh as jax_rollout_mesh
from autorally_tpu.solver import mppi as jmppi
from autorally_tpu.tools.track_generator import oval_track
from autorally_tpu_torch.config import CostParams, MPPIConfig
from autorally_tpu_torch.costs import MPPICost
from autorally_tpu_torch.models import NeuralNetDynamics
from autorally_tpu_torch.ops import kernel_rng as kr
from autorally_tpu_torch.ops import rollout_kernel as rk
from autorally_tpu_torch.parallel import (EnsembleShardedMPPISolver,
                                          ShardedMPPISolver, launch,
                                          make_mesh, rollout_mesh)
from autorally_tpu_torch.solver import EnsembleMPPISolver, MPPISolver
from tests.test_torch_ensemble import _ensemble
from tests.test_torch_solver import ITER_ATOL, ITER_RTOL, _pair

K, T = 256, 16
STATE = np.array([25.0, 0.0, np.pi / 2, 0.0, 3.0, 0.1, 0.0], np.float32)
U0 = np.tile(np.array([0.05, 0.3], np.float32), (T, 1))
CP = dict(desired_speed=6.0)
SUB = kr.split(kr.prng_key(7))[1]
# the sharded iteration against the single-process one on the same noise
# (tests/test_sharding.py): fp32 sums over shards in another order
SHARD_RTOL, SHARD_ATOL, BASELINE_RTOL = 1e-4, 1e-5, 1e-5
STAT_RTOL = 1e-4
SAMPLERS = {"gaussian": {}, "ou": dict(noise_sampler="ou", noise_param=0.15)}


def _spec(**kw) -> dict:
    """``sharded_program``'s spec: the seeded MLP of ``_pair`` on the ppm=2
    oval, one iteration at ``SUB`` and two solves."""
    k = kw.pop("K", K)
    solver, params, *_ = _pair(K=k, T=T)
    spec = dict(cfg=dict(num_rollouts=k, num_timesteps=T),
                params=launch.to_numpy(params), costmap=oval_track(ppm=2.0),
                cost_params=CP, state=STATE, U=U0, sub=SUB, solves=2)
    cfg_kw = kw.pop("cfg", {})
    spec.update(kw)
    spec["cfg"] = dict(spec["cfg"], **cfg_kw)
    return spec


def _run(n, specs):
    """Each spec's results on ``n`` gloo ranks (a list over ranks each)."""
    res = launch.run(launch.sharded_programs, n, (specs,), timeout=240)
    return [[r[i] for r in res] for i in range(len(specs))]


QUIET = dict(steering_std=0.0, throttle_std=0.0, kernel_rng=True)


@pytest.fixture(scope="module")
def one_rank():
    """One rank, forced collectives with the inline reference: host noise
    and the capacity mode."""
    return dict(zip(("host_noise", "capacity"), _run(1, [
        _spec(force_collectives=True, reference=True, cfg=dict(kernel_rng=k))
        for k in (False, True)])))


@pytest.fixture(scope="module")
def two_ranks():
    """Two ranks: host noise, the capacity mode without noise, and with
    gaussian and OU noise."""
    return dict(zip(("host_noise", "quiet", *SAMPLERS), _run(2, [
        _spec(), _spec(cfg=QUIET)] + [
        _spec(cfg=dict(kernel_rng=True, **kw)) for kw in SAMPLERS.values()])))


@pytest.fixture(scope="module")
def four_ranks():
    """Four ranks: host noise, and the ensemble on a 2 x 2 mesh."""
    _, _, stacked, *_ = _ensemble(num_members=2)
    return dict(zip(("host_noise", "ensemble"), _run(4, [
        _spec(), _spec(K=128, mesh=(2, 2),
                       params=launch.to_numpy(stacked))])))


def _shard_noise(solver, n):
    """The shards' host noise, concatenated in rank order (T, K, C)."""
    K_local = solver.cfg.num_rollouts // n
    return torch.cat([solver._sample_noise(
        solver._noise_generator(kr.fold_in(SUB, i)), (T, K_local, 2))
        for i in range(n)], dim=1)


def _assert_replicas_equal(results):
    for r in results[1:]:
        np.testing.assert_array_equal(r["U"], results[0]["U"])
        for f, v in results[0]["stats"].items():
            np.testing.assert_array_equal(r["stats"][f], v, err_msg=f)
        for f in ("U", "state_solution", "control_solution"):
            np.testing.assert_array_equal(r["solve"][f],
                                          results[0]["solve"][f], err_msg=f)


# -- fold_in, the mesh, the refusals ------------------------------------------

@pytest.mark.parametrize("seed,data", [(7, 0), (7, 1), (7, 3), (7, 7),
                                       (7, 2**31 + 5), (0, 1), (1234, 2),
                                       (2**40 + 3, 2**32 - 1)])
def test_fold_in_matches_jax_bit_for_bit(seed, data):
    want = np.asarray(jax.random.key_data(
        jax.random.fold_in(jax.random.PRNGKey(seed), data)))
    got = kr.fold_in(kr.prng_key(seed), data)
    assert got.dtype == np.uint32
    np.testing.assert_array_equal(got, want)


def test_mesh_helpers_without_a_process_group():
    mesh = rollout_mesh()
    assert mesh.shape == {"rollouts": 1} and mesh.index("rollouts") == 0
    assert not mesh.has_collectives
    grid = make_mesh((2, 2), ("ensemble", "rollouts"), ranks=[0, 1, 2, 3])
    assert grid.shape == {"ensemble": 2, "rollouts": 2}
    assert (grid.index("ensemble"), grid.index("rollouts")) == (0, 0)
    with pytest.raises(ValueError, match=r"mesh shape \(3,\) needs 3 "
                                         r"devices, have 2"):
        make_mesh((3,), ("rollouts",), ranks=[0, 1])
    with pytest.raises(ValueError, match="needs 4 devices, have 1"):
        make_mesh((2, 2), ("ensemble", "rollouts"))


def test_indivisible_configs_and_forced_collectives_are_refused():
    model = NeuralNetDynamics(0.02, device="cpu")
    cfg = MPPIConfig(num_rollouts=100, num_timesteps=T)
    four = make_mesh((4,), ("rollouts",), ranks=[0, 1, 2, 3])
    grid = make_mesh((3, 2), ("ensemble", "rollouts"),
                     ranks=list(range(6)))
    with pytest.raises(ValueError, match="not divisible by 3 shards"):
        ShardedMPPISolver(model, MPPICost(), cfg.replace(num_rollouts=100),
                          mesh=make_mesh((3,), ("rollouts",),
                                         ranks=[0, 1, 2]), device="cpu")
    with pytest.raises(ValueError, match=r"not divisible by 6 \(= 3 members "
                                         r"x 2 rollout shards\)"):
        EnsembleShardedMPPISolver(model, MPPICost(), cfg, grid, device="cpu")
    with pytest.raises(ValueError, match="initialised process group"):
        ShardedMPPISolver(model, MPPICost(), cfg, mesh=four,
                          force_collectives=True, device="cpu")
    # one rank without a process group runs inline
    one = ShardedMPPISolver(model, MPPICost(), cfg, device="cpu")
    assert one._inline_body and one._k_offset() == 0


def test_backend_rule_names_gloo_and_never_switches(monkeypatch):
    with pytest.raises(ValueError, match="CUDA tensors only"):
        launch.check_backend("nccl", "cpu", 1)
    with pytest.raises(ValueError, match="backend 'mpi'"):
        launch.check_backend("mpi", "cpu", 1)
    with pytest.raises(RuntimeError, match="no GPU"):
        launch.check_backend("gloo", "cuda", 2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    launch.check_backend("nccl", "cuda", 1)
    launch.check_backend("gloo", "cuda", 4)
    with pytest.raises(ValueError, match="NCCL refuses two ranks on one "
                                         "GPU.*backend='gloo'"):
        launch.check_backend("nccl", "cuda", 2)


def test_a_failing_rank_fails_the_run_with_its_traceback():
    with pytest.raises(RuntimeError, match=r"(?s)rank \d of 2 failed in "
                                           r"sharded_programs.*Traceback.*"
                                           r"not divisible by 2 shards"):
        _run(2, [_spec(cfg=dict(num_rollouts=255))])


# -- one shard -------------------------------------------------------------

@pytest.mark.parametrize("mode", ["host_noise", "capacity"])
def test_one_shard_inline_matches_collectives_bit_for_bit(one_rank, mode):
    (r,) = one_rank[mode]
    assert not r["inline"]
    ref = r["reference"]
    np.testing.assert_array_equal(r["U"], ref["U"])
    np.testing.assert_array_equal(ref["U"], r["single"]["U"])
    for f, v in r["stats"].items():
        assert v == ref["stats"][f] == r["single"]["stats"][f], f
    for f in ("U", "state_solution", "control_solution"):
        np.testing.assert_array_equal(r["solve"][f], ref["solve"][f])
    assert r["k_offset"] == 0 and r["K_local"] == K


# -- host noise over 2 and 4 ranks -------------------------------------------

@pytest.fixture(params=[2, 4], ids=["2ranks", "4ranks"])
def host_noise_run(request, two_ranks, four_ranks):
    n = request.param
    return n, {2: two_ranks, 4: four_ranks}[n]["host_noise"]


def test_host_noise_shards_match_the_single_process_iterate(host_noise_run):
    n, results = host_noise_run
    solver, params, cm, *_ = _pair(K=K, T=T)
    U_s, st_s = solver.iterate(params, CostParams(**CP), cm,
                               torch.tensor(STATE), torch.tensor(U0),
                               _shard_noise(solver, n))
    assert [r["k_offset"] for r in results] == [i * K // n for i in range(n)]
    r = results[0]
    np.testing.assert_allclose(r["U"], U_s.numpy(), rtol=SHARD_RTOL,
                               atol=SHARD_ATOL)
    np.testing.assert_allclose(r["stats"]["baseline"], st_s.baseline.item(),
                               rtol=BASELINE_RTOL)
    for f in ("normalizer", "ess", "trajectory_cost", "mean_cost",
              "crash_frac"):
        np.testing.assert_allclose(r["stats"][f], getattr(st_s, f).item(),
                                   rtol=STAT_RTOL, err_msg=f)


def test_host_noise_shards_match_the_jax_iterate(host_noise_run):
    n, results = host_noise_run
    solver, _, _, jsolver, jparams, jcm = _pair(K=K, T=T)
    eps = _shard_noise(solver, n).numpy()
    jU, jstats = jsolver.iterate(jparams, JaxCostParams(**CP), jcm,
                                 jnp.asarray(STATE), jnp.asarray(U0),
                                 jnp.asarray(eps))
    np.testing.assert_allclose(results[0]["U"], np.asarray(jU),
                               rtol=ITER_RTOL, atol=ITER_ATOL)
    for f in ("baseline", "normalizer", "ess", "mean_cost", "crash_frac"):
        np.testing.assert_allclose(results[0]["stats"][f],
                                   float(getattr(jstats, f)),
                                   rtol=ITER_RTOL, atol=ITER_ATOL, err_msg=f)


def test_host_noise_replicas_are_bit_for_bit_equal(host_noise_run):
    n, results = host_noise_run
    _assert_replicas_equal(results)
    assert all(np.isfinite(r["solve"]["U"]).all() for r in results)


# -- the capacity mode over 2 ranks ------------------------------------------

def test_capacity_shards_match_the_jax_sharded_rng_iterate(two_ranks):
    """Zero exploration noise: every control is U but the pure-noise band's
    (0 from rollout 0.99 K on, global numbering), whatever the stream."""
    results = two_ranks["quiet"]
    _, _, _, jsolver, jparams, jcm = _pair(K=K, T=T)
    js = JaxSharded(jsolver.model, jsolver.cost,
                    jsolver.cfg.replace(use_pallas_rollout=True, **QUIET),
                    mesh=jax_rollout_mesh(jax.devices()[:2]))
    js._pallas_interpret = pltpu.InterpretParams()
    assert js._use_kernel_rng(jcm)
    jU, jstats = js._sharded_rng_iterate(
        jparams, JaxCostParams(**CP), jcm, jnp.asarray(STATE),
        jnp.asarray(U0), jax.random.PRNGKey(3))
    _assert_replicas_equal(results)
    np.testing.assert_allclose(results[0]["U"], np.asarray(jU),
                               rtol=SHARD_RTOL, atol=SHARD_ATOL)
    for f in ("baseline", "normalizer", "ess", "mean_cost"):
        np.testing.assert_allclose(results[0]["stats"][f],
                                   float(getattr(jstats, f)),
                                   rtol=SHARD_RTOL, err_msg=f)
    # the band moved U: the sharded numerator counts it at its global place
    assert not np.allclose(results[0]["U"][1:], U0[1:])


@pytest.mark.parametrize("sampler", list(SAMPLERS))
def test_capacity_shards_match_jax_rollouts_on_the_stream(two_ranks,
                                                         sampler):
    """Each shard's passes against the JAX host-noise rollouts fed the
    port's stream at the shard's key and ``k_offset``, combined by the same
    MIN and sums in numpy."""
    results = two_ranks[sampler]
    _, _, _, jsolver, jparams, jcm = _pair(K=K, T=T, **SAMPLERS[sampler])
    cfg = MPPIConfig(num_rollouts=K, num_timesteps=T, **SAMPLERS[sampler])
    theta = rk.stream_theta(cfg)
    totals, numers = [], []
    for i, r in enumerate(results):
        key = torch.from_numpy(kr.fold_in(SUB, i).astype(np.int64))
        eps = kr.kernel_noise(key, r["k_offset"], r["K_local"], T, theta)
        total, u_seq, crash = jsolver.rollout_costs(
            jparams, JaxCostParams(**CP), jcm, jnp.asarray(STATE),
            jnp.asarray(U0), jnp.asarray(eps.numpy()),
            k_offset=r["k_offset"])
        np.testing.assert_allclose(r["shard"]["total"], np.asarray(total),
                                   rtol=2e-5, atol=1e-4)
        np.testing.assert_array_equal(r["shard"]["crash"], np.asarray(crash))
        totals.append(np.asarray(total, np.float64))
        numers.append(np.asarray(u_seq, np.float64))
    baseline = min(t.min() for t in totals)
    w = [np.exp(-cfg.gamma * (t - baseline)) for t in totals]
    eta = sum(x.sum() for x in w)
    spec = "k,tkc->tc" if numers[0].shape[0] == T else "k,ctk->tc"
    U_want = sum(np.einsum(spec, x, u) for x, u in zip(w, numers)) / eta
    np.testing.assert_allclose(results[0]["stats"]["baseline"], baseline,
                               rtol=BASELINE_RTOL)
    np.testing.assert_allclose(results[0]["U"], U_want, rtol=SHARD_RTOL,
                               atol=SHARD_ATOL)
    _assert_replicas_equal(results)


# -- the ensemble on a 2 x 2 mesh -------------------------------------------

def test_ensemble_shards_match_the_single_process_ensembles(four_ranks):
    Ke, M, R = 128, 2, 2
    base, model, stacked, jbase, jmodel, jstacked, _ = _ensemble(
        num_members=M)
    results = four_ranks["ensemble"]
    K_local = Ke // (M * R)
    assert [r["k_offset"] for r in results] == [0, 32, 64, 96]
    cfg = MPPIConfig(num_rollouts=Ke, num_timesteps=T)
    single = EnsembleMPPISolver(base, MPPICost(), cfg, num_members=M,
                                device="cpu")
    # the member-block noise in (e, r) order
    blocks = [single._sample_noise(single._noise_generator(
        kr.fold_in(kr.fold_in(SUB, e), r)), (T, K_local, 2))
        for e in range(M) for r in range(R)]
    eps = torch.cat(blocks, dim=1)
    _, _, cm, jpair, _, jcm = _pair(K=Ke, T=T)
    U_s, st_s = single.iterate(stacked, CostParams(**CP), cm,
                               torch.tensor(STATE), torch.tensor(U0), eps)
    _assert_replicas_equal(results)
    np.testing.assert_allclose(results[0]["U"], U_s.numpy(),
                               rtol=SHARD_RTOL, atol=SHARD_ATOL)
    np.testing.assert_allclose(results[0]["stats"]["baseline"],
                               st_s.baseline.item(), rtol=BASELINE_RTOL)
    jsolver = jmppi.MPPISolver(jmodel, jpair.cost, jpair.cfg)
    jU, jstats = jsolver.iterate(jstacked, JaxCostParams(**CP), jcm,
                                 jnp.asarray(STATE), jnp.asarray(U0),
                                 jnp.asarray(eps.numpy()))
    np.testing.assert_allclose(results[0]["U"], np.asarray(jU),
                               rtol=ITER_RTOL, atol=ITER_ATOL)
    np.testing.assert_allclose(results[0]["stats"]["ess"],
                               float(jstats.ess), rtol=STAT_RTOL)
