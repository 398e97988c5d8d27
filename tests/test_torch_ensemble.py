"""The port's model ensembles on the CPU, against the JAX package (the
counterparts of ``tests/test_ensemble.py``, on seeded weights):
``EnsembleDynamics``'s member blocks, ``member_params`` / ``stack_params``
and the stacked ``params_from_jax``, the ensemble through ``MPPISolver``
(the plain chain) and through ``EnsembleMPPISolver`` (the base model's
kernels a member: their plain versions here), the global numbering of the
noise-free and pure-noise rollouts across members, M identical members
against ``MPPISolver``, the refusals, and the members' one weight pack.

The base is the seeded MLP (``init_params`` of the JAX package, carried
with ``params_from_jax``); member m > 0 adds ``noise`` N(0, 1) from
``RandomState(0)``, as ``tests/test_ensemble.py`` builds members from the
reference weights.  K=128, T=16, M=4 on the ppm=2 oval."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autorally_tpu.config import CostParams as JaxCostParams
from autorally_tpu.config import MPPIConfig as JaxConfig
from autorally_tpu.costs import MPPICost as JaxCost
from autorally_tpu.costs.costmap import make_costmap as jax_make_costmap
from autorally_tpu.models import EnsembleDynamics as JaxEnsemble
from autorally_tpu.models import NeuralNetDynamics as JaxNN
from autorally_tpu.models.ensemble import stack_params as jax_stack_params
from autorally_tpu.solver import EnsembleMPPISolver as JaxEnsembleSolver
from autorally_tpu.solver import mppi as jmppi
from autorally_tpu.tools.track_generator import oval_track
from autorally_tpu_torch.config import CostParams, MPPIConfig
from autorally_tpu_torch.costs import MPPICost, make_costmap
from autorally_tpu_torch.models import EnsembleDynamics, NeuralNetDynamics
from autorally_tpu_torch.models.ensemble import member_params, stack_params
from autorally_tpu_torch.ops import rollout_kernel as rk
from autorally_tpu_torch.solver import EnsembleMPPISolver, MPPISolver
from tests.test_torch_solver import _assert_stats

K, T, M = 128, 16, 4
START = np.array([0.0, -15.0, 0.0, 0.0, 2.0, 0.0, 0.0], np.float32)
COST_RTOL, COST_ATOL = 2e-5, 1e-4
USEQ_ATOL = 1e-6
STATE_ATOL = 1e-5
ITER_RTOL, ITER_ATOL = 1e-5, 1e-6
DT = 0.02
RANGES = ((-0.99, 0.99), (-0.99, 0.65))


def _members(noise=0.05, num_members=M, seed=0):
    """(JAX stacked params, the members as numpy trees) from the seeded
    base."""
    jbase = JaxNN(DT, control_ranges=RANGES)
    p0 = jax.tree_util.tree_map(np.asarray,
                                jbase.init_params(jax.random.PRNGKey(seed)))
    rng = np.random.RandomState(0)
    members = []
    for m in range(num_members):
        scale = 0.0 if m == 0 else noise
        members.append({
            "weights": [W + scale * rng.randn(*W.shape).astype(np.float32)
                        for W in p0["weights"]],
            "biases": [b + scale * rng.randn(*b.shape).astype(np.float32)
                       for b in p0["biases"]],
            "control_rngs": p0["control_rngs"]})
    jstacked = jax_stack_params([jax.tree_util.tree_map(jnp.asarray, mp)
                                 for mp in members])
    return jstacked, members


def _ensemble(noise=0.05, num_members=M):
    """(port base, port EnsembleDynamics, stacked params, JAX base, JAX
    EnsembleDynamics, JAX stacked params, member 0's numpy params)."""
    jstacked, members = _members(noise, num_members)
    base = NeuralNetDynamics(DT, control_ranges=RANGES, device="cpu")
    model = EnsembleDynamics(base, num_members)
    stacked = model.params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                           jstacked))
    jbase = JaxNN(DT, control_ranges=RANGES)
    return (base, model, stacked, jbase, JaxEnsemble(jbase, num_members),
            jstacked, members[0])


def _costmaps():
    data, xb, yb = oval_track(ppm=2.0)
    return (make_costmap(data, xb, yb, device="cpu"),
            jax_make_costmap(data, xb, yb))


def _eps(seed=3, k=K, t=T):
    return np.random.default_rng(seed).standard_normal((t, k, 2)).astype(
        np.float32)


def test_ensemble_dynamics_blocks():
    base, model, stacked, _, jmodel, jstacked, m0 = _ensemble()
    k = 64
    states = np.tile(START, (k, 1))
    controls = np.tile(np.array([0.1, 0.3], np.float32), (k, 1))
    out = model.dynamics(stacked, torch.tensor(states), torch.tensor(controls))
    jout = jmodel.dynamics(jstacked, jnp.asarray(states),
                           jnp.asarray(controls))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-5,
                               atol=1e-6)
    # member 0 (rollouts 0..15) is the unperturbed base model
    p0 = base.params_from_jax(m0)
    ref = base.dynamics(p0, torch.tensor(states[:16]),
                        torch.tensor(controls[:16]))
    torch.testing.assert_close(out[:16], ref, rtol=1e-5, atol=1e-6)
    assert not torch.allclose(out[16:32], ref)
    # a single state: member 0; control ranges: member 0's
    one = model.dynamics(stacked, torch.tensor(START),
                         torch.tensor([0.1, 0.3]))
    torch.testing.assert_close(one, ref[0])
    wide = torch.tensor([[2.0, -2.0]])
    torch.testing.assert_close(model.enforce_constraints(stacked, wide),
                               torch.tensor([[0.99, -0.99]]))


def test_member_params_roundtrip_and_views():
    base, model, stacked, *_, m0 = _ensemble()
    first = member_params(stacked, 0)
    np.testing.assert_array_equal(first["weights"][0].numpy(),
                                  m0["weights"][0])
    # views into the stacked tensors, not copies
    assert first["weights"][0].data_ptr() == stacked["weights"][0].data_ptr()
    last = member_params(stacked, M - 1)
    assert (last["biases"][1].data_ptr()
            == stacked["biases"][1][M - 1].data_ptr())
    again = stack_params([member_params(stacked, m) for m in range(M)])
    for a, b in zip(again["weights"] + again["biases"],
                    stacked["weights"] + stacked["biases"]):
        assert torch.equal(a, b)


def test_stacked_params_from_jax_and_init_params():
    """``params_from_jax`` takes the JAX stacked tree as it is (leading
    axis M on every array) and holds it; ``init_params`` gives M distinct
    members and leaves the base model's held weights as they were."""
    base, model, stacked, *_ = _ensemble()
    jstacked, _ = _members()
    for a, j in zip(stacked["weights"] + stacked["biases"]
                    + [stacked["control_rngs"]],
                    jstacked["weights"] + jstacked["biases"]
                    + [jstacked["control_rngs"]]):
        assert a.shape[0] == M and a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), np.asarray(j))
    assert model.params() is stacked
    held = base.init_params(7)
    fresh = model.init_params(1)
    assert model.params() is fresh
    assert fresh["weights"][0].shape == (M, 6, 32)
    assert not torch.equal(fresh["weights"][0][0], fresh["weights"][0][1])
    assert base.params()["weights"][0] is held["weights"][0]
    assert torch.equal(model.init_params(1)["weights"][2], fresh["weights"][2])


def test_ensemble_solve_runs_and_matches_jax():
    """``MPPISolver`` over ``EnsembleDynamics``: the plain chain (no kernel
    form), one solve with the same noise as the JAX solver's."""
    _, model, stacked, _, jmodel, jstacked, _ = _ensemble()
    cfg = MPPIConfig(num_rollouts=K, num_timesteps=T)
    cm, jcm = _costmaps()
    solver = MPPISolver(model, MPPICost(), cfg, device="cpu")
    jsolver = jmppi.MPPISolver(jmodel, JaxCost(), JaxConfig(
        num_rollouts=K, num_timesteps=T))
    assert not solver.kernel_form and not jsolver.use_pallas_rollout
    eps = _eps(5)
    solver._sample_noise = lambda gen, shape: torch.tensor(eps)
    jsolver._sample_noise = lambda key, shape: jnp.asarray(eps)
    cs, stats = solver.solve(stacked, CostParams(), cm, START,
                             solver.init_state())
    jcs, jstats = jsolver.solve(jstacked, JaxCostParams(), jcm, START,
                                jsolver.init_state())
    assert torch.isfinite(cs.U).all() and float(stats.ess) > 1.0
    for name in ("U", "control_solution", "state_solution"):
        np.testing.assert_allclose(getattr(cs, name).numpy(),
                                   np.asarray(getattr(jcs, name)),
                                   rtol=ITER_RTOL, atol=STATE_ATOL,
                                   err_msg=name)
    _assert_stats(stats, jstats, ITER_RTOL, ITER_ATOL)


def test_ensemble_spread_lowers_ess():
    """Model disagreement spreads the rollout costs: a lower effective
    sample size than the single model's with the same noise, in both
    packages alike."""
    cfg = MPPIConfig(num_rollouts=K, num_timesteps=24)
    jcfg = JaxConfig(num_rollouts=K, num_timesteps=24)
    cm, jcm = _costmaps()
    eps = _eps(5, t=24)
    base, model, stacked, jbase, jmodel, jstacked, m0 = _ensemble(noise=0.3)
    p0 = NeuralNetDynamics(DT, control_ranges=RANGES,
                           device="cpu").params_from_jax(m0)
    U0 = torch.zeros((24, 2))
    ess = {}
    for name, mdl, params, jmdl, jparams in (
            ("ensemble", model, stacked, jmodel, jstacked),
            ("single", base, p0, jbase, jax.tree_util.tree_map(jnp.asarray,
                                                               m0))):
        _, stats = MPPISolver(mdl, MPPICost(), cfg, device="cpu").iterate(
            params, CostParams(), cm, torch.tensor(START), U0,
            torch.tensor(eps))
        _, jstats = jmppi.MPPISolver(jmdl, JaxCost(), jcfg).iterate(
            jparams, JaxCostParams(), jcm, jnp.asarray(START),
            jnp.zeros((24, 2)), jnp.asarray(eps))
        _assert_stats(stats, jstats, 1e-4, 1e-5)
        ess[name] = float(stats.ess)
    assert ess["ensemble"] < ess["single"]


def test_ensemble_solver_matches_ensemble_dynamics():
    """``EnsembleMPPISolver``'s member blocks (kernel A's plain version a
    member) reproduce the ``EnsembleDynamics`` plain chain with the same
    global noise, and the JAX ``EnsembleMPPISolver``: the launcher-level
    split is a pure re-batching."""
    base, model, stacked, jbase, jmodel, jstacked, _ = _ensemble(noise=0.2)
    cfg = MPPIConfig(num_rollouts=K, num_timesteps=T)
    cm, jcm = _costmaps()
    eps = torch.tensor(_eps(3))
    ref = MPPISolver(model, MPPICost(), cfg, device="cpu")
    fused = EnsembleMPPISolver(base, MPPICost(), cfg, num_members=M,
                               device="cpu")
    jfused = JaxEnsembleSolver(jbase, JaxCost(), JaxConfig(
        num_rollouts=K, num_timesteps=T), num_members=M)
    U0 = ref.init_state().U
    st = torch.tensor(START)
    t_ref, u_ref, c_ref = ref.rollout_costs(stacked, CostParams(), cm, st,
                                            U0, eps)
    t_f, u_f, c_f = fused.rollout_costs(stacked, CostParams(), cm, st, U0,
                                        eps)
    jt, ju, jc = jfused.rollout_costs(jstacked, JaxCostParams(), jcm,
                                      jnp.asarray(START), jnp.asarray(U0),
                                      jnp.asarray(eps.numpy()))
    for t, c in ((t_ref, c_ref), (np.asarray(jt), np.asarray(jc))):
        np.testing.assert_allclose(t_f.numpy(), np.asarray(t),
                                   rtol=COST_RTOL, atol=COST_ATOL)
        np.testing.assert_array_equal(c_f.numpy(), np.asarray(c))
    assert torch.equal(u_f, u_ref)
    np.testing.assert_allclose(u_f.numpy(), np.asarray(ju).transpose(2, 0, 1),
                               rtol=0, atol=USEQ_ATOL)
    U_ref, st_ref = ref.iterate(stacked, CostParams(), cm, st, U0, eps)
    U_f, st_f = fused.iterate(stacked, CostParams(), cm, st, U0, eps)
    torch.testing.assert_close(U_f, U_ref, rtol=ITER_RTOL, atol=ITER_ATOL)
    np.testing.assert_allclose(float(st_f.ess), float(st_ref.ess),
                               rtol=ITER_RTOL)


def test_ensemble_solver_full_solve_and_nominal():
    """A full solve runs; the nominal trajectory is member 0's."""
    base, _, stacked, jbase, _, jstacked, m0 = _ensemble(noise=0.2)
    cfg = MPPIConfig(num_rollouts=K, num_timesteps=T)
    cm, jcm = _costmaps()
    solver = EnsembleMPPISolver(base, MPPICost(), cfg, num_members=M,
                                device="cpu")
    jsolver = JaxEnsembleSolver(jbase, JaxCost(), JaxConfig(
        num_rollouts=K, num_timesteps=T), num_members=M)
    eps = _eps(6)
    solver._sample_noise = lambda gen, shape: torch.tensor(eps)
    jsolver._sample_noise = lambda key, shape: jnp.asarray(eps)
    cs, stats = solver.solve(stacked, CostParams(), cm, START,
                             solver.init_state())
    jcs, jstats = jsolver.solve(jstacked, JaxCostParams(), jcm, START,
                                jsolver.init_state())
    assert torch.isfinite(cs.U).all() and float(stats.ess) > 1.0
    for name in ("U", "control_solution", "state_solution"):
        np.testing.assert_allclose(getattr(cs, name).numpy(),
                                   np.asarray(getattr(jcs, name)),
                                   rtol=ITER_RTOL, atol=STATE_ATOL,
                                   err_msg=name)
    _assert_stats(stats, jstats, ITER_RTOL, ITER_ATOL)
    single = MPPISolver(base, MPPICost(), cfg, device="cpu")
    p0 = NeuralNetDynamics(DT, control_ranges=RANGES,
                           device="cpu").params_from_jax(m0)
    s_ref, c_ref = single.nominal_trajectory(p0, torch.tensor(START), cs.U)
    s_e, c_e = solver.nominal_trajectory(stacked, torch.tensor(START), cs.U)
    assert torch.equal(s_e, s_ref) and torch.equal(c_e, c_ref)


def test_ensemble_solver_rejects_indivisible():
    base = NeuralNetDynamics(DT, device="cpu")
    with pytest.raises(ValueError, match="not divisible"):
        EnsembleMPPISolver(base, MPPICost(),
                           MPPIConfig(num_rollouts=100, num_timesteps=8),
                           num_members=8, device="cpu")
    model = EnsembleDynamics(base, 8)
    stacked = model.init_params(0)
    with pytest.raises(ValueError, match="not divisible"):
        model.dynamics(stacked, torch.zeros((12, 7)), torch.zeros((12, 2)))
    solver = EnsembleMPPISolver(base, MPPICost(), MPPIConfig(
        num_rollouts=64, num_timesteps=8), num_members=8, device="cpu")
    with pytest.raises(NotImplementedError, match="downgrade"):
        solver.with_rollouts(128)
    assert solver.with_rollouts(64) is solver
    assert not solver._use_kernel_rng(_costmaps()[0])
    assert not EnsembleMPPISolver(base, MPPICost(), MPPIConfig(
        num_rollouts=64, num_timesteps=8, kernel_rng=True), num_members=8,
        device="cpu")._use_kernel_rng(_costmaps()[0])


def test_pure_noise_band_sits_in_the_last_member():
    """Each member call takes the global k_offset: rollout 0 (member 0's
    first) is noise-free, the last 1 % of the global K are pure noise (all
    in the last member), and u_seq is the single model's at the global
    K."""
    base, _, stacked, *_, m0 = _ensemble(noise=0.2)
    k = 512
    cfg = MPPIConfig(num_rollouts=k, num_timesteps=T, init_throttle=0.4)
    cm = _costmaps()[0]
    solver = EnsembleMPPISolver(base, MPPICost(), cfg, num_members=M,
                                device="cpu")
    U = solver.init_state().U
    eps = torch.tensor(_eps(7, k=k))
    _, u_seq, _ = solver.rollout_costs(stacked, CostParams(), cm,
                                       torch.tensor(START), U, eps)
    du = (eps * solver.nu).permute(2, 0, 1)                  # (C, T, K)
    first_pure = int(np.ceil(cfg.pure_noise_frac * k))       # 507
    assert first_pure > (M - 1) * k // M
    t = slice(cfg.optimization_stride, None)
    assert torch.equal(u_seq[:, :, 0], U.T)
    assert torch.equal(u_seq[:, t, first_pure:], du[:, t, first_pure:])
    assert torch.equal(u_seq[:, t, 1:first_pure],
                       U.T[:, t, None] + du[:, t, 1:first_pure])
    p0 = NeuralNetDynamics(DT, control_ranges=RANGES,
                           device="cpu").params_from_jax(m0)
    single = MPPISolver(base, MPPICost(), cfg, device="cpu")
    assert torch.equal(u_seq, single.rollout_costs(
        p0, CostParams(), cm, torch.tensor(START), U, eps)[1])


def test_identical_members_equal_mppi_solver():
    """M copies of one model: the ensemble solver gives ``MPPISolver``'s
    solve (on the card bit for bit, ``chip_smoke.py`` phase 25)."""
    base, *_, m0 = _ensemble()
    p0 = base.params_from_jax(m0)
    stacked = stack_params([p0] * M)
    cfg = MPPIConfig(num_rollouts=K, num_timesteps=T)
    cm = _costmaps()[0]
    ens = EnsembleMPPISolver(base, MPPICost(), cfg, num_members=M,
                             device="cpu")
    single = MPPISolver(base, MPPICost(), cfg, device="cpu")
    cs, stats = ens.solve(stacked, CostParams(), cm, START, ens.init_state())
    cs1, stats1 = single.solve(p0, CostParams(), cm, START,
                               single.init_state())
    for name in ("U", "control_solution", "state_solution"):
        torch.testing.assert_close(getattr(cs, name), getattr(cs1, name),
                                   rtol=ITER_RTOL, atol=ITER_ATOL)
    np.testing.assert_array_equal(cs.key, cs1.key)
    for name in stats._fields:
        torch.testing.assert_close(getattr(stats, name),
                                   getattr(stats1, name), rtol=ITER_RTOL,
                                   atol=ITER_ATOL)


def test_one_weight_pack_a_solve(monkeypatch):
    """The members' launches share one pack, (M, 1,412), kept on the
    ensemble model: a solve packs at most once, the next solve on the same
    stacked params not at all, new params once more; member m's row is its
    own weight buffer, and the kernels' inputs take it as it is."""
    base, model, stacked, *_ = _ensemble(noise=0.2)
    cfg = MPPIConfig(num_rollouts=K, num_timesteps=T)
    cm = _costmaps()[0]
    solver = EnsembleMPPISolver(base, MPPICost(), cfg, num_members=M,
                                device="cpu")
    packs = []
    cached = rk._cached_pack

    def counting(owner, src, pack):
        def counted():
            packs.append(owner)
            return pack()
        return cached(owner, src, counted)

    monkeypatch.setattr(rk, "_cached_pack", counting)
    cs = solver.init_state()
    for _ in range(2):
        cs, _ = solver.solve(stacked, CostParams(), cm, START, cs)
    assert packs == [solver.model]
    packed = rk.pack_members(base, stacked, owner=solver.model)
    assert packed.shape == (M, rk.KERNEL_NUM_WEIGHTS) and len(packs) == 1
    for m in range(M):
        torch.testing.assert_close(
            packed[m], rk._flat_weights(base, member_params(stacked, m)),
            rtol=0, atol=0)
    row = packed[2]
    args = rk._kernel_inputs(base, member_params(stacked, 2),
                             torch.tensor(START), torch.zeros((T, 2)), K,
                             packed_weights=row)
    assert args["weights"] is row and row.is_contiguous()
    other = stack_params([member_params(stacked, m) for m in range(M)])
    solver.solve(other, CostParams(), cm, START, cs)
    assert len(packs) == 2


def test_episode_captures_the_stacked_weights(monkeypatch):
    """``EpisodeRunner`` over ``EnsembleMPPISolver`` through the episode
    tests' stand-in graph: a replayed run equals the eager run bit for bit,
    the same stacked params replay the graph, other stacked params or an
    in-place change of them capture anew, and the capture keeps the
    members' pack (the kernels read it by address)."""
    from autorally_tpu_torch.runtime.episode import EpisodeRunner
    from tests.test_torch_episode import (FLAT_MAP, START as EP_START,
                                          _Context, _FakeGraph, _FakeStream)

    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "Stream", _FakeStream)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a: _FakeStream())
    monkeypatch.setattr(torch.cuda, "stream", lambda s: _Context())
    monkeypatch.setattr(torch.cuda, "graph", lambda g: _Context(g))
    monkeypatch.setattr(EpisodeRunner, "captures",
                        property(lambda self: True))
    base, _, stacked, *_ = _ensemble(noise=0.2)
    cfg = MPPIConfig(num_rollouts=64, num_timesteps=8)
    solver = EnsembleMPPISolver(base, MPPICost(), cfg, num_members=M,
                                device="cpu")
    runner = EpisodeRunner(solver, true_model=base, n_ticks=4)
    tick = runner._tick

    def recorded(*args):
        if _FakeGraph.capturing is not None:
            _FakeGraph.capturing.call = (tick, args)
        tick(*args)

    runner._tick = recorded
    captures = []
    capture = runner._capture
    runner._capture = lambda *a: (captures.append(1), capture(*a))
    cm = make_costmap(*FLAT_MAP, device="cpu")
    p_true = member_params(stacked, 0)

    def held(params):
        n = len(captures)
        got = runner.run(params, CostParams(), cm, EP_START,
                         params_true=p_true)
        want = runner.run(params, CostParams(), cm, EP_START,
                          params_true=p_true, eager=True)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        return got, len(captures) - n

    first, n = held(stacked)
    assert n == 1 and torch.isfinite(first.states).all()
    assert any(k is solver.model._kernel_pack
               for k in runner._captured.keep)
    assert held(stacked)[1] == 0
    other = stack_params([member_params(stacked, m) for m in range(M)])
    assert held(other)[1] == 1
    other["weights"][0].mul_(1.1)                         # in place
    assert held(other)[1] == 1
