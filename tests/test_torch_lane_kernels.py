"""The lane forms of kernels 1 and 2 (``ops/rollout_kernel.py``: a
stacked ``CostParams`` in one launch) on the CPU, where their wrappers run
the plain versions: each lane against the JAX kernels vmapped over their
scalars in interpret mode (the batching rule that gives the JAX sweep's
``pallas_call`` its lane axis), at the tolerances of the kernel-1 and
kernel-2 parity tests (``tests/test_torch_rollout_kernel.py``); each lane
equal to the port's solo plain call exactly; the lane scalars' layout; the
lane launch's geometry, picked from L x K; and that what ROADMAP Queue 2
A7 once refused (other specs, fields and precisions, the capacity mode)
asks for the library of its solo twin.  The CUDA lane kernels run only on
a GPU: ``chip_smoke.py`` phases 33-35 hold them against these plain
versions and each lane bit for bit against the solo instance.  Circles
and the field in lanes: ``tests/test_torch_lane_circles.py``; the
capacity mode and the other libraries' lanes:
``tests/test_torch_lane_capacity.py``."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autorally_tpu.config import CostParams as JaxCostParams
from autorally_tpu.config import MPPIConfig as JaxConfig
from autorally_tpu.costs.costmap import make_costmap as jax_make_costmap
from autorally_tpu.models import NeuralNetDynamics as JaxNN
from autorally_tpu.ops import rollout_kernel as jrk
from autorally_tpu.tools.track_generator import oval_track
from autorally_tpu_torch.config import (CostParams, MPPIConfig,
                                        lane_cost_params)
from autorally_tpu_torch.costs import (MPPICost, ObstacleCost, make_costmap,
                                       make_obstacles)
from autorally_tpu_torch.costs.neural_costmap import NeuralCostmap
from autorally_tpu_torch.models import BasisFunctionDynamics, NeuralNetDynamics
from autorally_tpu_torch.ops import rollout_kernel as rk
from autorally_tpu_torch.runtime.episode import EpisodeRunner
from autorally_tpu_torch.solver.mppi import MPPISolver
from autorally_tpu_torch.tools.param_sweep import stack_cost_params

K, T, L = 256, 24, 3
# tests/test_torch_rollout_kernel.py's tolerances: costs over 23 running-
# average steps of fp32 with another summation order in the MLP, u_seq
# one multiply and one add, states 24 Euler steps of the same MLP.
COST_RTOL, COST_ATOL = 2e-5, 1e-4
USEQ_ATOL = 1e-6
STATE_RTOL, STATE_ATOL = 1e-5, 1e-5
GRID = [dict(desired_speed=4.0, speed_coeff=2.5),
        dict(desired_speed=6.0, track_coeff=150.0, discount=0.2),
        dict(desired_speed=8.0, crash_coeff=5000.0, boundary_threshold=0.05)]


class Lanes:
    """L lanes of start states, U and cost params on the ppm=2 oval (the
    third lane's boundary threshold so low that some of its rollouts
    crash), one eps of a wide swarm at 6 m/s, seeded weights carried with
    ``params_from_jax``."""

    def __init__(self, seed=0):
        rs = np.random.default_rng(seed)
        # a wide swarm, so that some of its rollouts leave the track
        wide = dict(steering_std=4 * 0.275, throttle_std=4 * 0.3)
        self.cfg = MPPIConfig(num_rollouts=K, num_timesteps=T, **wide)
        self.jcfg = JaxConfig(num_rollouts=K, num_timesteps=T, **wide)
        data, xb, yb = oval_track(ppm=2.0)
        self.cm = make_costmap(data, xb, yb, device="cpu")
        self.jcm = jax_make_costmap(data, xb, yb)
        self.jmodel = JaxNN(self.jcfg.dt,
                            control_ranges=self.jcfg.control_ranges)
        self.jparams = self.jmodel.init_params(jax.random.PRNGKey(seed))
        self.model = NeuralNetDynamics(self.cfg.dt,
                                       control_ranges=self.cfg.control_ranges,
                                       device="cpu")
        self.params = self.model.params_from_jax(
            jax.tree_util.tree_map(np.asarray, self.jparams))
        base = np.array([25.0, 0.0, np.pi / 2, 0.0, 6.0, 0.0, 0.0],
                        np.float32)
        self.state = (base + rs.normal(0, 0.3, (L, 7)).astype(np.float32)
                      * np.float32([1, 1, 0.1, 0, 1, 0, 0]))
        self.U = np.tile(np.float32([0.0, 0.3]), (L, T, 1))
        self.U[..., 0] = rs.uniform(-0.3, 0.3, (L, T))
        self.eps = rs.standard_normal((T, K, 2)).astype(np.float32)
        self.cp = stack_cost_params(CostParams(), GRID)
        self.jcp = JaxCostParams(**{
            f: jnp.asarray(getattr(self.cp, f).numpy())
            for f in ("desired_speed", "speed_coeff", "track_coeff",
                      "max_slip_ang", "slip_penalty", "track_slop",
                      "crash_coeff", "steering_coeff", "throttle_coeff",
                      "boundary_threshold", "discount")})

    def torch_args(self):
        return (torch.tensor(self.state), torch.tensor(self.U),
                torch.tensor(self.eps))


@pytest.fixture(scope="module")
def lanes():
    return Lanes()


def test_fused_exact_lanes_match_the_vmapped_jax_kernel(lanes):
    s = lanes
    costs, u_seq, crash = rk.fused_exact_rollout_cost_lanes(
        s.model, s.params, s.cfg, s.cp, s.cm, *s.torch_args())
    assert costs.shape == crash.shape == (L, K)
    assert u_seq.shape == (L, 2, T, K)
    eps = jnp.asarray(s.eps)
    jc, ju, jx = jax.vmap(
        lambda cp, st, U: jrk.fused_exact_rollout_cost_pallas(
            s.jmodel, s.jparams, s.jcfg, cp, s.jcm, st, U, eps,
            interpret=True))(s.jcp, jnp.asarray(s.state), jnp.asarray(s.U))
    for lane in range(L):
        np.testing.assert_allclose(costs[lane].numpy(), np.asarray(jc[lane]),
                                   rtol=COST_RTOL, atol=COST_ATOL)
        np.testing.assert_array_equal(crash[lane].numpy(),
                                      np.asarray(jx[lane]))
        np.testing.assert_allclose(u_seq[lane].numpy(), np.asarray(ju[lane]),
                                   rtol=0, atol=USEQ_ATOL)
    # the lanes' coefficients and starts reach their costs
    assert len({float(c.mean()) for c in costs}) == L
    assert 0 < int(crash.sum()) < crash.numel()


def test_dynamics_chain_lanes_match_the_vmapped_jax_kernel(lanes):
    s = lanes
    states, u_seq = rk.dynamics_chain_lanes(s.model, s.params, s.cfg,
                                            *s.torch_args())
    eps = jnp.asarray(s.eps)
    js, ju = jax.vmap(lambda st, U: jrk.dynamics_chain_pallas(
        s.jmodel, s.jparams, s.jcfg, st, U, eps, interpret=True))(
        jnp.asarray(s.state), jnp.asarray(s.U))
    js = np.asarray(js)[:, :s.model.STATE_DIM]       # drop the SPAD rows
    assert states.shape == js.shape == (L, 7, T, K)
    for lane in range(L):
        np.testing.assert_allclose(states[lane].numpy(), js[lane],
                                   rtol=STATE_RTOL, atol=STATE_ATOL)
        np.testing.assert_allclose(u_seq[lane].numpy(), np.asarray(ju[lane]),
                                   rtol=0, atol=USEQ_ATOL)


def test_nominal_trajectory_lanes_match_the_vmapped_jax_kernel(lanes):
    s = lanes
    state, U, _ = s.torch_args()
    ss, cs = rk.nominal_trajectory_lanes(s.model, s.params, s.cfg, state, U)
    jss, jcs = jax.vmap(lambda st, u: jrk.nominal_trajectory_pallas(
        s.jmodel, s.jparams, s.jcfg, st, u, interpret=True))(
        jnp.asarray(s.state), jnp.asarray(s.U))
    assert ss.shape == (L, T, 7) and cs.shape == (L, T, 2)
    np.testing.assert_allclose(ss.numpy(), np.asarray(jss), rtol=STATE_RTOL,
                               atol=STATE_ATOL)
    np.testing.assert_array_equal(cs.numpy(), np.asarray(jcs))


@pytest.mark.parametrize("kind", ["nn", "bf"])
def test_each_lane_is_the_solo_plain_call_exactly(lanes, kind):
    s = lanes
    model, params = s.model, s.params
    if kind == "bf":
        model = BasisFunctionDynamics(s.cfg.dt, device="cpu")
        params = model.init_params(0)
    state, U, eps = s.torch_args()
    out = rk.fused_exact_rollout_cost_lanes(model, params, s.cfg, s.cp,
                                            s.cm, state, U, eps, l1_cost=True,
                                            k_offset=64)
    chain = rk.dynamics_chain_lanes(model, params, s.cfg, state, U, eps)
    nominal = rk.nominal_trajectory_lanes(model, params, s.cfg, state, U)
    for lane, cp in enumerate(lane_cost_params(s.cp)):
        solo = rk.fused_exact_rollout_cost(model, params, s.cfg, cp, s.cm,
                                           state[lane], U[lane], eps,
                                           l1_cost=True, k_offset=64)
        for a, b in zip(out, solo):
            assert torch.equal(a[lane], b)
        for a, b in zip(chain, rk.dynamics_chain(model, params, s.cfg,
                                                 state[lane], U[lane], eps)):
            assert torch.equal(a[lane], b)
        for a, b in zip(nominal, rk.nominal_trajectory(
                model, params, s.cfg, state[lane], U[lane])):
            assert torch.equal(a[lane], b)


def test_lane_scalars_follow_the_kernel_layout(lanes):
    """Row l is lane l's host scalars of a solo launch, in
    ``_FLOAT_SCALARS`` order; the solver packs them once per set of
    values."""
    s = lanes
    packed = rk.lane_scalars(s.model, s.cfg, s.cp, s.cm, "cpu")
    assert packed.shape == (L, len(rk._FLOAT_SCALARS))
    assert packed.dtype == torch.float32
    for lane, cp in enumerate(lane_cost_params(s.cp)):
        floats, _ = rk.launch_scalars(s.model, s.cfg, 0, T, K, cp, s.cm)
        np.testing.assert_array_equal(packed[lane].numpy(),
                                      np.float32(floats))
        f = dict(zip(rk._FLOAT_SCALARS, packed[lane].tolist()))
        assert f["desired_speed"] == GRID[lane]["desired_speed"]
    solver = MPPISolver(s.model, MPPICost(), s.cfg, device="cpu")
    held = solver._lane_scalars(s.cp, s.cm)
    assert torch.equal(held, packed)
    assert solver._lane_scalars(s.cp, s.cm) is held
    other = stack_cost_params(CostParams(), GRID[:2])
    assert solver._lane_scalars(other, s.cm).shape == (2, packed.shape[1])
    assert solver._lane_scalars(s.cp, s.cm) is not held


def test_lane_launch_geometry_is_picked_from_all_lanes(monkeypatch):
    """One launch runs L x K rollouts: 3 lanes of K=512 take the lane
    groups one wave of L x K asks for (G=16), where one lane of K=512
    alone takes G=32; the grid is a lane's blocks.  Kernel 3 takes its
    blocks of FIELD_BLOCK whatever L x K is."""
    model = NeuralNetDynamics(0.02, device="cpu")
    bf = BasisFunctionDynamics(0.02, device="cpu")
    monkeypatch.setattr(rk, "num_sms", lambda index: 132)
    dev = torch.device("cuda", 0)
    geom = rk._lanes_geometry(1, 3, 512, dev, model)
    assert geom == rk.ExactGeometry(16, rk.GROUP_BLOCK, 512 // (128 // 16))
    assert rk.exact_geometry(512, 132).group == 32
    assert rk._lanes_geometry(1, 12, 1920, dev, model) == (
        rk.ExactGeometry(1, rk.EXACT_BLOCK, 1920 // 64))
    assert rk._lanes_geometry(1, 3, 2560, dev, bf).group == 1
    # the nominal trajectories: a warp a lane
    assert rk._lanes_geometry(2, 12, 1, dev, model) == (
        rk.ExactGeometry(32, rk.CHAIN_WARP_BLOCK, 1))
    # kernel 3: blocks of FIELD_BLOCK, K / FIELD_BLOCK of them a lane
    for L, K in ((3, 512), (4, 16384)):
        assert rk._lanes_geometry(3, L, K, dev, model) == (
            rk.ExactGeometry(1, rk.FIELD_BLOCK, K // rk.FIELD_BLOCK))


def test_lane_refusals_name_a7(lanes, monkeypatch):
    """What a stacked ``CostParams`` was refused until the lane forms came
    to every library (ROADMAP Queue 2 A7) now runs: kernels 1 and 2 of
    another MLP spec and at ``"default"``, kernel 3 on a field of another
    spec, and pass 1, each lane launch asking ``_build.load`` (which
    records what it is asked for and raises: nothing is built) for the
    library its solo twin asks for; and the solver's capacity mode with
    lanes solves on the exact map and on that field."""
    s = lanes
    asked = []

    def load(*a, **k):
        asked.append((a, k))
        raise LookupError("no build here")

    monkeypatch.setattr(rk._build, "load", load)
    monkeypatch.setattr(rk, "num_sms", lambda index: 132)
    rk._kernel_lib.cache_clear()
    state, U, eps = s.torch_args()
    key = torch.tensor([3, 5])

    def libraries(launch):
        asked.clear()
        with pytest.raises(LookupError):
            launch()
        return list(asked)

    wide = NeuralNetDynamics(0.02, layers=(6, 64, 4), device="cpu")
    cp0 = lane_cost_params(s.cp)[0]
    for model, cfg in ((wide, s.cfg),
                       (s.model, s.cfg.replace(matmul_precision="default"))):
        params = model.init_params(0)
        pairs = (
            (lambda: rk.prepare_fused_exact_rollout_cost_lanes(
                model, params, cfg, s.cp, s.cm, state, U, eps),
             lambda: rk.prepare_fused_exact_rollout_cost(
                 model, params, cfg, cp0, s.cm, state[0], U[0], eps)),
            (lambda: rk.prepare_dynamics_chain_lanes(model, params, cfg,
                                                     state, U, eps),
             lambda: rk.prepare_dynamics_chain(model, params, cfg, state[0],
                                               U[0], eps)),
            (lambda: rk.prepare_fused_rng_costs_lanes(
                model, params, cfg, s.cp, s.cm, state, U, key),
             lambda: rk.prepare_fused_rng_costs(
                 model, params, cfg, cp0, s.cm, state[0], U[0], key)))
        for lane_launch, solo_launch in pairs:
            want = libraries(solo_launch)
            assert want and libraries(lane_launch) == want
            # not the default float32 library's
            assert want[0] != ((rk.KERNEL_LAYERS,), {})
    # kernel 3 and pass 1 on a field of another spec than 34-64-64-1
    field = NeuralCostmap.build(
        [np.zeros((34, 8), np.float32), np.zeros((8, 1), np.float32)],
        [np.zeros(8, np.float32), np.zeros(1, np.float32)],
        np.arange(1, 9, dtype=np.float32), s.cm.r_c1, s.cm.r_c2, s.cm.trs,
        device="cpu")
    want = libraries(lambda: rk.prepare_fused_rollout_cost(
        s.model, s.params, s.cfg, cp0, field, state[0], U[0], eps))
    assert want == [((rk.KERNEL_LAYERS, (8, 8)), {})]
    assert libraries(lambda: rk.prepare_fused_rollout_cost_lanes(
        s.model, s.params, s.cfg, s.cp, field, state, U, eps)) == want
    assert libraries(lambda: rk.prepare_fused_rng_costs_lanes(
        s.model, s.params, s.cfg, s.cp, field, state, U, key)) == want

    # the solver's capacity mode with lanes, on the CPU's plain versions
    asked.clear()
    cfg = MPPIConfig(num_rollouts=64, num_timesteps=8)
    capacity = MPPISolver(s.model, MPPICost(),
                          cfg.replace(kernel_rng=True), device="cpu")
    cs = capacity.init_state(0)
    lanes_cs = cs._replace(**{n: getattr(cs, n).expand(L, *getattr(
        cs, n).shape).clone() for n in ("U", "control_hist",
                                        "state_solution",
                                        "control_solution")})
    for surface in (s.cm, field):
        out, stats = capacity.solve(s.params, s.cp, surface, state, lanes_cs)
        assert out.U.shape == (L, 8, 2) and stats.ess.shape == (L,)
        assert torch.isfinite(out.U).all()
    assert not asked
    rk._kernel_lib.cache_clear()


def test_general_path_and_gains_lanes_are_the_solo_ones():
    """A cost subclass (the general path: kernel 2's lane form, then the
    epilogue a lane) prices each lane exactly as its solo call; an episode
    with DDP gains (the DDP run a lane) gives each lane its solo episode,
    within 1e-5 (the CPU plant's batched MLP sums in another order)."""
    class Subclass(MPPICost):
        pass

    cfg = MPPIConfig(num_rollouts=64, num_timesteps=8)
    model = NeuralNetDynamics(cfg.dt, device="cpu")
    params = model.init_params(0)
    data, xb, yb = oval_track(ppm=2.0)
    cm = make_costmap(data, xb, yb, device="cpu")
    rs = np.random.default_rng(3)
    state = torch.tensor(np.float32([25.0, 0.0, np.pi / 2, 0, 3, 0, 0])
                         + rs.normal(0, 0.2, (L, 7)).astype(np.float32))
    U = torch.tensor(rs.uniform(-0.3, 0.3, (L, 8, 2)).astype(np.float32))
    eps = torch.tensor(rs.standard_normal((8, 64, 2)).astype(np.float32))
    cp = stack_cost_params(CostParams(), GRID)
    solver = MPPISolver(model, Subclass(), cfg, device="cpu")
    assert not solver._fusable_cost()
    out = solver.rollout_costs_lanes(params, cp, cm, state, U, eps)
    for lane, cp_l in enumerate(lane_cost_params(cp)):
        solo = solver.rollout_costs(params, cp_l, cm, state[lane], U[lane],
                                    eps)
        for a, b in zip(out, solo):
            assert torch.equal(a[lane], b)
    runner = EpisodeRunner(MPPISolver(model, MPPICost(), cfg, device="cpu"),
                           n_ticks=3, use_feedback_gains=True)
    start = np.array([25.0, 0.0, math.pi / 2, 0, 2, 0, 0], np.float32)
    res = runner.run(params, cp, cm, start)
    assert res.states.shape == (L, 3, 7)
    for lane, cp_l in enumerate(lane_cost_params(cp)):
        solo = runner.run(params, cp_l, cm, start)
        for f in res._fields:
            torch.testing.assert_close(getattr(res, f)[lane],
                                       getattr(solo, f), rtol=1e-5,
                                       atol=1e-5, msg=f)
