"""The port's rollout kernels (their plain PyTorch versions, which the
wrappers run for CPU tensors) against the JAX package: the fused exact
Pallas kernel in interpret mode and the scan path of ``rollout_costs``,
the dynamics-chain and nominal-trajectory Pallas kernels in interpret mode.
Same seeded weights (carried with ``params_from_jax``), same numpy noise,
K=256, T=24 on the ppm=2 oval, as ``tests/test_exact_fused.py`` sizes it,
and on a fine random map where crashes differ between rollouts.
The CUDA kernels themselves run only on a GPU: ``chip_smoke.py`` holds them
against these plain versions there."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autorally_tpu.config import CostParams as JaxCostParams
from autorally_tpu.config import MPPIConfig as JaxConfig
from autorally_tpu.costs import MPPICost as JaxCost
from autorally_tpu.costs.costmap import make_costmap as jax_make_costmap
from autorally_tpu.models import NeuralNetDynamics as JaxNN
from autorally_tpu.ops import rollout_kernel as jrk
from autorally_tpu.solver.mppi import MPPISolver as JaxSolver
from autorally_tpu.tools.track_generator import oval_track
from autorally_tpu_torch.config import CostParams, MPPIConfig
from autorally_tpu_torch.costs import MPPICost, make_costmap
from autorally_tpu_torch.models import Dynamics, NeuralNetDynamics
from autorally_tpu_torch.ops import rollout_kernel as rk

K, T = 256, 24
# Costs: 23 running-average steps of fp32 with another summation order in
# the MLP (test_exact_fused.py's tolerance between the scan and the kernel).
COST_RTOL, COST_ATOL = 2e-5, 1e-4
USEQ_ATOL = 1e-6                    # perturb is one multiply and one add
STATE_RTOL, STATE_ATOL = 1e-5, 1e-5  # 24 Euler steps of the same MLP
START = (25.0, 0.0, np.pi / 2, 0.0, 3.0, 0.0, 0.0)

# name -> (MPPIConfig overrides, start-state overrides, map kind, extras)
CASES = {
    "nominal": ({}, {}, "oval", {}),
    "wide_noise": (dict(steering_std=4 * 0.275, throttle_std=4 * 0.3), {},
                   "oval", {}),
    "nan_x": ({}, {0: np.nan}, "oval", {}),
    # a fine random map (2 cm texels, values in [0, 0.67)): crashes differ
    # between rollouts, and any texel off by one changes a cost
    "random_map_l1_stride2": (dict(optimization_stride=2,
                                   steering_std=4 * 0.275,
                                   throttle_std=4 * 0.3), {4: 6.0},
                              "random", dict(l1_cost=True)),
    # the second half of a sharded batch: no noise-free rollout, and the
    # pure-noise threshold moves by k_offset
    "k_offset": ({}, {}, "oval", dict(k_offset=128)),
}


@dataclasses.dataclass
class Setup:
    cfg: MPPIConfig
    jcfg: JaxConfig
    model: NeuralNetDynamics
    params: dict
    jmodel: JaxNN
    jparams: dict
    costmap: object
    jcostmap: object
    state: np.ndarray
    U: np.ndarray
    eps: np.ndarray
    l1_cost: bool = False
    k_offset: int = 0

    def torch_args(self):
        return (torch.tensor(self.state), torch.tensor(self.U),
                torch.tensor(self.eps))

    def jax_args(self):
        return (jnp.asarray(self.state), jnp.asarray(self.U),
                jnp.asarray(self.eps))


def random_map(rs, ppm=50.0, hi=0.67):
    """A 10 m x 10 m map around the start with channel 0 uniform in
    [0, hi), cleared within 0.7 m of y = 0 so that no rollout crashes on
    its first, shared, steps (the boundary threshold is 0.65)."""
    xb, yb = (20.0, 30.0), (-5.0, 5.0)
    n = int(10 * ppm)
    data = np.zeros((n, n, 4), np.float32)
    data[..., 0] = rs.uniform(0, hi, (n, n)).astype(np.float32)
    ys = yb[0] + (np.arange(n) + 0.5) / ppm
    data[np.abs(ys) < 0.7, :, 0] = 0.0
    return data, xb, yb


def make_setup(case="nominal", seed=0) -> Setup:
    cfg_kw, state_kw, map_kind, extra = CASES[case]
    jcfg = JaxConfig(num_rollouts=K, num_timesteps=T, **cfg_kw)
    cfg = MPPIConfig(num_rollouts=K, num_timesteps=T, **cfg_kw)
    rs = np.random.default_rng(seed)
    if map_kind == "random":
        data, xb, yb = random_map(rs)
    else:
        data, xb, yb = oval_track(ppm=2.0)
    jmodel = JaxNN(jcfg.dt, control_ranges=jcfg.control_ranges)
    jparams = jmodel.init_params(jax.random.PRNGKey(seed))
    model = NeuralNetDynamics(cfg.dt, control_ranges=cfg.control_ranges,
                              device="cpu")
    params = model.params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                          jparams))
    state = np.array(START, np.float32)
    for i, v in state_kw.items():
        state[i] = v
    k_off = extra.get("k_offset", 0)
    eps = rs.standard_normal((T, K - k_off, 2)).astype(np.float32)
    U = np.tile(np.array([0.0, 0.3], np.float32), (T, 1))
    U[:, 0] = rs.uniform(-0.3, 0.3, T).astype(np.float32)
    return Setup(cfg, jcfg, model, params, jmodel, jparams,
                 make_costmap(data, xb, yb, device="cpu"),
                 jax_make_costmap(data, xb, yb), state, U, eps,
                 extra.get("l1_cost", False), k_off)


def _port_fused(s: Setup):
    return rk.fused_exact_rollout_cost(
        s.model, s.params, s.cfg, CostParams(), s.costmap, *s.torch_args(),
        l1_cost=s.l1_cost, k_offset=s.k_offset)


@pytest.mark.parametrize("case", list(CASES))
def test_fused_exact_plain_matches_jax_kernel(case):
    """Against ``fused_exact_rollout_cost_pallas`` in interpret mode."""
    s = make_setup(case)
    costs, u_seq, crash = _port_fused(s)
    jc, ju, jx = jrk.fused_exact_rollout_cost_pallas(
        s.jmodel, s.jparams, s.jcfg, JaxCostParams(), s.jcostmap,
        *s.jax_args(), l1_cost=s.l1_cost, k_offset=s.k_offset,
        interpret=True)
    np.testing.assert_allclose(costs.numpy(), np.asarray(jc),
                               rtol=COST_RTOL, atol=COST_ATOL)
    np.testing.assert_array_equal(crash.numpy(), np.asarray(jx))
    np.testing.assert_allclose(u_seq.numpy(), np.asarray(ju), rtol=0,
                               atol=USEQ_ATOL)
    assert np.isfinite(costs.numpy()).all()
    if case == "random_map_l1_stride2":
        assert 0 < int(crash.sum()) < crash.numel()


@pytest.mark.parametrize("case", ["nominal", "wide_noise", "nan_x",
                                  "random_map_l1_stride2"])
def test_fused_exact_plain_matches_jax_scan(case):
    """Against the JAX solver's own scan path (``rollout_costs``)."""
    s = make_setup(case)
    costs, u_seq, crash = _port_fused(s)
    solver = JaxSolver(s.jmodel, JaxCost(s.l1_cost), s.jcfg)
    assert not solver.use_pallas_rollout
    jc, ju, jx = solver.rollout_costs(s.jparams, JaxCostParams(), s.jcostmap,
                                      *s.jax_args())
    np.testing.assert_allclose(costs.numpy(), np.asarray(jc),
                               rtol=COST_RTOL, atol=COST_ATOL)
    np.testing.assert_array_equal(crash.numpy(), np.asarray(jx))
    np.testing.assert_allclose(u_seq.numpy().transpose(1, 2, 0),
                               np.asarray(ju), rtol=0, atol=USEQ_ATOL)


@pytest.mark.parametrize("case", ["nominal", "wide_noise", "nan_x",
                                  "k_offset"])
def test_dynamics_chain_plain_matches_jax_kernel(case):
    s = make_setup(case)
    states, u_seq = rk.dynamics_chain(s.model, s.params, s.cfg,
                                      *s.torch_args(), k_offset=s.k_offset)
    js, ju = jrk.dynamics_chain_pallas(s.jmodel, s.jparams, s.jcfg,
                                       *s.jax_args(), k_offset=s.k_offset,
                                       interpret=True)
    js = np.asarray(js)[:s.model.STATE_DIM]          # drop the SPAD rows
    assert states.shape == js.shape
    np.testing.assert_allclose(states.numpy(), js, rtol=STATE_RTOL,
                               atol=STATE_ATOL)
    np.testing.assert_allclose(u_seq.numpy(), np.asarray(ju), rtol=0,
                               atol=USEQ_ATOL)


def test_nominal_trajectory_matches_jax_kernel_and_scan():
    s = make_setup()
    state, U, _ = s.torch_args()
    ss, cs = rk.nominal_trajectory(s.model, s.params, s.cfg, state, U)
    jstate, jU, _ = s.jax_args()
    jss, jcs = jrk.nominal_trajectory_pallas(s.jmodel, s.jparams, s.jcfg,
                                             jstate, jU, interpret=True)
    solver = JaxSolver(s.jmodel, JaxCost(), s.jcfg)
    sss, scs = solver.nominal_trajectory(s.jparams, jstate, jU)
    assert ss.shape == (T, 7) and cs.shape == (T, 2)
    for ref_s, ref_c in ((jss, jcs), (sss, scs)):
        np.testing.assert_allclose(ss.numpy(), np.asarray(ref_s),
                                   rtol=STATE_RTOL, atol=STATE_ATOL)
        np.testing.assert_array_equal(cs.numpy(), np.asarray(ref_c))
    np.testing.assert_array_equal(ss[0].numpy(), s.state)


def test_rollout_zero_and_pure_noise_rules():
    """Rollout 0 follows U exactly; rollouts k >= 0.99 K are pure noise;
    step t < optimization_stride is frozen for all."""
    s = make_setup()
    _, u_seq, _ = _port_fused(s)
    u = u_seq.numpy()                                  # (C, T, K)
    np.testing.assert_array_equal(u[:, :, 0], s.U.T)
    np.testing.assert_array_equal(u[:, 0, :], np.repeat(s.U[0][:, None], K, 1))
    first_pure = int(np.ceil(np.float32(0.99 * K)))
    nu = np.array(s.cfg.exploration_std, np.float32)
    np.testing.assert_array_equal(
        u[:, 1:, first_pure:],
        (s.eps[1:, first_pure:, :] * nu).transpose(2, 0, 1))
    assert rk._pure_thresh(MPPIConfig(), 0) == pytest.approx(1900.8, abs=1e-3)
    k = np.arange(1920, dtype=np.float32)
    assert int((k >= rk._pure_thresh(MPPIConfig(), 0)).argmax()) == 1901


def test_launch_scalars_follow_the_kernel_layout():
    """The host scalars the CUDA launch unpacks by position."""
    s = make_setup("random_map_l1_stride2")
    cp = CostParams(desired_speed=5.5, discount=0.2)
    floats, ints = rk.launch_scalars(s.model, s.cfg, 0, T, K, cp, s.costmap,
                                     True)
    assert len(floats) == len(rk._FLOAT_SCALARS)
    assert len(ints) == len(rk._INT_SCALARS)
    f = dict(zip(rk._FLOAT_SCALARS, floats))
    i = dict(zip(rk._INT_SCALARS, ints))
    assert (f["nu0"], f["nu1"]) == pytest.approx(s.cfg.exploration_std)
    assert f["opt_delay"] == 2 and f["dt"] == pytest.approx(0.02)
    assert f["desired_speed"] == 5.5 and f["discount"] == pytest.approx(0.2)
    assert [f[n] for n in ("rc1x", "rc1y", "rc1w", "rc2x", "rc2y", "rc2w",
                           "trsx", "trsy", "trsw")] == list(s.costmap.transform)
    assert (i["T"], i["K"], i["k0_flag"], i["l1_cost"]) == (T, K, 1, 1)
    assert (i["H"], i["W"]) == (s.costmap.height, s.costmap.width)
    chain_f, chain_i = rk.launch_scalars(s.model, s.cfg, 128, T, K)
    assert len(chain_f) == len(floats) and len(chain_i) == len(ints)
    assert chain_i[2] == 0 and chain_f[3] == pytest.approx(0.99 * K - 128)
    assert rk.KERNEL_NUM_WEIGHTS == s.model.num_params == 1412
    assert sum(w.numel() for w in s.model.kernel_weights(s.params)) == 1412


def test_wrappers_dispatch_by_device_and_count_only_kernel_launches():
    s = make_setup()
    before = dict(rk.LAUNCHES)
    _port_fused(s)
    rk.dynamics_chain(s.model, s.params, s.cfg, *s.torch_args())
    assert dict(rk.LAUNCHES) == before    # CPU: plain, no launch
    meta = torch.empty((T, K, 2), device="meta")
    with pytest.raises(ValueError, match="no rollout kernel"):
        rk.fused_exact_rollout_cost(s.model, s.params, s.cfg, CostParams(),
                                    s.costmap, *s.torch_args()[:2], meta)
    with pytest.raises(ValueError, match="no rollout kernel"):
        rk.dynamics_chain(s.model, s.params, s.cfg, *s.torch_args()[:2], meta)


def test_kernel_refuses_what_it_was_not_built_for():
    """Other models, layer specs and obstacle terms are refused before any
    build or launch, never run by the plain version instead."""
    s = make_setup()
    wide = NeuralNetDynamics(0.02, layers=(6, 64, 4), device="cpu")

    class OtherModel(Dynamics):
        pass

    for model in (wide, OtherModel(0.02, device="cpu")):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            rk.prepare_dynamics_chain(model, s.params, s.cfg,
                                      *s.torch_args())
    with pytest.raises(NotImplementedError, match="obstacle"):
        rk.prepare_fused_exact_rollout_cost(
            s.model, s.params, s.cfg, CostParams(obstacles=np.zeros((1, 3))),
            s.costmap, *s.torch_args())


def test_packed_weights_are_reused_until_the_weights_change():
    """The kernels' weight buffer is packed once per set of weight tensors,
    and packed again for new params or after an in-place change."""
    s = make_setup()
    packed = rk._pack_weights(s.model, s.params)
    want = torch.cat([w.reshape(-1)
                      for w in s.model.kernel_weights(s.params)])
    torch.testing.assert_close(packed, want, rtol=0, atol=0)
    assert packed.numel() == rk.KERNEL_NUM_WEIGHTS
    assert rk._pack_weights(s.model, s.params) is packed
    with torch.no_grad():
        s.params["biases"][0].add_(1.0)
    repacked = rk._pack_weights(s.model, s.params)
    assert repacked is not packed
    assert repacked[6 * 32:6 * 32 + 32].eq(1.0).all()
    other = s.model.init_params(1)
    assert not torch.equal(rk._pack_weights(s.model, other), repacked)
