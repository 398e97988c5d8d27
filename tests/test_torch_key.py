"""The controller state's key against the JAX package's, on the CPU.

The port's ``ControllerState.key`` is the JAX package's key data (two
uint32 words), split once per iteration as ``jax.random.split`` does, bit
for bit (``ops/kernel_rng.split``); a solve returns the new key in the new
state and leaves its input state as it was.  Sizes: K = 128, T = 16.

Also the launch geometries of kernel 1, in pure Python
(``rk.exact_geometry``, ``rk.exact_rollout_slots``): each rollout of a
launch is stored by exactly one thread, at ragged K and any k_offset."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autorally_tpu.config import CostParams as JaxCostParams
from autorally_tpu_torch.config import CostParams
from autorally_tpu_torch.costs import MPPICost
from autorally_tpu_torch.ops import kernel_rng as kr
from autorally_tpu_torch.ops import rollout_kernel as rk
from autorally_tpu_torch.solver import mppi
from tests.test_torch_solver import SCENARIO_START, _pair

KEYS = [(0, 0), (0, 1), (0, 1234), (1, 0), (0x7FFFFFFF, 0x80000000),
        (0x80000000, 0x7FFFFFFF), (0xFFFFFFFF, 0xFFFFFFFF),
        (0x2545F491, 0x9E3779B9), (0xDEADBEEF, 0x0BADF00D)]
SEEDS = [0, 1, 5, 1234, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1, 2 ** 32,
         2 ** 32 + 5, 2 ** 40 + 7, -1, -5, -2 ** 31, 2 ** 63 - 1, -2 ** 63]
MODES = {"gaussian": {}, "colored": dict(noise_sampler="colored"),
         "ou": dict(noise_sampler="ou", noise_param=0.15),
         "capacity_gaussian": dict(kernel_rng=True),
         "capacity_ou": dict(kernel_rng=True, noise_sampler="ou",
                             noise_param=0.15)}


def _key_data(key) -> np.ndarray:
    return np.asarray(jax.random.key_data(key))


@pytest.mark.parametrize("key", KEYS, ids=lambda k: f"{k[0]:08x}_{k[1]:08x}")
def test_split_equals_jax_random_split(key):
    """Both halves of ``split`` against ``jax.random.split`` of the raw key
    data, and a chain of ten splits (each new key split again)."""
    jkey = jnp.asarray(np.array(key, np.uint32))
    mine = np.array(key, np.uint32)
    for _ in range(10):
        new, sub = kr.split(mine)
        ref = np.asarray(jax.random.split(jkey))
        assert new.dtype == sub.dtype == np.uint32
        np.testing.assert_array_equal(new, ref[0])
        np.testing.assert_array_equal(sub, ref[1])
        mine, jkey = new, jnp.asarray(ref[0])


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_and_init_state_key_equal_jax(seed):
    """``prng_key`` and ``init_state(seed).key`` equal
    ``key_data(PRNGKey(seed))``: [0, seed mod 2^32] (JAX keeps the low
    word with x64 off)."""
    want = _key_data(jax.random.PRNGKey(seed))
    np.testing.assert_array_equal(kr.prng_key(seed), want)
    solver, *_ = _pair(K=128, T=16)
    np.testing.assert_array_equal(solver.init_state(seed).key, want)


def test_prng_key_refuses_a_seed_beyond_int64():
    with pytest.raises(OverflowError):
        kr.prng_key(2 ** 64 - 1)


@pytest.mark.parametrize("mode", list(MODES))
def test_two_solves_from_one_state_are_equal(mode):
    """The same state solved twice gives equal plans, solutions and stats,
    and the input state is unchanged (its tensors and its key)."""
    base, params, cm, *_ = _pair(K=128, T=16)
    cfg = base.cfg.replace(**MODES[mode])
    solver = mppi.MPPISolver(base.model, MPPICost(), cfg, device="cpu")
    assert solver._use_kernel_rng(cm) == mode.startswith("capacity")
    cs = solver.slide(solver.init_state(7), 1)
    saved = {name: (v.copy() if isinstance(v, np.ndarray) else v.clone())
             for name, v in cs._asdict().items()}
    a, sa = solver.solve(params, CostParams(), cm, SCENARIO_START, cs)
    b, sb = solver.solve(params, CostParams(), cm, SCENARIO_START, cs)
    for name, v in cs._asdict().items():
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(v, saved[name], err_msg=name)
        else:
            assert torch.equal(v, saved[name]), name
    for name in ("U", "control_hist", "state_solution", "control_solution"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    np.testing.assert_array_equal(a.key, b.key)
    np.testing.assert_array_equal(a.key, kr.split(cs.key)[0])
    for name in mppi.SolveStats._fields:
        assert torch.equal(getattr(sa, name), getattr(sb, name)), name
    # the next solve, from the returned state, draws other noise
    c, _ = solver.solve(params, CostParams(), cm, SCENARIO_START, a)
    assert not torch.equal(c.U, a.U)


H100_SMS = 132


def _check_slots(geom, K, k_offset):
    k, store = rk.exact_rollout_slots(geom, K, k_offset)
    assert k.shape == store.shape == (geom.grid, geom.block)
    stored = np.sort(k[store])
    np.testing.assert_array_equal(stored, np.arange(k_offset, k_offset + K))
    ran = k[k >= 0]
    assert ran.min() >= k_offset and ran.max() < k_offset + K
    if geom.group > 1:
        # a lane leaves only with its whole warp (the shuffles need it)
        left = (k < 0).reshape(geom.grid, geom.block // 32, 32)
        assert np.all(left.all(axis=2) == left.any(axis=2))
        # the lanes of a group run one rollout
        g = k.reshape(geom.grid, -1, geom.group)
        assert np.all(g == g[..., :1])


@pytest.mark.parametrize("k_offset", [0, 131003])
@pytest.mark.parametrize("K", [1, 31, 32, 33, 63, 65, 127, 129, 959, 1919,
                               1920, 1921, 2560, 4223, 8449, 16381])
@pytest.mark.parametrize("forced", rk.GEOMETRIES, ids=lambda f: "G%dB%d" % f)
def test_every_geometry_covers_each_rollout_once(forced, K, k_offset):
    """Every geometry kernel 1 takes, at ragged K: each rollout of the
    slice is stored by exactly one thread, dummy rollouts repeat rollout
    K - 1, whole warps leave together, a group's lanes share a rollout."""
    _check_slots(rk._geometry(K, *forced), K, k_offset)


@pytest.mark.parametrize("k_offset", [0, 69])
@pytest.mark.parametrize("bf", [False, True])
@pytest.mark.parametrize("K", [1, 1920, 1921, 2560, 16384, 65536 - 19,
                               262143, 262144])
def test_exact_geometry_is_one_the_kernels_take(K, bf, k_offset):
    """The launcher's pick on an H100 (132 SMs): a built geometry
    (``rk.GEOMETRIES``), one rollout a thread for the BF model, lane groups
    for the MLP at the main path's K = 1920; and it covers every rollout."""
    geom = rk.exact_geometry(K, H100_SMS, bf)
    assert geom[:2] in rk.GEOMETRIES
    assert geom.grid == -(-K // (geom.block // geom.group))
    if bf:
        assert geom.group == 1
    if K == 1920 and not bf:
        assert geom.group > 1
    _check_slots(geom, K, k_offset)


@pytest.mark.parametrize("num_iters", [1, 2])
@pytest.mark.parametrize("kernel_rng", [False, True])
def test_key_follows_the_jax_solver_over_three_ticks(kernel_rng, num_iters):
    """After three slide + solve ticks the port's key equals the JAX
    solver's (one split per iteration; JAX on the CPU solves on its
    host-noise path, whose key schedule is the capacity mode's too)."""
    solver, params, cm, jsolver, jparams, jcm = _pair(
        K=128, T=16, kernel_rng=kernel_rng, num_iters=num_iters)
    cs, jcs = solver.init_state(), jsolver.init_state()
    np.testing.assert_array_equal(cs.key, _key_data(jcs.key))
    for _ in range(3):
        cs = solver.slide(cs, 1)
        cs, _ = solver.solve(params, CostParams(), cm, SCENARIO_START, cs)
        jcs = jsolver.slide(jcs, 1)
        jcs, _ = jsolver.solve(jparams, JaxCostParams(), jcm,
                               SCENARIO_START, jcs)
        np.testing.assert_array_equal(cs.key, _key_data(jcs.key))
