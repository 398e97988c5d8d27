"""Kernel 4 (pass 1 of the capacity mode) at MLP layer specs other than the
default library's 6-32-32-4, on the CPU: its plain PyTorch version in both
modes (the exact map and the 34-64-64-1 field), which the wrapper runs
for CPU tensors, against the JAX ``fused_rng_costs`` in TPU interpret mode
with zero exploration noise (every rollout's controls U, or 0 in the
pure-noise band, whatever the stream: the JAX kernels draw from the TPU's
own PRNG) and, with noise, against the JAX host-noise rollouts fed the
port's stream; the capacity iterate on the exact map against the JAX
iterate; and the libraries the wrappers load: a spec's own for kernels
1-4, the default one for pass 2.  Specs 6-16-16-16-4 and 6-24-4, K=256,
T=24 (``tests/test_torch_field_specs.py``'s set-up).  The CUDA kernels
run only on a GPU: ``chip_smoke.py`` phase 28 holds them against these
plain versions there."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from autorally_tpu.config import CostParams as JaxCostParams
from autorally_tpu.costs import MPPICost as JaxCost
from autorally_tpu.costs.costmap import make_costmap as jax_make_costmap
from autorally_tpu.ops import rollout_kernel as jrk
from autorally_tpu.solver import mppi as jmppi
from autorally_tpu.tools.track_generator import oval_track
from autorally_tpu_torch.config import CostParams
from autorally_tpu_torch.costs import MPPICost, make_costmap
from autorally_tpu_torch.ops import kernel_rng as kr
from autorally_tpu_torch.ops import rollout_kernel as rk
from autorally_tpu_torch.solver import mppi
from tests.test_torch_field_specs import (ITER_ATOL, ITER_RTOL, K, KEY,
                                          SPECS, T, _label, fields, setup)
from tests.test_torch_solver import _assert_stats

SAMPLERS = {"gaussian": {}, "ou": dict(noise_sampler="ou", noise_param=0.15)}
QUIET = dict(steering_std=0.0, throttle_std=0.0, kernel_rng=True)
# 23 running-average steps of fp32 with another summation order in the MLP
# and the field; against the JAX host-noise path a softmax-free cost, the
# iterate's tolerances (tests/test_torch_neural_costmap.py's pass-1 test)
COST_RTOL, COST_ATOL = 2e-5, 1e-4


def _maps():
    """(port exact map, JAX exact map) of the oval at 2 px/m."""
    data, xb, yb = oval_track(ppm=2.0)
    return (make_costmap(data, xb, yb, device="cpu"),
            jax_make_costmap(data, xb, yb))


def _surfaces(spec, mode):
    return fields(spec) if mode == "field" else _maps()


@pytest.mark.parametrize("sampler", list(SAMPLERS))
@pytest.mark.parametrize("mode", ["exact", "field"])
@pytest.mark.parametrize("spec", SPECS, ids=_label)
def test_pass1_plain_matches_jax_kernel_without_noise(spec, mode, sampler):
    """Pass 1's plain version against the JAX ``fused_rng_costs`` in TPU
    interpret mode, zero exploration noise: costs within COST_RTOL /
    COST_ATOL, crash flags equal."""
    s = setup(spec, **QUIET, **SAMPLERS[sampler])
    surface, jsurface = _surfaces(spec, mode)
    cp = CostParams(desired_speed=6.0)
    total, crash, ctx = rk.fused_rng_costs(
        s["model"], s["params"], s["cfg"], cp, surface,
        torch.tensor(s["state"]), torch.tensor(s["U"]), KEY)
    jtotal, jcrash, _ = jrk.fused_rng_costs(
        s["jmodel"], s["jparams"], s["jcfg"].replace(use_pallas_rollout=True),
        JaxCostParams(desired_speed=6.0), jsurface, jnp.asarray(s["state"]),
        jnp.asarray(s["U"]), jax.random.PRNGKey(3),
        interpret=pltpu.InterpretParams())
    assert total.shape == (K,) and ctx.K == K
    np.testing.assert_allclose(total.numpy(), np.asarray(jtotal),
                               rtol=COST_RTOL, atol=COST_ATOL)
    np.testing.assert_array_equal(crash.numpy(), np.asarray(jcrash))
    assert np.isfinite(total.numpy()).all()


@pytest.mark.parametrize("mode", ["exact", "field"])
@pytest.mark.parametrize("spec", SPECS, ids=_label)
def test_pass1_plain_matches_jax_rollout_costs_on_the_stream(spec, mode):
    """With noise (wide, OU): pass 1's plain version on a shard's slice
    (k_offset 128) against the JAX solver's host-noise rollouts fed the
    port's stream of that slice, within ITER_RTOL / ITER_ATOL, crash flags
    equal."""
    s = setup(spec, "wide_noise", kernel_rng=True, **SAMPLERS["ou"])
    surface, jsurface = _surfaces(spec, mode)
    k_off = 128
    total, crash, ctx = rk.fused_rng_costs(
        s["model"], s["params"], s["cfg"], CostParams(), surface,
        torch.tensor(s["state"]), torch.tensor(s["U"]), KEY, k_offset=k_off,
        K_local=K - k_off)
    eps = rk.rng_noise(ctx).numpy()
    assert eps.shape == (T, K - k_off, 2)
    js = jmppi.MPPISolver(s["jmodel"], JaxCost(), s["jcfg"])
    jc, _, jx = js.rollout_costs(s["jparams"], JaxCostParams(), jsurface,
                                 jnp.asarray(s["state"]), jnp.asarray(s["U"]),
                                 jnp.asarray(eps), k_offset=k_off)
    np.testing.assert_allclose(total.numpy(), np.asarray(jc),
                               rtol=ITER_RTOL, atol=ITER_ATOL)
    np.testing.assert_array_equal(crash.numpy(), np.asarray(jx))


@pytest.mark.parametrize("sampler", list(SAMPLERS))
@pytest.mark.parametrize("spec", SPECS, ids=_label)
def test_capacity_iterate_on_the_exact_map_matches_jax(spec, sampler):
    """One capacity-mode iteration on the exact map (pass 1's and pass 2's
    plain versions), U_new and the six SolveStats within ITER_RTOL /
    ITER_ATOL, against the JAX ``iterate`` fed the port's stream."""
    s = setup(spec, kernel_rng=True, **SAMPLERS[sampler])
    costmap, jcostmap = _maps()
    solver = mppi.MPPISolver(s["model"], MPPICost(), s["cfg"], device="cpu")
    assert solver._use_kernel_rng(costmap)
    cp = CostParams(desired_speed=6.0)
    U_new, stats = solver._iterate_kernel_rng(
        s["params"], cp, costmap, torch.tensor(s["state"]),
        torch.tensor(s["U"]), KEY)
    theta = rk.stream_theta(s["cfg"])
    eps = kr.kernel_noise(KEY, 0, K, T, theta).numpy()
    js = jmppi.MPPISolver(s["jmodel"], JaxCost(), s["jcfg"])
    jU, jstats = js.iterate(s["jparams"], JaxCostParams(desired_speed=6.0),
                            jcostmap, jnp.asarray(s["state"]),
                            jnp.asarray(s["U"]), jnp.asarray(eps))
    np.testing.assert_allclose(U_new.numpy(), np.asarray(jU),
                               rtol=ITER_RTOL, atol=ITER_ATOL)
    _assert_stats(stats, jstats, ITER_RTOL, ITER_ATOL)


@pytest.mark.parametrize("spec", SPECS, ids=_label)
def test_kernels_3_and_4_load_the_specs_library(spec, monkeypatch):
    """On the card kernel 3 and both modes of pass 1 take the spec's own
    library (``_build.load(spec)``) and pass 2 the default one; every
    kernel has a form for the spec.  Here ``_build.load`` records what it
    is asked for and raises: nothing is built, nothing runs the plain
    version instead."""
    s = setup(spec, kernel_rng=True)
    field, _ = fields(spec)
    costmap, _ = _maps()
    for kernel in (1, 2, 3, 4):
        assert rk.has_kernel_form(s["model"], kernel=kernel)
        rk._check_kernel_model(s["model"], kernel=kernel)
    asked = []

    def load(layers=None):
        asked.append(None if layers is None else tuple(layers))
        raise LookupError("no build here")

    monkeypatch.setattr(rk._build, "load", load)
    rk._kernel_lib.cache_clear()
    state, U = torch.tensor(s["state"]), torch.tensor(s["U"])
    args = (s["model"], s["params"], s["cfg"], CostParams())
    with pytest.raises(LookupError):
        rk.prepare_fused_rollout_cost(*args, field, state, U,
                                      torch.tensor(s["eps"]))
    for surface in (costmap, field):
        with pytest.raises(LookupError):
            rk.prepare_fused_rng_costs(*args, surface, state, U, KEY)
    ctx = rk.RngContext(s["model"], s["cfg"], U, KEY, 0, K, None)
    with pytest.raises(LookupError):
        rk.prepare_fused_rng_numer(ctx, torch.ones(K))
    assert asked == [spec, spec, spec, rk.KERNEL_LAYERS]
    rk._kernel_lib.cache_clear()
