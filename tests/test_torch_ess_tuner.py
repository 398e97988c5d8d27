"""The port's ESS tuner (``runtime/ess_tuner.py``) against the JAX
package's on the CPU: the host law (``EssTuner.update``) and the tensor law
(``gamma_step_traced``) on the grid of ``tests/test_ess_tuner.py`` with NaN
and inf, the clamps, ``reset``, ``seed`` and the target check, and
``attach`` driving the tube loop (``run_control_loop``) beside the JAX
loop's: the same gamma tick by tick."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autorally_tpu.config import MPPIConfig as JaxConfig
from autorally_tpu.runtime.ess_tuner import EssTuner as JaxEssTuner
from autorally_tpu.runtime.ess_tuner import \
    gamma_step_traced as jax_gamma_step
from autorally_tpu_torch.config import CostParams, MPPIConfig
from autorally_tpu_torch.runtime.ess_tuner import (EssTuner,
                                                   gamma_step_traced)
from test_torch_runtime import FLAT_MAP, _tube_pair

from autorally_tpu.config import CostParams as JaxCostParams

K = 128
ESS_GRID = (0.0, 1.0, 4.0, 31.9, 32.0, 120.0, float(K), 1e9, float("nan"),
            float("inf"))
G_STARTS = (0.15, 0.02, 1.19)
# float32 power and product in another library: within 1e-6 relative of the
# JAX package's (the JAX test holds its two laws to 1e-5)
LAW_RTOL = 1e-5


def _tuners(**kw):
    return (EssTuner(MPPIConfig(num_rollouts=K, gamma=0.15), **kw),
            JaxEssTuner(JaxConfig(num_rollouts=K, gamma=0.15), **kw))


@pytest.mark.parametrize("ess", ESS_GRID)
def test_host_and_tensor_laws_match_jax(ess):
    for g_start in G_STARTS:
        ours, ref = _tuners(target_frac=0.25)
        ours.gamma = ref.gamma = g_start
        g_host = ours.update(ess)
        assert g_host == ref.update(ess), (ess, g_start)
        g_dev = gamma_step_traced(
            torch.tensor(g_start, dtype=torch.float32),
            torch.tensor(ess, dtype=torch.float32), ours.target, ours.alpha,
            ours.lo, ours.hi)
        g_jax = jax_gamma_step(jnp.float32(g_start), jnp.float32(ess),
                               ref.target, ref.alpha, ref.lo, ref.hi)
        assert g_dev.dtype == torch.float32 and g_dev.dim() == 0
        np.testing.assert_allclose(float(g_dev), float(g_jax), rtol=LAW_RTOL)
        np.testing.assert_allclose(float(g_dev), g_host, rtol=LAW_RTOL)
        if not np.isfinite(ess):
            assert float(g_dev) == np.float32(g_start)   # kept
    # the band as 0-d tensors (the episode's form)
    g = gamma_step_traced(torch.tensor(0.15), torch.tensor(ess),
                          32.0, 0.25, torch.tensor(0.05), torch.tensor(0.3))
    assert np.float32(0.05) <= float(g) <= np.float32(0.3)


def test_clamps_reset_seed_and_target_check():
    ours, ref = _tuners(target_frac=0.25, headroom=4.0)
    for _ in range(200):
        g = ours.update(1.0)                  # ESS collapsed
        assert g == ref.update(1.0)
    assert g == pytest.approx(0.15 / 4.0)
    ours.reset()
    assert ours.gamma == 0.15
    for _ in range(200):
        g = ours.update(float(K))             # ESS pinned at K
    assert g == pytest.approx(0.15 * 4.0)
    seeded = ours.seed(CostParams())
    assert seeded.gamma == np.float32(g) and CostParams().gamma is None
    for frac in (0.0, -0.1, 1.5):
        with pytest.raises(ValueError, match="target_frac"):
            EssTuner(MPPIConfig(num_rollouts=K), target_frac=frac)
    g0 = ours.update(40.0)
    assert ours.update(float("nan")) == g0
    assert ours.update(float("inf")) == g0
    # attach_async seeds an unseeded tube at attach time
    tube = _DuckTube(CostParams())
    ours.attach_async(tube)
    assert tube.cost_params.gamma == np.float32(ours.gamma)


def test_attach_drives_the_tube_loop_like_jax():
    """``attach`` on both sides' tube loops (12 ticks, K=128, DDP gains, on
    the map of one cost where no texel edge blurs the comparison):
    it seeds the unseeded controllers, then every tick takes the winning
    solve's ESS and gives both controllers the new gamma; the gammas agree
    tick by tick and move off the start."""
    pair = _tube_pair(costmap=FLAT_MAP, max_iter=12)
    gammas = {}
    for side, mod in (("port", EssTuner), ("jax", JaxEssTuner)):
        actual, predicted, syn, lcfg, lp = pair[side]
        cfg = (MPPIConfig if side == "port" else JaxConfig)(
            num_rollouts=actual.cfg.num_rollouts)
        tuner = mod(cfg, target_frac=0.25)
        hook = tuner.attach(actual, predicted)
        assert actual.cost_params.gamma is not None
        assert float(predicted.cost_params.gamma) == pytest.approx(0.15)
        seen = gammas[side] = []

        def on_tick(i, chosen, used, state, hook=hook, seen=seen,
                    actual=actual, predicted=predicted):
            hook(i, chosen, used, state)
            seen.append(float(actual.cost_params.gamma))
            assert float(predicted.cost_params.gamma) == seen[-1]

        lp.run_control_loop(predicted, actual, syn, lcfg, on_tick=on_tick)
    assert len(gammas["port"]) == len(gammas["jax"]) == 12
    np.testing.assert_allclose(gammas["port"], gammas["jax"], rtol=LAW_RTOL)
    assert len(set(gammas["port"])) > 2


class _DuckTube:
    """What ``attach_async`` needs of a tube: cost params and their
    update."""

    def __init__(self, cost_params):
        self.cost_params = cost_params

    def update_cost_params(self, cost_params):
        self.cost_params = cost_params


class _Out:
    def __init__(self, ess):
        self.ess = ess


def test_attach_async_gammas_match_jax():
    """``attach_async`` on both packages over one sequence of harvested
    ESS values (NaN and inf among them): the tubes are seeded at attach
    time and carry the same gamma after every harvest."""
    ours, ref = _tuners(target_frac=0.25)
    tubes = _DuckTube(CostParams()), _DuckTube(JaxCostParams())
    hooks = ours.attach_async(tubes[0]), ref.attach_async(tubes[1])
    assert tubes[0].cost_params.gamma == float(tubes[1].cost_params.gamma)
    seq = np.random.default_rng(5).uniform(0.0, K, 40).tolist()
    seq[7:7] = [float("nan"), 1.0, float("inf"), float(K), 1e9]
    for i, ess in enumerate(seq):
        for hook in hooks:
            hook(i, "actual", None, _Out(np.float32(ess)), 0.0, 0.0)
        g, jg = (t.cost_params.gamma for t in tubes)
        assert type(g) is float and g == np.float32(g)
        assert g == float(jg), (i, ess)
    assert ours.gamma != ours.base


def test_attach_async_drives_the_async_loop():
    """``attach_async`` on the port's async tube (the CPU, 12 lockstep
    ticks): one update a harvest from the harvested ESS, gamma into the
    next dispatch."""
    from test_torch_async_loop import _build, _lockstep
    from autorally_tpu_torch.runtime.async_loop import run_control_loop_async

    tube, plant, cfg = _build()
    hook = EssTuner(cfg, target_frac=0.5).attach_async(tube)
    law = EssTuner(cfg, target_frac=0.5)
    seen = []

    def on_tick(i, used, state, out, harvest_ms, age_s):
        hook(i, used, state, out, harvest_ms, age_s)
        seen.append(float(np.float32(law.update(float(out.ess)))))
        assert tube.cost_params.gamma == seen[-1]

    run_control_loop_async(tube, plant, _lockstep(1, 12), on_tick=on_tick)
    assert len(seen) == 12 and len(set(seen)) > 2
