"""The port's track generator, costmap and cost terms against the JAX
package on the same numpy-seeded inputs (CPU, fp32)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autorally_tpu.config import CostParams as JaxCostParams
from autorally_tpu.costs import MPPICost as JaxCost
from autorally_tpu.costs.costmap import load_costmap as jax_load_costmap
from autorally_tpu.costs.costmap import make_costmap as jax_make_costmap
from autorally_tpu.costs.costmap import save_costmap
from autorally_tpu.tools.track_generator import oval_track as jax_oval_track
from autorally_tpu_torch.config import CostParams
from autorally_tpu_torch.costs import MPPICost, load_costmap, make_costmap
from autorally_tpu_torch.tools.track_generator import oval_track

# Cost terms are a handful of fp32 operations; XLA and PyTorch may round
# a product or a quotient differently by an ulp.
TERM_RTOL, TERM_ATOL = 1e-6, 1e-6


@pytest.mark.parametrize("kw", [
    {},
    dict(ppm=2.0),
    dict(half_length=30.0, half_width=18.0, track_width=6.0, ppm=10.0),
])
def test_oval_track_arrays_equal(kw):
    data, xb, yb = oval_track(**kw)
    jdata, jxb, jyb = jax_oval_track(**kw)
    np.testing.assert_array_equal(data, jdata)
    assert data.dtype == jdata.dtype
    assert (xb, yb) == (jxb, jyb)


def _maps(ppm=2.0, seed=0):
    """Both packages' costmaps over the oval with random channels 1-3."""
    data, xb, yb = oval_track(ppm=ppm)
    rs = np.random.default_rng(seed)
    data[..., 1:] = rs.uniform(0, 3, data[..., 1:].shape).astype(np.float32)
    return (make_costmap(data, xb, yb, device="cpu"),
            jax_make_costmap(data, xb, yb), xb, yb)


def _points(xb, yb, n=4000, seed=1):
    """World points inside the map, off every edge, and NaN."""
    rs = np.random.default_rng(seed)
    pad = 8.0
    x = rs.uniform(xb[0] - pad, xb[1] + pad, n).astype(np.float32)
    y = rs.uniform(yb[0] - pad, yb[1] + pad, n).astype(np.float32)
    x[:5] = np.nan
    y[5:10] = np.nan
    x[10:12], y[10:12] = np.inf, -np.inf
    return x, y


def test_lookup_matches_jax_with_clamp_and_nan():
    cm, jcm, xb, yb = _maps()
    x, y = _points(xb, yb)
    got = cm.lookup(torch.tensor(x), torch.tensor(y)).numpy()
    np.testing.assert_array_equal(got, np.asarray(
        jcm.lookup(jnp.asarray(x), jnp.asarray(y))))
    got0 = cm.lookup_ch0(torch.tensor(x), torch.tensor(y)).numpy()
    np.testing.assert_array_equal(got0, np.asarray(
        jcm.lookup_ch0(jnp.asarray(x), jnp.asarray(y))))
    np.testing.assert_array_equal(got0, got[..., 0])
    # NaN coordinates read texel 0 of their row or column
    iy, ix = cm.texel_indices(torch.tensor(x[:10]), torch.tensor(y[:10]))
    assert (ix[:5] == 0).all() and (iy[5:10] == 0).all()


def test_world_to_norm_and_layout_match_jax():
    cm, jcm, xb, yb = _maps()
    x, y = _points(xb, yb, n=500, seed=2)
    u, v = cm.world_to_norm(torch.tensor(x), torch.tensor(y))
    ju, jv = jcm.world_to_norm(jnp.asarray(x), jnp.asarray(y))
    np.testing.assert_array_equal(u.numpy(), np.asarray(ju))
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    assert cm.ch0.is_contiguous()
    assert torch.equal(cm.ch0, cm.data[..., 0])
    assert (cm.height, cm.width) == (jcm.height, jcm.width)
    np.testing.assert_array_equal(
        np.asarray(cm.transform, np.float32),
        np.concatenate([np.asarray(jcm.r_c1), np.asarray(jcm.r_c2),
                        np.asarray(jcm.trs)]))


def test_load_costmap_matches_jax(tmp_path):
    data, xb, yb = oval_track(ppm=2.0)
    path = str(tmp_path / "map.npz")
    save_costmap(data, xb, yb, 2.0, path)
    cm, jcm = load_costmap(path, device="cpu"), jax_load_costmap(path)
    np.testing.assert_array_equal(cm.data.numpy(), np.asarray(jcm.data))
    for a, b in ((cm.r_c1, jcm.r_c1), (cm.r_c2, jcm.r_c2), (cm.trs, jcm.trs)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _state_rows(n=3000, seed=3):
    """Rollout-like state components, a few with |u_x| <= 0.001 and
    large slip, plus NaN."""
    rs = np.random.default_rng(seed)
    f = lambda *a: rs.uniform(*a, n).astype(np.float32)
    x, y, yaw = f(-35, 35), f(-25, 25), f(-4, 4)
    ux, uy = f(-2, 9), f(-4, 4)
    ux[:50] = rs.uniform(-0.001, 0.001, 50).astype(np.float32)
    ux[50:60] = np.nan
    return x, y, yaw, ux, uy


@pytest.mark.parametrize("l1", [False, True])
def test_cost_terms_match_jax(l1):
    cm, jcm, xb, yb = _maps()
    x, y, yaw, ux, uy = _state_rows()
    p = CostParams(desired_speed=6.0, track_slop=0.2, steering_coeff=0.5,
                   throttle_coeff=0.25)
    jp = JaxCostParams(desired_speed=6.0, track_slop=0.2, steering_coeff=0.5,
                       throttle_coeff=0.25)
    cost, jcost = MPPICost(l1), JaxCost(l1)
    T = lambda a: torch.tensor(a)
    J = jnp.asarray
    close = lambda a, b: np.testing.assert_allclose(
        a.numpy(), np.asarray(b), rtol=TERM_RTOL, atol=TERM_ATOL)

    close(cost.speed_cost_c(p, T(ux)), jcost.speed_cost_c(jp, J(ux)))
    close(cost.stabilizing_cost_c(p, T(ux), T(uy)),
          jcost.stabilizing_cost_c(jp, J(ux), J(uy)))

    rs = np.random.default_rng(4)
    u = rs.uniform(-1, 1, (2, x.size)).astype(np.float32)
    du = rs.normal(0, 0.3, (2, x.size)).astype(np.float32)
    nu = np.array([0.275, 0.3], np.float32)
    close(cost.control_cost_c(p, T(u[0]), T(u[1]), T(du[0]), T(du[1]), T(nu)),
          jcost.control_cost_c(jp, J(u[0]), J(u[1]), J(du[0]), J(du[1]),
                               J(nu)))

    crash0 = (rs.uniform(size=x.size) < 0.1).astype(np.int32)
    track, crash = cost.track_cost_c(p, cm, T(x), T(y), T(yaw), T(crash0))
    jtrack, jcrash = jcost.track_cost_c(jp, jcm, J(x), J(y), J(yaw),
                                        J(crash0))
    close(track, jtrack)
    np.testing.assert_array_equal(crash.numpy(), np.asarray(jcrash))
    assert 0 < crash.sum() < x.size                    # the latch is exercised

    np.testing.assert_array_equal(
        cost.crash_cost(p, crash).numpy(),
        np.asarray(jcost.crash_cost(jp, jcrash)))
    s = np.zeros((x.size, 7), np.float32)
    s[:, 3] = rs.uniform(-2, 2, x.size)
    np.testing.assert_array_equal(
        cost.get_crash(T(s), T(crash0)).numpy(),
        np.asarray(jcost.get_crash(J(s), J(crash0))))
    np.testing.assert_array_equal(cost.terminal_cost(T(s)).numpy(),
                                  np.asarray(jcost.terminal_cost(J(s))))


def test_clamp_cost_matches_compute_cost_clamp():
    """The 1e12 / NaN clamp (costs.cu:405-407), as JAX's compute_cost
    applies it."""
    c = np.array([0.0, 5.0, 1e12, 2e12, np.inf, -np.inf, np.nan], np.float32)
    ref = np.where((c > 1e12) | np.isnan(c), np.float32(1e12), c)
    np.testing.assert_array_equal(MPPICost.clamp_cost(torch.tensor(c)).numpy(),
                                  ref)
