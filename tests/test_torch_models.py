"""The port's dynamics models against the JAX package on the same seeded
weights (carried across with ``params_from_jax``), random states and
controls, at fp32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autorally_tpu.models import NeuralNetDynamics as JaxNN
from autorally_tpu_torch.models import NeuralNetDynamics

DT = 0.02
RANGES = ((-0.99, 0.99), (-0.99, 0.65))


def _pair(negate=True, layers=(6, 32, 32, 4), seed=0):
    jm = JaxNN(DT, layers=layers, control_ranges=RANGES,
               negate_yaw_der=negate)
    jp = jm.init_params(jax.random.PRNGKey(seed))
    tm = NeuralNetDynamics(DT, layers=layers, control_ranges=RANGES,
                           negate_yaw_der=negate, device="cpu")
    tp = tm.params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    return jm, jp, tm, tp


def _inputs(n=64, seed=1):
    rs = np.random.default_rng(seed)
    s = rs.standard_normal((n, 7)).astype(np.float32) * np.float32(2.0)
    u = rs.uniform(-1.5, 1.5, (n, 2)).astype(np.float32)   # some out of range
    return s, u


@pytest.mark.parametrize("negate", [True, False])
def test_state_deriv_matches_jax(negate):
    jm, jp, tm, tp = _pair(negate)
    s, u = _inputs()
    ref = np.asarray(jm.state_deriv(jp, jnp.asarray(s), jnp.asarray(u)))
    got = tm.state_deriv(tp, torch.tensor(s), torch.tensor(u)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tm(torch.tensor(s), torch.tensor(u)).numpy(),
                               ref, rtol=1e-6, atol=1e-6)


def test_update_state_and_constraints_match_jax():
    jm, jp, tm, tp = _pair()
    s, u = _inputs()
    js, ju = jm.update_state(jp, jnp.asarray(s), jnp.asarray(u))
    ts, tu = tm.update_state(tp, torch.tensor(s), torch.tensor(u))
    np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6,
                               atol=1e-6)


def test_wider_network_matches_jax():
    """A 6-64-64-64-64-4 spec (the reference's wider_deeper asset shape)."""
    jm, jp, tm, tp = _pair(layers=(6, 64, 64, 64, 64, 4), seed=3)
    s, u = _inputs(seed=4)
    ref = np.asarray(jm.dynamics(jp, jnp.asarray(s), jnp.asarray(u)))
    got = tm.dynamics(tp, torch.tensor(s), torch.tensor(u)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


def test_npz_round_trip_and_reference_layout(tmp_path):
    """save_params writes the reference (out, in) float64 layout, which both
    packages' loaders read back to the same weights."""
    jm, jp, tm, tp = _pair()
    path = str(tmp_path / "nn.npz")
    tm.save_params(tp, path)
    data = np.load(path)
    assert data["dynamics_W1"].shape == (32, 6)
    assert data["dynamics_W1"].dtype == np.float64
    back = tm.load_params(path)
    ref = jm.load_params(path)
    for a, b, c in zip(back["weights"], ref["weights"], tp["weights"]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        np.testing.assert_array_equal(a.numpy(), c.numpy())
    np.testing.assert_array_equal(back["control_rngs"].numpy(),
                                  np.asarray(ref["control_rngs"]))


def test_init_params_seeded_and_held():
    tm = NeuralNetDynamics(DT, device="cpu")
    a = tm.init_params(7)
    b = NeuralNetDynamics(DT, device="cpu").init_params(7)
    assert [w.shape for w in a["weights"]] == [(6, 32), (32, 32), (32, 4)]
    for x, y in zip(a["weights"], b["weights"]):
        assert torch.equal(x, y)
    assert all(torch.count_nonzero(bias) == 0 for bias in a["biases"])
    assert tm.params()["weights"][0] is tm.weights[0]
    assert tm.num_params == 6 * 32 + 32 + 32 * 32 + 32 + 32 * 4 + 4


def test_kernel_weights_layout_matches_jax():
    jm, jp, tm, tp = _pair()
    for a, b in zip(tm.kernel_weights(tp), jm.kernel_weights(jp)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_layer_spec_validation():
    with pytest.raises(ValueError):
        NeuralNetDynamics(DT, layers=(5, 32, 4), device="cpu")
    with pytest.raises(ValueError):
        NeuralNetDynamics(DT, layers=(6, 32, 3), device="cpu")
