"""The port's DDP feedback-gain solver and box QP against the JAX package on
the CPU: the same seeded inputs on both sides, the weights carried across
with ``params_from_jax``.

- ``DDPSolver.run`` for the MLP and the BF model, one and three
  iterations, with and without the box QP; a model whose reported control
  slope has the wrong sign, so that the line search of every later
  iteration halves alpha past ``min_alpha`` and keeps the previous
  trajectory; a linear system against the numpy LQR recursion; the MLP's
  and the BF model's fused Euler steps against the models' own.
- The captured run's bookkeeping (a stand-in for ``torch.cuda.CUDAGraph``
  that replays by running the captured call again): each replay reads the
  caller's current weights and inputs and returns results of its own.
- ``boxqp`` on seeded positive-definite problems with active bounds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autorally_tpu.models import BasisFunctionDynamics as JaxBF
from autorally_tpu.models import NeuralNetDynamics as JaxNN
from autorally_tpu.models.base import Dynamics as JaxDynamics
from autorally_tpu.solver.boxqp import boxqp as jax_boxqp
from autorally_tpu.solver.ddp import DDPConfig as JaxDDPConfig
from autorally_tpu.solver.ddp import DDPSolver as JaxDDP
from autorally_tpu_torch.models import (BasisFunctionDynamics,
                                        NeuralNetDynamics)
from autorally_tpu_torch.models.base import Dynamics
from autorally_tpu_torch.models.basis_function import car_basis_functions
from autorally_tpu_torch.solver import ddp as ddp_mod
from autorally_tpu_torch.solver.boxqp import boxqp
from autorally_tpu_torch.solver.ddp import DDPConfig, DDPSolver

DT = 0.02
RANGES = ((-0.99, 0.99), (-0.99, 0.65))
# Gains after a 23-step float32 recursion whose products run in another
# order (and whose 2x2 determinant comes out of a fused product): measured
# within 3e-7 relative of the JAX package's; the trajectories and costs
# likewise.  rtol 1e-4 leaves the margin for a less well-conditioned quu;
# atol 1e-6 covers the feedforward of later iterations, which is itself of
# order 1e-6.
RTOL, ATOL = 1e-4, 1e-6
T = 24


def _models(kind):
    if kind == "nn":
        jm = JaxNN(DT, control_ranges=RANGES)
        tm = NeuralNetDynamics(DT, control_ranges=RANGES, device="cpu")
    else:
        jm = JaxBF(DT, control_ranges=RANGES)
        tm = BasisFunctionDynamics(DT, control_ranges=RANGES, device="cpu")
    jp = jm.init_params(jax.random.PRNGKey(0))
    tp = tm.params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    return jm, jp, tm, tp


def _problem(seed=0, T=T):
    """A perturbed start, noisy controls beyond the limits in places and
    targets around the start."""
    rs = np.random.default_rng(seed)
    x0 = (np.array([0, 0, 0, 0, 3.0, 0, 0]) + rs.standard_normal(7)
          * [1, 1, 0.3, 0.05, 1, 0.3, 0.3]).astype(np.float32)
    U = np.clip(rs.standard_normal((T, 2)) * 0.8, -1.2, 1.2).astype(
        np.float32)
    xt = (x0 + rs.standard_normal((T, 7)) * [3, 3, 1, 0.1, 2, 0.5, 0.5]
          ).astype(np.float32)
    ut = (rs.standard_normal((T, 2)) * 0.5).astype(np.float32)
    return x0, U, xt, ut


def _assert_result(res, jres, rtol=RTOL, atol=ATOL):
    for name in ddp_mod.DDPResult._fields:
        np.testing.assert_allclose(getattr(res, name).numpy(),
                                   np.asarray(getattr(jres, name)),
                                   rtol=rtol, atol=atol, err_msg=name)


def _count_alphas(solver):
    """Record the alpha of every forward pass of ``solver``."""
    alphas = []
    forward = solver._forward

    def counted(params, xs, us, KL, alpha, *rest):
        alphas.append(alpha)
        return forward(params, xs, us, KL, alpha, *rest)

    solver._forward = counted
    return alphas


@pytest.mark.parametrize("use_boxqp", [False, True])
@pytest.mark.parametrize("iterations", [1, 3])
@pytest.mark.parametrize("kind", ["nn", "bf"])
def test_ddp_matches_jax(kind, iterations, use_boxqp):
    jm, jp, tm, tp = _models(kind)
    x0, U, xt, ut = _problem()
    rngs = np.asarray(jp["control_rngs"])
    jres = JaxDDP(jm, DT, T, JaxDDPConfig(
        num_iterations=iterations, use_boxqp=use_boxqp)).run(
            jp, x0, U, xt, ut, rngs[:, 0], rngs[:, 1])
    solver = DDPSolver(tm, DT, T, DDPConfig(num_iterations=iterations,
                                            use_boxqp=use_boxqp),
                       device="cpu")
    alphas = _count_alphas(solver)
    res = solver.run(tp, x0, U, xt, ut, rngs[:, 0], rngs[:, 1])
    _assert_result(res, jres)
    assert res.feedback_gain.shape == (T, 2, 7)
    assert torch.all(res.feedback_gain[-1] == 0)
    assert torch.all(res.feedforward[-1] == 0)
    assert alphas[0] == 1.0 and (iterations > 1 or alphas == [1.0])


@jax.custom_jvp
def _jax_flip_slope(u):
    return u


@_jax_flip_slope.defjvp
def _jax_flip_slope_jvp(primals, tangents):
    return primals[0], -tangents[0]


class _FlipSlope(torch.autograd.Function):
    """The identity, reporting the slope -1 to forward mode."""

    generate_vmap_rule = True

    @staticmethod
    def forward(u):
        return u.clone()

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def jvp(ctx, t):
        return -t


class JaxLinear(JaxDynamics):
    """ds/dt = A_c s + B_c u (test-only), optionally reporting -B_c."""

    def __init__(self, dt, A_c, B_c, wrong_slope=False):
        super().__init__(dt)
        self.A_c = jnp.asarray(A_c, dtype=jnp.float32)
        self.B_c = jnp.asarray(B_c, dtype=jnp.float32)
        self.wrong_slope = wrong_slope

    def state_deriv(self, params, states, controls):
        if self.wrong_slope:
            controls = _jax_flip_slope(controls)
        return states @ self.A_c.T + controls @ self.B_c.T


class Linear(Dynamics):
    """The port's twin of :class:`JaxLinear`."""

    def __init__(self, dt, A_c, B_c, wrong_slope=False):
        super().__init__(dt, device="cpu")
        self.A_c = torch.tensor(A_c, dtype=torch.float32)
        self.B_c = torch.tensor(B_c, dtype=torch.float32)
        self.wrong_slope = wrong_slope

    def state_deriv(self, params, states, controls):
        if self.wrong_slope:
            controls = _FlipSlope.apply(controls)
        return states @ self.A_c.T + controls @ self.B_c.T


def _linear_system(seed):
    rs = np.random.RandomState(seed)
    A_c = rs.randn(7, 7).astype(np.float32) * 0.3
    B_c = rs.randn(7, 2).astype(np.float32) * 0.5
    return A_c, B_c


def test_line_search_exhausts_and_keeps_the_previous_trajectory():
    """With a strong control (B_c x 40) reported with the wrong slope, every
    step of iterations 1 and 2 raises the true cost (alpha 1 sixfold):
    alpha halves from 1 until it is under min_alpha (15 forward passes
    each) and both keep iteration 0's trajectory and cost, bit for bit, on
    both sides."""
    A_c, B_c = _linear_system(3)
    B_c = B_c * 40.0
    Tl = 20
    x0 = np.array([1.0, -0.5, 0.3, 0.0, 2.0, 0.2, 0.0], np.float32)
    U = np.zeros((Tl, 2), np.float32)
    zx, zu = np.zeros((Tl, 7), np.float32), np.zeros((Tl, 2), np.float32)
    big = np.full(2, 1e9, np.float32)
    runs = {}
    for n in (1, 3):
        jres = JaxDDP(JaxLinear(DT, A_c, B_c, True), DT, Tl,
                      JaxDDPConfig(num_iterations=n)).run(
            {}, x0, U, zx, zu, -big, big)
        solver = DDPSolver(Linear(DT, A_c, B_c, True), DT, Tl,
                           DDPConfig(num_iterations=n), device="cpu")
        alphas = _count_alphas(solver)
        res = solver.run({}, x0, U, zx, zu, -big, big)
        _assert_result(res, jres)
        runs[n] = (jres, res, alphas)
    halving = [0.5 ** i for i in range(15)]
    assert runs[3][2] == [1.0] + halving + halving
    assert halving[-1] < DDPConfig().min_alpha <= halving[-2]
    for name in ("state_traj", "control_traj", "cost"):
        np.testing.assert_array_equal(np.asarray(getattr(runs[3][0], name)),
                                      np.asarray(getattr(runs[1][0], name)),
                                      err_msg=name)
        np.testing.assert_array_equal(getattr(runs[3][1], name).numpy(),
                                      getattr(runs[1][1], name).numpy(),
                                      err_msg=name)


def lqr_gains_numpy(A, B, Q, R, Qf, T, dt):
    """Finite-horizon discrete LQR in float64, the reference backward pass
    (ddp.h:88-117) with the targets on the nominal trajectory (the
    recursion of ``tests/test_ddp.py``)."""
    Vxx = Qf.copy()
    Ks = np.zeros((T, B.shape[1], A.shape[0]))
    for k in range(T - 2, -1, -1):
        qux = B.T @ Vxx @ A
        qxx = Q * dt + A.T @ Vxx @ A
        quu = R * dt + B.T @ Vxx @ B
        K = -np.linalg.solve(quu, qux)
        Vxx = qxx + qux.T @ K
        Vxx = 0.5 * (Vxx + Vxx.T)
        Ks[k] = K
    return Ks


def test_ilqr_equals_lqr_on_linear_system():
    """On linear dynamics with the quadratic cost one backward pass is the
    LQR recursion; float32 against float64 over 29 steps, as
    ``tests/test_ddp.py`` holds the JAX package (rtol 5e-4, atol 5e-5)."""
    Tl = 30
    A_c, B_c = _linear_system(1234)
    solver = DDPSolver(Linear(DT, A_c, B_c), DT, Tl, device="cpu")
    A = np.eye(7) + A_c.astype(np.float64) * DT
    B = B_c.astype(np.float64) * DT
    cfg = solver.cfg
    Ks_ref = lqr_gains_numpy(A, B, np.diag(cfg.Q_diag), np.diag(cfg.R_diag),
                             np.diag(cfg.Qf_diag), Tl, DT)
    big = np.full(2, 1e9, np.float32)
    res = solver.run({}, np.zeros(7, np.float32), np.zeros((Tl, 2)),
                     np.zeros((Tl, 7)), np.zeros((Tl, 2)), -big, big)
    np.testing.assert_allclose(res.feedback_gain.numpy(), Ks_ref,
                               rtol=5e-4, atol=5e-5)
    assert res.feedback_gain[-1].abs().max() == 0


@pytest.mark.parametrize("negate", [True, False])
def test_mlp_step_is_the_model_step(negate):
    """The DDP's nine-kernel MLP step against the model's own ``step``
    on random rows (NaN and a large yaw included): the same arithmetic up
    to the rounding of a fused bias, complex product or update."""
    model = NeuralNetDynamics(DT, negate_yaw_der=negate, device="cpu")
    params = model.init_params(4)
    solver = DDPSolver(model, DT, 40, device="cpu")
    rs = np.random.default_rng(7)
    XU = solver._rows(torch.zeros(7), torch.zeros(40, 2))
    XU[:, :7] = torch.tensor(rs.standard_normal((40, 7)) * [20, 20, 9, 0.3,
                                                             4, 1, 1])
    XU[:, 7:9] = torch.tensor(rs.uniform(-1, 1, (40, 2)))
    XU[5, 4] = float("nan")
    rows = XU.clone()
    step = solver._stepper(params)
    for t in range(39):
        step(XU, t)
        want = model.step(params, rows[t, :7], rows[t, 7:9])
        np.testing.assert_allclose(XU[t + 1, :7].numpy(), want.numpy(),
                                   rtol=1e-6, atol=1e-6, err_msg=str(t))
        XU[t + 1] = rows[t + 1]           # the next row's own inputs


# The BF step's tolerance: its basis functions are the model's up to the
# rounding of a reordered product (a divisor taken from theta, 0.45 (yd /
# u_x) for 0.45 yd / u_x), measured within 3.1e-7 of the sum of the terms'
# magnitudes; each state is held within 1e-6 of its own magnitude plus dt
# times those of its derivative's terms.
BF_STEP_REL = 1e-6
# theta rows 2-4 and 9-15 scaled by their divisors (and 14, 15 more), so
# that every basis function moves the step well above the tolerance
BF_ROW_SCALE = 10.0 * np.array(
    [{2: 1200.0, 3: 1.44e6, 4: 1.728e9, 9: 40.0, 10: 1400.0, 11: 1.96e6,
      12: 2.744e9, 13: 40.0, 14: 4.8e4, 15: 1.92e7}.get(i, 1.0)
     for i in range(25)], np.float32)


@pytest.mark.parametrize("strong", [False, True])
def test_bf_step_is_the_model_step(strong):
    """The DDP's fused BF step against the model's own ``step`` on rows on
    both sides of u_x = 0.1 (0.1 itself, just above it, reversing), with
    both signs of the front and rear slip proxies, a steering of 0 and
    near tan's range, for the seeded and a strong theta."""
    model = BasisFunctionDynamics(DT, device="cpu")
    params = model.init_params(5)
    if strong:
        params = model.params_from_jax({
            "theta": params["theta"].numpy() * BF_ROW_SCALE[:, None],
            "control_rngs": params["control_rngs"].numpy()})
    n = 64
    rs = np.random.default_rng(9)
    X = rs.standard_normal((n, 7)) * [20, 20, 3, 0.3, 3, 1, 1]
    X[:16, 4] = [0.1, np.nextafter(np.float32(0.1), np.float32(1)), 0.05,
                 -0.5, 0.0, 0.1000001, 0.0999999, -3.0] * 2
    X[16:24, 5] = [2.0, -2.0] * 4                 # both slip signs
    X[16:24, 6] = [1.5, 1.5, -1.5, -1.5] * 2
    X[16:24, 4] = [0.5, 0.5, 0.5, 0.5, 4.0, 4.0, 4.0, 4.0]
    Uc = rs.uniform(-0.99, 0.99, (n, 2))
    Uc[:4, 0] = [0.0, 0.98, -0.98, 1e-3]
    solver = DDPSolver(model, DT, n, device="cpu")
    XU = solver._rows(torch.zeros(7), torch.zeros(n, 2))
    XU[:, :7] = torch.tensor(X, dtype=torch.float32)
    XU[:, 7:9] = torch.tensor(Uc, dtype=torch.float32)
    rows = XU.clone()
    assert (rows[:, 4] > 0.1).any() and (rows[:, 4] <= 0.1).any()
    step = solver._stepper(params)
    for t in range(n - 1):
        step(XU, t)
        x, u = rows[t, :7], rows[t, 7:9]
        want = model.step(params, x, u)
        phi = car_basis_functions(x, u)
        terms = (phi[:, None] * params["theta"]).abs().sum(0)
        scale = x.abs() + DT * torch.cat([
            (x[4].abs() + x[5].abs()).expand(2), x[6].abs()[None], terms])
        err = (XU[t + 1, :7] - want).abs()
        assert (err <= BF_STEP_REL * scale).all(), (t, err, scale)
        XU[t + 1] = rows[t + 1]           # the next row's own inputs


def test_inv2x2_is_the_closed_form_inverse():
    rs = np.random.default_rng(2)
    sign = torch.tensor([[1.0, -1.0], [-1.0, 1.0]])
    for _ in range(20):
        m = rs.standard_normal((2, 2)).astype(np.float32)
        np.testing.assert_allclose(
            ddp_mod._inv2x2(torch.tensor(m), sign).numpy(),
            np.linalg.inv(m.astype(np.float64)), rtol=1e-4, atol=1e-5)
    # a strided view (quu inside a step's H) as the recursion passes it
    H = torch.tensor(rs.standard_normal((9, 10)).astype(np.float32))
    np.testing.assert_allclose(
        ddp_mod._inv2x2(H[7:, 8:], sign).numpy(),
        np.linalg.inv(H[7:, 8:].double().numpy()), rtol=1e-4, atol=1e-5)


class _FakeGraph:
    """Stands in for ``torch.cuda.CUDAGraph``: the capture records the call
    made inside it, and a replay makes that call again on the buffers it
    captured, writing into the outputs it returned then."""

    capturing = None

    def __init__(self):
        self.call = None

    def replay(self):
        fn, args, outputs = self.call
        for out, new in zip(outputs, fn(*args)):
            out.copy_(new)


class _FakeStream:
    def __init__(self, *a, **k):
        pass

    def wait_stream(self, other):
        pass


class _Context:
    def __init__(self, enter=None):
        self.enter = enter

    def __enter__(self):
        if self.enter:
            self.enter()

    def __exit__(self, *exc):
        _FakeGraph.capturing = None


def test_replay_reads_new_weights_and_returns_results_of_its_own(
        monkeypatch):
    """The captured run's bookkeeping: a replay copies the caller's params
    (a hot model update) and inputs into the buffers the graph read when it
    was captured, and returns copies, so that two controllers sharing one
    solver never share a result.  A stale weight buffer, or outputs
    returned without a copy, fail here."""
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "Stream", _FakeStream)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a: _FakeStream())
    monkeypatch.setattr(torch.cuda, "stream", lambda s: _Context())

    def graph(g):
        return _Context(lambda: setattr(_FakeGraph, "capturing", g))

    monkeypatch.setattr(torch.cuda, "graph", graph)
    jm, jp, tm, tp = _models("nn")
    solver = DDPSolver(tm, DT, T, device="cpu")
    run = solver._run

    def recorded(*args):
        out = run(*args)
        if _FakeGraph.capturing is not None:
            _FakeGraph.capturing.call = (run, args, out)
        return out

    solver._run = recorded
    x0, U, xt, ut = _problem()
    rngs = tp["control_rngs"]
    inputs = lambda *a: tuple(solver._tensor(v) for v in a)

    def replay(params, args):
        return solver._replay(solver._graph(None, params, args), params, args)

    first = replay(tp, inputs(x0, U, xt, ut, rngs[:, 0], rngs[:, 1]))
    eager = solver.run(tp, x0, U, xt, ut, rngs[:, 0], rngs[:, 1])
    _assert_result(first, eager, rtol=0, atol=0)

    # new weights (a hot update) and new inputs reach the captured buffers
    new_p = tm.update_model(tp, tm.layers, 1.1 * np.concatenate(
        [w.t().reshape(-1).numpy() for w in tp["weights"]]
        + [b.numpy() for b in tp["biases"]]))
    x1, U1, xt1, ut1 = _problem(seed=5)
    second = replay(new_p, inputs(x1, U1, xt1, ut1, rngs[:, 0], rngs[:, 1]))
    fresh = DDPSolver(tm, DT, T, device="cpu").run(
        new_p, x1, U1, xt1, ut1, rngs[:, 0], rngs[:, 1])
    _assert_result(second, fresh, rtol=0, atol=0)
    # the first result is its own: the second replay did not overwrite it
    _assert_result(first, eager, rtol=0, atol=0)
    assert not torch.equal(first.feedback_gain, second.feedback_gain)
    assert solver._captured[None].graph.call is not None


def test_captures_only_the_default_configuration_on_cuda():
    _, _, tm, _ = _models("nn")
    solvers = {cfg: DDPSolver(tm, DT, T, cfg, device="cpu") for cfg in (
        DDPConfig(), DDPConfig(num_iterations=3), DDPConfig(use_boxqp=True))}
    assert not any(s.captures for s in solvers.values())
    for cfg, s in solvers.items():
        s.device = torch.device("cuda", 0)
        assert s.captures == (cfg == DDPConfig())


def test_ddp_defaults_to_cuda_and_raises_without_gpu(monkeypatch):
    _, _, tm, _ = _models("nn")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no GPU"):
        DDPSolver(tm, DT, T)
    with pytest.raises(ValueError, match="model is on"):
        DDPSolver(tm, DT, T, device="meta")


# The box QP stops when the free gradient's norm is under tol, and calls
# itself converged under 1e-6.  At the solution that norm is float32
# rounding noise, whose last bits differ between XLA's products and LU and
# PyTorch's; with H's eigenvalues at least 2 the noise stays under 1e-6,
# so `converged` is the same on both sides.  At tol 1e-5, above the noise,
# every decision (active set, step, stop) is the same: iterations equal.
# At the default 1e-8 the last iterations compare noise with tol (each
# fails its line search or moves x by rounding), so their count may differ
# by up to two after the same active set is found.
BOXQP_ATOL = 1e-5          # the solution, float32 Newton steps


def _qp(seed):
    rs = np.random.default_rng(seed)
    n = int(rs.integers(2, 5))
    A = rs.standard_normal((n, n)).astype(np.float32)
    H = (A @ A.T + 2.0 * np.eye(n)).astype(np.float32)
    g = (rs.standard_normal(n) * 3).astype(np.float32)
    lo = (-np.abs(rs.standard_normal(n)) * 0.5).astype(np.float32)
    hi = (np.abs(rs.standard_normal(n)) * 0.5).astype(np.float32)
    return H, g, lo, hi


@pytest.mark.parametrize("tol", [1e-5, 1e-8])
def test_boxqp_matches_jax(tol):
    active = 0
    jboxqp = jax.jit(jax_boxqp, static_argnames=("tol",))
    for seed in range(60):
        H, g, lo, hi = _qp(seed)
        jr = jboxqp(jnp.asarray(H), jnp.asarray(g), jnp.asarray(lo),
                    jnp.asarray(hi), tol=tol)
        r = boxqp(torch.tensor(H), torch.tensor(g), torch.tensor(lo),
                  torch.tensor(hi), tol=tol)
        np.testing.assert_allclose(r.x.numpy(), np.asarray(jr.x), rtol=0,
                                   atol=BOXQP_ATOL, err_msg=str(seed))
        assert r.free.tolist() == np.asarray(jr.free).tolist(), seed
        assert r.converged == bool(jr.converged), seed
        if tol == 1e-5:
            assert r.iterations == int(jr.iterations), seed
        else:
            assert abs(r.iterations - int(jr.iterations)) <= 2, seed
        np.testing.assert_allclose(float(r.value), float(jr.value),
                                   rtol=1e-5, atol=1e-6)
        active += int((~r.free).sum())
    assert active > 100     # the bounds bind in most of the 60 problems
