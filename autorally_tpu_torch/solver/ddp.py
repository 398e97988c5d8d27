"""iLQR/DDP feedback-gain solver (port of ``autorally_tpu/solver/ddp.py``;
reference ``DDP::run``, ``autorally_control/include/autorally_control/ddp/
ddp.h:50-157``, with ``ddp_model_wrapper.h`` and ``ddp_tracking_costs.h``).

The Jacobians are ``torch.func.jacfwd`` of the model's own ``state_deriv``
at every step of the horizon at once.  The rules are the JAX
package's, and through it the reference's:

- discrete Jacobians ``A = I + df*dt``, ``B = dfu*dt`` (ddp.h:72-73);
- a quadratic tracking running cost around the MPPI solution with
  Q = diag(0.5, 0.5, 0.25, 0, 0.05, 0.01, 0.01), R = diag(10, 10) and
  Qf = 0 (``mppi_controller.cu:410-417``); the terminal values come from the
  last target;
- the initial rollout clamps controls 0..T-3 only (ddp.h:57-64); the
  line-search forward pass clamps all of them (ddp.h:127-134);
- the backward recursion runs k = T-2..0 and the gains at T-1 stay zero;
  ``Vxx`` is symmetrized at every step (ddp.h:88-117); for C = 2 the
  ``quu`` solve is the closed-form 2x2 inverse (:func:`_inv2x2`), not LDLT;
- the running cost is summed for t < T-1, plus the terminal term;
- iteration 0 always accepts (ddp.h:119-151), which is the launch default
  ``num_iters = 1`` exactly.  When the line search exhausts its alphas
  (``alpha < min_alpha``) without improving on the previous iteration, the
  previous trajectory is kept: the reference "accepts" the alpha ~ 0
  forward pass there (ddp.h:136-143), and with dx(0) = 0 a zero-alpha
  rollout is the previous trajectory, so keeping it is the same fixed point
  without a near-zero step's rounding.  The accepted cost never increases;
- ``use_boxqp`` solves a box QP per step for the feedforward step against
  the control limits and keeps feedback only on its free set
  (control-limited DDP; the reference ships BoxQP but never calls it).

The recursion is a few small products a step, so on the GPU a run is
thousands of tiny kernels and the host's launches would set its pace.  So
:meth:`DDPSolver.run` dispatches by configuration: on a CUDA device with
the default ``num_iterations=1``, ``use_boxqp=False`` and two controls, the
whole run (initial rollout, Jacobians, backward and forward pass; at
iteration 0 the line search runs once, at alpha 1) is captured once per
CUDA stream as a ``torch.cuda.CUDAGraph`` and each call replays it, one
launch from the host.  Every other configuration, and every CPU run, runs
the same code eagerly.  A replay copies the caller's model params and
inputs into the buffers the graph captured, so a hot model update reaches
it, and returns copies of the graph's outputs, so that two controllers
sharing one solver never share a result.  The MLP's and the BF model's
rollouts take a fused Euler step (:meth:`DDPSolver._stepper`) of fewer
kernels than the model's ``step`` (9 and 17 against 22 and about 60),
since every kernel is a graph node.
"""

from __future__ import annotations

import dataclasses
import gc
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from autorally_tpu_torch.config import resolve_device
from autorally_tpu_torch.models.basis_function import (BF_PRODUCTS,
                                                       BasisFunctionDynamics)
from autorally_tpu_torch.models.neural_net import NeuralNetDynamics
from autorally_tpu_torch.solver.boxqp import boxqp


# The fused BF step's columns of a rollout row (:meth:`DDPSolver._rows`):
# the row's states, controls and 1, then its scratch: 10-11 the front and
# rear slip proxies (atan taken of the front's), 12-13 [uy, yd] / u_x,
# 14-16 [atan(front), r13, q] masked by u_x > 0.1, 17 tan_front, 18-20 the
# magnitudes of [r13, q, tan_front], 21 sin(steer).  The width stays even.
BF_COLUMNS = {"roll": 3, "ux": 4, "uy": 5, "yd": 6, "thr": 8, "one": 9,
              "r13": 15, "q": 16, "tf": 17, "abs_r13": 18, "abs_tf": 20,
              "sin": 21}
BF_SCRATCH = 12
# factors a basis function (BF_PRODUCTS' longest row)
BF_FACTORS = 4


class DDPResult(NamedTuple):
    """Per-timestep gains, mirroring ``OptimizerResult`` (result.h:10-68)."""

    feedback_gain: torch.Tensor    # (T, C, S)
    feedforward: torch.Tensor      # (T, C)
    state_traj: torch.Tensor       # (T, S)
    control_traj: torch.Tensor     # (T, C)
    cost: torch.Tensor             # scalar total cost


@dataclasses.dataclass(frozen=True)
class DDPConfig:
    num_iterations: int = 1
    # Reference weights (mppi_controller.cu:410-417).
    Q_diag: Tuple[float, ...] = (0.5, 0.5, 0.25, 0.0, 0.05, 0.01, 0.01)
    R_diag: Tuple[float, ...] = (10.0, 10.0)
    Qf_diag: Tuple[float, ...] = (0.0,) * 7
    min_alpha: float = 1e-4
    # Solve the feedforward step as a box QP against the control limits
    # and zero clamped feedback rows (control-limited DDP).  Off by
    # default: the reference instantiates BoxQP but never invokes it.
    use_boxqp: bool = False


def _inv2x2(m: torch.Tensor, sign: torch.Tensor) -> torch.Tensor:
    """Closed-form 2x2 inverse (replaces the reference's LDLT for C=2): the
    adjugate [[m11, -m01], [-m10, m00]] (``m`` turned half a turn and
    transposed, times ``sign`` = [[1, -1], [-1, 1]]) over the determinant
    m00 m11 - m01 m10, read off the diagonal of ``m`` times the adjugate.
    Four tensor operations, none of which reads the host."""
    adj = torch.flip(m, (0, 1)).t() * sign
    return adj / torch.mm(m, adj)[0, 0]


def _tree_map(fn, tree):
    """``fn`` on every tensor of a params tree of dicts and lists."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _leaves(tree) -> list:
    out = []
    _tree_map(out.append, tree)
    return out


class _Captured(NamedTuple):
    """A captured run: its graph, the buffers it reads and writes, and the
    shapes of the params and inputs it was captured for."""

    graph: Any
    params: list
    inputs: tuple
    outputs: DDPResult
    shapes: tuple


class DDPSolver:
    """Feedback-gain solver for tube-MPPI tracking (``computeFeedbackGains``,
    mppi_controller.cu:427-439) on one device (``cuda`` unless ``device``
    says otherwise)."""

    def __init__(self, model, dt: float, num_timesteps: int,
                 cfg: DDPConfig = DDPConfig(), device=None):
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model is on {model.device}, DDP solver on "
                             f"{self.device}")
        self.model = model
        self.dt = float(dt)
        self.T = int(num_timesteps)
        if self.T < 2:
            raise ValueError(f"the DDP needs T >= 2, got {self.T}")
        self.cfg = cfg
        S, C = model.STATE_DIM, model.CONTROL_DIM
        f32 = dict(dtype=torch.float32, device=self.device)
        self.Q = torch.diag(torch.tensor(cfg.Q_diag, **f32))
        self.R = torch.diag(torch.tensor(cfg.R_diag, **f32))
        self.Qf = torch.diag(torch.tensor(cfg.Qf_diag, **f32))
        self._eye = torch.eye(S, **f32)
        self._zero_x = torch.zeros(S, **f32)
        self._zero_u = torch.zeros(C, **f32)
        self._one = torch.ones((), **f32)
        self._zero = torch.zeros((), **f32)
        self._adj_sign = torch.tensor([[1.0, -1.0], [-1.0, 1.0]], **f32)
        self._captured: Dict[Optional[int], _Captured] = {}
        self._row_width = S + C + 1
        if type(model) is BasisFunctionDynamics:
            # the BF step's tables, made here: a capture cannot copy from
            # the host
            self._row_width += BF_SCRATCH
            self._bf_tables = (
                torch.tensor([[BF_COLUMNS[f] for f in names]
                              + [BF_COLUMNS["one"]] * (BF_FACTORS - len(names))
                              for names, _ in BF_PRODUCTS],
                             device=self.device).reshape(-1),
                torch.tensor([d for _, d in BF_PRODUCTS], **f32),
                torch.tensor([0.45, -0.35], **f32))

    @property
    def captures(self) -> bool:
        """Whether :meth:`run` replays a CUDA graph: on a CUDA device for
        the default configuration (one iteration, no box QP) and two
        controls; everything else runs eagerly."""
        return (self.device.type == "cuda" and self.cfg.num_iterations == 1
                and not self.cfg.use_boxqp and self.model.CONTROL_DIM == 2)

    # -- cost pieces (TrackingCostDDP, ddp_tracking_costs.h:38-52) ----------

    def _trajectory_cost(self, xs, us, x_targets, u_targets) -> torch.Tensor:
        """Running cost ``(dx Q dx + du R du) dt`` summed over t < T-1,
        plus the terminal ``dx Qf dx`` at T-1 (ddp.h:135)."""
        dx = xs - x_targets
        du = us - u_targets
        c = ((dx @ self.Q) * dx).sum(1) + ((du @ self.R) * du).sum(1)
        return (c[:-1] * self.dt).sum() + (dx[-1] @ self.Qf) @ dx[-1]

    # -- core ----------------------------------------------------------------

    def _rows(self, x0, us) -> torch.Tensor:
        """The rollouts' buffer: row t is [x_t, u_t, 1] (T, S+C+1), x_0 and
        the controls ``us`` (T, C) filled in, then the BF step's scratch
        columns (``BF_COLUMNS``) for the BF model.  The 1 is the MLP step's
        bias input; every row's offset stays even, so that (u_x, u_y) can
        be read as one complex number (:meth:`_stepper`)."""
        S, C = self.model.STATE_DIM, self.model.CONTROL_DIM
        XU = torch.ones((self.T, self._row_width), dtype=torch.float32,
                        device=self.device)
        XU[0, :S] = x0
        XU[:, S:S + C] = us
        return XU

    def _stepper(self, params):
        """``step(XU, t)``: XU[t+1, :S] <- the Euler step ``x + f(x, u) dt``
        from row t.  A model other than the MLP and the BF model takes its
        own ``step``.

        The MLP's and the BF model's steps are written in few kernels (a
        run is thousands of tiny kernels, each a graph node): the learned
        derivative (:meth:`_mlp_derivative`, :meth:`_bf_derivative`) into
        D[3:], the kinematics (c u_x - s u_y, s u_x + c u_y) as one complex
        product e^(i yaw) (u_x + i u_y), and one fused update.  The same
        arithmetic as the model's ``step`` up to the rounding of a fused
        bias, product or update."""
        model, dt = self.model, self.dt
        S, C = model.STATE_DIM, model.CONTROL_DIM
        if type(model) not in (NeuralNetDynamics, BasisFunctionDynamics):
            def step(XU, t):
                XU[t + 1, :S] = model.step(params, XU[t, :S],
                                           XU[t, S:S + C])
            return step
        D = torch.empty(S + 1, dtype=torch.float32, device=self.device)
        derivative = (self._mlp_derivative if type(model) is NeuralNetDynamics
                      else self._bf_derivative)(params, D[3:S])

        def step(XU, t):
            derivative(XU[t])
            torch.mul(torch.polar(self._one, XU[t, 2]),
                      torch.view_as_complex(XU[t, 4:6]),
                      out=torch.view_as_complex(D[0:2]))
            if model.negate_yaw_der:
                torch.neg(XU[t, 6], out=D[2])
            else:
                D[2] = XU[t, 6]
            torch.add(XU[t, :S], D[:S], alpha=dt, out=XU[t + 1, :S])
        return step

    def _mlp_derivative(self, params, out):
        """``derivative(row)``: the MLP's [roll, u_x, u_y, yaw rate]
        derivative of a row into ``out`` in five kernels (the whole step in
        nine, where the model's ``step`` takes 22): each layer one product
        with its bias as the last column (the input ends in a 1: the row's
        [roll, u_x, u_y, yaw rate, steering, throttle, 1] for the first
        layer), tanh written into a buffer that ends in a 1."""
        S, C = self.model.STATE_DIM, self.model.CONTROL_DIM
        layers = [torch.cat([W.t(), b[:, None]], dim=1)
                  for W, b in zip(params["weights"], params["biases"])]
        hidden = [torch.ones(w.shape[0] + 1, dtype=torch.float32,
                             device=self.device) for w in layers[:-1]]

        def derivative(row):
            h = row[3:S + C + 1]
            for w, buf in zip(layers, hidden):
                torch.tanh(torch.mv(w, h), out=buf[:-1])
                h = buf
            torch.mv(layers[-1], h, out=out)
        return derivative

    def _bf_derivative(self, params, out):
        """``derivative(row)``: the BF model's ``phi @ theta`` of a row into
        ``out`` in 13 kernels (the whole step in 17, where the model's
        ``step`` takes about 60): the primitives of ``BF_PRODUCTS`` written
        into the row's scratch columns (``BF_COLUMNS``) by a few vector
        operations, the 25 basis functions as one gather of four factors a
        function (padded with the row's 1) and their product, and one
        product with theta^T over the divisors (4, 25).  The same functions
        up to the rounding of a reordered product: a quotient by a divisor
        is taken from theta, and 0.45 yd / u_x as 0.45 (yd / u_x)."""
        factors, divisors, slip = self._bf_tables
        W = (params["theta"] / divisors[:, None]).t().contiguous()
        n = len(BF_PRODUCTS)

        def derivative(row):
            moving = torch.gt(row[4], 0.1)
            # [uy, yd] / u_x (1 where u_x <= 0.1); the front and rear slip
            # proxies uy/u_x + (0.45, -0.35) yd/u_x, atan of the front's
            torch.div(row[5:7], torch.where(moving, row[4], self._one),
                      out=row[12:14])
            torch.addcmul(row[12], row[13], slip, out=row[10:12])
            row[10].atan_()
            # [atan(front), r13, q], each 0 where u_x <= 0.1; tan_front =
            # tan(atan(front) - steer)
            torch.where(moving, row[10:13], self._zero, out=row[14:17])
            torch.tan(row[14] - row[7], out=row[17])
            torch.abs(row[15:18], out=row[18:21])
            torch.sin(row[7], out=row[21])
            phi = torch.index_select(row, 0, factors).view(n, -1).prod(1)
            torch.mv(W, phi, out=out)
        return derivative

    def _backward(self, params, xs, us, x_targets, u_targets, u_min,
                  u_max) -> torch.Tensor:
        """The backward recursion around (xs, us): the gains [K | l]
        (T, C, S+1), zero at T-1.

        A step is written in as few tensor operations as it takes.  The
        value function travels as V = [Vxx | Vx] (S, S+1), and one step's
        Q-function as H = [[qxx, qx, qxu], [qux, qu, quu]] (S+C, S+1+C) =
        [A B]^T V E_k + F_k, where E_k = [[A, 0, B], [0, 1, 0]] and F_k =
        [[Q dt, Lx dt, 0], [0, Lu dt, R dt]] are formed for every k at
        once: two products, P = [A B]^T V written into [P | I] and H =
        [P | I] [E_k; F_k].  Then [K | l] = -quu^-1 [qux | qu] and V <-
        [qxx | qx] + qux^T [K | l], Vxx symmetrized."""
        model, dt, T, cfg = self.model, self.dt, self.T, self.cfg
        S, C = model.STATE_DIM, model.CONTROL_DIM
        # Jacobians at every step at once: the derivative of the batched
        # state_deriv at (xs + dx, us + du) in a (dx, du) shared by all
        # rows, each row depending on its own state and control alone.
        # (One level of forward mode: jacfwd under vmap turns the tangents
        # of an operation with a Python float, the BF model's, to float64.)
        dfx, dfu = torch.func.jacfwd(
            lambda dx, du: model.state_deriv(params, xs[:-1] + dx,
                                             us[:-1] + du),
            argnums=(0, 1))(self._zero_x, self._zero_u)  # (T-1,S,S), (T-1,S,C)
        A = self._eye + dfx * dt                        # Phi (ddp.h:72-73)
        B = dfu * dt
        ABt = torch.cat([A, B], dim=2).transpose(1, 2).contiguous()
        EF = torch.zeros((T - 1, 2 * S + 1 + C, S + 1 + C),
                         dtype=torch.float32, device=self.device)
        E, F = EF[:, :S + 1], EF[:, S + 1:]
        E[:, :S, :S] = A
        E[:, S, S] = 1.0
        E[:, :S, S + 1:] = B
        F[:, :S, :S] = self.Q * dt
        F[:, S:, S + 1:] = self.R * dt
        # dL (ddp_tracking_costs.h:45-48)
        F[:, :S, S] = ((xs[:-1] - x_targets[:-1]) @ self.Q) * dt
        F[:, S:, S] = ((us[:-1] - u_targets[:-1]) @ self.R) * dt

        # terminal boundary (ddp.h:81-85); xf = the last target
        # (mppi_controller.cu:437)
        V = torch.cat([self.Qf, (self.Qf @ (xs[-1] - x_targets[-1]))[:, None]],
                      dim=1)
        KL = torch.zeros((T, C, S + 1), dtype=torch.float32,
                         device=self.device)
        PI = torch.zeros((S + C, 2 * S + 1 + C), dtype=torch.float32,
                         device=self.device)
        PI[:, S + 1:] = torch.eye(S + C, dtype=torch.float32,
                                  device=self.device)
        for k in range(T - 2, -1, -1):                  # ddp.h:88
            torch.mm(ABt[k], V, out=PI[:, :S + 1])
            H = torch.mm(PI, EF[k])
            G = H[S:, :S + 1]                           # [qux | qu]
            quu = H[S:, S + 1:]
            if cfg.use_boxqp:
                # control-limited step: feedforward from the box QP in
                # delta-u coordinates, feedback only on the free set
                res = boxqp(quu, G[:, S], u_min - us[k], u_max - us[k])
                fmask = res.free.to(quu.dtype)
                quu_f = (quu * fmask[:, None] * fmask[None, :]
                         + torch.diag(1.0 - fmask))
                KL[k, :, :S] = -torch.linalg.solve(quu_f,
                                                   G[:, :S] * fmask[:, None])
                KL[k, :, S] = res.x
            else:
                inv = (_inv2x2(quu, self._adj_sign) if C == 2
                       else torch.linalg.inv(quu))
                torch.addmm(KL[k], inv, G, beta=0, alpha=-1, out=KL[k])
            V = torch.addmm(H[:S, :S + 1], G[:, :S].t(), KL[k])
            Vxx = V[:, :S]
            torch.mul(Vxx + Vxx.t(), 0.5, out=Vxx)
        return KL

    def _forward(self, step, xs, us, KL, alpha: float, x_targets,
                 u_targets, u_min, u_max):
        """The forward pass at step ``alpha``: (xs, us, cost).  Each step's
        control is one product: [K | u_ref + alpha l] [x - x_ref; 1]."""
        S, C = self.model.STATE_DIM, self.model.CONTROL_DIM
        KU = KL.clone()
        KU[:, :, S] = us + alpha * KL[:, :, S]
        XU = self._rows(xs[0], 0.0)
        dx = torch.ones(S + 1, dtype=torch.float32, device=self.device)
        for t in range(self.T):
            torch.sub(XU[t, :S], xs[t], out=dx[:S])
            torch.clamp(torch.mv(KU[t], dx), u_min, u_max,
                        out=XU[t, S:S + C])
            if t < self.T - 1:
                step(XU, t)
        xn, un = XU[:, :S], XU[:, S:S + C]
        return xn, un, self._trajectory_cost(xn, un, x_targets, u_targets)

    def _run(self, params, x0, U, x_targets, u_targets, u_min,
             u_max) -> DDPResult:
        T, S, C = self.T, self.model.STATE_DIM, self.model.CONTROL_DIM
        step = self._stepper(params)
        XU = self._rows(x0, U)
        # the initial rollout clamps controls 0..T-3 only
        torch.clamp(U[:T - 2], u_min, u_max, out=XU[:T - 2, S:S + C])
        for t in range(T - 1):
            step(XU, t)
        xs, us = XU[:, :S], XU[:, S:S + C]
        prev_cost = None
        for it in range(self.cfg.num_iterations):
            KL = self._backward(params, xs, us, x_targets, u_targets, u_min,
                                u_max)
            alpha = 1.0
            while True:
                xn, un, cost = self._forward(step, xs, us, KL, alpha,
                                             x_targets, u_targets, u_min,
                                             u_max)
                if it == 0 or bool(cost <= prev_cost):
                    break
                if alpha < self.cfg.min_alpha:
                    # exhausted without improvement: keep the previous
                    # trajectory (the reference's alpha -> 0 accept, exact)
                    xn, un, cost = xs, us, prev_cost
                    break
                alpha *= 0.5
            xs, us, prev_cost = xn, un, cost
        return DDPResult(feedback_gain=KL[:, :, :S].contiguous(),
                         feedforward=KL[:, :, S].contiguous(),
                         state_traj=xs.contiguous(),
                         control_traj=us.contiguous(), cost=cost)

    # -- the captured run ---------------------------------------------------

    def _capture(self, params, inputs) -> _Captured:
        """Capture :meth:`_run` on copies of ``params`` and ``inputs`` after
        a warm-up on a side stream (cuBLAS and the caching allocator set up
        there, outside the capture), with Python's cyclic collector off."""
        fresh = lambda t: t.detach().to(self.device, torch.float32).clone(
            memory_format=torch.contiguous_format)
        static_params = _tree_map(fresh, params)
        static_inputs = tuple(fresh(t) for t in inputs)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            self._run(static_params, *static_inputs)
        torch.cuda.current_stream(self.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        # garbage that holds another graph must not be collected during
        # the capture: destroying a graph then invalidates the capture
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph):
                outputs = self._run(static_params, *static_inputs)
        finally:
            if collecting:
                gc.enable()
        return _Captured(graph, _leaves(static_params), static_inputs,
                         outputs, self._shapes(params, inputs))

    @staticmethod
    def _shapes(params, inputs) -> tuple:
        return (tuple(tuple(t.shape) for t in _leaves(params)),
                tuple(tuple(t.shape) for t in inputs))

    def _graph(self, key, params, inputs) -> _Captured:
        """The graph captured for the stream ``key`` (each stream its own
        graph and buffers, so that runs on two streams overlap), captured
        on the current stream first if need be."""
        cap = self._captured.get(key)
        if cap is None or cap.shapes != self._shapes(params, inputs):
            cap = self._captured[key] = self._capture(params, inputs)
        return cap

    def _replay(self, cap: _Captured, params, inputs) -> DDPResult:
        """Replay ``cap`` on the current stream on ``params`` and
        ``inputs``; copies of its outputs."""
        for dst, src in zip(cap.params, _leaves(params)):
            dst.copy_(src)
        for dst, src in zip(cap.inputs, inputs):
            dst.copy_(src)
        cap.graph.replay()
        return DDPResult(*(t.clone() for t in cap.outputs))

    def _tensor(self, a) -> torch.Tensor:
        if torch.is_tensor(a):
            return a.to(self.device, torch.float32)
        return torch.tensor(np.asarray(a, dtype=np.float32),
                            device=self.device)

    def run(self, model_params, x0, U, x_targets, u_targets, u_min,
            u_max, eager: bool = False, stream=None) -> DDPResult:
        """Tracking feedback gains around the MPPI solution.

        Arguments mirror ``computeFeedbackGains`` (mppi_controller.cu:
        427-439): ``x0`` (S,), ``U`` (T, C), the targets are the nominal
        state (T, S) and control (T, C) solutions, ``u_min``/``u_max`` (C,)
        the control limits; arrays or tensors.  Replays the captured graph
        where :attr:`captures` says so, unless ``eager``.

        With a CUDA ``stream`` the run is enqueued there, after that stream
        waits for the current one, and returns at once: its result is
        ready on ``stream``, and a consumer on another stream waits for it
        first (``Controller`` does).  The tube's two controllers run their
        DDP on their own streams, so that the two runs overlap."""
        inputs = tuple(self._tensor(a) for a in (x0, U, x_targets,
                                                 u_targets, u_min, u_max))
        graph = self.captures and not eager
        if stream is None:
            if not graph:
                return self._run(model_params, *inputs)
            key = (torch.cuda.current_stream(self.device).cuda_stream
                   if self.device.type == "cuda" else None)
            return self._replay(self._graph(key, model_params, inputs),
                                model_params, inputs)
        cap = (self._graph(stream.cuda_stream, model_params, inputs)
               if graph else None)
        current = torch.cuda.current_stream(self.device)
        stream.wait_stream(current)
        # the caching allocator reuses a block once its stream is done with
        # it: mark the inputs read on `stream`, the results on `current`
        for t in (*inputs, *_leaves(model_params)):
            t.record_stream(stream)
        with torch.cuda.stream(stream):
            res = (self._replay(cap, model_params, inputs) if graph
                   else self._run(model_params, *inputs))
        for t in res:
            t.record_stream(current)
        return res
