"""Generalized-linear (basis function) dynamics (port of
``autorally_tpu/models/basis_function.py``; reference ``GeneralizedLinear<
CarBasisFuncs,7,2,25,CarKinematics,3>``, ``generalized_linear.cuh/.cu``,
``car_bfs.cuh``).

The derivative of [roll, u_x, u_y, yaw_der] is ``phi(s, u) @ theta`` with
the 25 hand-crafted car basis functions ``phi`` (``car_bfs.cuh:44-121``)
and theta (25, 4).  The ``u_x > 0.1`` branches are masks with safe
denominators, as in the JAX package.  The module holds its current theta
and ``control_rngs``; every dynamics method also takes a params dict in the
JAX package's layout (``{"theta", "control_rngs"}``).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from autorally_tpu_torch.models.base import Dynamics, Params

NUM_BFS = 25


def car_basis_functions(states: torch.Tensor,
                        controls: torch.Tensor) -> torch.Tensor:
    """All 25 basis functions: (..., S), (..., C) -> (..., 25), the rows of
    ``car_basis_functions`` of the JAX package (``arctan`` and ``tan``, as
    its scan path evaluates them)."""
    roll, ux, uy, yd = (states[..., i] for i in (3, 4, 5, 6))
    steer, thr = controls[..., 0], controls[..., 1]

    moving = ux > 0.1
    safe_ux = torch.where(moving, ux, torch.ones_like(ux))
    zero = torch.zeros_like(ux)
    cube = lambda v: v * v * v

    # atan(uy/ux + .45*yd/ux) - steer   (front slip proxy)
    front = torch.atan(uy / safe_ux + 0.45 * yd / safe_ux) - steer
    tan_front = torch.tan(torch.where(moving, front, -steer))
    abs_tf = torch.abs(tan_front)
    sin_st = torch.sin(steer)
    # rear slip proxy terms
    r13 = uy / safe_ux - 0.35 * yd / safe_ux

    phi = [
        thr,                                                       # 0
        ux / 10.0,                                                 # 1
        sin_st * tan_front / 1200.0,                               # 2
        sin_st * tan_front * abs_tf / 1440000.0,                   # 3
        sin_st * cube(tan_front) / 1728000000.0,                   # 4
        yd * uy / 25.0,                                            # 5
        yd / 10.0,                                                 # 6
        uy / 10.0,                                                 # 7
        sin_st,                                                    # 8
        torch.where(moving, uy / safe_ux / 40.0, zero),            # 9
        tan_front / 1400.0,                                        # 10
        tan_front * abs_tf / 1960000.0,                            # 11
        cube(tan_front) / 2744000000.0,                            # 12
        torch.where(moving, r13 / 40.0, zero),                     # 13
        torch.where(moving, r13 * torch.abs(r13) / 1600.0, zero),  # 14
        torch.where(moving, cube(r13) / 64000.0, zero),            # 15
        yd * ux / 50.0,                                            # 16
        roll,                                                      # 17
        roll * yd,                                                 # 18
        roll * ux / 3.0,                                           # 19
        roll * ux * yd / 5.0,                                      # 20
        ux * ux / 100.0,                                           # 21
        cube(ux) / 1000.0,                                         # 22
        thr * thr,                                                 # 23
        cube(thr),                                                 # 24
    ]
    return torch.stack(phi, dim=-1)


# The rows of car_basis_functions as products of a few primitives over a
# constant divisor, (factors, divisor) in row order: "sin" sin(steer), "tf"
# tan_front, "abs_tf" |tan_front|, and, zero unless u_x > 0.1, "q" uy/ux,
# "r13" the rear slip proxy and "abs_r13" its magnitude.  The DDP's fused
# BF step (``solver/ddp.py``) forms every row from these.
BF_PRODUCTS = (
    (("thr",), 1.0),                                   # 0
    (("ux",), 10.0),                                   # 1
    (("sin", "tf"), 1200.0),                           # 2
    (("sin", "tf", "abs_tf"), 1440000.0),              # 3
    (("sin", "tf", "tf", "tf"), 1728000000.0),         # 4
    (("yd", "uy"), 25.0),                              # 5
    (("yd",), 10.0),                                   # 6
    (("uy",), 10.0),                                   # 7
    (("sin",), 1.0),                                   # 8
    (("q",), 40.0),                                    # 9
    (("tf",), 1400.0),                                 # 10
    (("tf", "abs_tf"), 1960000.0),                     # 11
    (("tf", "tf", "tf"), 2744000000.0),                # 12
    (("r13",), 40.0),                                  # 13
    (("r13", "abs_r13"), 1600.0),                      # 14
    (("r13", "r13", "r13"), 64000.0),                  # 15
    (("yd", "ux"), 50.0),                              # 16
    (("roll",), 1.0),                                  # 17
    (("roll", "yd"), 1.0),                             # 18
    (("roll", "ux"), 3.0),                             # 19
    (("roll", "ux", "yd"), 5.0),                       # 20
    (("ux", "ux"), 100.0),                             # 21
    (("ux", "ux", "ux"), 1000.0),                      # 22
    (("thr", "thr"), 1.0),                             # 23
    (("thr", "thr", "thr"), 1.0),                      # 24
)


class BasisFunctionDynamics(Dynamics):
    """``phi(s, u) @ theta`` dynamics with theta (25, 4), stored transposed
    relative to the reference's (4, 25) ``W`` as in the JAX package."""

    def __init__(self, dt: float,
                 control_ranges=((-0.99, 0.99), (-0.99, 0.65)),
                 negate_yaw_der: bool = True, device=None):
        # CarKinematics (car_kinematics.cuh:47-52) always negates yaw_der.
        super().__init__(dt, negate_yaw_der, device)
        self._control_ranges = control_ranges
        self.theta = nn.Parameter(torch.zeros((NUM_BFS, self.DYNAMICS_DIM),
                                              device=self.device),
                                  requires_grad=False)
        self.register_buffer("control_rngs", self._tensor(control_ranges))

    def _tensor(self, a) -> torch.Tensor:
        return torch.tensor(np.asarray(a, dtype=np.float32),
                            device=self.device)

    def _hold(self, theta, control_rngs) -> Params:
        """Make the given theta (25, 4) and ranges the held ones and return
        them as a params dict."""
        self.theta = nn.Parameter(self._tensor(theta), requires_grad=False)
        self.control_rngs = self._tensor(control_rngs)
        return self.params()

    def params(self) -> Params:
        """The held weights as a params dict (shares their storage)."""
        return {"theta": self.theta, "control_rngs": self.control_rngs}

    # -- parameters ---------------------------------------------------------

    def init_params(self, seed: int) -> Params:
        """theta ~ N(0, 0.01^2) from a numpy seed (the JAX package's scale)."""
        rng = np.random.default_rng(seed)
        return self._hold(
            0.01 * rng.standard_normal((NUM_BFS, self.DYNAMICS_DIM)),
            self._control_ranges)

    def params_from_jax(self, params_np) -> Params:
        """Carry the JAX package's params over, given as numpy arrays
        ``{"theta": (25, 4), "control_rngs": (C, 2)}``."""
        return self._hold(params_np["theta"], params_np["control_rngs"])

    def load_params(self, path: str) -> Params:
        """Load ``W`` (4, 25) float64 from the reference ``.npz``
        (``generalized_linear.cu:92-108``)."""
        W = np.asarray(np.load(path)["W"], dtype=np.float32)
        W = W.reshape(self.DYNAMICS_DIM, NUM_BFS)
        return self._hold(W.T, self._control_ranges)

    def save_params(self, params: Params, path: str) -> None:
        """Export to the reference ``.npz`` layout: ``W`` (4, 25) float64."""
        np.savez(path, W=params["theta"].detach().cpu().double().numpy().T)

    @property
    def num_params(self) -> int:
        return NUM_BFS * self.DYNAMICS_DIM

    # -- in-kernel form (ops/rollout_kernel.py) ------------------------------

    KERNEL_KIND = "bf"

    def kernel_weights(self, params: Params) -> list:
        """One (4, 25) theta panel, the layout of the JAX package's kernels
        and of the CUDA kernels' weight buffer."""
        return [params["theta"].t()]

    # -- forward ------------------------------------------------------------

    def dynamics(self, params: Params, states: torch.Tensor,
                 controls: torch.Tensor) -> torch.Tensor:
        """``phi @ theta`` in full fp32 (the package switches TF32 off)."""
        return car_basis_functions(states, controls) @ params["theta"]
