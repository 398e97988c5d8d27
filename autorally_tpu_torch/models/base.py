"""Dynamics-model interface (PyTorch port of ``autorally_tpu/models/base.py``).

Every method is batched over rollouts: a model maps ``(params, states
(..., S), controls (..., C))`` to derivatives.  State layout (identical to
the reference, ``neural_net_model.cuh:54-62``)::

    s = [x, y, yaw, roll, u_x, u_y, yaw_der]        (STATE_DIM = 7)
    u = [steering, throttle]                        (CONTROL_DIM = 2)

The first ``KINEMATICS_DIM = 3`` states evolve by closed-form kinematics,
the trailing ``DYNAMICS_DIM`` states by the learned model.  Parameters
travel as a dict of tensors with the JAX package's pytree layout, so every
method takes them explicitly, as there.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch
from torch import nn

from autorally_tpu_torch.config import resolve_device

Params = Any


class Dynamics(nn.Module):
    """Base class for batched dynamics models."""

    STATE_DIM: int = 7
    CONTROL_DIM: int = 2
    KINEMATICS_DIM: int = 3

    def __init__(self, dt: float, negate_yaw_der: bool = True, device=None):
        super().__init__()
        self.dt = float(dt)
        # The reference pose pipeline reports the negative yaw derivative;
        # the provided models were trained against it
        # (neural_net_model.cu:352-354, launch param negate_yaw_der).
        self.negate_yaw_der = bool(negate_yaw_der)
        self.device = resolve_device(device)

    @property
    def DYNAMICS_DIM(self) -> int:
        return self.STATE_DIM - self.KINEMATICS_DIM

    def kernel_weights(self, params: Params) -> list:
        raise NotImplementedError

    def dynamics(self, params: Params, states: torch.Tensor,
                 controls: torch.Tensor) -> torch.Tensor:
        """Learned derivative of the trailing DYNAMICS_DIM states."""
        raise NotImplementedError

    def kinematics(self, states: torch.Tensor) -> torch.Tensor:
        """Closed-form kinematic derivative for [x, y, yaw]
        (``neural_net_model.cu:347-355``): (..., S) -> (..., 3)."""
        yaw = states[..., 2]
        u_x = states[..., 4]
        u_y = states[..., 5]
        yaw_der = states[..., 6]
        c, s = torch.cos(yaw), torch.sin(yaw)
        dx = c * u_x - s * u_y
        dy = s * u_x + c * u_y
        dyaw = -yaw_der if self.negate_yaw_der else yaw_der
        return torch.stack([dx, dy, dyaw], dim=-1)

    def state_deriv(self, params: Params, states: torch.Tensor,
                    controls: torch.Tensor) -> torch.Tensor:
        """Full (..., S) state derivative (``computeStateDeriv``)."""
        return torch.cat([self.kinematics(states),
                          self.dynamics(params, states, controls)], dim=-1)

    def enforce_constraints(self, params: Params,
                            controls: torch.Tensor) -> torch.Tensor:
        """Clamp controls to ``params["control_rngs"]`` (C, 2)."""
        rngs = params["control_rngs"]
        return torch.clamp(controls, rngs[:, 0], rngs[:, 1])

    def step(self, params: Params, states: torch.Tensor,
             controls: torch.Tensor) -> torch.Tensor:
        """One Euler step ``s + ds*dt`` (``neural_net_model.cu:334-344``).
        Controls must be pre-clamped."""
        return states + self.state_deriv(params, states, controls) * self.dt

    def update_state(self, params: Params, states: torch.Tensor,
                     controls: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Clamp + integrate; returns (next_state, clamped_control)
        (``updateState``, ``neural_net_model.cu:280-288``)."""
        u = self.enforce_constraints(params, controls)
        return self.step(params, states, u), u
