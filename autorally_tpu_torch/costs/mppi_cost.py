"""MPPI running cost — all terms of the reference ``MPPICosts``
(port of ``autorally_tpu/costs/mppi_cost.py``; ``costs.cu:301-414``).

Every term maps over same-shaped tensors of single state/control
components, so callers can pass (K,) or (T, K) slices.  Conditional logic
(crash latch, slip kill) is masking, never branching.
"""

from __future__ import annotations

from typing import Tuple

import torch

from autorally_tpu_torch.config import CostParams
from autorally_tpu_torch.costs.costmap import Costmap

# Distance from the GPS receiver to the front/back of the car
# (costs.cuh:271-272).
FRONT_D = 0.5
BACK_D = -0.5

COST_CLAMP = 1.0e12


class MPPICost:
    """Batched MPPI cost.  ``l1_cost`` selects the L1 speed cost."""

    def __init__(self, l1_cost: bool = False):
        self.l1_cost = bool(l1_cost)

    def control_cost_c(self, p: CostParams, u0, u1, du0, du1, nu):
        """``getControlCost`` (costs.cu:307-313): ``u*`` are the clamped
        controls, ``du*`` the raw scaled noise."""
        return (p.steering_coeff * du0 * (u0 - du0) / (nu[0] * nu[0])
                + p.throttle_coeff * du1 * (u1 - du1) / (nu[1] * nu[1]))

    def speed_cost_c(self, p: CostParams, ux):
        """``getSpeedCost`` (costs.cu:315-326)."""
        err = ux - p.desired_speed
        return p.speed_coeff * (torch.abs(err) if self.l1_cost else err * err)

    @staticmethod
    def footprint_track_cost(costmap: Costmap, x, y, yaw) -> torch.Tensor:
        """Max of the front/back channel-0 samples at one vehicle footprint:
        the exact points the crash latch of :meth:`track_cost_c` tests
        (``getTrackCost``, costs.cu:359-393).  The degeneracy guard's
        position gate (``runtime/controller.py``) reads it, so that the
        gate cannot drift from the latch.  NaN coordinates sample texel
        (0, 0), as every lookup does."""
        c, s = torch.cos(yaw), torch.sin(yaw)
        pts = costmap.lookup_ch0(torch.stack([x + FRONT_D * c, x + BACK_D * c]),
                                 torch.stack([y + FRONT_D * s, y + BACK_D * s]))
        return torch.max(pts)

    def track_cost_c(self, p: CostParams, costmap: Costmap, x, y, yaw,
                     crash) -> Tuple[torch.Tensor, torch.Tensor]:
        """``getTrackCost`` (costs.cu:359-393): channel 0 sampled at the
        car's front and back; crossing the boundary latches ``crash``."""
        c, sn = torch.cos(yaw), torch.sin(yaw)
        both = costmap.lookup_ch0(
            torch.stack([x + FRONT_D * c, x + BACK_D * c]),
            torch.stack([y + FRONT_D * sn, y + BACK_D * sn]))
        front, back = both[0], both[1]
        track = (torch.abs(front) + torch.abs(back)) / 2.0
        track = torch.where(torch.abs(track) < p.track_slop,
                            torch.zeros_like(track), p.track_coeff * track)
        hit = (front >= p.boundary_threshold) | (back >= p.boundary_threshold)
        crash = torch.where(hit, torch.ones_like(crash), crash)
        return track, crash

    def stabilizing_cost_c(self, p: CostParams, ux, uy):
        """``getStabilizingCost`` (costs.cu:337-349): slip-angle penalty and
        trajectory kill above ``max_slip_ang``; 0 where |u_x| <= 0.001."""
        active = torch.abs(ux) > 0.001
        slip = -torch.atan(uy / torch.where(active, torch.abs(ux),
                                            torch.ones_like(ux)))
        cost = p.slip_penalty * slip * slip
        cost = cost + torch.where(torch.abs(slip) > p.max_slip_ang,
                                  p.crash_coeff, 0.0)
        return torch.where(active, cost, torch.zeros_like(cost))

    def crash_cost(self, p: CostParams, crash):
        """``getCrashCost`` (costs.cu:328-335)."""
        return torch.where(crash > 0, p.crash_coeff, 0.0)

    def get_crash(self, s, crash):
        """Roll-over latch on states (..., S), applied after each state
        update (``getCrash``, costs.cu:301-305)."""
        return torch.where(torch.abs(s[..., 3]) > 1.57,
                           torch.ones_like(crash), crash)

    def terminal_cost(self, s: torch.Tensor) -> torch.Tensor:
        """``terminalCost`` (costs.cu:411-414) — identically zero."""
        return torch.zeros(s.shape[:-1], dtype=torch.float32, device=s.device)

    @staticmethod
    def clamp_cost(c: torch.Tensor) -> torch.Tensor:
        """NaN / overflow clamp to 1e12 (costs.cu:405-407)."""
        return torch.where((c > COST_CLAMP) | torch.isnan(c),
                           torch.full_like(c, COST_CLAMP), c)
