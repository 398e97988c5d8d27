"""ESS-targeted softmax-temperature tuning (port of
``autorally_tpu/runtime/ess_tuner.py``).

MPPI's importance-sampled update degrades at both temperature extremes:
too high a ``gamma`` collapses the effective sample size (a handful of
rollouts carry all the weight), too low a one flattens the weights toward
a plain average.  The reference pins gamma at launch
(``path_integral_nn.launch``: 0.15).  :class:`EssTuner` is a host-side
multiplicative controller on the measured effective sample size: after
each solve,

    gamma <- gamma * (max(ess, 1) / ess_target)^alpha,   clamped to
    [base/headroom, base*headroom]

so an ESS below target lowers the temperature and raises the ESS, and the
other way round.  The new gamma reaches the solves through
``CostParams.gamma`` (``config.effective_gamma``), which the softmax reads
as a scalar: a Python float on the host loop, a 0-d tensor in the captured
episode (:func:`gamma_step_traced`, ``runtime/episode.py``).

Usage::

    tuner = EssTuner(cfg, target_frac=0.25)
    ...each tick, after reading SolveStats...
    cp = cp.replace(gamma=tuner.update(float(stats.ess)))
    plant.push_cost_params(cp)
"""

from __future__ import annotations

import math

import numpy as np
import torch


def gamma_step_traced(gamma: torch.Tensor, ess: torch.Tensor, target,
                      alpha, lo, hi) -> torch.Tensor:
    """One multiplicative ESS -> gamma step on 0-d tensors, on their device
    and without reading the host: the same law as :meth:`EssTuner.update`,
    for the captured episode (``runtime/episode.py``).  ``lo`` and ``hi``
    are floats or 0-d tensors.  A non-finite ESS sample or result keeps
    gamma (an inf would otherwise land on the upper clamp rather than be
    ignored as the host tuner ignores it)."""
    step = (torch.clamp(ess, min=1.0) / target) ** alpha
    g = torch.clamp(gamma * step, lo, hi)
    return torch.where(torch.isfinite(ess) & torch.isfinite(g), g, gamma)


class EssTuner:
    """Multiplicative ESS -> temperature controller (a host-side scalar)."""

    def __init__(self, cfg, target_frac: float = 0.25, alpha: float = 0.25,
                 headroom: float = 8.0):
        """``target_frac``: the desired ESS as a fraction of K.  ``alpha``:
        the adaptation gain a solve (0.25 converges in a few ticks without
        oscillating through the plant's closed loop).  ``headroom``: the
        multiplicative clamp around the configured gamma, so that a
        transient ESS excursion cannot turn the solver into argmin
        following (gamma -> inf) or plain averaging (gamma -> 0)."""
        if not (0.0 < target_frac <= 1.0):
            raise ValueError(f"target_frac in (0, 1]: {target_frac}")
        self.base = float(cfg.gamma)
        self.target = float(target_frac) * float(cfg.num_rollouts)
        self.alpha = float(alpha)
        self.lo = self.base / float(headroom)
        self.hi = self.base * float(headroom)
        self.gamma = self.base

    def update(self, ess: float) -> float:
        """One adaptation step from the latest solve's measured ESS; returns
        the gamma to place in ``CostParams.gamma``.  A non-finite ESS (a
        NaN solve is a transient the plant layer survives,
        ``autorally_plant.cpp:353-375``) leaves gamma unchanged."""
        ess = float(ess)
        if not math.isfinite(ess):
            return self.gamma
        ratio = max(ess, 1.0) / self.target
        self.gamma = min(max(self.gamma * ratio ** self.alpha, self.lo),
                         self.hi)
        return self.gamma

    def seed(self, cost_params):
        """``cost_params`` with gamma set to the tuner's current value in
        float32, as the JAX package seeds it."""
        return cost_params.replace(gamma=float(np.float32(self.gamma)))

    def reset(self) -> None:
        self.gamma = self.base

    # -- loop integration --------------------------------------------------

    def attach(self, *controllers):
        """``on_tick`` hook for :func:`~autorally_tpu_torch.runtime.
        control_loop.run_control_loop`: read the winning controller's
        measured ESS, adapt, and give the new gamma (in float32) to every
        controller, so that both tube halves solve at the same temperature
        and the arbitration compares like with like.  Attaching also
        :meth:`seed`\\ s any controller whose cost params still carry
        ``gamma=None``."""
        for c in controllers:
            if c.cost_params.gamma is None:
                c.update_cost_params(self.seed(c.cost_params))

        def on_tick(num_iter, chosen, used, state):
            if chosen.stats is None:
                return
            g = float(np.float32(self.update(float(chosen.stats.ess))))
            for c in controllers:
                c.update_cost_params(c.cost_params.replace(gamma=g))

        return on_tick

    def attach_async(self, tube):
        """``on_tick`` hook for :func:`~autorally_tpu_torch.runtime.
        async_loop.run_control_loop_async`: one :meth:`update` from each
        harvested ``TubeTickOutput.ess`` (``depth`` ticks stale, which this
        slow multiplicative law tolerates by design), the new gamma (in
        float32) riding the next dispatch's gamma buffer, which captures
        nothing.  Seeds an unseeded tube at attach time, as :meth:`attach`
        does."""
        if tube.cost_params.gamma is None:
            tube.update_cost_params(self.seed(tube.cost_params))

        def on_tick(num_iter, used, state, out, harvest_ms, age_s):
            g = float(np.float32(self.update(float(out.ess))))
            tube.update_cost_params(tube.cost_params.replace(gamma=g))

        return on_tick
