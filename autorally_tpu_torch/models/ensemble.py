"""Model-ensemble dynamics: rollouts partitioned across M parameter sets
(port of ``autorally_tpu/models/ensemble.py``).

The reference has no multi-model rollouts; its robust-MPPI lineage
(tube-MPPI, RSS'18) motivates sampling trajectories under an ensemble of
dynamics models.  The K rollouts are split into M contiguous blocks, block
m evaluated under parameter set m.  Params are the base model's params dict
with a leading M axis on every tensor, and the evaluation is a
``torch.func.vmap`` of the base model's ``dynamics`` over the members (a
batched matmul a layer for the MLP), in full fp32 (the package switches
TF32 off).

:class:`EnsembleDynamics` has no in-kernel form (``KERNEL_KIND`` is
``None``): an ``MPPISolver`` over it runs the plain chain.
:class:`~autorally_tpu_torch.solver.ensemble.EnsembleMPPISolver` runs the
same blocks through the base model's kernels, a launch a member.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from autorally_tpu_torch.models.base import Dynamics, Params


def _tree_map(fn, *trees):
    """``fn`` over the tensors of params trees of one structure (dicts,
    lists and tuples of tensors)."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def stack_params(params_list) -> Params:
    """Stack M params trees into one tree with leading axis M."""
    return _tree_map(lambda *xs: torch.stack(xs), *params_list)


def member_params(params: Params, m: int) -> Params:
    """Member m's params of a stacked tree (views, no copies)."""
    return _tree_map(lambda x: x[m], params)


class EnsembleDynamics(Dynamics):
    """A base model with M stacked parameter sets.

    ``dynamics``/``state_deriv`` take a batch whose leading dim K is
    divisible by M; block ``m`` (rollouts m*K/M .. (m+1)*K/M) is evaluated
    under member ``m``.  A single state (1-D: the nominal re-rollout, the
    plant) uses member 0, and so do the control ranges.  The ensemble holds
    its own stacked set (:meth:`params`); the base model's held weights are
    left as they were."""

    def __init__(self, base: Dynamics, num_members: int):
        super().__init__(base.dt, base.negate_yaw_der, base.device)
        self.base = base
        self.num_members = int(num_members)
        self._stacked = None

    def _hold(self, stacked: Params) -> Params:
        self._stacked = stacked
        return stacked

    def params(self) -> Params:
        """The held stacked params."""
        return self._stacked

    def init_params(self, seed: int) -> Params:
        """M members, each the base model's ``init_params`` of one of the M
        seeds that ``numpy.random.SeedSequence(seed)`` generates, made on a
        copy of the base so that its held weights stay as they are."""
        scratch = copy.deepcopy(self.base)
        seeds = np.random.SeedSequence(seed).generate_state(self.num_members)
        return self._hold(stack_params([scratch.init_params(int(s))
                                        for s in seeds]))

    def params_from_jax(self, params_np) -> Params:
        """Carry the JAX package's stacked params tree over, given as numpy
        arrays with the leading M axis (``stack_params`` of the base
        model's trees)."""
        return self._hold(_tree_map(
            lambda a: torch.tensor(np.asarray(a, dtype=np.float32),
                                   device=self.device), params_np))

    def dynamics(self, params: Params, states: torch.Tensor,
                 controls: torch.Tensor) -> torch.Tensor:
        if states.dim() == 1:
            return self.base.dynamics(member_params(params, 0), states,
                                      controls)
        K = states.shape[0]
        M = self.num_members
        if K % M:
            raise ValueError(f"batch {K} not divisible by ensemble size {M}")
        blocks = lambda x: x.reshape(M, K // M, *x.shape[1:])
        out = torch.func.vmap(self.base.dynamics)(params, blocks(states),
                                                  blocks(controls))
        return out.reshape(K, -1)

    def enforce_constraints(self, params: Params,
                            controls: torch.Tensor) -> torch.Tensor:
        """Clamp to member 0's ``control_rngs`` (the ranges are shared)."""
        rngs = params["control_rngs"][0]
        return torch.clamp(controls, rngs[:, 0], rngs[:, 1])
