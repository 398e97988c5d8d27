"""Projected-Newton box-constrained QP (port of
``autorally_tpu/solver/boxqp.py``; reference ``BoxQP``,
``autorally_control/include/autorally_control/ddp/boxqp.h``).  Solves::

    min_x 0.5 x'H x + g'x    s.t.  lower <= x <= upper

with an active-set projected-Newton iteration: clamp, find the clamped set
from the gradient's sign, take a Newton step on the free block (a masked
dense solve) and a projected Armijo line search.  The JAX package runs the
loops as ``lax.while_loop``; here they are Python loops that read their
conditions on the host, which is fine for the one caller,
``DDPConfig(use_boxqp=True)`` (off by default, never used by the
reference).  Arithmetic is float32, as there.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class BoxQPResult(NamedTuple):
    x: torch.Tensor             # solution
    value: torch.Tensor         # objective at the solution
    free: torch.Tensor          # free-set mask (bool)
    iterations: int
    converged: bool


def _clamped(H, g, x, lower, upper):
    """(grad, free) at ``x``: a variable is clamped at a bound its
    gradient pushes it against."""
    grad = g + H @ x
    at_lo = (x <= lower + 1e-12) & (grad > 0)
    at_hi = (x >= upper - 1e-12) & (grad < 0)
    return grad, ~(at_lo | at_hi)


def boxqp(H: torch.Tensor, g: torch.Tensor, lower: torch.Tensor,
          upper: torch.Tensor, x0=None, max_iter: int = 100,
          tol: float = 1e-8, min_step: float = 1e-10) -> BoxQPResult:
    """Solve the box QP.  ``H`` must be positive definite on free blocks."""
    def objective(x):
        return 0.5 * x @ H @ x + g @ x

    zero = torch.zeros_like(g)
    x = torch.clamp(zero if x0 is None else x0, lower, upper)
    it, done = 0, False
    while not done and it < max_iter:
        grad, free = _clamped(H, g, x, lower, upper)
        free_grad = torch.where(free, grad, zero)
        gnorm = torch.linalg.vector_norm(free_grad)
        all_clamped = not bool(free.any())

        # Newton step on the free block: rows and columns of clamped
        # variables replaced by the identity, so that one dense solve
        # takes any active set
        fmask = free.to(H.dtype)
        H_mod = (H * fmask[:, None] * fmask[None, :]
                 + torch.diag(1.0 - fmask))
        dx = torch.linalg.solve(H_mod, -free_grad)
        dx = torch.where(free, dx, zero)

        # projected backtracking line search (Armijo)
        f0 = objective(x)
        expected = grad @ dx
        alpha, accepted = 1.0, False
        while not accepted and alpha > min_step:
            x_new = torch.clamp(x + alpha * dx, lower, upper)
            accepted = bool(objective(x_new) - f0 <= 0.1 * alpha * expected)
            if not accepted:
                alpha *= 0.5
        done = all_clamped or bool(gnorm < tol) or not accepted
        if not done:
            x = torch.clamp(x + alpha * dx, lower, upper)
        it += 1
    grad, free = _clamped(H, g, x, lower, upper)
    gnorm = torch.linalg.vector_norm(torch.where(free, grad, zero))
    return BoxQPResult(x=x, value=objective(x), free=free, iterations=it,
                       converged=bool(gnorm < 1e-6) or not bool(free.any()))
