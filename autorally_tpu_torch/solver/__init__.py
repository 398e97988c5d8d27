"""MPPI and DDP solvers."""

from autorally_tpu_torch.solver.ddp import DDPSolver
from autorally_tpu_torch.solver.ensemble import EnsembleMPPISolver
from autorally_tpu_torch.solver.mppi import MPPISolver, SolveStats

__all__ = ["DDPSolver", "EnsembleMPPISolver", "MPPISolver", "SolveStats"]
