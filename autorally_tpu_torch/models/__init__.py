from autorally_tpu_torch.models.base import Dynamics
from autorally_tpu_torch.models.basis_function import (BasisFunctionDynamics,
                                                       car_basis_functions)
from autorally_tpu_torch.models.ensemble import EnsembleDynamics
from autorally_tpu_torch.models.neural_net import NeuralNetDynamics

__all__ = ["BasisFunctionDynamics", "Dynamics", "EnsembleDynamics",
           "NeuralNetDynamics", "car_basis_functions"]
