from autorally_tpu_torch.models.base import Dynamics
from autorally_tpu_torch.models.neural_net import NeuralNetDynamics

__all__ = ["Dynamics", "NeuralNetDynamics"]
