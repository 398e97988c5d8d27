from autorally_tpu_torch.costs.costmap import (Costmap, load_costmap,
                                               make_costmap, save_costmap)
from autorally_tpu_torch.costs.mppi_cost import MPPICost
from autorally_tpu_torch.costs.neural_costmap import (NeuralCostmap,
                                                      fit_neural_costmap)
from autorally_tpu_torch.costs.obstacles import ObstacleCost, make_obstacles

__all__ = ["Costmap", "MPPICost", "NeuralCostmap", "ObstacleCost",
           "fit_neural_costmap", "load_costmap", "make_costmap",
           "make_obstacles", "save_costmap"]
