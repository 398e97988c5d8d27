from autorally_tpu_torch.costs.costmap import Costmap, load_costmap, make_costmap
from autorally_tpu_torch.costs.mppi_cost import MPPICost

__all__ = ["Costmap", "MPPICost", "load_costmap", "make_costmap"]
