"""Independent physics simulation, the framework's Gazebo stand-in (port of
``autorally_tpu/sim``).

The reference validates its controller against Gazebo, a rigid-body
simulator whose vehicle model (wheel contacts, Ackermann steering joints,
effort-controlled axles) shares nothing with the controller's learned
dynamics.  This package is that independent oracle: a first-principles
four-wheel vehicle model (tire slip forces, wheel spin dynamics, steering
servo, load transfer, roll) with actuation semantics ported from the Gazebo
controller node, so closed-loop results grade the controller against
physics it has never seen.  The physics runs on the card (a control period
one CUDA graph) unless the caller asks for the CPU.
"""

from autorally_tpu_torch.sim.vehicle import (SimState, VehicleParams,
                                             controller_state,
                                             init_sim_state, vehicle_step)
from autorally_tpu_torch.sim.actuation import (ActuationLimits, SimCommand,
                                               SimCommandArbiter,
                                               ackermann_angles,
                                               wheel_speeds)
from autorally_tpu_torch.sim.plant import SimVehiclePlant
from autorally_tpu_torch.sim.sensors import (SensorSimConfig,
                                             SensorSimulator,
                                             SimVehicleEstimatedPlant)
from autorally_tpu_torch.sim.description import (
    DEFAULT_URDF, VehicleDescription, WorldDescription, load_urdf,
    load_world, sensor_config_from_description,
    vehicle_params_from_description)

__all__ = [
    "SimState", "VehicleParams", "vehicle_step", "init_sim_state",
    "controller_state", "ActuationLimits", "SimCommand",
    "SimCommandArbiter", "ackermann_angles", "wheel_speeds",
    "SimVehiclePlant", "SensorSimConfig", "SensorSimulator",
    "SimVehicleEstimatedPlant", "DEFAULT_URDF", "VehicleDescription",
    "WorldDescription", "load_urdf", "load_world",
    "sensor_config_from_description", "vehicle_params_from_description",
]
