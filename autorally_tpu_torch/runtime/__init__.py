"""The tube-MPPI runtime (port of ``autorally_tpu/runtime``): the
controller, the plants, the control loop, the telemetry, the diagnostics,
the state estimator, profiling, host and card status, the telemetry bus
with its runstop backchannel and the runstop box; in their own modules the
episode, the ESS tuner, the async loop, the realtime gate, the native
bindings, the UDP plant, the serial transport and the vehicle I/O (the
chassis link and its arbiter, GPS, wheel odometry, the vehicle network and
the simple controllers)."""

from autorally_tpu_torch.runtime.controller import Controller
from autorally_tpu_torch.runtime.plant import (BasePlant, FullState,
                                               ReplayPlant, SyntheticPlant)
from autorally_tpu_torch.runtime.control_loop import (ControlLoopConfig,
                                                      run_control_loop)
from autorally_tpu_torch.runtime.telemetry import (LapStats, StatusMonitor,
                                                   TimingStats)
from autorally_tpu_torch.runtime.diagnostics import (Diagnostics,
                                                     DiagnosticsAggregator)
from autorally_tpu_torch.runtime.wheel_odometry import WheelOdometry
from autorally_tpu_torch.runtime.state_estimator import (ErrorStateEKF,
                                                         EstimatorConfig)
from autorally_tpu_torch.runtime.profiling import SolveTimer, device_trace
from autorally_tpu_torch.runtime.controllers import (ConstantSpeedController,
                                                     GpsWaypointController,
                                                     JoystickController,
                                                     SafeSpeedGovernor,
                                                     ThrottleCalibration)
from autorally_tpu_torch.runtime.system_status import SystemStatusMonitor
from autorally_tpu_torch.runtime.telemetry_bus import (RunstopReceiver,
                                                       TelemetryBus,
                                                       send_runstop)
from autorally_tpu_torch.runtime.runstop_box import RunStopBox
from autorally_tpu_torch.runtime.vehicle_network import (
    VehicleNetworkCoordinator, VehicleNetworkNode)

__all__ = [
    "Controller", "BasePlant", "FullState", "SyntheticPlant", "ReplayPlant",
    "ControlLoopConfig", "run_control_loop",
    "LapStats", "StatusMonitor", "TimingStats",
    "Diagnostics", "DiagnosticsAggregator", "WheelOdometry",
    "ErrorStateEKF", "EstimatorConfig", "SolveTimer", "device_trace",
    "ConstantSpeedController", "GpsWaypointController",
    "JoystickController", "SafeSpeedGovernor", "ThrottleCalibration",
    "SystemStatusMonitor", "TelemetryBus", "RunstopReceiver",
    "send_runstop", "RunStopBox", "VehicleNetworkCoordinator",
    "VehicleNetworkNode",
]
