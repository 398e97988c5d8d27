"""The tube-MPPI runtime (port of ``autorally_tpu/runtime``): the
controller, the plants, the control loop, the telemetry, the diagnostics,
the state estimator, profiling, host and card status, the telemetry bus
with its runstop backchannel and the runstop box; in their own modules the
episode, the ESS tuner, the async loop, the realtime gate, the native
bindings, the UDP plant and the serial transport.  The vehicle I/O
(chassis, GPS, wheel odometry, the vehicle network and the simple
controllers) is listed in ROADMAP.md, Queue 1 item 11b."""

from autorally_tpu_torch.runtime.controller import Controller
from autorally_tpu_torch.runtime.plant import (BasePlant, FullState,
                                               ReplayPlant, SyntheticPlant)
from autorally_tpu_torch.runtime.control_loop import (ControlLoopConfig,
                                                      run_control_loop)
from autorally_tpu_torch.runtime.telemetry import (LapStats, StatusMonitor,
                                                   TimingStats)
from autorally_tpu_torch.runtime.diagnostics import (Diagnostics,
                                                     DiagnosticsAggregator)
from autorally_tpu_torch.runtime.state_estimator import (ErrorStateEKF,
                                                         EstimatorConfig)
from autorally_tpu_torch.runtime.profiling import SolveTimer, device_trace
from autorally_tpu_torch.runtime.system_status import SystemStatusMonitor
from autorally_tpu_torch.runtime.telemetry_bus import (RunstopReceiver,
                                                       TelemetryBus,
                                                       send_runstop)
from autorally_tpu_torch.runtime.runstop_box import RunStopBox

__all__ = [
    "Controller", "BasePlant", "FullState", "SyntheticPlant", "ReplayPlant",
    "ControlLoopConfig", "run_control_loop",
    "LapStats", "StatusMonitor", "TimingStats",
    "Diagnostics", "DiagnosticsAggregator",
    "ErrorStateEKF", "EstimatorConfig", "SolveTimer", "device_trace",
    "SystemStatusMonitor", "TelemetryBus", "RunstopReceiver",
    "send_runstop", "RunStopBox",
]
