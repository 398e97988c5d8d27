"""The tube-MPPI runtime (port of ``autorally_tpu/runtime``, the names ported
so far): the controller, the plants, the control loop and the telemetry;
in their own modules the episode, the ESS tuner, the async loop, the
realtime gate, profiling, the native bindings and the UDP plant.  The rest
of the JAX package's runtime (vehicle I/O, diagnostics, the estimator, ...)
is listed in ROADMAP.md, Queue 1."""

from autorally_tpu_torch.runtime.controller import Controller
from autorally_tpu_torch.runtime.plant import (BasePlant, FullState,
                                               ReplayPlant, SyntheticPlant)
from autorally_tpu_torch.runtime.control_loop import (ControlLoopConfig,
                                                      run_control_loop)
from autorally_tpu_torch.runtime.telemetry import (LapStats, StatusMonitor,
                                                   TimingStats)

__all__ = [
    "Controller", "BasePlant", "FullState", "SyntheticPlant", "ReplayPlant",
    "ControlLoopConfig", "run_control_loop",
    "LapStats", "StatusMonitor", "TimingStats",
]
