"""Plant over the independent physics vehicle (port of
``autorally_tpu/sim/plant.py``).

Drop-in alternative to the port's ``runtime.plant.SyntheticPlant`` that
integrates the first-principles four-wheel model instead of a
``Dynamics``-family model, so closed-loop evaluation faces genuine model
mismatch (the role of Gazebo + the ground-truth republisher for the
reference, ``autorally_gazebo/nodes/``).

A control period is a :class:`VehiclePeriod`: on the card its ``n_sub``
substeps and a packed copy of the 13 state numbers are captured once as
one CUDA graph, and each period copies the command into the graph's
static input, replays the graph and reads the packed state to the host
once; on the CPU it runs eagerly.  The plant's pose, controller state and
wheel speeds come from that host copy.
"""

from __future__ import annotations

import gc
from typing import Optional

import numpy as np
import torch

from autorally_tpu_torch.config import resolve_device
from autorally_tpu_torch.runtime.plant import BasePlant
from autorally_tpu_torch.sim.actuation import (ActuationLimits, SimCommand,
                                               SimCommandArbiter,
                                               wheel_speeds)
from autorally_tpu_torch.sim.vehicle import (SimState, VehicleParams,
                                             _constants, _substep,
                                             init_sim_state, pack_sim_state,
                                             sim_state_to_numpy,
                                             unpack_sim_state)


def host_controller_state(h: SimState) -> np.ndarray:
    """:func:`~autorally_tpu_torch.sim.vehicle.controller_state` of a host
    state (``sim_state_to_numpy``'s)."""
    return np.array([h.x, h.y, h.yaw, h.roll, h.vx, h.vy, -h.yaw_rate],
                    dtype=np.float32)


class VehiclePeriod:
    """One control period of ``vehicle_step(params, s, cmd, dt, n_sub)``
    on ``device``, the state held in a static (13,) buffer.

    On the card the first :meth:`step` (unless ``eager``) runs the period
    once on a side stream (with the state put back after it), then
    captures the substeps and the write-back of the packed state as one
    CUDA graph, with Python's cyclic collector off; each :meth:`step`
    then replays it.  ``capture_count`` counts the captures."""

    def __init__(self, params: VehicleParams, state: SimState, dt: float,
                 n_sub: int = 20, device=None, eager: bool = False):
        self.device = resolve_device(device)
        self.params = params
        self.dt, self.n_sub = float(dt), int(n_sub)
        self.eager = eager or self.device.type != "cuda"
        self._consts = _constants(params, self.dt / self.n_sub,
                                  self.device)
        self.state = pack_sim_state(state).to(self.device, torch.float32,
                                              copy=True)
        self.cmd = torch.zeros(3, dtype=torch.float32, device=self.device)
        pin = self.device.type == "cuda"
        self._cmd_host = torch.zeros(3, dtype=torch.float32,
                                     pin_memory=pin)
        self._state_host = torch.zeros(self.state.shape[0],
                                       dtype=torch.float32, pin_memory=pin)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.capture_count = 0

    def _run(self) -> None:
        """The period on the buffers: the substeps from ``state`` under
        ``cmd``, the packed result written back into ``state``."""
        s = unpack_sim_state(self.state)
        for _ in range(self.n_sub):
            s = _substep(self.params, s, self.cmd, self._consts)
        self.state.copy_(pack_sim_state(s))

    def prepare(self) -> None:
        """Capture the period now (on the card, unless eager), so that the
        first :meth:`step` of a paced loop is not late; the state stays."""
        if not self.eager and self.graph is None:
            self._capture()

    def _capture(self) -> None:
        dev = self.device
        saved = self.state.clone()
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self._run()                        # warm-up, outside the graph
        torch.cuda.current_stream(dev).wait_stream(side)
        self.state.copy_(saved)
        graph = torch.cuda.CUDAGraph()
        # an older graph freed mid-capture would invalidate this one
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph):
                self._run()
        finally:
            if collecting:
                gc.enable()
        self.graph = graph
        self.capture_count += 1

    def set_state(self, state: SimState) -> None:
        """Replace the state the next period starts from."""
        self.state.copy_(pack_sim_state(state).to(self.device,
                                                  torch.float32))

    @torch.no_grad()
    def step(self, cmd) -> np.ndarray:
        """Advance one period under ``cmd`` = [steering, throttle,
        front_brake]; returns the packed state on the host (one read)."""
        self._cmd_host.copy_(torch.as_tensor(np.asarray(cmd, np.float32)))
        self.cmd.copy_(self._cmd_host, non_blocking=True)
        if self.eager:
            self._run()
        else:
            self.prepare()
            self.graph.replay()
        self._state_host.copy_(self.state, non_blocking=True)
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        return self._state_host.numpy().copy()


class SimVehiclePlant(BasePlant):
    """Closed-loop plant simulated with the wheel-level physics model.

    ``step_sim`` advances one control period: the controller's last
    published command goes through the sim-side arbiter (priority +
    staleness + runstop, like the Gazebo node), drives the physics, and
    the resulting pose re-enters the control pipeline.  The physics runs on
    ``device`` (``cuda`` unless the caller asks for another; on the card
    a period is one replayed CUDA graph)."""

    def __init__(self, init_state: np.ndarray, dt: float,
                 num_timesteps: int, params: VehicleParams = VehicleParams(),
                 n_sub: int = 20, device=None, **kw):
        super().__init__(dt, num_timesteps, **kw)
        self.device = resolve_device(device)
        self.params = params
        self.n_sub = int(n_sub)
        x, y, yaw = (float(init_state[0]), float(init_state[1]),
                     float(init_state[2]))
        vx = float(init_state[4]) if len(init_state) > 4 else 0.0
        s0 = init_sim_state(x=x, y=y, yaw=yaw, vx=vx, device=self.device)
        self.period = VehiclePeriod(params, s0, self.dt, self.n_sub,
                                    self.device)
        self._host = sim_state_to_numpy(s0)
        self.sim_time = 0.0
        self.arbiter = SimCommandArbiter(["mppi"], ActuationLimits())

    @property
    def sim_state(self) -> SimState:
        """A copy of the current state on the device."""
        return unpack_sim_state(self.period.state.clone())

    @sim_state.setter
    def sim_state(self, s: SimState) -> None:
        self.period.set_state(s)
        self._host = sim_state_to_numpy(s)

    def on_control(self, t: float, steering: float, throttle: float) -> None:
        self.arbiter.put_command(SimCommand(
            sender="mppi", steering=steering, throttle=throttle, stamp=t))

    def _advance(self) -> None:
        """One period under the arbitrated command; the host copy updated."""
        s_cmd, t_cmd, b_cmd, _ = self.arbiter.arbitrate(self.sim_time)
        self._host = sim_state_to_numpy(self.period.step(
            [s_cmd, t_cmd, b_cmd]))
        self.sim_time += self.dt

    def step_sim(self, n_steps: int = 1) -> None:
        for _ in range(n_steps):
            self._advance()
            self.receive_state_vector(self.sim_time, self.true_state)

    @property
    def true_state(self) -> np.ndarray:
        return host_controller_state(self._host)

    def wheel_speeds(self) -> np.ndarray:
        return wheel_speeds(self.params, self._host)
