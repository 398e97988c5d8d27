"""Chassis interface: serial protocol, actuator calibration, command
arbitration, runstop gating.

Port of ``AutoRallyChassis`` (``autorally_core/src/autorally_chassis/
AutoRallyChassis.cpp``) minus ROS:

- wire protocol (``:140-305``): frames ``#<type>...\\n``; type ``w`` =
  wheel speeds as CSV rotations/s (scaled by wheel diameter * pi to m/s),
  type ``r`` = RC pulse widths CSV [steer_us, throttle_us,
  autonomousEnabled_us, throttleRelay], type ``e`` = error string;
  commands out are the 9-byte ``#s`` frame with three big-endian pulse
  width shorts (``sendCommandToChassis``, ``:427-464``)
- actuator calibration (``actuatorCmdToMs``/``actuatorUsToCmd``,
  ``:466-530``): [-1, 1] command <-> pulse width via (min, center, max)
  with reverse handling (frontBrake flips within [0, 1]) and the
  two-strikes invalid-pulse policy (-5.0 disable sentinel)
- command arbitration (``setChassisActuators``, ``:307-385``): highest
  priority fresh command wins per actuator; throttle additionally gated
  by the runstop aggregate (ALL fresh runstop publishers must enable
  motion; no publishers or no fresh ones -> disabled)

Transport is any file descriptor (a real serial port opened with
termios, or a pty for tests — the reference's own serial-test technique,
``serialSensorInterfaceTest.cpp:36``).
"""

from __future__ import annotations

import dataclasses
import math
import os
import struct
from typing import Callable, Dict, List, Optional, Tuple

# The chassis command/state records ARE the wire types — one definition
# (autorally_msgs role) shared by the arbiter, the UDP deployments, and
# the telemetry bus.
from autorally_tpu_torch.msgs import ChassisCommand, ChassisState

__all__ = ["ActuatorConfig", "ChassisCommand", "ChassisState",
           "ActuatorCalibration", "CommandArbiter", "ChassisLink",
           "open_serial_port"]

PI = math.pi


@dataclasses.dataclass
class ActuatorConfig:
    """Pulse-width calibration for one actuator (us)."""

    min: int = 1000
    center: int = 1500
    max: int = 2000
    reverse: bool = False


class ActuatorCalibration:
    """cmd <-> pulse-width conversions with invalid-pulse tracking."""

    def __init__(self, configs: Optional[Dict[str, ActuatorConfig]] = None):
        self.configs = configs or {
            "steering": ActuatorConfig(),
            "throttle": ActuatorConfig(),
            "frontBrake": ActuatorConfig(),
        }
        self._invalid_flag: Dict[str, bool] = {}
        self._invalid_count: Dict[str, int] = {}
        self._most_recent: Dict[str, float] = {}

    def cmd_to_us(self, value: float, actuator: str) -> int:
        """``actuatorCmdToMs``: [-1, 1] -> pulse width us."""
        c = self.configs[actuator]
        if c.reverse:
            if actuator == "frontBrake":
                value = 1.0 - value       # flip within [0, 1]
            else:
                value = -value
        val = c.center
        if value < 0:
            val += int((c.center - c.min) * value)
        else:
            val += int((c.max - c.center) * value)
        return val

    def us_to_cmd(self, pulse_width: int, actuator: str) -> float:
        """``actuatorUsToCmd``: pulse width -> [-1, 1]; out-of-range
        pulses reuse the previous value once, then return the -5.0
        disable sentinel."""
        c = self.configs[actuator]
        if pulse_width < 900 or pulse_width > 2100:
            if self._invalid_flag.get(actuator, False):
                cmd = -5.0
            else:
                cmd = self._most_recent.get(actuator, -5.0)
                self._invalid_count[actuator] = (
                    self._invalid_count.get(actuator, 0) + 1)
            self._invalid_flag[actuator] = True
            return cmd
        self._invalid_flag[actuator] = False
        val = pulse_width - c.center
        if val < 0:
            cmd = val / float(c.center - c.min)
        else:
            cmd = val / float(c.max - c.center)
        self._most_recent[actuator] = cmd
        return cmd


class CommandArbiter:
    """Priority arbitration + runstop gating (``setChassisActuators``)."""

    def __init__(self, priorities: List[str], command_max_age: float = 0.2,
                 runstop_max_age: float = 1.0):
        self.priorities = list(priorities)   # highest priority first
        self.command_max_age = command_max_age
        self.runstop_max_age = runstop_max_age
        self.commands: Dict[str, ChassisCommand] = {}
        self.runstops: Dict[str, Tuple[bool, float]] = {}

    def submit(self, cmd: ChassisCommand) -> None:
        if cmd.sender not in self.priorities:
            raise KeyError(f"unknown commander {cmd.sender!r}; register it "
                           "in the priority list")
        self.commands[cmd.sender] = cmd

    def submit_runstop(self, sender: str, motion_enabled: bool,
                       stamp: float) -> None:
        self.runstops[sender] = (motion_enabled, stamp)

    def arbitrate(self, now: float) -> ChassisState:
        state = ChassisState()

        # runstop aggregate (AutoRallyChassis.cpp:322-348)
        if not self.runstops:
            state.runstop_motion_enabled = False
        else:
            state.runstop_motion_enabled = True
            valid = 0
            for enabled, stamp in self.runstops.values():
                if now - stamp < self.runstop_max_age:
                    valid += 1
                    if not enabled:
                        state.runstop_motion_enabled = False
                        state.throttle_commander = "runstop"
            if valid == 0:
                state.runstop_motion_enabled = False
                state.throttle_commander = "runstop"

        # highest-priority fresh command per actuator (:350-384)
        for sender in self.priorities:
            cmd = self.commands.get(sender)
            if cmd is None or now - cmd.stamp >= self.command_max_age:
                continue
            if (not state.throttle_commander
                    and state.runstop_motion_enabled
                    and -1.0 <= cmd.throttle <= 1.0):
                state.throttle_commander = sender
                state.throttle = cmd.throttle
            if not state.steering_commander and -1.0 <= cmd.steering <= 1.0:
                state.steering_commander = sender
                state.steering = cmd.steering
            if (not state.front_brake_commander
                    and 0.0 <= cmd.front_brake <= 1.0):
                state.front_brake_commander = sender
                state.front_brake = cmd.front_brake
        return state


class ChassisLink:
    """Framed serial link to the chassis microcontroller.

    ``fd`` is any readable/writable file descriptor.  Incoming bytes are
    framed on ``#<type>...\\n`` and dispatched to callbacks; outgoing
    commands use the binary ``#s`` frame.
    """

    def __init__(self, fd: int, calibration: ActuatorCalibration,
                 wheel_diameter: float = 0.19,
                 on_wheel_speeds: Optional[Callable] = None,
                 on_rc_command: Optional[Callable] = None,
                 on_error: Optional[Callable] = None):
        self.fd = fd
        self.cal = calibration
        self.wheel_diameter = wheel_diameter
        self.on_wheel_speeds = on_wheel_speeds
        self.on_rc_command = on_rc_command
        self.on_error = on_error
        self.autonomous_enabled = False
        self.throttle_relay_enabled = False
        self._buf = b""
        self._device = None    # SerialDeviceThreaded once start()ed

    # -- incoming ------------------------------------------------------------

    def process_bytes(self, data: bytes) -> None:
        """Feed raw bytes; complete frames dispatch callbacks
        (``pollSerial``-equivalent framing, AutoRallyChassis.cpp:136-168)."""
        self._buf += data
        while True:
            start = self._buf.find(b"#")
            if start < 0:
                self._buf = b""
                return
            end = self._buf.find(b"\n", start)
            if end < 0:
                self._buf = self._buf[start:]
                return
            frame = self._buf[start + 1:end]
            self._buf = self._buf[end + 1:]
            if frame:
                self._dispatch(chr(frame[0]), frame[1:])

    def _dispatch(self, msg_type: str, payload: bytes) -> None:
        if msg_type == "w":                    # wheel speeds, rot/s CSV
            try:
                parts = payload.decode().split(",")
                if len(parts) != 4:
                    return
                speeds = tuple(float(p) * self.wheel_diameter * PI
                               for p in parts)
            except (ValueError, UnicodeDecodeError):
                return
            if self.on_wheel_speeds:
                self.on_wheel_speeds(*speeds)   # lf, rf, lb, rb in m/s
        elif msg_type == "r":                  # RC pulse widths CSV
            try:
                parts = payload.decode().split(",")
                if len(parts) != 4:
                    return
                steer = self.cal.us_to_cmd(int(parts[0]), "steering")
                throttle = self.cal.us_to_cmd(int(parts[1]), "throttle")
                self.autonomous_enabled = int(parts[2]) > 1500
                self.throttle_relay_enabled = bool(int(parts[3]))
            except (ValueError, UnicodeDecodeError):
                return
            if self.on_rc_command:
                self.on_rc_command(steer, throttle, self.autonomous_enabled)
        elif msg_type == "e":                  # error string from firmware
            if self.on_error:
                try:
                    self.on_error(payload.decode(errors="replace"))
                except Exception:
                    pass

    # -- outgoing ------------------------------------------------------------

    def send_command(self, steering: float, throttle: float,
                     front_brake: float = 0.0) -> None:
        """The 9-byte ``#s`` actuator frame (AutoRallyChassis.cpp:427-464)."""
        frame = (b"#s"
                 + struct.pack(">h", self.cal.cmd_to_us(steering, "steering"))
                 + struct.pack(">h", self.cal.cmd_to_us(throttle, "throttle"))
                 + struct.pack(">h", self.cal.cmd_to_us(front_brake,
                                                        "frontBrake"))
                 + b"\n")
        if self._device is not None:
            self._device.write_port(frame)     # serialized (writePort role)
        else:
            os.write(self.fd, frame)

    # -- reader thread (SerialDeviceThreaded transport) -----------------------

    def start(self) -> None:
        from autorally_tpu_torch.runtime.serial_device import \
            SerialDeviceThreaded

        self._device = SerialDeviceThreaded(self.fd, name="chassis")
        self._device.register_data_callback(
            lambda: self.process_bytes(self._device.take()))
        self._device.start()

    def stop(self) -> None:
        if self._device is not None:
            self._device.stop()


def open_serial_port(device: str, baud: int = 115200) -> int:
    """Open and configure a raw serial port (delegates to the shared
    serial transport layer, ``SerialCommon::connect`` role)."""
    from autorally_tpu_torch.runtime.serial_device import SerialSettings
    from autorally_tpu_torch.runtime.serial_device import \
        open_serial_port as _open

    return _open(device, SerialSettings(baud=baud))
