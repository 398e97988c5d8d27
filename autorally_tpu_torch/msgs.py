"""Typed wire messages — the ``autorally_msgs`` role (the port's copy of
``autorally_tpu/msgs.py``: the same types, wire ids and byte layout, so a
message that either package encodes decodes in the other).

The reference defines 15 ROS message types (``autorally_msgs/msg/*.msg``)
that everything speaks: chassis command/state, wheel speeds, runstop,
lap stats, the path-integral telemetry family, the layered
``neuralNetModel`` used for live model push, image masks for the OCS,
and the state-estimator status byte.  This module is those types as
plain dataclasses plus a compact self-describing binary codec, so any
two processes in this framework (sim node, control node, operator
console, vehicle network) can exchange them over UDP or a byte stream
without ROS.

Design notes:

- One spec table per type (``_SPECS``) drives both ``encode`` and
  ``decode`` — there is a single source of truth for the wire layout.
- The layout is little-endian, length-prefixed for strings/arrays, and
  versioned (a bumped ``WIRE_VERSION`` refuses to decode rather than
  misparse).
- ``neuralNetModel`` carries float32 weight panels exactly like the
  reference's layered message (``neuralNetModel.msg``/
  ``neuralNetLayer.msg``), and :func:`model_msg_from_params` /
  :func:`params_from_model_msg` bridge it to the port's parameter dict
  (tensors, ``models/neural_net.py``) — the live model-push path
  (``param_getter.cpp`` / ``mppi_nodelet`` model update role) has a wire
  format.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Dict, List, Tuple

import numpy as np
import torch

from autorally_tpu_torch.config import resolve_device

WIRE_VERSION = 1
_MAGIC = 0xA7


class MsgDecodeError(ValueError):
    """Raised when a buffer cannot be decoded as a known message."""


# ---------------------------------------------------------------------------
# Message dataclasses (field names snake_cased from the .msg definitions)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Point2D:
    """``point2D.msg``: pixel coordinate."""

    x: int = 0
    y: int = 0


@dataclasses.dataclass
class Line2D:
    """``line2D.msg``: segment between two pixel points."""

    start: Point2D = dataclasses.field(default_factory=Point2D)
    end: Point2D = dataclasses.field(default_factory=Point2D)


@dataclasses.dataclass
class RegionOfInterest:
    """``sensor_msgs/RegionOfInterest`` as used by ``imageMask.msg``."""

    x_offset: int = 0
    y_offset: int = 0
    height: int = 0
    width: int = 0


@dataclasses.dataclass
class ImageMask:
    """``imageMask.msg``: OCS overlay primitives from a vision sender."""

    stamp: float = 0.0
    sender: str = ""
    points: List[Point2D] = dataclasses.field(default_factory=list)
    lines: List[Line2D] = dataclasses.field(default_factory=list)
    rois: List[RegionOfInterest] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class ChassisCommand:
    """``chassisCommand.msg``: one commander's actuator request.

    Values outside the valid actuator range ([-1, 1]; front brake
    [0, 1]) mean "not commanding this actuator" — the reference's -5.0
    convention (``AutoRallyChassis.cpp:350-385``)."""

    sender: str = ""
    steering: float = -5.0
    throttle: float = -5.0
    front_brake: float = -5.0
    stamp: float = 0.0


@dataclasses.dataclass
class ChassisState:
    """``chassisState.msg``: what the chassis actually executed and who
    commanded each actuator."""

    steering: float = 0.0
    throttle: float = 0.0
    front_brake: float = 0.0
    steering_commander: str = ""
    throttle_commander: str = ""
    front_brake_commander: str = ""
    runstop_motion_enabled: bool = False
    throttle_relay_enabled: bool = False
    autonomous_enabled: bool = False
    stamp: float = 0.0


@dataclasses.dataclass
class WheelSpeeds:
    """``wheelSpeeds.msg``: per-wheel linear speeds, m/s."""

    lf: float = 0.0
    rf: float = 0.0
    lb: float = 0.0
    rb: float = 0.0
    stamp: float = 0.0


@dataclasses.dataclass
class Runstop:
    """``runstop.msg``: one publisher's motion-enable vote."""

    sender: str = ""
    motion_enabled: bool = False
    stamp: float = 0.0


@dataclasses.dataclass
class LapStats:
    """``lapStats.msg``: per-lap summary."""

    lap_number: int = 0
    lap_time: float = 0.0
    max_speed: float = 0.0
    max_slip: float = 0.0
    stamp: float = 0.0


@dataclasses.dataclass
class NeuralNetLayer:
    """``neuralNetLayer.msg``: one dense layer, row-major float32."""

    name: str = ""
    weight: List[float] = dataclasses.field(default_factory=list)
    bias: List[float] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class NeuralNetModel:
    """``neuralNetModel.msg``: layered network for live model push."""

    network: List[NeuralNetLayer] = dataclasses.field(default_factory=list)
    num_layers: int = 0
    structure: List[int] = dataclasses.field(default_factory=list)
    stamp: float = 0.0


@dataclasses.dataclass
class PathIntegralParams:
    """``pathIntegralParams.msg``: the MPPI launch configuration echo."""

    hz: int = 50
    num_timesteps: int = 100
    num_iters: int = 1
    gamma: float = 0.15
    init_steering: float = 0.0
    init_throttle: float = 0.0
    steering_var: float = 0.0
    throttle_var: float = 0.0
    max_throttle: float = 0.0
    speed_coefficient: float = 0.0
    track_coefficient: float = 0.0
    max_slip_angle: float = 0.0
    track_slop: float = 0.0
    crash_coeff: float = 0.0
    map_path: str = ""
    desired_speed: float = 0.0


@dataclasses.dataclass
class PathIntegralStats:
    """``pathIntegralStats.msg``: tagged run stats (params + lap)."""

    tag: str = ""
    params: PathIntegralParams = dataclasses.field(
        default_factory=PathIntegralParams)
    stats: LapStats = dataclasses.field(default_factory=LapStats)
    stamp: float = 0.0


@dataclasses.dataclass
class PathIntegralStatus:
    """``pathIntegralStatus.msg``: controller status line."""

    info: str = ""
    status: int = 0
    stamp: float = 0.0


@dataclasses.dataclass
class PathIntegralTiming:
    """``pathIntegralTiming.msg``: loop timing telemetry."""

    average_time_between_poses: float = 0.0
    average_optimization_cycle_time: float = 0.0
    average_sleep_time: float = 0.0
    stamp: float = 0.0


@dataclasses.dataclass
class StateEstimatorStatus:
    """``stateEstimatorStatus.msg``: estimator health byte."""

    OK = 0
    WARN = 1
    ERROR = 2

    status: int = 0
    stamp: float = 0.0


# ---------------------------------------------------------------------------
# Wire codec
# ---------------------------------------------------------------------------
# Field formats: 'f8' float64, 'f4' float32, 'i4'/'i8' signed ints,
# 'b' bool, 's' string (u16 len + utf8), 'f4[]' float32 array (u32 len),
# 'i4[]' int32 array, 'M:Name' nested message, 'M[Name]' message list
# (u16 count).

_SPECS: Dict[type, List[Tuple[str, str]]] = {
    Point2D: [("x", "i4"), ("y", "i4")],
    Line2D: [("start", "M:Point2D"), ("end", "M:Point2D")],
    RegionOfInterest: [("x_offset", "i4"), ("y_offset", "i4"),
                       ("height", "i4"), ("width", "i4")],
    ImageMask: [("stamp", "f8"), ("sender", "s"),
                ("points", "M[Point2D]"), ("lines", "M[Line2D]"),
                ("rois", "M[RegionOfInterest]")],
    ChassisCommand: [("stamp", "f8"), ("sender", "s"), ("steering", "f8"),
                     ("throttle", "f8"), ("front_brake", "f8")],
    ChassisState: [("stamp", "f8"), ("steering", "f8"), ("throttle", "f8"),
                   ("front_brake", "f8"), ("steering_commander", "s"),
                   ("throttle_commander", "s"),
                   ("front_brake_commander", "s"),
                   ("runstop_motion_enabled", "b"),
                   ("throttle_relay_enabled", "b"),
                   ("autonomous_enabled", "b")],
    WheelSpeeds: [("stamp", "f8"), ("lf", "f8"), ("rf", "f8"),
                  ("lb", "f8"), ("rb", "f8")],
    Runstop: [("stamp", "f8"), ("sender", "s"), ("motion_enabled", "b")],
    LapStats: [("stamp", "f8"), ("lap_number", "i8"), ("lap_time", "f8"),
               ("max_speed", "f8"), ("max_slip", "f8")],
    NeuralNetLayer: [("name", "s"), ("weight", "f4[]"), ("bias", "f4[]")],
    NeuralNetModel: [("stamp", "f8"), ("network", "M[NeuralNetLayer]"),
                     ("num_layers", "i4"), ("structure", "i4[]")],
    PathIntegralParams: [("hz", "i8"), ("num_timesteps", "i8"),
                         ("num_iters", "i8"), ("gamma", "f8"),
                         ("init_steering", "f8"), ("init_throttle", "f8"),
                         ("steering_var", "f8"), ("throttle_var", "f8"),
                         ("max_throttle", "f8"), ("speed_coefficient", "f8"),
                         ("track_coefficient", "f8"),
                         ("max_slip_angle", "f8"), ("track_slop", "f8"),
                         ("crash_coeff", "f8"), ("map_path", "s"),
                         ("desired_speed", "f8")],
    PathIntegralStats: [("stamp", "f8"), ("tag", "s"),
                        ("params", "M:PathIntegralParams"),
                        ("stats", "M:LapStats")],
    PathIntegralStatus: [("stamp", "f8"), ("info", "s"), ("status", "i4")],
    PathIntegralTiming: [("stamp", "f8"),
                         ("average_time_between_poses", "f8"),
                         ("average_optimization_cycle_time", "f8"),
                         ("average_sleep_time", "f8")],
    StateEstimatorStatus: [("stamp", "f8"), ("status", "i4")],
}

_BY_NAME = {cls.__name__: cls for cls in _SPECS}
# Stable type ids (wire compatibility — append only, never renumber).
_TYPE_IDS = {cls: i for i, cls in enumerate([
    Point2D, Line2D, RegionOfInterest, ImageMask, ChassisCommand,
    ChassisState, WheelSpeeds, Runstop, LapStats, NeuralNetLayer,
    NeuralNetModel, PathIntegralParams, PathIntegralStats,
    PathIntegralStatus, PathIntegralTiming, StateEstimatorStatus], 1)}
_BY_TYPE_ID = {i: cls for cls, i in _TYPE_IDS.items()}

_SCALAR = {"f8": "<d", "f4": "<f", "i4": "<i", "i8": "<q"}


def _pack_value(fmt: str, value, out: List[bytes]) -> None:
    if fmt in _SCALAR:
        out.append(struct.pack(_SCALAR[fmt], value))
    elif fmt == "b":
        out.append(struct.pack("<B", 1 if value else 0))
    elif fmt == "s":
        raw = str(value).encode()
        out.append(struct.pack("<H", len(raw)) + raw)
    elif fmt.endswith("[]"):
        base = _SCALAR[fmt[:-2]]
        out.append(struct.pack("<I", len(value)))
        out.append(struct.pack(f"<{len(value)}{base[1]}", *value))
    elif fmt.startswith("M:"):
        _pack_fields(_BY_NAME[fmt[2:]], value, out)
    elif fmt.startswith("M["):
        cls = _BY_NAME[fmt[2:-1]]
        out.append(struct.pack("<H", len(value)))
        for item in value:
            _pack_fields(cls, item, out)
    else:                                       # pragma: no cover
        raise ValueError(f"unknown field format {fmt!r}")


def _pack_fields(cls: type, msg, out: List[bytes]) -> None:
    for name, fmt in _SPECS[cls]:
        _pack_value(fmt, getattr(msg, name), out)


def _unpack_value(fmt: str, buf: bytes, off: int):
    try:
        if fmt in _SCALAR:
            s = _SCALAR[fmt]
            return struct.unpack_from(s, buf, off)[0], off + struct.calcsize(s)
        if fmt == "b":
            return buf[off] != 0, off + 1
        if fmt == "s":
            (n,) = struct.unpack_from("<H", buf, off)
            off += 2
            if off + n > len(buf):
                # Python slicing would silently clamp a corrupt length
                # prefix and leave the cursor past the end — fail loudly
                raise MsgDecodeError(
                    f"string length {n} overruns buffer")
            return buf[off:off + n].decode(), off + n
        if fmt.endswith("[]"):
            base = _SCALAR[fmt[:-2]]
            (n,) = struct.unpack_from("<I", buf, off)
            off += 4
            vals = list(struct.unpack_from(f"<{n}{base[1]}", buf, off))
            return vals, off + n * struct.calcsize(base)
        if fmt.startswith("M:"):
            return _unpack_fields(_BY_NAME[fmt[2:]], buf, off)
        if fmt.startswith("M["):
            cls = _BY_NAME[fmt[2:-1]]
            (n,) = struct.unpack_from("<H", buf, off)
            off += 2
            items = []
            for _ in range(n):
                item, off = _unpack_fields(cls, buf, off)
                items.append(item)
            return items, off
    except (struct.error, IndexError, UnicodeDecodeError) as e:
        raise MsgDecodeError(f"truncated or corrupt field ({fmt}): {e}")
    raise ValueError(f"unknown field format {fmt!r}")   # pragma: no cover


def _unpack_fields(cls: type, buf: bytes, off: int):
    kwargs = {}
    for name, fmt in _SPECS[cls]:
        kwargs[name], off = _unpack_value(fmt, buf, off)
    return cls(**kwargs), off


def encode(msg) -> bytes:
    """Serialize a message to its framed wire form."""
    cls = type(msg)
    if cls not in _TYPE_IDS:
        raise TypeError(f"{cls.__name__} is not a wire message type")
    out: List[bytes] = [struct.pack("<BBB", _MAGIC, WIRE_VERSION,
                                    _TYPE_IDS[cls])]
    _pack_fields(cls, msg, out)
    return b"".join(out)


def decode(buf: bytes):
    """Parse a framed wire buffer back into its message dataclass."""
    if len(buf) < 3:
        raise MsgDecodeError("buffer shorter than the 3-byte header")
    magic, version, type_id = struct.unpack_from("<BBB", buf, 0)
    if magic != _MAGIC:
        raise MsgDecodeError(f"bad magic byte 0x{magic:02x}")
    if version != WIRE_VERSION:
        raise MsgDecodeError(f"wire version {version} != {WIRE_VERSION}")
    cls = _BY_TYPE_ID.get(type_id)
    if cls is None:
        raise MsgDecodeError(f"unknown message type id {type_id}")
    msg, off = _unpack_fields(cls, buf, 3)
    if off != len(buf):
        raise MsgDecodeError(f"{len(buf) - off} trailing bytes after "
                             f"{cls.__name__}")
    return msg


def to_dict(msg) -> dict:
    """Message -> plain dict (for the JSONL telemetry bus / debugging)."""
    d = dataclasses.asdict(msg)
    d["_type"] = type(msg).__name__
    return d


def from_dict(d: dict):
    """Inverse of :func:`to_dict` (nested messages rebuilt per spec)."""
    cls = _BY_NAME[d["_type"]]

    def build(cls, payload):
        kwargs = {}
        for name, fmt in _SPECS[cls]:
            v = payload[name]
            if fmt.startswith("M:"):
                v = build(_BY_NAME[fmt[2:]], v)
            elif fmt.startswith("M["):
                v = [build(_BY_NAME[fmt[2:-1]], item) for item in v]
            kwargs[name] = v
        return cls(**kwargs)

    return build(cls, d)


# ---------------------------------------------------------------------------
# neuralNetModel <-> the port's parameter dict (live model push)
# ---------------------------------------------------------------------------

def _host(a) -> np.ndarray:
    """A weight panel as a float32 numpy array (a tensor on any device is
    copied to the host)."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, np.float32)


def model_msg_from_params(params, stamp: float = 0.0) -> NeuralNetModel:
    """The port's parameter dict (``{"weights": [(in, out)...], "biases":
    [...]}``, tensors on any device or numpy arrays, the layout of
    :meth:`NeuralNetDynamics.params`) -> layered wire message.  The wire
    layout is the reference's: float32 row-major with ``W_i`` of shape
    (out, in) (``neuralNetModel.msg`` / ``neural_net_model.cu:73-106``), so
    a reference consumer could decode it too."""
    layers = []
    structure = []
    for i, (W, b) in enumerate(zip(params["weights"], params["biases"])):
        W = _host(W).T                                   # (out, in)
        b = _host(b).reshape(-1)
        if not structure:
            structure.append(int(W.shape[1]))
        structure.append(int(W.shape[0]))
        layers.append(NeuralNetLayer(name=f"dense_{i + 1}",
                                     weight=W.reshape(-1).tolist(),
                                     bias=b.tolist()))
    return NeuralNetModel(network=layers, num_layers=len(layers),
                          structure=structure, stamp=stamp)


def params_from_model_msg(msg: NeuralNetModel, control_ranges=None,
                          device=None) -> dict:
    """Inverse of :func:`model_msg_from_params`: wire message -> the
    parameter dict that ``Controller.update_model_params`` takes, as
    contiguous float32 tensors on ``device`` (``cuda`` unless the caller
    asks for another).  ``control_ranges`` (if given) fills the
    ``control_rngs`` entry, a (C, 2) float32 tensor."""
    if len(msg.structure) != msg.num_layers + 1:
        raise MsgDecodeError("structure length must be num_layers + 1")
    dev = resolve_device(device)
    weights, biases = [], []
    for i, layer in enumerate(msg.network):
        n_in, n_out = msg.structure[i], msg.structure[i + 1]
        W = np.asarray(layer.weight, np.float32)
        if W.size != n_in * n_out:
            raise MsgDecodeError(
                f"layer {i}: {W.size} weights != {n_out}x{n_in}")
        b = np.asarray(layer.bias, np.float32)
        if b.size != n_out:
            raise MsgDecodeError(f"layer {i}: {b.size} biases != {n_out}")
        W = np.ascontiguousarray(W.reshape(n_out, n_in).T)   # store (in, out)
        weights.append(torch.as_tensor(W, device=dev))
        biases.append(torch.as_tensor(b, device=dev))
    out = {"weights": weights, "biases": biases}
    if control_ranges is not None:
        out["control_rngs"] = torch.as_tensor(
            np.asarray(control_ranges, np.float32), device=dev)
    return out
