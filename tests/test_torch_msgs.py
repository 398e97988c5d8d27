"""The port's wire messages (``autorally_tpu_torch/msgs.py``) against the JAX
package's: the same bytes for every type, each package decoding the other's,
the codec's faults (the codec half of ``tests/test_faults.py``) and the
neuralNetModel bridge on the port's tensor params."""

import dataclasses
import json
import random
import struct
import time

import jax
import numpy as np
import pytest
import torch

from autorally_tpu import msgs as jmsgs
from autorally_tpu.models import NeuralNetDynamics as JaxNN
from autorally_tpu_torch import msgs
from autorally_tpu_torch.models import NeuralNetDynamics

RANGES = ((-0.99, 0.99), (-0.99, 0.65))


def _samples(m):
    """One message of each of the 16 wire types (``tests/test_msgs.py``'s),
    built from module ``m``."""
    return [
        m.Point2D(x=3, y=7),
        m.Line2D(start=m.Point2D(1, 2), end=m.Point2D(3, 4)),
        m.RegionOfInterest(x_offset=2, y_offset=4, height=8, width=16),
        m.ImageMask(stamp=1.5, sender="vision", points=[m.Point2D(9, 9)],
                    lines=[m.Line2D(m.Point2D(0, 0), m.Point2D(5, 5))],
                    rois=[m.RegionOfInterest(1, 2, 3, 4)]),
        m.ChassisCommand(sender="mppi_controller", steering=-0.25,
                         throttle=0.6, front_brake=-5.0, stamp=12.25),
        m.ChassisState(steering=0.1, throttle=0.2, front_brake=0.0,
                       steering_commander="mppi_controller",
                       throttle_commander="RC", front_brake_commander="",
                       runstop_motion_enabled=True,
                       throttle_relay_enabled=True,
                       autonomous_enabled=False, stamp=13.0),
        m.WheelSpeeds(lf=1.0, rf=1.5, lb=2.0, rb=2.5, stamp=0.5),
        m.Runstop(sender="OCS", motion_enabled=True, stamp=3.0),
        m.LapStats(lap_number=4, lap_time=58.68, max_speed=5.78,
                   max_slip=0.093, stamp=99.0),
        m.NeuralNetLayer(name="dense_1", weight=[0.5, -0.5], bias=[0.25]),
        m.NeuralNetModel(network=[m.NeuralNetLayer("dense_1", [1.0, 2.0],
                                                   [3.0])],
                         num_layers=1, structure=[2, 1], stamp=7.0),
        m.PathIntegralParams(hz=50, num_timesteps=100, num_iters=1,
                             gamma=0.15, steering_var=0.3, throttle_var=0.25,
                             max_throttle=0.65, map_path="maps/ccrf.npz",
                             desired_speed=6.0),
        m.PathIntegralStats(tag="r2", stamp=1.0,
                            params=m.PathIntegralParams(hz=40),
                            stats=m.LapStats(lap_number=1)),
        m.PathIntegralStatus(info="nominal", status=0, stamp=2.0),
        m.PathIntegralTiming(average_time_between_poses=0.02,
                             average_optimization_cycle_time=0.011,
                             average_sleep_time=0.008, stamp=4.0),
        m.StateEstimatorStatus(status=m.StateEstimatorStatus.WARN,
                               stamp=5.0),
    ]


PAIRS = list(zip(_samples(msgs), _samples(jmsgs)))
IDS = [type(p).__name__ for p, _ in PAIRS]


def _same(port_msg, jax_msg) -> bool:
    """Two messages of the two packages hold the same fields and values."""
    return (type(port_msg).__name__ == type(jax_msg).__name__
            and msgs.to_dict(port_msg) == jmsgs.to_dict(jax_msg))


# -- the wire, across the packages -------------------------------------------

@pytest.mark.parametrize("pair", PAIRS, ids=IDS)
def test_encode_equals_jax(pair):
    ours, ref = pair
    assert msgs.encode(ours) == jmsgs.encode(ref)


@pytest.mark.parametrize("pair", PAIRS, ids=IDS)
def test_each_package_decodes_the_others_bytes(pair):
    ours, ref = pair
    assert _same(ours, jmsgs.decode(msgs.encode(ours)))
    assert msgs.decode(jmsgs.encode(ref)) == ours


def test_wire_ids_version_and_specs_equal_jax():
    assert msgs.WIRE_VERSION == jmsgs.WIRE_VERSION == 1
    assert msgs._MAGIC == jmsgs._MAGIC
    assert ({c.__name__: i for c, i in msgs._TYPE_IDS.items()}
            == {c.__name__: i for c, i in jmsgs._TYPE_IDS.items()})
    assert ({c.__name__: s for c, s in msgs._SPECS.items()}
            == {c.__name__: s for c, s in jmsgs._SPECS.items()})
    assert msgs._TYPE_IDS[msgs.Point2D] == 1
    assert msgs._TYPE_IDS[msgs.ChassisCommand] == 5
    assert msgs._TYPE_IDS[msgs.StateEstimatorStatus] == 16


# -- the port's codec (tests/test_msgs.py) ----------------------------------

@pytest.mark.parametrize("msg", _samples(msgs), ids=IDS)
def test_binary_roundtrip(msg):
    assert msgs.decode(msgs.encode(msg)) == msg


@pytest.mark.parametrize("msg", _samples(msgs), ids=IDS)
def test_dict_roundtrip(msg):
    d = msgs.to_dict(msg)
    assert msgs.from_dict(json.loads(json.dumps(d))) == msg


def test_all_fifteen_reference_types_covered():
    reference = {"ChassisCommand", "ChassisState", "ImageMask", "LapStats",
                 "Line2D", "NeuralNetLayer", "NeuralNetModel",
                 "PathIntegralParams", "PathIntegralStats",
                 "PathIntegralStatus", "PathIntegralTiming", "Point2D",
                 "Runstop", "StateEstimatorStatus", "WheelSpeeds"}
    assert reference <= {cls.__name__ for cls in msgs._TYPE_IDS}


def test_decode_rejects_garbage():
    with pytest.raises(msgs.MsgDecodeError):
        msgs.decode(b"")
    with pytest.raises(msgs.MsgDecodeError):
        msgs.decode(b"\x00\x01\x05" + b"junk")
    good = msgs.encode(msgs.WheelSpeeds(lf=1.0))
    for bad in (good[:-3], good + b"\x00", bytes([good[0], 99]) + good[2:],
                bytes([good[0], good[1], 250]) + good[3:]):
        with pytest.raises(msgs.MsgDecodeError):
            msgs.decode(bad)


def test_encode_rejects_non_message():
    with pytest.raises(TypeError):
        msgs.encode({"not": "a message"})
    with pytest.raises(TypeError):
        msgs.encode(jmsgs.Point2D(1, 2))      # the other package's type


def test_messages_are_dataclasses_with_defaults():
    for cls in msgs._TYPE_IDS:
        msg = cls()
        assert dataclasses.is_dataclass(msg)
        assert msgs.decode(msgs.encode(msg)) == msg


# -- faults (the codec half of tests/test_faults.py) -------------------------

def _decode_both(buf):
    """Each package's decode of ``buf``: the message's dict as JSON (NaN
    payloads compare equal there), or the error's type."""
    out = []
    for m in (msgs, jmsgs):
        try:
            out.append(json.dumps(m.to_dict(m.decode(buf)), sort_keys=True))
        except m.MsgDecodeError:
            out.append("MsgDecodeError")
    return out


@pytest.mark.parametrize("msg", _samples(msgs), ids=IDS)
def test_codec_truncation_always_raises(msg):
    buf = msgs.encode(msg)
    for n in range(0, len(buf), max(1, len(buf) // 64)):
        with pytest.raises(msgs.MsgDecodeError):
            msgs.decode(buf[:n])


@pytest.mark.parametrize("msg", _samples(msgs), ids=IDS)
def test_codec_corruption_never_escapes(msg):
    """Random corruption: the port's decode returns a message or raises
    ``MsgDecodeError``, and the JAX package's decode of the same bytes does
    the same (an equal message, or the error)."""
    rng = random.Random(1234)
    buf = bytearray(msgs.encode(msg))
    for _ in range(300):
        attack = bytearray(buf)
        for _ in range(rng.randint(1, 4)):
            attack[rng.randrange(len(attack))] = rng.randrange(256)
        ours, ref = _decode_both(bytes(attack))
        assert ours == ref


def test_codec_random_garbage():
    rng = random.Random(99)
    for _ in range(300):
        blob = bytes(rng.randrange(256) for _ in range(rng.randrange(200)))
        ours, ref = _decode_both(blob)
        assert ours == ref


def test_codec_version_and_frame_attacks():
    buf = bytearray(msgs.encode(msgs.WheelSpeeds(1, 2, 3, 4, stamp=0.5)))
    with pytest.raises(msgs.MsgDecodeError, match="version"):
        msgs.decode(bytes(buf[:1]) + bytes([msgs.WIRE_VERSION + 1])
                    + bytes(buf[2:]))
    with pytest.raises(msgs.MsgDecodeError, match="magic"):
        msgs.decode(b"\x00" + bytes(buf[1:]))
    with pytest.raises(msgs.MsgDecodeError, match="type id"):
        msgs.decode(bytes(buf[:2]) + b"\xfe" + bytes(buf[3:]))
    with pytest.raises(msgs.MsgDecodeError, match="[Tt]railing"):
        msgs.decode(bytes(buf) + b"\x00")


def test_codec_hostile_length_prefixes():
    buf = bytearray(msgs.encode(msgs.ImageMask(
        stamp=1.0, sender="v", points=[msgs.Point2D(1, 2)], lines=[],
        rois=[])))
    for off in (11, 14):              # sender's u16 length, points' count
        attack = bytearray(buf)
        attack[off:off + 2] = struct.pack("<H", 0xFFFF)
        t0 = time.monotonic()
        with pytest.raises(msgs.MsgDecodeError):
            msgs.decode(bytes(attack))
        assert time.monotonic() - t0 < 1.0
    nn = bytearray(msgs.encode(msgs.NeuralNetModel(
        network=[msgs.NeuralNetLayer("l", [1.0, 2.0], [3.0])],
        num_layers=1, structure=[2, 1], stamp=0.0)))
    idx = bytes(nn).find(struct.pack("<I", 2))     # the weights' count
    assert idx > 0
    nn[idx:idx + 4] = struct.pack("<I", 2 ** 31 - 1)
    t0 = time.monotonic()
    with pytest.raises(msgs.MsgDecodeError):
        msgs.decode(bytes(nn))
    assert time.monotonic() - t0 < 1.0


# -- the model bridge on the port's params ------------------------------------

def _model_pair(seed=0):
    """A seeded 6-32-32-4 MLP's params on both packages (the port's carried
    across with ``params_from_jax``)."""
    jm = JaxNN(0.02, control_ranges=RANGES)
    jp = jm.init_params(jax.random.PRNGKey(seed))
    rs = np.random.default_rng(seed)
    jp = {**jp, "biases": [rs.normal(size=b.shape).astype(np.float32)
                           for b in jp["biases"]]}
    tm = NeuralNetDynamics(0.02, control_ranges=RANGES, device="cpu")
    tp = tm.params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    return jm, jp, tm, tp


def test_model_bridge_bytes_equal_jax_and_roundtrip_the_params():
    """The port's params (tensors) make the bytes the JAX bridge makes of
    the same weights; the decoded message gives back contiguous float32
    tensors on the device asked for, bit for bit, which drive the model
    exactly as the originals."""
    jm, jp, tm, tp = _model_pair()
    msg = msgs.model_msg_from_params(tp, stamp=1.0)
    assert msg.num_layers == 3 and msg.structure == [6, 32, 32, 4]
    wire = msgs.encode(msg)
    assert wire == jmsgs.encode(jmsgs.model_msg_from_params(jp, stamp=1.0))
    back = msgs.params_from_model_msg(msgs.decode(wire),
                                      control_ranges=RANGES, device="cpu")
    for key in ("weights", "biases"):
        for a, b in zip(tp[key], back[key]):
            assert b.dtype == torch.float32 and b.is_contiguous()
            assert b.device.type == "cpu"
            assert torch.equal(a, b)
    assert torch.equal(back["control_rngs"], tp["control_rngs"])
    x = torch.zeros(1, 7)
    u = torch.tensor([[0.1, 0.3]])
    assert torch.equal(tm.state_deriv(tp, x, u), tm.state_deriv(back, x, u))
    # and the JAX package decodes the port's bytes to its own params
    jback = jmsgs.params_from_model_msg(jmsgs.decode(wire))
    for a, b in zip(jp["weights"], jback["weights"]):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_params_from_model_msg_defaults_to_cuda(monkeypatch):
    msg = msgs.model_msg_from_params(_model_pair()[3])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no GPU"):
        msgs.params_from_model_msg(msg)


def test_model_msg_structure_validation():
    msg = msgs.NeuralNetModel(
        network=[msgs.NeuralNetLayer("d", [1.0, 2.0], [3.0])],
        num_layers=1, structure=[2, 1, 1])
    with pytest.raises(msgs.MsgDecodeError):
        msgs.params_from_model_msg(msg, device="cpu")
    msg.structure = [3, 1]
    with pytest.raises(msgs.MsgDecodeError):
        msgs.params_from_model_msg(msg, device="cpu")
    msg.structure = [2, 1]
    msg.network[0].bias = [3.0, 4.0]
    with pytest.raises(msgs.MsgDecodeError):
        msgs.params_from_model_msg(msg, device="cpu")


def test_timing_and_lap_messages_equal_jax():
    """``TimingStats.as_msg`` and ``LapStats.record_as_msg`` give the JAX
    package's messages, byte for byte on the wire."""
    from autorally_tpu.config import MPPIConfig as JaxConfig
    from autorally_tpu.runtime import telemetry as jtele
    from autorally_tpu_torch.config import MPPIConfig
    from autorally_tpu_torch.runtime import telemetry

    ours, ref = telemetry.TimingStats(), jtele.TimingStats()
    for k in range(20):
        for t in (ours, ref):
            t.update(20.0 + k % 3, 9.5 + 0.25 * k, 10.5 - 0.25 * k)
    assert (msgs.encode(ours.as_msg(stamp=4.0))
            == jmsgs.encode(ref.as_msg(stamp=4.0)))
    rec = telemetry.LapRecord(3, 58.68, 5.78, 0.093)
    jrec = jtele.LapRecord(3, 58.68, 5.78, 0.093)
    for cfg, jcfg in ((None, None), (MPPIConfig(), JaxConfig())):
        a = telemetry.LapStats.record_as_msg(rec, cfg, tag="r2", stamp=9.0)
        b = jtele.LapStats.record_as_msg(jrec, jcfg, tag="r2", stamp=9.0)
        assert msgs.encode(a) == jmsgs.encode(b)
