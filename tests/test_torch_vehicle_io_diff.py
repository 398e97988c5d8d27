"""The port's vehicle I/O against the JAX package's, field for field.

The same seeded byte streams (valid frames with garbage and corrupted
frames between them, cut at random points) go to each module of
``autorally_tpu.runtime`` and to its twin in ``autorally_tpu_torch``:
GPS fixes, covariances, UTC references and RTK states, the chassis link's
callbacks and ``#s`` bytes, the arbiter's states, the controllers'
commands, the wheel odometry's estimates and the WGS-84 helpers must be
equal.  The scaling forecast's document for a given ladder is held
against the JAX tool's, key for key, its fabrics aside.
"""

import dataclasses
import json
import os

import numpy as np
import pytest

from autorally_tpu.runtime import chassis as jchassis
from autorally_tpu.runtime import controllers as jcontrollers
from autorally_tpu.runtime import gps as jgps
from autorally_tpu.runtime import wheel_odometry as jodom
from autorally_tpu.runtime.diagnostics import Diagnostics as JDiagnostics
from autorally_tpu_torch.runtime import chassis, controllers, gps
from autorally_tpu_torch.runtime import wheel_odometry as odom
from autorally_tpu_torch.runtime.diagnostics import Diagnostics

DAY = 20000 * 86400.0


class Clock:
    def __init__(self, t: float):
        self.t = t

    def __call__(self) -> float:
        return self.t


def _nmea(body: str) -> bytes:
    return f"${body}*{gps.nmea_checksum(body)}\r\n".encode()


def _garbage(rng, n: int) -> bytes:
    return rng.integers(0, 256, n, dtype=np.uint8).tobytes()


def _dm(deg: float, lat: bool) -> str:
    s, h = gps._dm_format(deg, lat)
    return f"{s},{h}"


def _gps_stream(seed: int, epochs: int):
    """(UTC seconds, bytes) an epoch: GST, GSA, GGA, GNS, ZDA and JRTK in a
    shuffled order, each corrupted at 10 %, garbage between them."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(epochs):
        t = 17 * 3600.0 + 0.1 * i + (86400.0 - 17 * 3600.0 - 3.0
                                      if i > epochs // 2 else 0.0)
        utc = f"{int(t // 3600) % 24:02d}{int(t // 60) % 60:02d}{t % 60:05.2f}"
        lat = 33.78 + rng.normal(0, 1e-4)
        lon = -84.40 + rng.normal(0, 1e-4)
        q = int(rng.choice([0, 1, 2, 4, 5]))
        mode = str(rng.choice(["RR", "AN", "NN", "FF", "DN", "RA"]))
        s = rng.uniform(0.005, 3.0, 3)
        sentences = [
            f"GPGGA,{utc},{_dm(lat, True)},{_dm(lon, False)},{q},15,0.8,"
            f"{rng.uniform(200, 300):.3f},M,-30.0,M,1.0,0001",
            f"GPGNS,{utc},{_dm(lat, True)},{_dm(lon, False)},{mode},12,0.9,"
            f"{rng.uniform(200, 300):.3f},-30.0,5.0,0001,S",
            f"GPGST,{utc},1.2,{s[0]:.3f},{s[1]:.3f},12.0,{s[0]:.3f},"
            f"{s[1]:.3f},{s[2]:.3f}",
            f"GPGSA,A,3,05,12,20,25,,,,,,,,,{rng.uniform(1, 3):.1f},"
            f"{rng.uniform(0.5, 2):.1f},{rng.uniform(1, 3):.1f},1",
            f"GPZDA,{utc},17,08,2026,00,00",
            f">JRTK,6,{int(rng.choice([0, 120, 299]))},"
            f"{int(rng.integers(0, 2))},{int(rng.integers(0, 2))}",
            "GPVTG,,T,,M,0.0,N,0.0,K,A",
            "GPXYZ,1,2,3",
        ]
        chunk = b""
        for j in rng.permutation(len(sentences)):
            frame = _nmea(sentences[j])
            if rng.random() < 0.1:
                k = int(rng.integers(1, len(frame) - 4))
                frame = frame[:k] + b"Z" + frame[k + 1:]
            chunk += _garbage(rng, int(rng.integers(0, 12))) + frame
        out.append((t, chunk))
    return out


def _drive_receiver(mod, diag_cls, source: str, seed: int):
    fixes, utcs = [], []
    clock = Clock(DAY + 17 * 3600.0)
    diag = diag_cls("gps")
    rx = mod.GpsReceiver(position_source=source, diagnostics=diag,
                         on_fix=fixes.append, on_utc=utcs.append,
                         clock=clock)
    rng = np.random.default_rng(seed + 1)
    states = []
    for t, data in _gps_stream(seed, 120):
        clock.t = DAY + t + rng.uniform(0, 0.05)
        i = 0
        while i < len(data):
            n = int(rng.integers(1, 64))
            rx.feed(data[i:i + n])
            i += n
        states.append((rx.rtk_status, rx._cov_type, tuple(rx._cov)))
    entries = {k: (e.level, e.message) for k, e in diag.entries.items()}
    return ([dataclasses.asdict(f) for f in fixes], utcs, states,
            rx.framer.bad_checksums, entries)


@pytest.mark.parametrize("source", ["GPGGA", "GPGNS"])
@pytest.mark.parametrize("seed", [0, 1])
def test_gps_receiver_equals_jax_on_a_noisy_stream(source, seed):
    ours = _drive_receiver(gps, Diagnostics, source, seed)
    ref = _drive_receiver(jgps, JDiagnostics, source, seed)
    assert len(ours[0]) > 20               # fixes were published
    assert ours == ref


def test_rtcm3_framer_equals_jax():
    rng = np.random.default_rng(7)
    stream = b""
    for _ in range(60):
        t = int(rng.choice([1004, 1005, 1012, 1033, 4090, 999]))
        n = int(rng.integers(2, 40))
        body = bytes([t >> 4, (t & 0xF) << 4]) + _garbage(rng, n - 2)
        stream += (_garbage(rng, int(rng.integers(0, 20)))
                   + bytes([0xD3, n >> 8, n & 0xFF]) + body + b"\x00\x00\x00")
    a, b = gps.Rtcm3Framer(), jgps.Rtcm3Framer()
    got_a, got_b = [], []
    i = 0
    while i < len(stream):
        n = int(rng.integers(1, 50))
        got_a += a.feed(stream[i:i + n])
        got_b += b.feed(stream[i:i + n])
        i += n
    assert got_a and got_a == got_b


def test_wgs84_helpers_and_simulator_equal_jax():
    rng = np.random.default_rng(3)
    ref = (33.7805, -84.4005, 250.0)
    sim, jsim = gps.GpsNmeaSimulator(), jgps.GpsNmeaSimulator()
    for x, y, z in rng.uniform(-500, 500, (50, 3)):
        geo = gps.geodetic_from_enu(ref, x, y, z)
        assert geo == jgps.geodetic_from_enu(ref, x, y, z)
        assert (gps.enu_from_geodetic(ref, *geo)
                == jgps.enu_from_geodetic(ref, *geo))
        assert gps.geodetic_to_ecef(*geo) == jgps.geodetic_to_ecef(*geo)
        t = float(rng.uniform(0, 86400))
        assert sim.sentences(t, x, y, z) == jsim.sentences(t, x, y, z)


def _chassis_stream(seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    out = b""
    for _ in range(80):
        kind = rng.integers(0, 5)
        if kind == 0:
            body = ",".join(f"{v:.3f}" for v in rng.uniform(-1, 30, 4))
            frame = b"#w" + body.encode()
        elif kind == 1:
            us = rng.integers(800, 2200, 3)
            frame = (f"#r{us[0]},{us[1]},{us[2]},{rng.integers(0, 2)}"
                     .encode())
        elif kind == 2:
            frame = b"#e" + _garbage(rng, 6).replace(b"\n", b"x")
        elif kind == 3:
            frame = b"#w1.0,2.0"                     # wrong field count
        else:
            frame = b"#r1500,abc,1600,1"             # unparsable
        junk = _garbage(rng, int(rng.integers(0, 20))).replace(b"#", b"*")
        out += junk + frame + b"\n"
    return out


def test_chassis_link_equals_jax_on_a_noisy_stream():
    stream = _chassis_stream(11)
    rng = np.random.default_rng(12)
    cuts = []
    i = 0
    while i < len(stream):
        n = int(rng.integers(1, 40))
        cuts.append(stream[i:i + n])
        i += n

    def run(mod):
        got = []
        link = mod.ChassisLink(
            fd=-1, calibration=mod.ActuatorCalibration(),
            on_wheel_speeds=lambda *a: got.append(("w",) + a),
            on_rc_command=lambda *a: got.append(("r",) + a),
            on_error=lambda e: got.append(("e", e)))
        for c in cuts:
            link.process_bytes(c)
        return got, link.autonomous_enabled, link.throttle_relay_enabled

    ours, ref = run(chassis), run(jchassis)
    assert len(ours[0]) > 40
    assert ours == ref


def test_calibration_and_send_command_bytes_equal_jax():
    rng = np.random.default_rng(5)
    cfg = {"steering": (1100, 1520, 1900, True),
           "throttle": (1000, 1500, 2000, False),
           "frontBrake": (1050, 1480, 1950, True)}

    def cal(mod):
        return mod.ActuatorCalibration({
            k: mod.ActuatorConfig(*v) for k, v in cfg.items()})

    frames = []
    for mod in (chassis, jchassis):
        r, w = os.pipe()
        link = mod.ChassisLink(w, cal(mod))
        out = []
        for s, t, b in rng.uniform(-1.2, 1.2, (40, 3)):
            link.send_command(float(s), float(t), float(abs(b)))
            out.append(os.read(r, 64))
        os.close(r)
        os.close(w)
        frames.append(out)
        rng = np.random.default_rng(5)
    assert frames[0] == frames[1]
    assert all(len(f) == 9 and f[:2] == b"#s" for f in frames[0])
    a, b = cal(chassis), cal(jchassis)
    for us in rng.integers(800, 2200, 200):
        for act in cfg:
            assert a.us_to_cmd(int(us), act) == b.us_to_cmd(int(us), act)


def test_arbiter_equals_jax_on_seeded_submissions():
    names = ["joystick", "mppi", "constantSpeed", "waypoint"]
    rng = np.random.default_rng(9)
    events = []
    now = 100.0
    for _ in range(400):
        now += float(rng.uniform(0, 0.08))
        if rng.random() < 0.2:
            events.append(("runstop", str(rng.choice(["box", "ocs"])),
                           bool(rng.random() < 0.8), now))
        else:
            v = rng.uniform(-1.3, 1.3, 3)
            v[rng.random(3) < 0.2] = -5.0
            events.append(("cmd", str(rng.choice(names)),
                           tuple(float(x) for x in v), now))

    def run(mod, msgs_cmd):
        arb = mod.CommandArbiter(names, command_max_age=0.15)
        out = []
        for kind, who, val, t in events:
            if kind == "runstop":
                arb.submit_runstop(who, val, t)
            else:
                arb.submit(msgs_cmd(sender=who, stamp=t, steering=val[0],
                                    throttle=val[1], front_brake=val[2]))
            out.append(dataclasses.asdict(arb.arbitrate(t + 0.01)))
        return out

    ours = run(chassis, chassis.ChassisCommand)
    ref = run(jchassis, jchassis.ChassisCommand)
    assert ours == ref
    assert {o["throttle_commander"] for o in ours} >= {"runstop", "mppi"}


def test_controllers_equal_jax_on_seeded_inputs():
    rng = np.random.default_rng(21)
    speeds = rng.uniform(0, 12, (300, 4))
    poses = rng.uniform(-20, 20, (300, 3))
    axes = rng.uniform(-1.2, 1.2, (300, 4))
    wps = [tuple(p) for p in rng.uniform(-20, 20, (6, 2))]

    def run(mod):
        cs = mod.ConstantSpeedController()
        cs.set_speed(6.0)
        wp = mod.GpsWaypointController(wps, radius=2.0)
        joy = mod.JoystickController()
        gov = mod.SafeSpeedGovernor(max_speed=8.0)
        cal = mod.ThrottleCalibration(mod.DEFAULT_CALIBRATION.points)
        out = []
        for i in range(300):
            t = 0.02 * i
            if i % 50 == 0:
                gov.submit_safe_speed(f"s{i % 3}", float(rng.uniform(3, 9)),
                                      t)
            out.append(dataclasses.asdict(cs.wheel_speeds(*speeds[i], t)))
            out.append(dataclasses.asdict(wp.odometry(*poses[i], t)))
            out.append(dataclasses.asdict(joy.joy(list(axes[i]), t)))
            out.append((gov.get_safe_speed(t), gov.safe_throttle(
                float(axes[i, 0]), float(speeds[i, 0]), t),
                cal.interpolate(float(speeds[i, 1]))))
        return out

    rng = np.random.default_rng(21)
    ours = run(controllers)
    rng = np.random.default_rng(21)
    ref = run(jcontrollers)
    assert ours == ref


def test_wheel_odometry_equals_jax():
    rng = np.random.default_rng(4)
    a, b = odom.WheelOdometry(), jodom.WheelOdometry()
    for i in range(500):
        if i % 25 == 0:
            s = float(rng.uniform(-1.1, 1.1))
            a.update_steering(s)
            b.update_steering(s)
        w = rng.uniform(0, 8, 4)
        ea = a.update_wheel_speeds(0.02 * i, *w)
        eb = b.update_wheel_speeds(0.02 * i, *w)
        assert dataclasses.asdict(ea) == dataclasses.asdict(eb)


def test_scaling_forecast_equals_jax_for_a_ladder(capsys):
    from autorally_tpu.tools import scaling_forecast as jsf
    from autorally_tpu_torch.tools import scaling_forecast as sf

    ladder = "1920=0.1932,8192=0.3292,262144=3.9414"
    argv = ["--skip-probe", "--ladder", ladder, "--ns", "2,4,8,16"]
    doc = sf.main(argv)
    ours = capsys.readouterr().out.strip()
    jsf.main(argv)
    ref = json.loads(capsys.readouterr().out.strip())
    assert json.loads(ours) == doc
    assert doc["ladder_ms"] == ref["ladder_ms"]
    assert doc["fit"] == ref["fit"]
    assert set(doc) == set(ref)
    assert set(doc["forecast"]) == set(ref["forecast"])
    # the model itself is the JAX tool's: equal rows on equal fabrics
    for fab in list(sf.FABRICS.values()) + list(jsf.FABRICS.values()):
        for K in (1920, 262144):
            a, b = sf.fit_ladder(sf.DEFAULT_LADDER)
            assert (sf.forecast(K, a, b, fab, [2, 4, 8])
                    == jsf.forecast(K, a, b, fab, [2, 4, 8]))
            assert (sf.t_coll_ms(4, fab, 4096)
                    == jsf.t_coll_ms(4, fab, 4096))
