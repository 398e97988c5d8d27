"""The port's GPS driver (``tests/test_gps.py`` case for case on
``autorally_tpu_torch``, with the NMEA, RTCM3 and receiver cases of
``tests/test_faults.py``).

GPS driver tests (GPSHemisphere role): NMEA framing + checksums,
GGA/GNS fix semantics, GST/GSA covariance policy with 5 s staleness,
RTCM3 correction framing, base/rover roles over ptys, WGS-84 ENU
conversion, and the fix -> EKF bridge."""

import math
import os
import pty
import time

from autorally_tpu_torch.runtime.diagnostics import Diagnostics
from autorally_tpu_torch.runtime.gps import (
    ACCURACY_AUTONOMOUS, COV_APPROXIMATED, COV_DIAGONAL_KNOWN, COV_UNKNOWN,
    STATUS_FIX, STATUS_GBAS_FIX, STATUS_NO_FIX, STATUS_SBAS_FIX, GpsBase,
    GpsEstimatorBridge, GpsReceiver, GpsRover, NmeaFramer, Rtcm3Framer,
    enu_from_geodetic)


def _nmea(body: str) -> bytes:
    acc = 0
    for ch in body:
        acc ^= ord(ch)
    return f"${body}*{acc:02X}\r\n".encode()


# Atlanta-ish coordinates (the reference's home track is at GT)
GGA_RTK = ("GPGGA,170000.00,3346.8161,N,08424.0387,W,4,15,0.8,"
           "280.0,M,-30.0,M,5.0,0001")
GNS_RTK = ("GPGNS,170000.00,3346.8161,N,08424.0387,W,RR,15,0.8,"
           "280.0,-30.0,5.0,0001,S")
GST = "GPGST,170000.00,1.2,0.03,0.02,12.0,0.02,0.03,0.05"
GSA = "GPGSA,A,3,05,12,20,25,29,31,,,,,,,1.6,0.9,1.3,1"


class FakeClock:
    def __init__(self, t0: float):
        self.t = t0

    def __call__(self) -> float:
        return self.t


def _clock_at_utc(hhmmss: float = 17 * 3600.0) -> FakeClock:
    """Host clock aligned with the sentences' 170000.00 UTC stamp."""
    day = int(time.time()) // 86400 * 86400
    return FakeClock(day + hhmmss)


def test_framer_splits_validates_and_strips():
    f = NmeaFramer()
    chunk = _nmea(GST) + b"garbage" + _nmea(GGA_RTK)[:10]
    out = f.feed(chunk)
    assert out == [GST]
    out = f.feed(_nmea(GGA_RTK)[10:])
    assert out == [GGA_RTK]
    # corrupted checksum is dropped and counted
    bad = _nmea(GST).replace(b"GPGST", b"GPGSX")
    assert f.feed(bad) == []
    assert f.bad_checksums == 1
    # sentences without checksum still pass (reference never checks)
    assert f.feed(b"$GPZDA,170000.00,17,08,2026,00,00\r\n") == [
        "GPZDA,170000.00,17,08,2026,00,00"]


def test_gga_rtk_fix():
    fixes = []
    rx = GpsReceiver(position_source="GPGGA", on_fix=fixes.append,
                     clock=_clock_at_utc())
    rx.feed(_nmea(GGA_RTK))
    assert len(fixes) == 1
    fix = fixes[0]
    assert fix.status == STATUS_GBAS_FIX
    assert abs(fix.latitude - (33.0 + 46.8161 / 60.0)) < 1e-9
    assert abs(fix.longitude + (84.0 + 24.0387 / 60.0)) < 1e-9
    assert abs(fix.altitude - 250.0) < 1e-9      # antenna + geoid sep


def test_gga_quality_mapping_and_no_fix():
    rx = GpsReceiver(position_source="GPGGA", clock=_clock_at_utc())
    no_fix = GGA_RTK.replace(",4,15,", ",0,00,")
    rx.feed(_nmea(no_fix))
    assert rx.fix.status == STATUS_NO_FIX
    rx.feed(_nmea(GGA_RTK.replace(",4,15,", ",1,15,")))
    assert rx.fix.status == STATUS_FIX
    rx.feed(_nmea(GGA_RTK.replace(",4,15,", ",2,15,")))
    assert rx.fix.status == STATUS_SBAS_FIX
    rx.feed(_nmea(GGA_RTK.replace(",4,15,", ",5,15,")))
    assert rx.fix.status == STATUS_GBAS_FIX


def test_gns_mode_letters():
    rx = GpsReceiver(position_source="GPGNS", clock=_clock_at_utc())
    rx.feed(_nmea(GNS_RTK))
    assert rx.fix.status == STATUS_GBAS_FIX
    rx.feed(_nmea(GNS_RTK.replace(",RR,", ",AN,")))
    assert rx.fix.status == STATUS_FIX
    rx.feed(_nmea(GNS_RTK.replace(",RR,", ",NN,")))
    assert rx.fix.status == STATUS_NO_FIX


def test_position_source_filter():
    fixes = []
    rx = GpsReceiver(position_source="GPGNS", on_fix=fixes.append,
                     clock=_clock_at_utc())
    rx.feed(_nmea(GGA_RTK))                    # wrong source: ignored
    assert fixes == []
    rx.feed(_nmea(GNS_RTK))
    assert len(fixes) == 1


def test_gst_covariance_known_diagonal():
    clock = _clock_at_utc()
    rx = GpsReceiver(position_source="GPGGA", clock=clock)
    rx.feed(_nmea(GST))
    rx.feed(_nmea(GGA_RTK))
    assert rx.fix.covariance_type == COV_DIAGONAL_KNOWN
    lat_var, lon_var, alt_var = rx.fix.position_covariance
    assert abs(lat_var - 0.02 ** 2) < 1e-12
    assert abs(lon_var - 0.03 ** 2) < 1e-12
    assert abs(alt_var - 0.05 ** 2) < 1e-12


def test_gst_covariance_accepted_near_utc_midnight():
    """Regression: the reference gates GST on ``atof(utc) > 100``
    (GPSHemisphere.cpp:696), discarding every measured covariance in the
    first 61 s of the UTC day — and in any sim whose clock starts at 0.
    We keep only the no-data (empty-field) intent."""
    gst_midnight = GST.replace("170000.00", "000012.00")
    rx = GpsReceiver(position_source="GPGGA", clock=_clock_at_utc())
    rx.feed(_nmea(gst_midnight))
    rx.feed(_nmea(GGA_RTK))
    assert rx.fix.covariance_type == COV_DIAGONAL_KNOWN
    # a truly empty sentence is still ignored
    rx2 = GpsReceiver(position_source="GPGGA", clock=_clock_at_utc())
    rx2.feed(_nmea("GPGST,,,,,,,,"))
    rx2.feed(_nmea(GGA_RTK))
    assert rx2.fix.covariance_type != COV_DIAGONAL_KNOWN


def test_gsa_covariance_approximated_and_not_overriding_gst():
    clock = _clock_at_utc()
    rx = GpsReceiver(position_source="GPGGA", clock=clock)
    rx.feed(_nmea(GGA_RTK.replace(",4,15,", ",1,15,")))   # autonomous fix
    rx.feed(_nmea(GSA))
    rx.feed(_nmea(GGA_RTK.replace(",4,15,", ",1,15,")))
    assert rx.fix.covariance_type == COV_APPROXIMATED
    want = (0.9 * ACCURACY_AUTONOMOUS) ** 2
    assert abs(rx.fix.position_covariance[0] - want) < 1e-9
    # a GST arrives: better source wins and GSA no longer overrides
    rx.feed(_nmea(GST))
    rx.feed(_nmea(GSA))
    rx.feed(_nmea(GGA_RTK))
    assert rx.fix.covariance_type == COV_DIAGONAL_KNOWN


def test_covariance_expires_after_5s():
    clock = _clock_at_utc()
    rx = GpsReceiver(position_source="GPGGA", clock=clock)
    rx.feed(_nmea(GST))
    clock.t += 6.0
    rx.feed(_nmea(GGA_RTK))
    assert rx.fix.covariance_type == COV_UNKNOWN


def test_stamp_from_utc_and_abandon_guard():
    clock = _clock_at_utc(17 * 3600.0 + 0.35)  # host 0.35 s after the fix
    rx = GpsReceiver(position_source="GPGGA", clock=clock)
    rx.feed(_nmea(GGA_RTK))
    assert abs(rx.fix.stamp - (clock.t - 0.35)) < 1e-6
    # >1 s disagreement falls back to host time (GPSHemisphere.cpp:396-402)
    clock.t += 3600.0
    rx.feed(_nmea(GGA_RTK))
    assert rx.fix.stamp == clock.t


def test_jrtk_base_status():
    diag = Diagnostics("gps")
    rx = GpsReceiver(diagnostics=diag, clock=_clock_at_utc())
    rx.process_sentence(">JRTK,6,0,0,1")
    assert rx.rtk_status == "transmitting"
    rx.process_sentence(">JRTK,6,0,1,0")
    assert rx.rtk_status == "ready"
    rx.process_sentence(">JRTK,6,299,0,0")
    assert rx.rtk_status == "none"
    rx.process_sentence(">JRTK,6,120,0,0")
    assert "until ready" in rx.rtk_status


def test_utc_time_reference():
    utcs = []
    clock = _clock_at_utc()
    rx = GpsReceiver(on_utc=utcs.append, clock=clock)
    rx.process_sentence("GPZDA,170000.00,17,08,2026,00,00")
    assert len(utcs) == 1
    assert abs(utcs[0] - clock.t) < 1e-6


def test_rtcm3_framer_types_and_reassembly():
    def frame(msg_type: int, payload_len: int = 8) -> bytes:
        payload = bytes([msg_type >> 4, (msg_type & 0xF) << 4])
        payload += bytes(payload_len - 2)
        return (bytes([0xD3, (len(payload) >> 8) & 0x03,
                       len(payload) & 0xFF]) + payload + b"\x00\x00\x00")

    f = Rtcm3Framer()
    good = frame(1004) + frame(4094)
    out = f.feed(b"\x01\x02" + good[:5])       # leading junk + partial
    assert out == []
    out = f.feed(good[5:])
    assert [t for t, _ in out] == [1004, 4094]
    assert all(raw[0] == 0xD3 for _, raw in out)
    # unknown type dropped and counted (GPSHemisphere.cpp:297-302)
    assert f.feed(frame(1111)) == []
    assert f.dropped == 1


def test_base_and_rover_over_ptys():
    from autorally_tpu_torch.runtime.serial_device import (SerialSettings,
                                                           configure_port)

    def raw_pair():
        m, s = pty.openpty()
        configure_port(s, SerialSettings())
        return m, s

    ma, sa = raw_pair()
    mb, sb = raw_pair()
    mc, sc = raw_pair()
    md, sd = raw_pair()
    corrections = []
    base = GpsBase(sa, sb, on_correction=lambda t, f: corrections.append(f),
                   position_source="GPGGA", clock=_clock_at_utc())
    rover = GpsRover(sc, sd, position_source="GPGGA",
                     clock=_clock_at_utc())
    base.start()
    rover.start()
    try:
        os.write(ma, _nmea(GGA_RTK))
        rtcm = (bytes([0xD3, 0x00, 0x02, 1004 >> 4, (1004 & 0xF) << 4])
                + b"\x00\x00\x00")
        os.write(mb, rtcm)
        deadline = time.time() + 5.0
        while time.time() < deadline and (
                base.receiver.fix.status != STATUS_GBAS_FIX
                or not corrections):
            time.sleep(0.01)
        assert base.receiver.fix.status == STATUS_GBAS_FIX
        assert corrections == [rtcm]
        # the network hands the frame to the rover -> written to port B
        rover.handle_correction(corrections[0])
        assert os.read(md, 64) == rtcm
        assert rover.corrections_fresh
        # base RTK status query goes out port A
        base.query_rtk_status()
        assert os.read(ma, 64) == b"$JRTK,6\r\n"
    finally:
        base.stop()
        rover.stop()
        for fd in (ma, mb, mc, md, sa, sb, sc, sd):
            try:
                os.close(fd)
            except OSError:
                pass


def test_enu_from_geodetic_exactness():
    ref = (33.7805, -84.4005, 250.0)
    # 1 arcsecond north ~ 30.82 m; 1 arcsecond east at this latitude
    e, n, u = enu_from_geodetic(ref, ref[0] + 1 / 3600.0, ref[1], ref[2])
    assert abs(e) < 1e-6
    assert abs(n - 30.82) < 0.05
    assert abs(u) < 1e-3                       # earth curvature over 30 m
    e, n, u = enu_from_geodetic(ref, ref[0], ref[1] + 1 / 3600.0, ref[2])
    assert abs(n) < 1e-3
    # east arcsec uses the prime-vertical radius (~6385 km here), not
    # the meridian radius: (N + h) cos(lat) * 1"
    lat = math.radians(ref[0])
    n_rad = 6378137.0 / math.sqrt(1 - 0.00669438 * math.sin(lat) ** 2)
    want_e = (n_rad + ref[2]) * math.cos(lat) * math.radians(1 / 3600.0)
    assert abs(e - want_e) < 0.01
    e, n, u = enu_from_geodetic(ref, ref[0], ref[1], ref[2] + 2.0)
    assert abs(u - 2.0) < 1e-9


def test_estimator_bridge_feeds_ekf():
    class FakeEKF:
        def __init__(self):
            self.calls = []

        def gps_update(self, pos, var=None):
            self.calls.append((tuple(pos), var))

    ekf = FakeEKF()
    bridge = GpsEstimatorBridge(ekf)
    fixes = []
    clock = _clock_at_utc()
    rx = GpsReceiver(position_source="GPGGA", clock=clock,
                     on_fix=lambda f: (fixes.append(f), bridge(f)))
    rx.feed(_nmea(GST))
    rx.feed(_nmea(GGA_RTK))
    # second fix one arcsecond north of the first
    north = GGA_RTK.replace("3346.8161", "3346.8328")
    rx.feed(_nmea(north))
    assert bridge.updates == 2
    (p0, v0), (p1, v1) = ekf.calls
    assert p0 == (0.0, 0.0, 0.0)               # first fix anchors the frame
    assert abs(p1[1] - 30.82) < 0.3            # ~1 arcsec north
    assert v0 is not None and abs(v0[0] - 0.03 ** 2) < 1e-12  # E = lon var
    # a no-fix never reaches the filter
    bridge(fixes[0].__class__(status=STATUS_NO_FIX))
    assert bridge.updates == 2


# ---------------------------------------------------------------------------
# serial line noise into the framers (tests/test_faults.py)
# ---------------------------------------------------------------------------

def _garbage(rng, n):
    return bytes(rng.randrange(256) for _ in range(n))


def test_nmea_framer_survives_noise_and_recovers():
    import random

    from autorally_tpu_torch.runtime.gps import nmea_checksum

    rng = random.Random(3)
    body = ("GPGGA,170000.00,3346.8161,N,08424.0387,W,4,15,0.8,"
            "291.6,M,-30.8,M,1.0,0000")
    sentence = f"${body}*{nmea_checksum(body)}\r\n".encode()
    f = NmeaFramer()
    recovered = 0
    stream = b""
    for _ in range(50):
        stream += _garbage(rng, rng.randrange(0, 120)) + sentence
    # feed in adversarial chunk sizes (split mid-sentence)
    i = 0
    while i < len(stream):
        n = rng.randrange(1, 97)
        recovered += sum(1 for s in f.feed(stream[i:i + n])
                         if s.startswith("GPGGA"))
        i += n
    # a garbage block holding '$' swallows the next sentence; most recover
    # and the framer never wedges
    assert recovered >= 25
    assert f.bad_checksums > 0
    assert sum(1 for s in f.feed(sentence) if s.startswith("GPGGA")) == 1


def test_rtcm3_framer_survives_noise():
    import random

    rng = random.Random(4)
    f = Rtcm3Framer()
    for _ in range(200):
        f.feed(_garbage(rng, rng.randrange(0, 64)))   # must not raise


def test_gps_receiver_eats_garbage():
    import random

    rng = random.Random(5)
    rx = GpsReceiver()
    for _ in range(100):
        rx.feed(_garbage(rng, rng.randrange(0, 128)))  # must not raise
