"""RTK GPS driver — the GPSHemisphere role.

Port of ``autorally_core/src/gps/GPSHemisphere.cpp`` minus ROS and the
Hemisphere-specific configuration strings:

- NMEA sentence framing from a serial byte stream with checksum
  validation (``gpsInfoCallback``, ``GPSHemisphere.cpp:192-222``);
- fix processing: GPGGA / GPGNS position + quality/mode mapping to a
  NavSatFix-shaped :class:`GpsFix` (``processGPSMessage``,
  ``:319-545``; ``processQuality`` ``:828-861``; ``processMode``
  ``:863-907``), DDMM.MMMM latitude/longitude conversion
  (``processLatitude``/``processLongitude`` ``:909-975``), antenna
  altitude + geoidal separation (``processAltitude``), GPS-time
  stamping with the ±1 s abandon guard (``:392-402``);
- covariance: GPGST known-diagonal standard deviations preferred, GPGSA
  DOP × fix-quality accuracy approximation otherwise, 5 s staleness
  back to unknown (``:609-745``);
- UTC time reference from the configured source sentence
  (``processUTC``, ``:977-1001``);
- base/rover RTK roles: the base polls ``$JRTK,6`` transmit status
  (``rtkStatusCallback``, ``:1027-1047``) and streams RTCM3 correction
  frames off its second port (``rtcmDataCallback``, ``:224-308``)
  for the radio network to broadcast; the rover writes received
  corrections into its second port and tracks correction staleness
  (``rtcmCorrectionCallback``, ``:311-317``).

What is deliberately different: the estimator here consumes a *local
ENU* position, so :func:`enu_from_geodetic` (exact WGS-84
geodetic→ECEF→ENU, the GeographicLib role in the reference's
StateEstimator) and :class:`GpsEstimatorBridge` close the path from
NMEA bytes to :meth:`ErrorStateEKF.gps_update` with the fix's own
covariance — the reference leaves that conversion to GTSAM's GpsHelper.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, List, Optional, Tuple

# NavSatStatus constants (sensor_msgs/NavSatStatus semantics)
STATUS_NO_FIX = -1
STATUS_FIX = 0
STATUS_SBAS_FIX = 1
STATUS_GBAS_FIX = 2

# NavSatFix covariance types
COV_UNKNOWN = 0
COV_APPROXIMATED = 1
COV_DIAGONAL_KNOWN = 2

COV_STALE_S = 5.0              # GPSHemisphere.cpp:609-614 / 686-691

# accuracy multipliers (launch defaults, gpsBase.launch:8-10)
ACCURACY_RTK = 0.02
ACCURACY_WAAS = 0.6
ACCURACY_AUTONOMOUS = 2.5

# RTCM3 message types the reference forwards (GPSHemisphere.cpp:268)
_RTCM3_OK = (lambda t: (1000 < t < 1030) or (4087 < t <= 4096))


@dataclasses.dataclass
class GpsFix:
    """NavSatFix-shaped fix record."""

    stamp: float = 0.0
    latitude: float = 0.0
    longitude: float = 0.0
    altitude: float = 0.0
    status: int = STATUS_NO_FIX
    position_covariance: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    covariance_type: int = COV_UNKNOWN


class NmeaFramer:
    """Byte stream -> complete NMEA sentences.

    Framing matches the reference's reader: scan to the next ``$``,
    take through ``\\r\\n``, hand the sentence on without the leading
    ``$`` (so Hemisphere ``$>JRTK`` replies arrive as ``>JRTK,...``,
    the form ``processGPSMessage`` matches on).  Checksums (``*hh``)
    are verified when present — a corrupted sentence is dropped and
    counted rather than parsed."""

    def __init__(self):
        self._buf = b""
        self.bad_checksums = 0

    def feed(self, data: bytes) -> List[str]:
        self._buf += data
        out: List[str] = []
        while True:
            start = self._buf.find(b"$")
            if start < 0:
                # no sentence start in the buffer; keep a tail in case a
                # '$' is about to arrive mid-chunk
                self._buf = b""
                return out
            end = self._buf.find(b"\r\n", start)
            if end < 0:
                self._buf = self._buf[start:]
                return out
            raw = self._buf[start + 1:end]
            self._buf = self._buf[end + 2:]
            sentence = raw.decode(errors="replace")
            if self._checksum_ok(sentence):
                out.append(self._strip_checksum(sentence))
            else:
                self.bad_checksums += 1

    @staticmethod
    def _checksum_ok(sentence: str) -> bool:
        star = sentence.rfind("*")
        if star < 0 or len(sentence) - star != 3:
            return True                        # no checksum field
        want = sentence[star + 1:]
        acc = 0
        for ch in sentence[:star]:
            acc ^= ord(ch)
        try:
            return acc == int(want, 16)
        except ValueError:
            return False

    @staticmethod
    def _strip_checksum(sentence: str) -> str:
        star = sentence.rfind("*")
        if star >= 0 and len(sentence) - star == 3:
            return sentence[:star]
        return sentence


class Rtcm3Framer:
    """Byte stream -> complete RTCM3 frames (type, frame bytes).

    Mirrors ``rtcmDataCallback`` (``GPSHemisphere.cpp:224-308``): skip
    to the 0xD3 preamble, read the 10-bit payload length from the
    header, extract the 12-bit message type from the first two payload
    bytes, forward known correction types whole (3-byte header +
    payload + 3-byte CRC), drop and count unknown types."""

    def __init__(self):
        self._buf = b""
        self.dropped = 0

    def feed(self, data: bytes) -> List[Tuple[int, bytes]]:
        self._buf += data
        out: List[Tuple[int, bytes]] = []
        while True:
            sync = self._buf.find(b"\xd3")
            if sync < 0:
                self._buf = b""
                return out
            self._buf = self._buf[sync:]
            if len(self._buf) < 6:
                return out
            length = ((self._buf[1] & 0x03) << 8) | self._buf[2]
            total = 3 + length + 3            # header + payload + CRC24
            if len(self._buf) < total:
                return out
            msg_type = (self._buf[3] << 4) | (self._buf[4] >> 4)
            frame = self._buf[:total]
            self._buf = self._buf[total:]
            if _RTCM3_OK(msg_type):
                out.append((msg_type, frame))
            else:
                self.dropped += 1


def _dm_to_degrees(value: str, hemisphere: str, degree_digits: int) -> float:
    """NMEA DDMM.MMMM / DDDMM.MMMM -> signed decimal degrees
    (``processLatitude``/``processLongitude``)."""
    deg = float(value[:degree_digits]) + float(value[degree_digits:]) / 60.0
    return -deg if hemisphere in ("S", "W") else deg


def _utc_seconds(token: str) -> float:
    """HHMMSS.SS -> seconds since UTC midnight (``GetUTC``,
    ``GPSHemisphere.cpp:1003-1020``)."""
    return (int(token[0:2]) * 3600 + int(token[2:4]) * 60
            + float(token[4:]))


class GpsReceiver:
    """NMEA fix processor with the reference's quality/covariance
    semantics.  Feed it bytes (or sentences); it maintains ``self.fix``
    and fires ``on_fix`` for each published position."""

    def __init__(self, position_source: str = "GPGNS",
                 utc_source: str = "GPZDA",
                 accuracy_rtk: float = ACCURACY_RTK,
                 accuracy_waas: float = ACCURACY_WAAS,
                 accuracy_autonomous: float = ACCURACY_AUTONOMOUS,
                 gps_time_offset: float = 0.0,
                 diagnostics=None,
                 on_fix: Optional[Callable[[GpsFix], None]] = None,
                 on_utc: Optional[Callable[[float], None]] = None,
                 clock: Callable[[], float] = time.time):
        self.position_source = position_source
        self.utc_source = utc_source
        self.accuracy = {STATUS_FIX: accuracy_autonomous,
                         STATUS_SBAS_FIX: accuracy_waas,
                         STATUS_GBAS_FIX: accuracy_rtk}
        self.gps_time_offset = gps_time_offset
        self.diag = diagnostics
        self.on_fix = on_fix
        self.on_utc = on_utc
        self.clock = clock
        self.fix = GpsFix()
        self.framer = NmeaFramer()
        self._cov = [0.0, 0.0, 0.0]
        self._cov_type = COV_UNKNOWN
        self._cov_time: Optional[float] = None
        self.rtk_status: str = "unknown"       # base-mode JRTK,6 state

    # -- ingestion -------------------------------------------------------------

    def feed(self, data: bytes) -> None:
        for sentence in self.framer.feed(data):
            self.process_sentence(sentence)

    def process_sentence(self, sentence: str) -> None:
        tokens = sentence.split(",")
        msg_type = tokens[0]
        handler = {
            "GPGGA": self._gga, "GPGNS": self._gns, "GPGST": self._gst,
            "GPGSA": self._gsa, "GLGSA": self._gsa, "GNGSA": self._gsa,
            "GPZDA": self._zda, ">JRTK": self._jrtk,
        }.get(msg_type)
        if handler is not None:
            try:
                handler(tokens)
            except (ValueError, IndexError):
                self._diag_error(f"{msg_type} parse error")
        elif msg_type in ("GPVTG", "PSAT", "GPGSV", "GLGSV",
                          "GLGNS", "GNGNS"):
            self._tick(msg_type)               # heartbeat only
        else:
            self._diag_warn(f"unknown message type {msg_type}")

    # -- position sentences ----------------------------------------------------

    def _gga(self, tokens: List[str]) -> None:
        """GPGGA: quality field is a digit (``processQuality``)."""
        if len(tokens) < 15:
            self._diag_warn("GPGGA wrong token count")
            return
        self._tick("GPGGA")
        if self.position_source != "GPGGA":
            return
        quality = tokens[6]
        status = {"0": STATUS_NO_FIX, "1": STATUS_FIX, "2": STATUS_SBAS_FIX,
                  "4": STATUS_GBAS_FIX, "5": STATUS_GBAS_FIX}.get(quality)
        self._publish_position(utc=tokens[1], lat=tokens[2], lat_h=tokens[3],
                               lon=tokens[4], lon_h=tokens[5], status=status,
                               alt=tokens[9], geoid_sep=tokens[11],
                               n_sats=tokens[7],
                               no_fix=(tokens[1] == "" or tokens[6] == "0"))

    def _gns(self, tokens: List[str]) -> None:
        """GPGNS: mode indicator is a letter per constellation
        (``processMode``)."""
        if len(tokens) < 13:
            self._diag_warn("GPGNS wrong token count")
            return
        self._tick("GPGNS")
        if self.position_source != "GPGNS":
            return
        mode = tokens[6]
        status: Optional[int] = STATUS_NO_FIX
        for ch in mode:                        # best across constellations
            s = {"N": STATUS_NO_FIX, "A": STATUS_FIX, "E": STATUS_FIX,
                 "D": STATUS_SBAS_FIX, "P": STATUS_SBAS_FIX,
                 "R": STATUS_GBAS_FIX, "F": STATUS_GBAS_FIX}.get(ch)
            if s is not None and s > status:
                status = s
        no_fix = tokens[1] == "" or all(ch == "N" for ch in mode)
        self._publish_position(utc=tokens[1], lat=tokens[2], lat_h=tokens[3],
                               lon=tokens[4], lon_h=tokens[5], status=status,
                               alt=tokens[9], geoid_sep=tokens[10],
                               n_sats=tokens[7], no_fix=no_fix)

    def _publish_position(self, utc: str, lat: str, lat_h: str, lon: str,
                          lon_h: str, status: Optional[int], alt: str,
                          geoid_sep: str, n_sats: str, no_fix: bool) -> None:
        now = self.clock()
        if no_fix or status is None or status == STATUS_NO_FIX:
            self.fix = GpsFix(stamp=now, status=STATUS_NO_FIX)
            self._diag_error("no position fix")
            return
        latitude = _dm_to_degrees(lat, lat_h, 2)
        longitude = _dm_to_degrees(lon, lon_h, 3)
        altitude = float(alt) + float(geoid_sep)
        # zero lat/lon/alt means a receiver still converging (:371-375)
        if (abs(latitude) < 1e-3 or abs(longitude) < 1e-3
                or abs(altitude) < 1e-3):
            return

        # GPS-of-day stamp, abandoned when >1 s from host time (:392-402)
        day = int(now + self.gps_time_offset) // 86400 * 86400
        stamp = day + _utc_seconds(utc) + self.gps_time_offset
        if abs(stamp - now) > 1.0:
            stamp = now
        self._maybe_expire_covariance(now)
        self.fix = GpsFix(stamp=stamp, latitude=latitude,
                          longitude=longitude, altitude=altitude,
                          status=status,
                          position_covariance=tuple(self._cov),
                          covariance_type=self._cov_type)
        if self.diag is not None:
            self.diag.diag_ok("fix", f"status {status}, {n_sats} sats")
            self.diag.tick("Publishing navSatFix")
        if self.on_fix is not None:
            self.on_fix(self.fix)

    # -- covariance sentences ----------------------------------------------------

    def _maybe_expire_covariance(self, now: float) -> None:
        if (self._cov_time is not None
                and now - self._cov_time > COV_STALE_S):
            self._cov_type = COV_UNKNOWN

    def _gst(self, tokens: List[str]) -> None:
        """GPGST: measured std devs — the best covariance source."""
        if len(tokens) < 9:
            self._diag_warn("GPGST wrong token count")
            return
        self._tick("GPGST")
        now = self.clock()
        self._maybe_expire_covariance(now)
        # No-data guard: a receiver without a fix emits empty fields.  The
        # reference gates on ``atof(utc) > 100`` (GPSHemisphere.cpp:696),
        # which also silently discards every GST in the first 61 s of the
        # UTC day (and any sim clock starting near 0); checking the fields
        # for emptiness keeps the intent without the dead window.
        if tokens[6] == "" or tokens[1] == "":
            return
        lat_sd = float(tokens[6])
        lon_sd = float(tokens[7])
        alt_sd = float(tokens[8])
        self._cov = [lat_sd ** 2, lon_sd ** 2, alt_sd ** 2]
        self._cov_type = COV_DIAGONAL_KNOWN
        self._cov_time = now

    def _gsa(self, tokens: List[str]) -> None:
        """GxGSA: DOP × per-quality accuracy — the fallback covariance
        (only upgrades from unknown/approximated, never overrides GST)."""
        if len(tokens) < 18:
            self._diag_warn("GSA wrong token count")
            return
        self._tick(tokens[0])
        now = self.clock()
        self._maybe_expire_covariance(now)
        if self._cov_type > COV_APPROXIMATED:
            return
        if float(tokens[2] or 0) <= 1:         # 1 = no fix
            return
        mult = self.accuracy.get(self.fix.status,
                                 self.accuracy[STATUS_FIX])
        hdop = float(tokens[16])
        vdop = float(tokens[17])
        self._cov = [(hdop * mult) ** 2, (hdop * mult) ** 2,
                     (vdop * mult) ** 2]
        self._cov_type = COV_APPROXIMATED
        self._cov_time = now

    # -- time / RTK status -------------------------------------------------------

    def _zda(self, tokens: List[str]) -> None:
        if len(tokens) < 2 or tokens[1] == "":
            return
        self._tick("GPZDA")
        if self.utc_source == "GPZDA" and self.on_utc is not None:
            day = int(self.clock()) // 86400 * 86400
            self.on_utc(day + _utc_seconds(tokens[1]))

    def _jrtk(self, tokens: List[str]) -> None:
        """Base-mode ``$JRTK,6`` reply: transmit status (:545-587)."""
        if len(tokens) < 2 or tokens[1] != "6":
            return
        if len(tokens) < 5:
            self._diag_warn(">JRTK wrong token count")
            return
        time_to_go, ready, transmitting = (tokens[2], int(tokens[3]),
                                           int(tokens[4]))
        if transmitting > 0:
            self.rtk_status = "transmitting"
            self._diag_ok("RTK Corrections", "transmitting")
        elif ready > 0:
            self.rtk_status = "ready"
            self._diag_ok("RTK Corrections", "ready to transmit")
        elif int(time_to_go) == 299:
            self.rtk_status = "none"
            self._diag_error("RTK Fix", "none")
        else:
            self.rtk_status = f"{time_to_go}s until ready"
            self._diag_warn("RTK Corrections",
                            f"{time_to_go} seconds until ready")

    # -- diagnostics helpers -------------------------------------------------------

    def _tick(self, key: str) -> None:
        if self.diag is not None:
            self.diag.tick(key)

    def _diag_ok(self, key: str, msg: str = "") -> None:
        if self.diag is not None:
            self.diag.diag_ok(key, msg)

    def _diag_warn(self, key: str, msg: str = "") -> None:
        if self.diag is not None:
            self.diag.diag_warn(key, msg)

    def _diag_error(self, key: str, msg: str = "") -> None:
        if self.diag is not None:
            self.diag.diag_error(key, msg)


# ---------------------------------------------------------------------------
# Base / rover roles over the serial transport
# ---------------------------------------------------------------------------

RTK_QUERY = b"$JRTK,6\r\n"                     # rtkStatusCallback, :1030
RTK_STALE_S = 120.0                            # :1033-1041 (commented policy)


class GpsBase:
    """Base-station role: NMEA status off port A, RTCM3 corrections off
    port B, forwarded whole to ``on_correction`` (the radio network's
    broadcast input — :class:`VehicleNetworkCoordinator` in this
    framework, XBee in the reference)."""

    def __init__(self, fd_nmea: int, fd_rtcm: int,
                 on_correction: Optional[Callable[[int, bytes], None]] = None,
                 diagnostics=None, **receiver_kwargs):
        from autorally_tpu_torch.runtime.serial_device import \
            SerialDeviceThreaded

        self.receiver = GpsReceiver(diagnostics=diagnostics,
                                    **receiver_kwargs)
        self.rtcm = Rtcm3Framer()
        self.on_correction = on_correction
        self.corrections_sent = 0
        self.port_a = SerialDeviceThreaded(fd_nmea, diagnostics=diagnostics,
                                           name="gps_a")
        self.port_b = SerialDeviceThreaded(fd_rtcm, diagnostics=diagnostics,
                                           name="gps_b")
        self.port_a.register_data_callback(
            lambda: self.receiver.feed(self.port_a.take()))
        self.port_b.register_data_callback(self._drain_rtcm)

    def _drain_rtcm(self) -> None:
        for msg_type, frame in self.rtcm.feed(self.port_b.take()):
            self.corrections_sent += 1
            if self.on_correction is not None:
                self.on_correction(msg_type, frame)

    def start(self) -> None:
        self.port_a.start()
        self.port_b.start()

    def query_rtk_status(self) -> None:
        """1 Hz in the reference (``m_rtkStatusTimer``)."""
        self.port_a.write_port(RTK_QUERY)

    def stop(self) -> None:
        self.port_a.stop()
        self.port_b.stop()


class GpsRover:
    """Rover role: NMEA fixes off port A; corrections received from the
    network are written into port B (``rtcmCorrectionCallback``)."""

    def __init__(self, fd_nmea: int, fd_rtcm: int, diagnostics=None,
                 clock: Callable[[], float] = time.time,
                 **receiver_kwargs):
        from autorally_tpu_torch.runtime.serial_device import \
            SerialDeviceThreaded

        self.receiver = GpsReceiver(diagnostics=diagnostics, clock=clock,
                                    **receiver_kwargs)
        self.clock = clock
        self.last_correction: Optional[float] = None
        self.port_a = SerialDeviceThreaded(fd_nmea, diagnostics=diagnostics,
                                           name="gps_a")
        self.port_b = SerialDeviceThreaded(fd_rtcm, diagnostics=diagnostics,
                                           name="gps_b")
        self.port_a.register_data_callback(
            lambda: self.receiver.feed(self.port_a.take()))

    def start(self) -> None:
        self.port_a.start()
        self.port_b.start()

    def handle_correction(self, frame: bytes) -> None:
        self.last_correction = self.clock()
        self.port_b.write_port(frame)

    @property
    def corrections_fresh(self) -> bool:
        return (self.last_correction is not None
                and self.clock() - self.last_correction < RTK_STALE_S)

    def stop(self) -> None:
        self.port_a.stop()
        self.port_b.stop()


# ---------------------------------------------------------------------------
# Geodetic -> local ENU (the GeographicLib role)
# ---------------------------------------------------------------------------

_WGS84_A = 6378137.0
_WGS84_F = 1.0 / 298.257223563
_WGS84_E2 = _WGS84_F * (2.0 - _WGS84_F)


def geodetic_to_ecef(lat_deg: float, lon_deg: float,
                     alt: float) -> Tuple[float, float, float]:
    lat = math.radians(lat_deg)
    lon = math.radians(lon_deg)
    s, c = math.sin(lat), math.cos(lat)
    n = _WGS84_A / math.sqrt(1.0 - _WGS84_E2 * s * s)
    return ((n + alt) * c * math.cos(lon),
            (n + alt) * c * math.sin(lon),
            (n * (1.0 - _WGS84_E2) + alt) * s)


def enu_from_geodetic(ref: Tuple[float, float, float],
                      lat_deg: float, lon_deg: float,
                      alt: float) -> Tuple[float, float, float]:
    """Exact WGS-84 ENU offset of (lat, lon, alt) from ``ref``."""
    x0, y0, z0 = geodetic_to_ecef(*ref)
    x, y, z = geodetic_to_ecef(lat_deg, lon_deg, alt)
    dx, dy, dz = x - x0, y - y0, z - z0
    lat = math.radians(ref[0])
    lon = math.radians(ref[1])
    sl, cl = math.sin(lon), math.cos(lon)
    sp, cp = math.sin(lat), math.cos(lat)
    east = -sl * dx + cl * dy
    north = -sp * cl * dx - sp * sl * dy + cp * dz
    up = cp * cl * dx + cp * sl * dy + sp * dz
    return east, north, up


def geodetic_from_enu(ref: Tuple[float, float, float],
                      east: float, north: float,
                      up: float = 0.0) -> Tuple[float, float, float]:
    """Inverse of :func:`enu_from_geodetic` (Newton refinement; mm-exact
    at track scale).  Used to synthesize NMEA streams from simulator
    ground truth — the Gazebo GPS plugin's job."""
    lat, lon, alt = ref
    lat_r = math.radians(ref[0])
    m_rad = _WGS84_A * (1 - _WGS84_E2) / (
        1 - _WGS84_E2 * math.sin(lat_r) ** 2) ** 1.5
    n_rad = _WGS84_A / math.sqrt(1 - _WGS84_E2 * math.sin(lat_r) ** 2)
    for _ in range(3):
        e, n, u = enu_from_geodetic(ref, lat, lon, alt)
        lat += math.degrees((north - n) / m_rad)
        lon += math.degrees((east - e) / (n_rad * math.cos(lat_r)))
        alt += up - u
    return lat, lon, alt


def _dm_format(deg: float, is_lat: bool) -> Tuple[str, str]:
    """Decimal degrees -> (DDMM.MMMMMM, hemisphere) NMEA field pair."""
    hemi = ("N" if deg >= 0 else "S") if is_lat else (
        "E" if deg >= 0 else "W")
    deg = abs(deg)
    d = int(deg)
    minutes = (deg - d) * 60.0
    width = 2 if is_lat else 3
    return f"{d:0{width}d}{minutes:09.6f}", hemi


def nmea_checksum(body: str) -> str:
    acc = 0
    for ch in body:
        acc ^= ord(ch)
    return f"{acc:02X}"


class GpsNmeaSimulator:
    """Synthesizes the receiver's wire stream from simulator ground
    truth: local ENU position -> geodetic -> ``$GPGGA`` (+ optional
    ``$GPGST`` std devs), checksummed.  Closes the loop sim -> bytes ->
    :class:`GpsReceiver` -> :class:`GpsEstimatorBridge` -> EKF with the
    real parser in the path (the Gazebo gps plugin role)."""

    def __init__(self, ref: Tuple[float, float, float] = (33.7805,
                                                          -84.4005, 250.0),
                 quality: int = 4, sigma: float = 0.02):
        self.ref = ref
        self.quality = quality
        self.sigma = sigma

    def sentences(self, t: float, x: float, y: float,
                  z: float = 0.0) -> bytes:
        lat, lon, alt = geodetic_from_enu(self.ref, x, y, z)
        hh = int(t // 3600) % 24
        mm = int(t // 60) % 60
        ss = t % 60.0
        utc = f"{hh:02d}{mm:02d}{ss:05.2f}"
        lat_s, lat_h = _dm_format(lat, True)
        lon_s, lon_h = _dm_format(lon, False)
        geoid = -30.0
        gga = (f"GPGGA,{utc},{lat_s},{lat_h},{lon_s},{lon_h},"
               f"{self.quality},15,0.8,{alt - geoid:.3f},M,{geoid:.1f},M,"
               "1.0,0001")
        gst = (f"GPGST,{utc},1.2,{self.sigma},{self.sigma},0.0,"
               f"{self.sigma},{self.sigma},{2 * self.sigma}")
        # GST precedes GGA so the fix publishes with this epoch's
        # covariance already applied (the receiver publishes on GGA)
        return (f"${gst}*{nmea_checksum(gst)}\r\n"
                f"${gga}*{nmea_checksum(gga)}\r\n").encode()


class GpsEstimatorBridge:
    """NMEA fix -> EKF position update in the local frame.

    The reference anchors its local frame at the estimator's first
    received fix; same here unless ``reference`` is given.  Each fix is
    converted to ENU and applied with its own covariance (falling back
    to the EKF's configured GPS noise when the fix has none)."""

    def __init__(self, ekf,
                 reference: Optional[Tuple[float, float, float]] = None,
                 min_status: int = STATUS_FIX):
        self.ekf = ekf
        self.reference = reference
        self.min_status = min_status
        self.updates = 0

    def __call__(self, fix: GpsFix) -> None:
        if fix.status < self.min_status:
            return
        if self.reference is None:
            self.reference = (fix.latitude, fix.longitude, fix.altitude)
        enu = enu_from_geodetic(self.reference, fix.latitude,
                                fix.longitude, fix.altitude)
        # fix covariance is (lat, lon, alt) = (N, E, U); ENU wants E first
        cov = fix.position_covariance
        var = ((cov[1], cov[0], cov[2])
               if fix.covariance_type != COV_UNKNOWN else None)
        self.ekf.gps_update(enu, var=var)
        self.updates += 1
