"""The port's serial transport (``runtime/serial_device.py``) through a pty,
mirroring ``tests/test_serial_device.py`` (all but its chassis case, whose
link is not ported yet), and its frame scanner against the JAX
package's."""

import os
import pty
import random
import threading
import time

import pytest

from autorally_tpu.runtime import serial_device as jserial
from autorally_tpu_torch.runtime.diagnostics import Diagnostics
from autorally_tpu_torch.runtime.serial_device import (SerialDeviceThreaded,
                                                       SerialSettings,
                                                       configure_port,
                                                       open_serial_port,
                                                       scan_hash_frames)


def _raw_pty():
    """A pty pair with the slave in raw mode, as a real serial port opened
    by ``open_serial_port`` is."""
    master, slave = pty.openpty()
    configure_port(slave, SerialSettings())
    return master, slave


def _wait_for(pred, timeout=5.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(0.01)
    return False


def test_reader_buffers_and_fires_callback():
    master, slave = _raw_pty()
    dev = SerialDeviceThreaded(slave, name="test")
    fired = threading.Event()
    dev.register_data_callback(fired.set)
    dev.start()
    try:
        os.write(master, b"hello ")
        os.write(master, b"world")
        assert _wait_for(lambda: len(dev.data) == 11)
        assert fired.is_set()
        assert dev.take(5) == b"hello"
        assert dev.take() == b" world"
        assert dev.data == b""
    finally:
        dev.close()
        os.close(master)


def test_quiet_second_raises_diag_warning():
    master, slave = pty.openpty()
    diag = Diagnostics("serial")
    dev = SerialDeviceThreaded(slave, diagnostics=diag, name="gps_a")
    dev.start()
    try:
        assert _wait_for(lambda: "gps_a" in diag.entries, timeout=3.0)
        assert "No data" in diag.entries["gps_a"].message
    finally:
        dev.close()
        os.close(master)


def test_write_port_and_write_try():
    master, slave = pty.openpty()
    dev = SerialDeviceThreaded(slave, name="test")
    assert dev.write_port(b"x") == -1          # not started yet
    dev.start()
    try:
        assert dev.write_port(b"ping") == 4
        assert os.read(master, 16) == b"ping"
        dev._write_lock.acquire()
        try:
            assert dev.write_try(b"nope") == -1
        finally:
            dev._write_lock.release()
        assert dev.write_try(b"yes") == 3
        assert os.read(master, 16) == b"yes"
    finally:
        dev.close()
        os.close(master)


def test_clean_shutdown_on_peer_close():
    master, slave = _raw_pty()
    dev = SerialDeviceThreaded(slave, name="test")
    dev.start()
    os.write(master, b"last")
    assert _wait_for(lambda: dev.data == b"last")
    os.close(master)                           # EOF
    assert _wait_for(lambda: not dev._thread.is_alive(), timeout=3.0)
    dev.close()


def test_status_tick_levels():
    master, slave = pty.openpty()
    diag = Diagnostics("serial")
    dev = SerialDeviceThreaded(slave, diagnostics=diag, name="chassis")
    dev.status_tick()
    assert diag.entries["chassis"].message == "Not connected"
    dev.start()
    try:
        dev.status_tick()
        assert diag.entries["chassis"].message == "Connected"
    finally:
        dev.close()
        os.close(master)


def test_configure_port_applies_termios_settings():
    import termios

    master, slave = pty.openpty()
    try:
        configure_port(slave, SerialSettings(baud=57600, parity="even",
                                             stop_bits=2, data_bits=7))
        attrs = termios.tcgetattr(slave)
        assert attrs[4] == termios.B57600
        assert not (attrs[3] & termios.ICANON)
        assert not (attrs[3] & termios.ECHO)
    finally:
        os.close(master)
        os.close(slave)


@pytest.mark.parametrize("settings", [
    dict(baud=12345), dict(parity="marsian"), dict(data_bits=5),
    dict(stop_bits=3)], ids=["baud", "parity", "data_bits", "stop_bits"])
def test_configure_port_rejects_bad_settings(settings):
    master, slave = pty.openpty()
    try:
        with pytest.raises(ValueError):
            configure_port(slave, SerialSettings(**settings))
    finally:
        os.close(master)
        os.close(slave)


def test_open_serial_port_configures_a_pty():
    """``open_serial_port`` opens a device by path and applies the raw-mode
    settings (the pty slave's path stands in for /dev/ttyUSB0)."""
    import termios

    master, slave = pty.openpty()
    try:
        fd = open_serial_port(os.ttyname(slave), baud=38400)
        try:
            attrs = termios.tcgetattr(fd)
            assert attrs[4] == termios.B38400
            assert not (attrs[3] & termios.ICANON)
        finally:
            os.close(fd)
    finally:
        os.close(master)
        os.close(slave)


def test_scan_hash_frames_framing_and_garbage_bounds():
    frames, rest = scan_hash_frames("junk#a:1\r\n#b:2\r\n#c")
    assert frames == ["a:1", "b:2"] and rest == "#c"
    frames, rest = scan_hash_frames("x" * 10000)
    assert frames == [] and rest == ""
    frames, rest = scan_hash_frames("#" + "y" * 9000 + "#ok:GREEN")
    assert frames == [] and rest == "#ok:GREEN"
    frames, rest = scan_hash_frames(rest + "\r\n")
    assert frames == ["ok:GREEN"] and rest == ""


def test_scan_hash_frames_equals_jax_on_noisy_streams():
    """Seeded streams of frames, partial frames and line noise, fed in
    random chunks: the same frames and carried tails as the JAX scanner at
    every step (and the default ``max_partial``)."""
    rng = random.Random(7)
    alphabet = "#:\r\nGREN,ps0123456789xy"
    for _ in range(40):
        stream = "".join(rng.choice(alphabet)
                         for _ in range(rng.randrange(50, 3000)))
        ours = ref = ""
        i = 0
        while i < len(stream):
            n = rng.randrange(1, 300)
            got = scan_hash_frames(ours + stream[i:i + n], max_partial=64)
            want = jserial.scan_hash_frames(ref + stream[i:i + n],
                                            max_partial=64)
            assert got == want
            ours, ref = got[1], want[1]
            i += n
        assert scan_hash_frames(stream) == jserial.scan_hash_frames(stream)


def test_runstop_box_buffer_bounded_on_noise():
    from autorally_tpu_torch.runtime.runstop_box import RunStopBox

    box = RunStopBox(fd=-1)
    for _ in range(50):
        box.process_bytes(b"\xff\xfe garbage without framing " * 40)
    assert len(box._buf) <= 8192
    assert box.motion_enabled is False
    box.process_bytes(b"#RunStop:GREEN\r\n")
    assert box.state == "GREEN"
