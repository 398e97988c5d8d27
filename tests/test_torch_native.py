"""The port's native runtime bindings (``runtime/native.py``): the twins of
``tests/test_native.py`` (ring buffer, pacer, UDP link) on the library the
port builds from ``native/artpu_rt.cpp`` into its own build directory, and
the build's refusal, with the compiler's output, of a source that does not
compile.  UDP ports come from the OS (``free_ports``, which the other
files of the port's tests use too)."""

import sys
import threading
import time

import numpy as np
import pytest

from autorally_tpu_torch.runtime import native
from autorally_tpu_torch.runtime.native import Pacer, Ring, UdpLink
from autorally_tpu_torch.runtime.realtime_gate import free_udp_ports

# the JAX package's tests bind fixed ports in this range while the port's
# run beside them (the test files run in parallel): never take one of it
JAX_TEST_PORTS = range(47000, 50000)


def free_ports(n: int) -> list:
    """``n`` free UDP ports from the OS, none in ``JAX_TEST_PORTS``."""
    for _ in range(100):
        ports = free_udp_ports(n)
        if not any(p in JAX_TEST_PORTS for p in ports):
            return ports
    raise RuntimeError("no free UDP ports outside the JAX tests' range")


def test_library_is_built_from_the_native_source_into_the_port_build():
    assert native.native_available()
    lib = native.load()
    assert native.SO_PATH.exists() and native.SO_PATH.name == "libartpu_rt.so"
    assert native.SO_PATH.parent.name == "_build"
    assert native.SO_PATH.parent.parent.name == "autorally_tpu_torch"
    assert native.SOURCE.name == "artpu_rt.cpp"
    assert native.SOURCE.parent.name == "native"
    assert lib is native.load()               # loaded once


def test_a_failed_build_raises_with_the_compiler_output(monkeypatch,
                                                       tmp_path):
    bad = tmp_path / "bad.cpp"
    bad.write_text("int main( {\n")
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "SO_PATH", tmp_path / "build" / "lib.so")
    with pytest.raises(RuntimeError, match="bad.cpp") as exc:
        native.load()
    assert "error" in str(exc.value)
    assert not native.native_available()
    assert not (tmp_path / "build" / "lib.so").exists()
    with pytest.raises(RuntimeError):
        Pacer(0.01)


def test_ring_fifo_order():
    r = Ring(capacity=8, record_len=3)
    for i in range(5):
        r.push(np.array([i, i + 0.5, i + 0.25], dtype=np.float32))
    for i in range(5):
        np.testing.assert_allclose(r.pop(), [i, i + 0.5, i + 0.25])
    assert r.pop() is None


def test_ring_overwrite_oldest():
    r = Ring(capacity=4, record_len=1)
    for i in range(10):
        r.push(np.array([float(i)], dtype=np.float32))
    assert r.dropped == 6
    np.testing.assert_allclose(r.pop_latest(), [9.0])
    assert r.pop() is None


def test_ring_latest_wins_and_refuses_a_wrong_record():
    r = Ring(capacity=64, record_len=2)
    assert r.pop_latest() is None
    for i in range(20):
        r.push(np.array([i, -i], dtype=np.float32))
    np.testing.assert_allclose(r.pop_latest(), [19, -19])
    with pytest.raises(ValueError, match="3 floats"):
        r.push(np.zeros(3, np.float32))


def _fast_switching():
    """A shortened thread switch interval for the threaded ring tests, so
    that the producer and the consumer alternate often even on a loaded
    host (restore the returned value)."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-4)
    return old


def test_ring_threaded_producer():
    r = Ring(capacity=1024, record_len=2)
    old = _fast_switching()

    def produce():
        for i in range(5000):
            r.push(np.array([i, 2 * i], dtype=np.float32))

    t = threading.Thread(target=produce)
    t.start()
    seen, last = 0, -1
    try:
        deadline = time.time() + 10
        while seen < 100 and time.time() < deadline:
            rec = r.pop()
            if rec is not None:
                assert rec[1] == 2 * rec[0]
                assert rec[0] > last            # monotone even with drops
                last = rec[0]
                seen += 1
    finally:
        t.join(timeout=10)
        sys.setswitchinterval(old)
    assert not t.is_alive() and seen >= 100


def test_ring_pop_full_idle_producer_terminates():
    r = Ring(capacity=4, record_len=1)
    for i in range(9):                          # head - tail == capacity
        r.push(np.array([float(i)], dtype=np.float32))
    got = []

    def drain():
        while True:
            rec = r.pop()
            if rec is None:
                return
            got.append(float(rec[0]))

    t = threading.Thread(target=drain, daemon=True)
    t.start()
    t.join(timeout=5.0)
    assert not t.is_alive(), "pop livelocked on a full idle ring"
    assert got == [5.0, 6.0, 7.0, 8.0]


def test_ring_push_reports_drops_consistently():
    r = Ring(capacity=2, record_len=1)
    flags = [r.push(np.array([float(i)], dtype=np.float32))
             for i in range(6)]
    assert sum(flags) == r.dropped == 4


def test_ring_no_torn_records_under_heavy_overwrite():
    r = Ring(capacity=2, record_len=2)
    stop = threading.Event()

    def produce():
        i = 0
        while not stop.is_set():
            r.push(np.array([i, 3.0 * i], dtype=np.float32))
            i += 1

    t = threading.Thread(target=produce, daemon=True)
    old = _fast_switching()
    t.start()
    try:
        checked, last = 0, -1.0
        deadline = time.time() + 3
        while checked < 2000 and time.time() < deadline:
            rec = r.pop()
            if rec is not None:
                assert rec[1] == 3.0 * rec[0], rec
                assert rec[0] > last
                last = rec[0]
                checked += 1
        assert checked >= 500
    finally:
        stop.set()
        t.join(timeout=5)
        sys.setswitchinterval(old)


def test_pacer_period_accuracy():
    p = Pacer(0.005)                            # 200 Hz
    t0 = time.perf_counter()
    for _ in range(40):
        p.wait()
    elapsed = time.perf_counter() - t0
    assert 0.18 < elapsed < 0.4, elapsed      # generous on a shared host
    assert p.ticks == 40


def test_pacer_reports_missed_ticks():
    p = Pacer(0.002)
    p.wait()
    time.sleep(0.02)                            # overrun ~10 periods
    assert p.wait() >= 5
    assert p.missed >= 5


def test_udp_roundtrip():
    port, = free_ports(1)
    ring = Ring(capacity=128, record_len=4)
    link = UdpLink(port, ring)
    try:
        for i in range(10):
            UdpLink.send(port, np.array([i, 1, 2, 3], dtype=np.float32))
        deadline = time.time() + 5
        while link.received < 10 and time.time() < deadline:
            time.sleep(0.01)
        assert link.received == 10
        np.testing.assert_allclose(ring.pop_latest(), [9, 1, 2, 3])
    finally:
        link.close()
