"""The port's runstop box (``runtime/runstop_box.py``): line noise means stop
(``tests/test_faults.py::test_runstop_box_garbage_means_stop``), the same
states as the JAX box on a seeded noisy stream, and the box's serial link
and 5 Hz publisher over a pty."""

import os
import pty
import random
import time

from autorally_tpu.runtime.runstop_box import RunStopBox as JaxRunStopBox
from autorally_tpu_torch.runtime.diagnostics import Diagnostics
from autorally_tpu_torch.runtime.runstop_box import RunStopBox
from autorally_tpu_torch.runtime.serial_device import (SerialSettings,
                                                       configure_port)


def _garbage(rng, n):
    return bytes(rng.randrange(256) for _ in range(n))


def test_runstop_box_garbage_means_stop():
    rng = random.Random(8)
    box = RunStopBox(fd=-1)
    assert not box.motion_enabled
    box.process_bytes(b"#RunStop:GREEN\r\n")
    assert box.motion_enabled
    # line noise replaces the state -> must fail safe (stop)
    box.process_bytes(b"#RunStop:GRE" + _garbage(rng, 8).replace(
        b"\r", b"x") + b"\r\n")
    assert not box.motion_enabled
    box.process_bytes(b"#RunStop:GREEN\r\n")
    assert box.motion_enabled


def test_runstop_box_states_equal_jax_on_a_noisy_stream():
    """Seeded frames (GREEN, YELLOW, RED, a broken state) between bursts of
    line noise, fed in random chunks to both boxes: the same state and
    motion-enable after every chunk."""
    rng = random.Random(21)
    stream = b""
    for _ in range(200):
        stream += _garbage(rng, rng.randrange(0, 40))
        stream += rng.choice([b"#RunStop:GREEN\r\n", b"#RunStop:YELLOW\r\n",
                              b"#RunStop:RED\r\n", b"#RunStop:GR\r\n",
                              b"#RunStop:GREEN"])
    ours, ref = RunStopBox(fd=-1), JaxRunStopBox(fd=-1)
    seen = set()
    i = 0
    while i < len(stream):
        n = rng.randrange(1, 64)
        for box in (ours, ref):
            box.process_bytes(stream[i:i + n])
        assert (ours.state, ours.motion_enabled, ours._buf) == (
            ref.state, ref.motion_enabled, ref._buf)
        seen.add(ours.motion_enabled)
        i += n
    assert seen == {True, False}


def test_runstop_box_over_a_pty_publishes_and_goes_stale():
    """The box's frames through the serial transport: GREEN enables motion
    at the 5 Hz publisher, silence past a second stops it with the
    diagnostics error."""
    master, slave = pty.openpty()
    configure_port(slave, SerialSettings())
    diag = Diagnostics("runstop_box")
    votes = []
    box = RunStopBox(slave, on_runstop=lambda s, en, t: votes.append((s, en)),
                     diagnostics=diag, publish_hz=20.0)
    box.start()
    try:
        os.write(master, b"#RunStop:GREEN\r\n")
        deadline = time.time() + 5.0
        while ("RUNSTOP", True) not in votes and time.time() < deadline:
            time.sleep(0.01)
        assert ("RUNSTOP", True) in votes
        assert diag.entries["runstop"].message == "state GREEN"
        deadline = time.time() + 5.0
        while votes[-1] != ("RUNSTOP", False) and time.time() < deadline:
            time.sleep(0.05)
        assert votes[-1] == ("RUNSTOP", False)
        assert "No recent data" in diag.entries["runstop"].message
        assert box.published >= len(votes) > 2
    finally:
        box.stop()
        os.close(master)
        os.close(slave)
