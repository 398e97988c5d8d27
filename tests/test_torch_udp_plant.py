"""The port's ``UdpPlant`` (``runtime/udp_plant.py``) against the JAX
package's on the CPU: the same solution, the same pose records over UDP,
in both wire formats; the published commands, the commands sent back over
UDP and the plant states agree.  The twins of ``tests/test_udp_plant.py``'s
pipeline tests.  UDP ports come from the OS."""

import math
import time

import numpy as np
import pytest

from autorally_tpu.runtime.pose import euler_123_to_quat
from autorally_tpu.runtime.udp_plant import UdpPlant as JaxUdpPlant
from autorally_tpu_torch.runtime.native import Ring, UdpLink
from autorally_tpu_torch.runtime.udp_plant import UdpPlant
from test_torch_native import free_ports


def _wait(fn, timeout=5.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        out = fn()
        if out is not None:
            return out
        time.sleep(0.005)
    return None


def _pose_records(fmt: str, n: int = 12) -> list:
    rs = np.random.default_rng(4)
    recs = []
    for i in range(n):
        t = 100.0 + 0.013 * (i + 1)     # inside the (T - 1) dt window
        if fmt == "state":
            s = [1.0 + 0.1 * i, 2.0, 0.1 + 0.01 * i, 0.02, 3.0, 0.1, 0.05]
            recs.append(np.array([t, *(np.array(s) + rs.normal(0, 0.01, 7))],
                                 np.float32))
        else:
            yaw = 1.0 + 0.02 * i
            q = euler_123_to_quat(0.05, 0.01, yaw)
            v = 4.0 + 0.1 * i
            recs.append(np.array([t, 10.0 + 0.08 * i, -3.0, 0.0, *q,
                                  v * math.cos(yaw), v * math.sin(yaw), 0.0,
                                  0.2], np.float32))
    # an out-of-order record, which both plants drop
    recs.insert(5, recs[2].copy())
    return recs


@pytest.mark.parametrize("fmt", ["state", "odom"])
@pytest.mark.parametrize("gains", [False, True])
def test_udp_plant_publishes_what_the_jax_plant_publishes(fmt, gains):
    """Each pose record goes to both plants; each plant's poll step runs
    once the record has arrived.  The published (steering, throttle)
    (None for the dropped out-of-order record), the commands received back
    over UDP, the plant states and the drop counts agree."""
    T = 10
    ports = free_ports(4)
    rs = np.random.default_rng(7)
    ctrl = rs.uniform(-0.5, 0.5, (T, 2)).astype(np.float32)
    states = rs.normal(0, 1, (T, 7)).astype(np.float32)
    K = rs.normal(0, 0.1, (T, 2, 7)).astype(np.float32) if gains else None
    ours = UdpPlant(dt=0.02, num_timesteps=T, pose_port=ports[0],
                    control_port=ports[1], fmt=fmt, use_feedback_gains=gains)
    ref = JaxUdpPlant(dt=0.02, num_timesteps=T, pose_port=ports[2],
                      control_port=ports[3], fmt=fmt, use_feedback_gains=gains)
    rings = [Ring(capacity=64, record_len=3) for _ in range(2)]
    links = [UdpLink(ports[1], rings[0]), UdpLink(ports[3], rings[1])]
    try:
        for p in (ours, ref):
            p.set_solution(states, ctrl, K, ts=100.0)
        published = ([], [])
        recs = _pose_records(fmt)
        for i, rec in enumerate(recs):
            for p, port, pub in ((ours, ports[0], published[0]),
                                 (ref, ports[2], published[1])):
                UdpLink.send(port, rec)
                assert _wait(lambda: True if p.link.received > i else None)
                pub.append(p.poll_once())
        assert published[0] == published[1]
        assert published[0][5] is None                # the dropped record
        assert sum(o is not None for o in published[0]) == len(recs) - 1
        assert ours.dropped_poses == ref.dropped_poses == 1
        assert vars(ours.get_state()) == pytest.approx(vars(ref.get_state()))
        assert ours.published == ref.published
        sent = []
        for link, ring in zip(links, rings):
            assert _wait(lambda: True if link.received == len(recs) - 1
                         else None)
            got = []
            while (rec := ring.pop()) is not None:
                got.append(rec)
            sent.append(np.array(got))
        np.testing.assert_array_equal(sent[0], sent[1])
        np.testing.assert_allclose(
            sent[0][:, 1:], np.array([o for o in published[0]
                                      if o is not None]), rtol=1e-6)
    finally:
        for link in links:
            link.close()
        ours.stop()
        ref.stop()


def test_udp_plant_poller_thread_closes_the_loop():
    """With its poller thread started, the plant answers a pose with a
    command over UDP and stops cleanly; a bad format is refused."""
    pose_port, ctrl_port = free_ports(2)
    plant = UdpPlant(dt=0.02, num_timesteps=10, pose_port=pose_port,
                     control_port=ctrl_port, fmt="state",
                     use_feedback_gains=False)
    ring = Ring(capacity=64, record_len=3)
    link = UdpLink(ctrl_port, ring)
    try:
        plant.set_solution(np.zeros((10, 7)),
                           np.tile([0.25, 0.5], (10, 1)), None, ts=100.0)
        plant.start()
        UdpLink.send(pose_port, np.array([100.02, 1, 2, 0.1, 0, 3, 0, 0],
                                         np.float32))
        rec = _wait(ring.pop_latest)
        np.testing.assert_allclose(rec, [100.02, 0.25, 0.5], rtol=1e-6)
        st = plant.get_state()
        assert st.x_pos == 1 and st.u_x == pytest.approx(3.0)
    finally:
        plant.stop()
        link.close()
    assert not plant._thread.is_alive()
    with pytest.raises(ValueError):
        UdpPlant(dt=0.02, num_timesteps=10, pose_port=pose_port,
                 control_port=ctrl_port, fmt="xyz")
