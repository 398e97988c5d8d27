"""The port's runstop-box driver and vehicle network
(``tests/test_vehicle_network.py`` case for case on
``autorally_tpu_torch``).

Runstop-box serial driver + multi-vehicle network tests (the RunStop
node and XBee mesh roles; VERDICT round-1 missing items 7 and 8)."""

import os
import pty
import time

import numpy as np
import pytest

from autorally_tpu_torch.runtime.chassis import CommandArbiter, ChassisCommand
from autorally_tpu_torch.runtime.diagnostics import Diagnostics
from autorally_tpu_torch.runtime.runstop_box import RunStopBox
from autorally_tpu_torch.runtime.vehicle_network import (
    VehicleNetworkCoordinator, VehicleNetworkNode)


class TestRunStopBox:
    def test_frame_parsing_matches_reference(self):
        box = RunStopBox(fd=-1)
        # partial frame buffers until terminated
        box.process_bytes(b"#RunStop:GRE")
        assert box.state == "RED"                # initial until a frame
        box.process_bytes(b"EN\r\n")
        assert box.state == "GREEN"
        assert box.motion_enabled
        # garbage before the frame start is discarded
        box.process_bytes(b"zzz#RunStop:YELLOW\r\n")
        assert box.state == "YELLOW"
        assert not box.motion_enabled
        # multiple frames drain in one call; last wins
        box.process_bytes(b"#RunStop:RED\r\n#RunStop:GREEN\r\n")
        assert box.state == "GREEN" and box.motion_enabled

    def test_staleness_forces_stop(self):
        box = RunStopBox(fd=-1)
        box.process_bytes(b"#RunStop:GREEN\r\n")
        assert box.motion_enabled
        box.last_message_time = time.time() - 1.5     # silence > 1 s
        assert not box.motion_enabled

    def test_pty_driver_feeds_arbiter_and_diagnostics(self):
        """End-to-end over a pseudo-terminal, like the reference's box on
        a serial port: frames in -> runstop submitted to the arbiter at
        5 Hz -> actuation gated."""
        import tty

        master, slave = pty.openpty()
        tty.setraw(slave)     # raw: no CR->NL translation, no echo
        arb = CommandArbiter(["mppi"])
        diag = Diagnostics("runstop_box")
        box = RunStopBox(slave, on_runstop=arb.submit_runstop,
                         diagnostics=diag, publish_hz=50.0)
        box.start()
        try:
            os.write(master, b"#RunStop:GREEN\r\n")
            deadline = time.time() + 2
            while box.state != "GREEN" and time.time() < deadline:
                time.sleep(0.01)
            time.sleep(0.1)                        # let publisher fire
            arb.submit(ChassisCommand(sender="mppi", steering=0.1,
                                      throttle=0.5, stamp=time.time()))
            st = arb.arbitrate(time.time())
            assert st.throttle == pytest.approx(0.5)

            os.write(master, b"#RunStop:RED\r\n")
            deadline = time.time() + 2
            while box.state != "RED" and time.time() < deadline:
                time.sleep(0.01)
            time.sleep(0.1)
            arb.submit(ChassisCommand(sender="mppi", steering=0.1,
                                      throttle=0.5, stamp=time.time()))
            st = arb.arbitrate(time.time())
            assert st.throttle <= 0.0              # runstop engaged
            assert box.published > 3
        finally:
            box.stop()
            os.close(master)
            os.close(slave)


class TestVehicleNetwork:
    def test_registration_pose_relay_and_runstop(self):
        coord = VehicleNetworkCoordinator(runstop_hz=50.0)
        coord.start()
        got = []
        alpha = VehicleNetworkNode(
            "alpha", ("127.0.0.1", coord.port),
            on_peer_pose=lambda s, m: got.append((s, m)))
        beta = VehicleNetworkNode("beta", ("127.0.0.1", coord.port),
                                  transmit_hz=100.0)
        try:
            alpha.start()
            beta.start()
            deadline = time.time() + 3
            while len(coord.active_vehicles()) < 2 and time.time() < deadline:
                time.sleep(0.02)
            assert coord.active_vehicles() == ["alpha", "beta"]

            # runstop broadcast: disabled by default at the base station
            deadline = time.time() + 3
            while alpha._last_runstop is None and time.time() < deadline:
                time.sleep(0.02)
            assert not alpha.motion_enabled
            coord.set_runstop(True)
            deadline = time.time() + 3
            while not alpha.motion_enabled and time.time() < deadline:
                time.sleep(0.02)
            assert alpha.motion_enabled and beta.motion_enabled

            # pose relay: beta's pose reaches alpha, not beta itself
            assert beta.transmit_pose(1.0, x=3.0, y=4.0, yaw=0.5,
                                      vx=5.0, vy=0.1)
            deadline = time.time() + 3
            while "beta" not in alpha.peers() and time.time() < deadline:
                time.sleep(0.02)
            pose = alpha.peers()["beta"]
            assert pose["x"] == 3.0 and pose["vx"] == 5.0
            assert got and got[-1][0] == "beta"
            assert "alpha" not in beta.peers()

            # rate cap: back-to-back transmits are suppressed
            beta.transmit_pose(1.01, 3, 4, 0.5, 5, 0.1)
            assert not beta.transmit_pose(1.02, 3, 4, 0.5, 5, 0.1)
        finally:
            alpha.close()
            beta.close()
            coord.close()

    def test_runstop_staleness_disables_motion(self):
        coord = VehicleNetworkCoordinator(runstop_hz=50.0)
        coord.set_runstop(True)
        coord.start()
        node = VehicleNetworkNode("solo", ("127.0.0.1", coord.port))
        try:
            node.start()
            deadline = time.time() + 3
            while not node.motion_enabled and time.time() < deadline:
                time.sleep(0.02)
            assert node.motion_enabled
            coord.close()                          # radio silence
            deadline = time.time() + 3
            while node.motion_enabled and time.time() < deadline:
                time.sleep(0.05)
            assert not node.motion_enabled         # 1 s staleness-to-stop
        finally:
            node.close()

    def test_peer_poses_feed_obstacle_cost(self):
        """The multi-vehicle role the mesh exists for: another vehicle's
        relayed pose becomes a dynamic obstacle in the cost function."""
        from autorally_tpu_torch.costs.obstacles import make_obstacles

        coord = VehicleNetworkCoordinator()
        coord.start()
        me = VehicleNetworkNode("me", ("127.0.0.1", coord.port))
        other = VehicleNetworkNode("other", ("127.0.0.1", coord.port),
                                   transmit_hz=100.0)
        try:
            me.start()
            other.start()
            deadline = time.time() + 3
            while len(coord.active_vehicles()) < 2 and time.time() < deadline:
                time.sleep(0.02)
            other.transmit_pose(0.0, x=10.0, y=-2.0, yaw=0.0,
                                vx=3.0, vy=0.0)
            deadline = time.time() + 3
            while "other" not in me.peers() and time.time() < deadline:
                time.sleep(0.02)
            poses = me.peers()
            circles = [(p["x"], p["y"], 0.5) for p in poses.values()]
            obs = make_obstacles(circles, device="cpu")
            arr = obs.numpy()
            active = arr[arr[:, 2] > 0]
            assert active.shape == (1, 3)
            assert active[0, 0] == 10.0 and active[0, 1] == -2.0
        finally:
            me.close()
            other.close()
            coord.close()


def test_rtk_corrections_relay_base_to_rovers():
    """The full reference RTK chain (XBee transmitRTCM role): base GPS
    port B -> coordinator broadcast -> vehicle node -> rover port B."""
    import os
    import pty

    from autorally_tpu_torch.runtime.gps import GpsBase, GpsRover
    from autorally_tpu_torch.runtime.serial_device import (SerialSettings,
                                                           configure_port)
    from autorally_tpu_torch.runtime.vehicle_network import (
        VehicleNetworkCoordinator, VehicleNetworkNode)

    def raw_pair():
        m, s = pty.openpty()
        configure_port(s, SerialSettings())
        return m, s

    ma, sa = raw_pair()
    mb, sb = raw_pair()
    mc, sc = raw_pair()
    md, sd = raw_pair()
    coord = VehicleNetworkCoordinator(port=0)
    coord.start()
    rover = GpsRover(sc, sd)
    node = VehicleNetworkNode("alpha", ("127.0.0.1", coord.port),
                              on_correction=rover.handle_correction)
    base = GpsBase(sa, sb, on_correction=coord.broadcast_correction)
    try:
        node.start()
        rover.start()
        base.start()
        deadline = time.time() + 5.0
        while time.time() < deadline and not coord.active_vehicles():
            time.sleep(0.02)
        assert coord.active_vehicles() == ["alpha"]

        rtcm = (bytes([0xD3, 0x00, 0x02, 1004 >> 4, (1004 & 0xF) << 4])
                + b"\x00\x00\x00")
        os.write(mb, rtcm)                     # base GPS emits a frame
        deadline = time.time() + 5.0
        while time.time() < deadline and node.corrections_received == 0:
            time.sleep(0.02)
        assert node.corrections_received == 1
        assert os.read(md, 64) == rtcm         # landed on the rover's port B
        assert rover.corrections_fresh
    finally:
        base.stop()
        rover.stop()
        node.close()
        coord.close()
        for fd in (ma, mb, mc, md, sa, sb, sc, sd):
            try:
                os.close(fd)
            except OSError:
                pass


def test_timing_and_lap_stats_wire_bridges():
    from autorally_tpu_torch import msgs
    from autorally_tpu_torch.config import MPPIConfig
    from autorally_tpu_torch.runtime.telemetry import (LapRecord, LapStats,
                                                       TimingStats)

    t = TimingStats()
    t.update(20.0, 11.0, 8.0)
    msg = t.as_msg(stamp=5.0)
    assert isinstance(msg, msgs.PathIntegralTiming)
    assert abs(msg.average_optimization_cycle_time - 0.011) < 1e-12
    assert msgs.decode(msgs.encode(msg)) == msg

    rec = LapRecord(lap_number=2, lap_time=58.7, max_speed=5.8,
                    max_slip=0.09)
    stats = LapStats.record_as_msg(rec, cfg=MPPIConfig(), tag="r2",
                                   stamp=6.0)
    assert isinstance(stats, msgs.PathIntegralStats)
    assert stats.stats.lap_time == 58.7
    assert stats.params.hz == 50 and stats.params.num_timesteps == 100
    assert msgs.decode(msgs.encode(stats)) == stats
