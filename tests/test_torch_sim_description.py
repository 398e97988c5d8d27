"""The port's scene description (``autorally_tpu_torch/sim/description.py``)
against the JAX package's on the CPU: the bundled URDF (the port's own copy,
byte for byte the JAX one) parses into the same description, the physics
parameters and the sensor rig map from it field by field as the JAX
package's, malformed documents are refused alike, worlds round-trip and
are validated, and the description drives the port's simulator."""

import dataclasses
import filecmp
import json
import math
import os

import numpy as np
import pytest

from autorally_tpu.sim import description as jdesc
from autorally_tpu_torch.sim.description import (
    DEFAULT_URDF, DescriptionError, WorldDescription, load_urdf, load_world,
    save_world, sensor_config_from_description,
    vehicle_params_from_description)


def test_bundled_urdf_is_the_jax_packages_byte_for_byte():
    import autorally_tpu_torch

    assert os.path.exists(DEFAULT_URDF)
    assert DEFAULT_URDF.startswith(
        os.path.dirname(os.path.abspath(autorally_tpu_torch.__file__))
        + os.sep)
    assert filecmp.cmp(DEFAULT_URDF, jdesc.DEFAULT_URDF, shallow=False)


def test_bundled_urdf_matches_platform_spec_and_jax():
    desc = load_urdf(DEFAULT_URDF)
    assert desc.name == "autorally_platform"
    assert desc.chassis_mass == 20.5
    assert abs(desc.total_mass - 23.92) < 1e-9
    assert abs(desc.wheelbase - 0.570) < 1e-9
    assert abs(desc.track - 0.40) < 1e-9
    assert desc.wheel_radius == 0.095
    assert abs(desc.max_steer - math.radians(25.0)) < 1e-3
    assert desc.mu == 0.7
    assert desc.com_height == 0.12
    assert desc.axle_effort == 8.0
    jd = jdesc.load_urdf(jdesc.DEFAULT_URDF)
    assert dataclasses.asdict(desc) == dataclasses.asdict(jd)
    assert desc.wheelbase == jd.wheelbase
    assert desc.total_mass == jd.total_mass


def test_sensor_rig_matches_jax():
    desc = load_urdf(DEFAULT_URDF)
    assert desc.sensors["imu"].update_rate == 200.0
    assert desc.sensors["gps"].update_rate == 20.0
    assert desc.sensors["stereo_camera"].update_rate == 60.0
    jd = jdesc.load_urdf(jdesc.DEFAULT_URDF)
    for hz in (50.0, 20.0, 100.0):
        cfg = sensor_config_from_description(desc, control_hz=hz)
        jcfg = jdesc.sensor_config_from_description(jd, control_hz=hz)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    cfg = sensor_config_from_description(desc, control_hz=50.0)
    assert (cfg.accel_noise, cfg.gyro_noise, cfg.gps_noise) == (0.2, 0.02,
                                                                0.15)
    assert cfg.gps_every in (2, 3)


@pytest.mark.parametrize("overrides", [{}, {"mu": 0.4},
                                       {"izz": 0.6, "ixx": 0.175}])
def test_vehicle_params_mapping_field_by_field(overrides):
    desc = load_urdf(DEFAULT_URDF)
    vp = vehicle_params_from_description(desc, **overrides)
    jvp = jdesc.vehicle_params_from_description(
        jdesc.load_urdf(jdesc.DEFAULT_URDF), **overrides)
    for f in dataclasses.fields(vp):
        assert getattr(vp, f.name) == getattr(jvp, f.name), f.name
    assert [f.name for f in dataclasses.fields(vp)] == \
        [f.name for f in dataclasses.fields(jvp)]
    assert vp.mu == overrides.get("mu", 0.7)
    assert abs(vp.mass - 23.92) < 1e-9
    assert vp.a == 0.34 and vp.b == 0.23


def test_description_drives_the_physics_sim():
    from autorally_tpu_torch.sim.vehicle import (controller_state,
                                                 init_sim_state,
                                                 vehicle_step)

    vp = vehicle_params_from_description(load_urdf(DEFAULT_URDF))
    s = init_sim_state(x=0.0, y=0.0, yaw=0.0, vx=0.0, device="cpu")
    for _ in range(50):                        # 1 s of half throttle
        s = vehicle_step(vp, s, [0.0, 0.5, 0.0], 0.02, 10)
    out = controller_state(s).numpy()
    assert out[4] > 1.0
    assert np.isfinite(out).all()


@pytest.mark.parametrize("doc", [
    "<robot name='x'><link name='chassis'><inertial><mass value='1'/>"
    "</inertial></link></robot>",
    "<material name='x'/>",
    "<robot name='x'><link name='chassis'/><link name='lf_wheel'>"
    "<collision><geometry><cylinder radius='0.1' length='0.05'/>"
    "</geometry></collision></link></robot>",
])
def test_malformed_urdf_rejected_as_jax(tmp_path, doc):
    bad = tmp_path / "bad.urdf"
    bad.write_text(doc)
    with pytest.raises(jdesc.DescriptionError) as jexc:
        jdesc.load_urdf(str(bad))
    with pytest.raises(DescriptionError) as exc:
        load_urdf(str(bad))
    assert str(exc.value) == str(jexc.value)


def test_world_roundtrip_and_validation(tmp_path):
    w = WorldDescription(name="ccrf", track="maps/ccrf.npz",
                         spawn_x=1.0, spawn_y=-2.0, spawn_yaw=0.5,
                         mu=0.55, desired_speed=8.0)
    path = str(tmp_path / "ccrf.json")
    save_world(w, path)
    assert load_world(path) == w
    jpath = str(tmp_path / "jccrf.json")
    jdesc.save_world(jdesc.WorldDescription(**dataclasses.asdict(w)), jpath)
    with open(path) as a, open(jpath) as b:
        assert a.read() == b.read()
    assert dataclasses.asdict(jdesc.load_world(path)) == \
        dataclasses.asdict(w)
    assert WorldDescription() == WorldDescription(
        **dataclasses.asdict(jdesc.WorldDescription()))
    with open(path) as f:
        doc = json.load(f)
    doc["gravity"] = -9.8
    with open(path, "w") as f:
        json.dump(doc, f)
    with pytest.raises(DescriptionError, match="gravity"):
        load_world(path)
