"""Vehicle + world scene description, the ``autorally_description`` role
(port of ``autorally_tpu/sim/description.py``).

The reference describes the platform as a URDF/xacro scene
(``autorally_description/urdf/autoRallyPlatform.urdf.xacro``) that
Gazebo instantiates: link masses/inertias, wheel geometry, steering
joint limits, axle efforts, tire friction, and sensor plugins (IMU
200 Hz, GPS 20 Hz, stereo camera 60 Hz).  This module parses a plain
URDF subset (stdlib ``xml.etree``) into semantic quantities and maps
them onto this framework's simulator:

- :func:`load_urdf` -> :class:`VehicleDescription` (masses, axle
  positions from joint origins, wheel radius from cylinder geometry,
  steering limit/rate from the revolute joint, axle effort/damping/
  friction, ``<gazebo>`` mu, sensor rates/noise);
- :func:`vehicle_params_from_description` -> the physics oracle's
  :class:`~autorally_tpu_torch.sim.vehicle.VehicleParams`;
- :func:`sensor_config_from_description` -> the synthetic sensor rig's
  :class:`~autorally_tpu_torch.sim.sensors.SensorSimConfig`;
- :func:`load_world` -> :class:`WorldDescription` (track + spawn pose
  + friction override), the worlds/ role, as a small JSON document.

The bundled ``assets/autorally_platform.urdf`` (the port's own copy, byte
for byte the JAX package's) carries the published platform constants, so
``SimVehiclePlant`` and the sim node can be constructed entirely from a
scene description, like Gazebo from the reference's.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import xml.etree.ElementTree as ET
from typing import Dict, Optional, Tuple

DEFAULT_URDF = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "assets", "autorally_platform.urdf")


@dataclasses.dataclass
class SensorDescription:
    name: str
    type: str
    update_rate: float
    noise: Dict[str, float]


@dataclasses.dataclass
class VehicleDescription:
    """Semantic quantities extracted from the URDF."""

    name: str
    chassis_mass: float
    wheel_masses: Dict[str, float]
    chassis_inertia: Tuple[float, float, float]     # ixx, iyy, izz
    com_height: float
    front_axle_x: float
    rear_axle_x: float
    track: float
    wheel_radius: float
    max_steer: float
    steer_rate: float
    steer_damping: float
    axle_effort: float
    axle_damping: float
    axle_friction: float
    mu: float
    sensors: Dict[str, SensorDescription]

    @property
    def wheelbase(self) -> float:
        return self.front_axle_x - self.rear_axle_x

    @property
    def total_mass(self) -> float:
        return self.chassis_mass + sum(self.wheel_masses.values())


class DescriptionError(ValueError):
    """Raised when a description file is missing required elements."""


def _origin_xyz(elem) -> Tuple[float, float, float]:
    origin = elem.find("origin")
    if origin is None or "xyz" not in origin.attrib:
        return (0.0, 0.0, 0.0)
    x, y, z = (float(v) for v in origin.attrib["xyz"].split())
    return (x, y, z)


def load_urdf(path: str = DEFAULT_URDF) -> VehicleDescription:
    """Parse the URDF subset into a :class:`VehicleDescription`."""
    root = ET.parse(path).getroot()
    if root.tag != "robot":
        raise DescriptionError(f"{path}: root element is <{root.tag}>, "
                               "expected <robot>")

    # -- links: masses, chassis inertia/CoM, wheel radius ---------------------
    chassis_mass = None
    chassis_inertia = (0.0, 0.0, 0.0)
    com_height = 0.0
    wheel_masses: Dict[str, float] = {}
    wheel_radius = None
    for link in root.findall("link"):
        name = link.attrib.get("name", "")
        inertial = link.find("inertial")
        mass = (float(inertial.find("mass").attrib["value"])
                if inertial is not None and inertial.find("mass") is not None
                else 0.0)
        if name == "chassis":
            chassis_mass = mass
            if inertial is not None:
                com_height = _origin_xyz(inertial)[2]
                inertia = inertial.find("inertia")
                if inertia is not None:
                    chassis_inertia = (float(inertia.attrib["ixx"]),
                                       float(inertia.attrib["iyy"]),
                                       float(inertia.attrib["izz"]))
        elif name.endswith("_wheel"):
            wheel_masses[name] = mass
            cyl = link.find("collision/geometry/cylinder")
            if cyl is not None:
                wheel_radius = float(cyl.attrib["radius"])
    if chassis_mass is None:
        raise DescriptionError(f"{path}: no <link name=\"chassis\">")
    if wheel_radius is None:
        raise DescriptionError(f"{path}: no wheel cylinder geometry")

    # -- joints: axle positions, steering limits, efforts ----------------------
    front_xs, rear_xs, half_tracks = [], [], []
    max_steer = steer_rate = steer_damping = None
    axle_effort = axle_damping = axle_friction = None
    for joint in root.findall("joint"):
        jtype = joint.attrib.get("type", "")
        xyz = _origin_xyz(joint)
        limit = joint.find("limit")
        dyn = joint.find("dynamics")
        if jtype == "revolute" and "steering" in joint.attrib.get("name", ""):
            front_xs.append(xyz[0])
            half_tracks.append(abs(xyz[1]))
            if limit is not None:
                max_steer = float(limit.attrib["upper"])
                steer_rate = float(limit.attrib.get("velocity", 6.0))
            if dyn is not None:
                steer_damping = float(dyn.attrib.get("damping", 0.0))
        elif jtype == "continuous":
            rear_xs.append(xyz[0])
            half_tracks.append(abs(xyz[1]))
            if limit is not None:
                axle_effort = float(limit.attrib.get("effort", 8.0))
            if dyn is not None:
                axle_damping = float(dyn.attrib.get("damping", 0.0))
                axle_friction = float(dyn.attrib.get("friction", 0.0))
    if not front_xs or not rear_xs:
        raise DescriptionError(f"{path}: need steering and axle joints")
    if max_steer is None:
        raise DescriptionError(f"{path}: steering joint has no <limit>")

    # -- gazebo extensions: friction + sensors ---------------------------------
    mu = 0.7
    sensors: Dict[str, SensorDescription] = {}
    for gz in root.findall("gazebo"):
        mu1 = gz.find("mu1")
        if mu1 is not None:
            mu = float(mu1.text)
        for sensor in gz.findall("sensor"):
            rate_el = sensor.find("updateRate")
            noise = {}
            for child in sensor:
                if child.tag.endswith("Noise") and child.text:
                    noise[child.tag] = float(child.text)
            sensors[sensor.attrib["name"]] = SensorDescription(
                name=sensor.attrib["name"],
                type=sensor.attrib.get("type", ""),
                update_rate=(float(rate_el.text)
                             if rate_el is not None else 0.0),
                noise=noise)

    return VehicleDescription(
        name=root.attrib.get("name", "robot"),
        chassis_mass=chassis_mass,
        wheel_masses=wheel_masses,
        chassis_inertia=chassis_inertia,
        com_height=com_height,
        front_axle_x=float(sum(front_xs) / len(front_xs)),
        rear_axle_x=float(sum(rear_xs) / len(rear_xs)),
        track=2.0 * max(half_tracks),
        wheel_radius=wheel_radius,
        max_steer=max_steer,
        steer_rate=steer_rate or 6.0,
        steer_damping=steer_damping or 0.08,
        axle_effort=axle_effort or 8.0,
        axle_damping=axle_damping or 0.001,
        axle_friction=axle_friction or 0.05,
        mu=mu,
        sensors=sensors,
    )


def vehicle_params_from_description(desc: VehicleDescription,
                                    **overrides):
    """Description -> the physics oracle's parameter pytree."""
    from autorally_tpu_torch.sim.vehicle import VehicleParams

    kw = dict(
        mass=desc.total_mass,
        ixx=desc.chassis_inertia[0],
        izz=desc.chassis_inertia[2],
        wheelbase=desc.wheelbase,
        a=desc.front_axle_x,
        b=abs(desc.rear_axle_x),
        track=desc.track,
        h_cg=desc.com_height,
        wheel_radius=desc.wheel_radius,
        wheel_damping=desc.axle_damping,
        wheel_friction=desc.axle_friction,
        mu=desc.mu,
        max_steer=desc.max_steer,
        servo_rate=desc.steer_rate,
        servo_tau=desc.steer_damping,
        rear_effort=desc.axle_effort,
    )
    kw.update(overrides)
    return VehicleParams(**kw)


def sensor_config_from_description(desc: VehicleDescription,
                                   control_hz: float = 50.0):
    """Description -> the synthetic sensor rig's config (IMU/GPS/wheel
    rates and noise; camera has no role in the estimation rig)."""
    from autorally_tpu_torch.sim.sensors import SensorSimConfig

    kw = {}
    imu = desc.sensors.get("imu")
    if imu is not None:
        kw["accel_noise"] = imu.noise.get("accelNoise", 0.2)
        kw["gyro_noise"] = imu.noise.get("gyroNoise", 0.02)
    gps = desc.sensors.get("gps")
    if gps is not None:
        kw["gps_noise"] = gps.noise.get("positionNoise", 0.15)
        if gps.update_rate > 0:
            kw["gps_every"] = max(1, round(control_hz / gps.update_rate))
    wheel = desc.sensors.get("wheel_odometry")
    if wheel is not None:
        kw["vel_noise"] = wheel.noise.get("velocityNoise", 0.15)
    return SensorSimConfig(**kw)


# ---------------------------------------------------------------------------
# Worlds
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class WorldDescription:
    """A runnable scene: which track, where the car starts, how grippy
    the surface is (the ``autorally_gazebo/worlds`` role)."""

    name: str = "oval"
    track: Optional[str] = None            # costmap .npz path (None = builtin)
    spawn_x: float = 30.0
    spawn_y: float = 0.0
    spawn_yaw: float = math.pi / 2.0
    mu: Optional[float] = None             # surface override
    desired_speed: float = 6.0


def load_world(path: str) -> WorldDescription:
    """Load a world JSON document."""
    with open(path) as f:
        doc = json.load(f)
    unknown = set(doc) - {f.name for f in
                          dataclasses.fields(WorldDescription)}
    if unknown:
        raise DescriptionError(f"{path}: unknown world keys {sorted(unknown)}")
    return WorldDescription(**doc)


def save_world(world: WorldDescription, path: str) -> None:
    with open(path, "w") as f:
        json.dump(dataclasses.asdict(world), f, indent=2)
