"""Four-wheel rigid-body vehicle model, the independent physics oracle (port
of ``autorally_tpu/sim/vehicle.py``).

A first-principles re-creation of the physics Gazebo provides for the
reference: a planar rigid body with roll, four wheels with spin dynamics
and slip-based tire forces, a rate-limited steering servo and
effort-controlled axles.  Parameters come from the reference's URDF
(``autoRallyPlatform.urdf.xacro``) and the Gazebo controller node's
actuation mapping (``autorally_controller.py:268-271``).  It shares nothing
with the controller's dynamics families: the state is wheel-level (13
numbers with the four wheel speeds and the steering angle), and closed-loop
results against it measure the controller under genuine model mismatch.

The state is a :class:`SimState` of float32 tensors on one device; a
period (:func:`vehicle_step`) is ``n_sub`` semi-implicit Euler substeps in
a plain loop.  Each substep rounds where the JAX package's compiled substep
(``jax.jit`` of ``vehicle_step`` with the parameters constant) does: the
parameters are Python floats, so an expression of parameters alone is
formed in double and meets the float32 state only at the end, as JAX's
weak-typed scalars do, and where XLA's simplifier turns a division by a
constant into a product with its float32 reciprocal, or folds a chain of
constant factors into one, the port takes that folded factor
(``_Constants``, which also holds every scalar operand as a 0-d tensor);
sums of four run left to right and roots are correctly rounded, as XLA's
on the CPU.  What is left between the two is the last
bit of the transcendental functions.  A parameter divided by a tensor
divides by a 0-d tensor (PyTorch's ``scalar / tensor`` is a reciprocal and
a product, two roundings).  The plant (``sim/plant.py``) captures a period
as one CUDA graph on the card.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import NamedTuple, Tuple

import numpy as np
import torch

from autorally_tpu_torch.config import resolve_device

STATE_SIZE = 13            # the packed state: 9 scalars, then the 4 wheels


@dataclasses.dataclass(frozen=True)
class VehicleParams:
    """Physical parameters (defaults = reference URDF / Gazebo node)."""

    mass: float = 23.9            # chassis 20.5 + 4 wheels (~3.4) [kg]
    izz: float = 1.2              # yaw inertia (box estimate; the URDF's
    #                               token value is non-physical)
    ixx: float = 0.35             # roll inertia
    wheelbase: float = 0.570      # urdf wheelbase
    a: float = 0.34               # CoM -> front axle (cm_to_front_shock)
    b: float = 0.23               # CoM -> rear axle  (cm_to_rear_shock)
    track: float = 0.4            # hex_hub_dist
    h_cg: float = 0.12            # chassis_cm_height
    wheel_radius: float = 0.095   # tire_dia / 2
    wheel_inertia: float = 0.004  # cylinder, rear wheel mass 0.89
    wheel_damping: float = 0.001  # urdf axle joint damping
    wheel_friction: float = 0.05  # rolling resistance torque scale [N m]
    mu: float = 0.7               # urdf mu1 (dirt-like)
    c_alpha: float = 6.0          # cornering stiffness per unit load [/rad]
    c_slip: float = 9.0           # longitudinal stiffness per unit slip
    v_ref: float = 0.4            # low-speed slip regularization [m/s]
    drag: float = 0.7             # aero drag F = -drag*vx*|vx|

    max_steer: float = math.radians(25.0)   # controller node :358
    steer_sign: float = -1.0      # steer_ang = -25deg*cmd (node :358)
    servo_tau: float = 0.08      # steering joint lag (damping-88 joint)
    servo_rate: float = 6.0       # max steering rate [rad/s]

    rear_effort: float = 8.0      # rear_axle_max_effort (node :273)
    rear_brake_effort: float = 4.0
    front_brake_effort: float = 2.5

    roll_k: float = 80.0          # shock roll stiffness [N m/rad]
    roll_c: float = 6.0           # shock roll damping

    def replace(self, **kw) -> "VehicleParams":
        return dataclasses.replace(self, **kw)


class SimState(NamedTuple):
    """Wheel-level vehicle state: 0-d float32 tensors and (4,) wheels."""

    x: torch.Tensor
    y: torch.Tensor
    yaw: torch.Tensor
    roll: torch.Tensor
    roll_rate: torch.Tensor
    vx: torch.Tensor              # body longitudinal velocity
    vy: torch.Tensor              # body lateral velocity
    yaw_rate: torch.Tensor
    steer: torch.Tensor           # virtual front steering angle [rad]
    omega: torch.Tensor           # (4,) wheel spin [lf, rf, lr, rr] [rad/s]


def init_sim_state(x=0.0, y=0.0, yaw=0.0, vx=0.0, device=None) -> SimState:
    """A state at rest but for ``vx``, the wheels rolling at ``vx``
    (``vx / 0.095`` in double, as the JAX package), on ``device`` (``cuda``
    unless the caller asks for another)."""
    dev = resolve_device(device)
    z = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)
    return SimState(x=z(x), y=z(y), yaw=z(yaw), roll=z(0.0),
                    roll_rate=z(0.0), vx=z(vx), vy=z(0.0), yaw_rate=z(0.0),
                    steer=z(0.0),
                    omega=torch.full((4,), vx / 0.095, dtype=torch.float32,
                                     device=dev))


def pack_sim_state(s: SimState) -> torch.Tensor:
    """The state as one (13,) float32 tensor: the scalars in field order,
    then the four wheels."""
    return torch.cat([torch.stack(list(s[:-1])), s.omega])


def unpack_sim_state(v: torch.Tensor) -> SimState:
    """The :class:`SimState` of views into a packed (13,) tensor."""
    return SimState(*v[:9].unbind(), omega=v[9:])


def sim_state_from_numpy(s, device=None) -> SimState:
    """The crossing into the port: ``s`` a SimState-shaped tuple of host
    values (a JAX ``SimState`` mapped through ``np.asarray``) or a packed
    (13,) array; the state on ``device`` (``cuda`` unless asked
    otherwise)."""
    dev = resolve_device(device)
    if len(s) == len(SimState._fields):
        flat = np.concatenate([np.asarray(v, np.float32).reshape(-1)
                               for v in s])
    else:
        flat = np.asarray(s, np.float32).reshape(-1)
    if flat.shape != (STATE_SIZE,):
        raise ValueError(f"a SimState holds {STATE_SIZE} numbers, got "
                         f"{flat.shape}")
    return unpack_sim_state(torch.tensor(flat, device=dev))


def sim_state_to_numpy(s) -> SimState:
    """The state on the host: a :class:`SimState` of float32 numpy values
    (0-d arrays and (4,) wheels), from a state of tensors (one device read)
    or of host values, or from a packed (13,) array."""
    if isinstance(s, SimState) and isinstance(s.x, torch.Tensor):
        s = pack_sim_state(s).detach().cpu().numpy()
    flat = np.concatenate([np.asarray(v, np.float32).reshape(-1)
                           for v in s])
    return SimState(*(flat[i].copy() for i in range(9)),
                    omega=flat[9:].copy())


def controller_state(s: SimState) -> torch.Tensor:
    """The controller's 7-state [x, y, yaw, roll, u_x, u_y, yaw_mder].

    ``yaw_mder`` uses the plant's negated convention
    (``autorally_plant.cpp:212``): the controller state carries -yaw_rate.
    """
    return torch.stack([s.x, s.y, s.yaw, s.roll, s.vx, s.vy, -s.yaw_rate])


class _Constants:
    """What a substep of ``dt`` reads that depends on the parameters alone,
    as float32 tensors on one device, made once per (params, substep,
    device) before any capture: (4,) wheel arrays, and 0-d scalars.  A
    binary operation with a 0-d tensor rounds as with the Python float it
    holds and costs the CPU half the time (PyTorch converts a Python float
    operand of a 0-d tensor with a copy there).  The folded factors are
    XLA's when it compiles the JAX substep: a division by a constant
    becomes a product with its float32 reciprocal, and a chain of constant
    factors becomes one float32 factor, folded left to right.  They were
    read from the optimised HLO of jax / jaxlib 0.9.0 on the CPU;
    ``tests/test_torch_sim_vehicle.py::test_xla_folds_the_factors_the_port_copies``
    fails, naming the factor, when another XLA folds differently."""

    def __init__(self, p: VehicleParams, dt: float, device: torch.device):
        f = np.float32
        t32 = lambda v: torch.tensor(np.asarray(v, f), device=device)
        inv = lambda v: f(1.0) / f(v)
        g = 9.81
        fz_front = p.mass * g * p.b / p.wheelbase / 2
        fz_rear = p.mass * g * p.a / p.wheelbase / 2
        wy = np.array([1.0, -1.0, 1.0, -1.0], f) * f(p.track / 2)
        # (4,) wheel layout [lf, rf, lr, rr]; body frame: x forward, y left
        self.wx = t32(np.array([1.0, 1.0, -1.0, -1.0], f)
                      * np.array([p.a, p.a, p.b, p.b], f))
        self.wy = t32(wy)
        self.sign_wy = t32(np.sign(wy))
        self.fz_static = t32(np.array([1.0, 1.0, 0.0, 0.0], f) * f(fz_front)
                             + np.array([0.0, 0.0, 1.0, 1.0], f)
                             * f(fz_rear))
        scalars = dict(
            zero=0.0, one=1.0, half=0.5, tiny=1e-6, dt=dt,
            wheelbase=p.wheelbase, half_track=p.track / 2,
            radius=p.wheel_radius, c_slip=p.c_slip, mu=p.mu,
            neg_c_alpha=-p.c_alpha, drag=p.drag, damping=p.wheel_damping,
            friction=p.wheel_friction, rear_effort=p.rear_effort,
            rear_brake_effort=p.rear_brake_effort,
            front_brake_effort=p.front_brake_effort,
            roll_k=p.roll_k, roll_c=p.roll_c,
            # the factors XLA folds
            steer_gain=p.steer_sign * p.max_steer,
            inv_tau=inv(p.servo_tau),
            load_transfer=f(p.mass) * f(p.h_cg) * inv(p.track) * f(0.5),
            half_r=f(p.wheel_radius) * f(0.5),
            slip_r=f(p.c_slip) * f(p.wheel_radius),
            slip_rr=f(p.c_slip) * f(p.wheel_radius * p.wheel_radius),
            dt_iw=dt / p.wheel_inertia,
            dt_iw_denom=f(dt) * inv(p.wheel_inertia),
            inv_mass=inv(p.mass),
            roll_force=f(-p.mass) * inv(p.mass) * f(p.h_cg),
            dt_izz=inv(p.izz) * f(dt),
            dt_ixx=inv(p.ixx) * f(dt))
        for name, v in scalars.items():
            setattr(self, name, t32(v))


@functools.lru_cache(maxsize=64)
def _constants(p: VehicleParams, dt: float, device: torch.device
               ) -> _Constants:
    return _Constants(p, dt, device)


def _sum4(v: torch.Tensor) -> torch.Tensor:
    """The sum of a (4,) tensor left to right, as XLA reduces it (a
    PyTorch reduction takes another order on the card)."""
    a, b, c, d = v.unbind()
    return a + b + c + d


def _sqrt(v: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 root: PyTorch's CPU float32 sqrt is
    not always, so there the float64 root is rounded to float32."""
    if v.is_cuda:
        return torch.sqrt(v)
    return torch.sqrt(v.double()).float()


def _wheel_steer(steer: torch.Tensor, c: _Constants
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-wheel Ackermann angles (left, right) for virtual angle
    ``steer`` (``_ctrl_steering``, autorally_controller.py:497-521).  Both
    branches are evaluated; ``safe`` keeps the turn-centre branch finite."""
    tan_s = torch.tan(steer)
    safe = torch.where(torch.abs(tan_s) < c.tiny, c.tiny, tan_s)
    center_y = c.wheelbase / safe                 # signed turn-center offset
    d_l = torch.atan(c.wheelbase / (center_y - c.half_track))
    d_r = torch.atan(c.wheelbase / (center_y + c.half_track))
    small = torch.abs(steer) < 1e-4
    return (torch.where(small, steer, d_l), torch.where(small, steer, d_r))


def _substep(p: VehicleParams, s: SimState, cmd: torch.Tensor,
             c: _Constants) -> SimState:
    """One semi-implicit Euler physics substep of ``c.dt``.  The JAX
    substep's expressions (in the comments where they differ) with XLA's
    folding of their constant factors, each operation in its order.

    ``cmd``: [steer_cmd, throttle_cmd, front_brake] with the chassis
    command ranges [-1, 1] / [0, 1].
    """
    steer_cmd, throttle, front_brake = cmd.unbind()
    dt = c.dt

    # --- steering servo (position-controlled joint -> first-order lag
    #     with rate limit) --------------------------------------------------
    # steer_des = steer_sign * max_steer * clip(steer_cmd, -1, 1)
    steer_des = torch.clamp(steer_cmd, -1.0, 1.0) * c.steer_gain
    # clip((steer_des - steer) / servo_tau, -servo_rate, servo_rate)
    d_steer = torch.clamp((steer_des - s.steer) * c.inv_tau,
                          -p.servo_rate, p.servo_rate)
    steer = s.steer + d_steer * dt

    d_l, d_r = _wheel_steer(steer, c)
    wx, wy = c.wx, c.wy
    delta = torch.stack([d_l, d_r, c.zero, c.zero])

    # --- contact-point velocities in tire frames --------------------------
    vcx = s.vx - s.yaw_rate * wy
    vcy = s.vy + s.yaw_rate * wx
    cd, sd = torch.cos(delta), torch.sin(delta)
    v_long = cd * vcx + sd * vcy
    v_lat = -sd * vcx + cd * vcy
    v_den = torch.clamp(torch.abs(v_long), min=p.v_ref)

    # --- normal loads: static split + lateral/longitudinal transfer -------
    ay_est = s.yaw_rate * s.vx
    # dfz_lat = mass * ay_est * h_cg / track / 2
    dfz_lat = ay_est * c.load_transfer
    fz = torch.clamp(c.fz_static - dfz_lat * c.sign_wy, min=0.1)

    # --- drive / brake torques (autorally_controller.py:268-271, 383-391;
    #     effort published identically to both wheels of an axle) ----------
    rear_tau = torch.where(throttle >= 0.0, throttle * c.rear_effort,
                           throttle * c.rear_brake_effort)
    # front_ws = (omega[0] + omega[1]) * r / 2
    front_ws = (s.omega[0] + s.omega[1]) * c.half_r
    front_tau = -torch.sign(front_ws) * c.front_brake_effort * \
        torch.clamp(front_brake, 0.0, 1.0)
    tau = torch.stack([front_tau, front_tau, rear_tau, rear_tau])

    # --- wheel spin: semi-implicit in the slip force ----------------------
    # Fx = k (omega r - v_long) / v_den with k = c_slip * fz; solving the
    # spin update implicitly keeps the stiff wheel/slip coupling stable at
    # 1 kHz substeps.
    k = fz * c.c_slip
    # denom = 1 + dt * (r * r * k / v_den + wheel_damping) / iw
    denom = (fz * c.slip_rr / v_den + c.damping) * c.dt_iw_denom + c.one
    rolling = torch.tanh(s.omega * c.half) * c.friction
    # omega + dt / iw * (tau - rolling + r * k * v_long / v_den)
    drive = fz * c.slip_r * v_long / v_den
    omega = (s.omega + (tau - rolling + drive) * c.dt_iw) / denom

    # --- tire forces with friction ellipse --------------------------------
    slip = (omega * c.radius - v_long) / v_den
    fx0 = k * slip
    alpha = torch.atan(v_lat / v_den)
    fy0 = fz * c.neg_c_alpha * torch.tan(alpha)
    f_mag = _sqrt(fx0 * fx0 + fy0 * fy0) + c.tiny
    scale = torch.clamp(fz * c.mu / f_mag, max=1.0)
    fx_t, fy_t = fx0 * scale, fy0 * scale

    fx_b = cd * fx_t - sd * fy_t
    fy_b = sd * fx_t + cd * fy_t

    # --- rigid-body update -------------------------------------------------
    fx_tot = _sum4(fx_b) - s.vx * c.drag * torch.abs(s.vx)
    fy_tot = _sum4(fy_b)
    mz = _sum4(fy_b * wx - fx_b * wy)

    # fx_tot / mass + yaw_rate * vy; fy_tot / mass - yaw_rate * vx
    ax = fx_tot * c.inv_mass + s.yaw_rate * s.vy
    ay = fy_tot * c.inv_mass - s.yaw_rate * s.vx
    vx = s.vx + ax * dt
    vy = s.vy + ay * dt
    # yaw_rate + mz / izz * dt
    yaw_rate = s.yaw_rate + mz * c.dt_izz

    # roll from lateral load on the sprung mass through the shocks:
    # roll_rate + (-mass * (fy_tot / mass) * h_cg - roll_k * roll
    #              - roll_c * roll_rate) / ixx * dt
    roll_rate = s.roll_rate + (fy_tot * c.roll_force - s.roll * c.roll_k
                               - s.roll_rate * c.roll_c) * c.dt_ixx
    roll = s.roll + roll_rate * dt

    cy, sy = torch.cos(s.yaw), torch.sin(s.yaw)
    x = s.x + (vx * cy - vy * sy) * dt
    y = s.y + (vx * sy + vy * cy) * dt
    yaw = s.yaw + yaw_rate * dt

    return SimState(x=x, y=y, yaw=yaw, roll=roll, roll_rate=roll_rate,
                    vx=vx, vy=vy, yaw_rate=yaw_rate, steer=steer,
                    omega=omega)


def vehicle_step(p: VehicleParams, s: SimState, cmd, dt: float,
                 n_sub: int = 20) -> SimState:
    """Advance one control period ``dt`` with ``n_sub`` physics substeps
    on the device of ``s``.  ``cmd`` = [steering, throttle, front_brake]
    in chassis-command units."""
    dev = s.x.device
    cmd = torch.as_tensor(cmd, dtype=torch.float32, device=dev)
    sub = dt / n_sub
    c = _constants(p, sub, dev)
    for _ in range(n_sub):
        s = _substep(p, s, cmd, c)
    return s
