"""Typed configuration tree for the MPPI framework (PyTorch port).

Mirrors ``autorally_tpu/config.py``: :class:`CostParams` holds the
runtime-tunable cost coefficients (the reference's dynamic_reconfigure
surface, ``cfg/PathIntegralParams.cfg:12-21``) and :class:`MPPIConfig` the
shape-defining settings (K, T, noise, ...).  Both are frozen dataclasses with
the same fields and defaults as the JAX package.  Also holds
:func:`resolve_device`, the one place the port decides where it runs.
"""

from __future__ import annotations

import dataclasses
import os
import re
import xml.etree.ElementTree as ET
from typing import Any, Dict, Optional, Tuple

import torch


# Default location of the reference's shipped model weights (the .npz
# interchange format): the model directory of an AutoRally checkout, found
# through ``AUTORALLY_TPU_ASSETS`` (as in the JAX package) or relative to
# the working directory.  Used as an ARGUMENT DEFAULT only.
_ASSETS = os.environ.get(
    "AUTORALLY_TPU_ASSETS",
    os.path.join("autorally_control", "src", "path_integral", "params",
                 "models"))
REFERENCE_NN_NPZ = os.path.join(_ASSETS, "autorally_nnet_09_12_2018.npz")
REFERENCE_BF_NPZ = os.path.join(_ASSETS, "basis_function_09_12_2018.npz")


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for another.  Raises instead of quietly running on the CPU when CUDA is
    requested (explicitly or by default) and no GPU is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA requested but no GPU is available; pass device='cpu' "
                "to run the plain PyTorch path")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@dataclasses.dataclass(frozen=True)
class CostParams:
    """Runtime-tunable cost parameters (``costs.cuh:67-86``; defaults from
    ``launch/path_integral_nn.launch``)."""

    desired_speed: float = 8.0
    speed_coeff: float = 4.25
    track_coeff: float = 200.0
    max_slip_ang: float = 1.25
    slip_penalty: float = 10.0
    track_slop: float = 0.0
    crash_coeff: float = 10000.0
    steering_coeff: float = 0.0
    throttle_coeff: float = 0.0
    boundary_threshold: float = 0.65
    discount: float = 0.1
    # Live obstacle circles for ObstacleCost (costs/obstacles.py): when set,
    # they override the cost's own array on every solve.
    obstacles: Any = None
    # Runtime softmax-temperature override; None uses MPPIConfig.gamma.
    gamma: Any = None

    def replace(self, **kw) -> "CostParams":
        return dataclasses.replace(self, **kw)


# ``MPPIConfig.matmul_precision``'s names, as the JAX package's kernels
# take them (``PRECISIONS`` and ``_prec``), and whether each gives the
# dynamics' products bf16 operands: "highest" and "high" multiply in
# float32 (the JAX kernels round "high" up to HIGHEST, the only other
# precision a TPU kernel lowers), "default" is one bf16 pass of the MXU:
# both operands rounded to bf16, the products summed in float32.
MATMUL_PRECISIONS = {"highest": False, "high": False, "default": True}


def bf16_operands(precision: str) -> bool:
    """Whether ``matmul_precision`` ``precision`` gives the dynamics'
    products bf16 operands (``MATMUL_PRECISIONS``); raises ``ValueError``
    for a name the JAX package does not take."""
    if precision not in MATMUL_PRECISIONS:
        raise ValueError(f"matmul_precision must be one of "
                         f"{tuple(MATMUL_PRECISIONS)}, got {precision!r}")
    return MATMUL_PRECISIONS[precision]


def effective_gamma(cfg: "MPPIConfig", cost_params: CostParams):
    """The softmax temperature a solve should use: ``CostParams.gamma``
    when set, else the static config's."""
    return cfg.gamma if cost_params.gamma is None else cost_params.gamma


def cost_params_lanes(cost_params: CostParams) -> Optional[int]:
    """The lane count of a stacked ``CostParams`` (every field a tensor
    with a leading lane axis, ``tools/param_sweep.stack_cost_params``: the
    JAX package's vmapped pytree), None for one set of scalars."""
    v = cost_params.desired_speed
    return int(v.shape[0]) if torch.is_tensor(v) and v.dim() == 1 else None


def lane_cost_params(cost_params: CostParams) -> list:
    """A stacked ``CostParams``'s lanes, one ``CostParams`` each: lane l's
    float32 coefficients as Python floats, its gamma a 0-d view of the
    stacked gamma (which may live on the device), its ``obstacles`` lane
    l's rows of stacked (L, N, 3) circles; a field without a lane axis
    (None, gamma as one float, or circles (N, 3) that every lane prices,
    as the episode's moving obstacles are) as it is."""
    out = []
    for lane in range(cost_params_lanes(cost_params)):
        kw = {}
        for f in dataclasses.fields(cost_params):
            v = getattr(cost_params, f.name)
            lane_dims = 3 if f.name == "obstacles" else 1
            if not (torch.is_tensor(v) and v.dim() == lane_dims):
                continue
            kw[f.name] = (v[lane] if f.name in ("gamma", "obstacles")
                          else float(v[lane]))
        out.append(cost_params.replace(**kw))
    return out


@dataclasses.dataclass(frozen=True)
class MPPIConfig:
    """Static solver configuration; same fields and defaults as the JAX
    package.  ``scan_unroll`` and ``exact_fused`` are TPU performance knobs
    with no semantic effect, kept so configs compare field by field.
    ``use_pallas_rollout=True`` has one semantic effect, as in the JAX
    package: it forces the kernel form for a model whose ``KERNEL_KIND`` is
    set but whose subclass overrides a method the kernels replace, and the
    kernels then evaluate the declaring class's math; ``None`` and
    ``False`` leave the choice to the model and the cost
    (``solver/mppi.py``)."""

    num_rollouts: int = 1920          # K  (path_integral_main.cu:66)
    num_timesteps: int = 100          # T  (launch: num_timesteps)
    hz: int = 50
    optimization_stride: int = 1
    gamma: float = 0.15               # temperature
    num_iters: int = 1                # opt iterations per replan
    init_steering: float = 0.0
    init_throttle: float = 0.0
    steering_std: float = 0.275
    throttle_std: float = 0.3
    max_throttle: float = 0.65
    l1_cost: bool = False             # L1 vs L2 speed cost (costs.cu:315-326)
    seed: int = 1234                  # reference cuRAND seed (mppi_controller.cu:331)
    use_feedback_gains: bool = True
    debug_mode: bool = False
    pure_noise_frac: float = 0.99     # mppi_controller.cu:141
    scan_unroll: int = 10
    use_pallas_rollout: bool = None
    noise_sampler: str = "gaussian"
    noise_param: float = 1.0
    kernel_rng: bool = False
    exact_fused: bool = True
    matmul_precision: str = "highest"  # MATMUL_PRECISIONS

    @property
    def dt(self) -> float:
        return 1.0 / self.hz

    @property
    def exploration_std(self) -> Tuple[float, float]:
        return (self.steering_std, self.throttle_std)

    @property
    def init_u(self) -> Tuple[float, float]:
        return (self.init_steering, self.init_throttle)

    @property
    def control_ranges(self) -> Tuple[Tuple[float, float], Tuple[float, float]]:
        """((steer_min, steer_max), (throttle_min, throttle_max)), as
        hard-coded by ``path_integral_main.cu:98``."""
        return ((-0.99, 0.99), (-0.99, self.max_throttle))

    def replace(self, **kw) -> "MPPIConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# roslaunch XML loading (parity with param_getter.cpp:75-151)
# ---------------------------------------------------------------------------

_ENV_RE = re.compile(r"\$\(env\s+([A-Za-z_][A-Za-z0-9_]*)\)")
_FIND_RE = re.compile(r"\$\(find\s+([A-Za-z_][A-Za-z0-9_]*)\)")


def _substitute(value: str, env: Optional[Dict[str, str]] = None) -> str:
    """Expand ``$(env VAR)`` substitutions like ``param_getter.cpp:93-117``."""
    env = dict(os.environ) if env is None else env
    value = _ENV_RE.sub(lambda m: env.get(m.group(1), ""), value)
    return _FIND_RE.sub(lambda m: m.group(1), value)


def _coerce(value: str, type_hint: Optional[str]) -> Any:
    if type_hint == "int":
        return int(value)
    if type_hint == "double":
        return float(value)
    if type_hint == "bool":
        return value.strip().lower() in ("1", "true", "yes")
    if type_hint in ("str", "string"):
        return value
    v = value.strip()
    if v.lower() in ("true", "false"):
        return v.lower() == "true"
    for cast in (int, float):
        try:
            return cast(v)
        except ValueError:
            pass
    return value


def load_launch_params(path: str, node_name: str = "mppi_controller",
                       env: Optional[Dict[str, str]] = None) -> Dict[str, Any]:
    """Parse a roslaunch XML file into a flat param dict."""
    params: Dict[str, Any] = {}
    for node in ET.parse(path).getroot().iter("node"):
        if node.get("name") != node_name:
            continue
        for p in node.iter("param"):
            raw = _substitute(p.get("value", ""), env)
            params[p.get("name")] = _coerce(raw, p.get("type"))
    return params


_CFG_KEYS = ("hz", "num_timesteps", "optimization_stride", "gamma",
             "num_iters", "init_steering", "init_throttle", "steering_std",
             "throttle_std", "max_throttle", "l1_cost", "use_feedback_gains",
             "debug_mode")
_COST_KEYS = (("desired_speed", "desired_speed"),
              ("speed_coefficient", "speed_coeff"),
              ("track_coefficient", "track_coeff"),
              ("max_slip_angle", "max_slip_ang"),
              ("slip_penalty", "slip_penalty"),
              ("track_slop", "track_slop"),
              ("crash_coeff", "crash_coeff"),
              ("steering_coeff", "steering_coeff"),
              ("throttle_coeff", "throttle_coeff"),
              ("boundary_threshold", "boundary_threshold"),
              ("discount", "discount"))


def config_from_params(params: Dict[str, Any]) -> Tuple[MPPIConfig, CostParams]:
    """Build the typed configs from a launch-file param dict."""
    cfg = MPPIConfig(**{k: params[k] for k in _CFG_KEYS if k in params})
    costs = CostParams(**{dst: float(params[src])
                          for src, dst in _COST_KEYS if src in params})
    return cfg, costs
