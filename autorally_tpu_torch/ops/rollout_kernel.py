"""The MPPI rollout kernels: CUDA wrappers and their plain PyTorch versions.

Port of the TPU kernels of ``autorally_tpu/ops/rollout_kernel.py`` that the
solver runs:

- :func:`fused_exact_rollout_cost` (kernel in ``csrc/rollout_kernels.cu``,
  ``fused_exact_kernel``) replaces ``_fused_exact_kernel``: the whole
  ``rolloutKernel`` (``mppi_controller.cu:72-184``) with the exact
  point-sampled costmap;
- :func:`dynamics_chain` (``dynamics_chain_kernel``) replaces
  ``_rollout_kernel``: the dynamics chain alone, emitting every state; and
  :func:`nominal_trajectory` runs it for the single noise-free rollout;
- :func:`fused_rollout_cost` (``fused_field_kernel``) replaces
  ``_fused_kernel``: the same rollout with the track surface a
  :class:`~autorally_tpu_torch.costs.neural_costmap.NeuralCostmap`;
- :func:`fused_rng_costs` (``fused_rng_kernel`` on a ``Costmap``,
  ``fused_rng_field_kernel`` on a ``NeuralCostmap``) replaces both modes of
  ``_fused_rng_kernel`` and :func:`fused_rng_numer`
  (``weighted_update_kernel``) replaces ``_weighted_update_kernel``: the
  two passes of the kernel-RNG capacity mode, which draw the noise stream
  of ``ops/kernel_rng.py`` inside the kernels, so that nothing of size
  T x K reaches device memory; :func:`fused_rng_solve_iteration` composes
  them into one MPPI iteration.

The kernels evaluate either model of the JAX package's kernels: the
6-32-32-4 ``NeuralNetDynamics`` or the 25-function
``BasisFunctionDynamics`` (``_bf_deriv``), each its own instance of every
kernel; and the fused kernels (A, 3, pass 1) price the circles of an
``ObstacleCost`` (``_make_obstacle_terms``) when the caller passes
``obstacles`` (with ``obstacle_coeff`` and ``inflation``), as the JAX
package's wrappers take them.

Each wrapper runs the plain version (``*_plain``) for tensors on the CPU,
launches the CUDA kernel for tensors on a GPU, and raises for anything
else; there is no fallback from one to the other.  Each counts its kernel
launches in :data:`LAUNCHES` by instance: the wrapper's name for the MLP
without obstacles, with ``_bf``, ``_obstacles`` or ``_bf_obstacles`` for
the others (``fused_rng_costs_field*`` for pass 1's field mode).  Layouts
are those of the JAX package's public functions: eps (T, K, C) in, u_seq
(C, T, K), states (S, T, K), costs and crash (K,) out, the capacity mode's
numerator (C, T).
"""

from __future__ import annotations

import collections
import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from autorally_tpu_torch.config import effective_gamma
from autorally_tpu_torch.costs.costmap import Costmap
from autorally_tpu_torch.costs.mppi_cost import MPPICost
from autorally_tpu_torch.costs.neural_costmap import NeuralCostmap
from autorally_tpu_torch.costs.obstacles import obstacle_terms
from autorally_tpu_torch.models.basis_function import (NUM_BFS,
                                                       BasisFunctionDynamics)
from autorally_tpu_torch.models.neural_net import NeuralNetDynamics
from autorally_tpu_torch.ops import _build
from autorally_tpu_torch.ops.kernel_rng import kernel_noise
from autorally_tpu_torch.ops.sampling import ou_coefficients

# The layer spec the CUDA kernels are compiled for (csrc kIn/kH1/kH2/kOut).
KERNEL_LAYERS = (6, 32, 32, 4)
KERNEL_NUM_WEIGHTS = sum(a * b + b for a, b in zip(KERNEL_LAYERS[:-1],
                                                    KERNEL_LAYERS[1:]))
# The basis-function form's weights: theta^T (4, 25) (csrc kNumBfs).
KERNEL_BF_WEIGHTS = NUM_BFS * 4
# The field spec the field kernels are compiled for (csrc kFreqs, kFieldIn,
# kFieldH1, kFieldH2): fit_neural_costmap's default, F = 8, hidden (64, 64).
FIELD_KERNEL_LAYERS = (34, 64, 64, 1)
FIELD_KERNEL_FREQS = 8
FIELD_NUM_WEIGHTS = sum(a * b + b for a, b in zip(
    FIELD_KERNEL_LAYERS[:-1], FIELD_KERNEL_LAYERS[1:])) + FIELD_KERNEL_FREQS
# Circles the fused kernels stage in shared memory (csrc kMaxObstacles).
MAX_OBSTACLES = 64
# Dynamic shared memory holds the weights, U (T x 2) and up to
# MAX_OBSTACLES circles, and the field in the field kernels; stay under the
# 48 KB a launch gets without opting in (the MLP field kernels at T = 2048
# with 64 circles: 48,704 bytes).
MAX_KERNEL_T = 4096
MAX_FIELD_KERNEL_T = 2048

# Host launch scalars, in the order csrc/rollout_kernels.cu unpacks them.
_FLOAT_SCALARS = ("nu0", "nu1", "opt_delay", "pure_thresh", "dt",
                  "rc1x", "rc1y", "rc1w", "rc2x", "rc2y", "rc2w",
                  "trsx", "trsy", "trsw",
                  "desired_speed", "speed_coeff", "track_coeff",
                  "max_slip_ang", "slip_penalty", "track_slop", "crash_coeff",
                  "steering_coeff", "throttle_coeff", "boundary_threshold",
                  "discount", "obstacle_coeff", "inflation")
_INT_SCALARS = ("T", "K", "k0_flag", "negate_yaw_der", "bf", "H", "W",
                "l1_cost", "n_obs")
# Rollouts per block of the pass-2 kernel (csrc kUpdateBlock): each block
# writes one (C, T) partial numerator.
UPDATE_BLOCK = 256


# ---------------------------------------------------------------------------
# shared pieces
# ---------------------------------------------------------------------------

def _pure_thresh(cfg, k_offset) -> float:
    """``pure_noise_frac * K_total - k_offset`` in float32, as the JAX
    kernels' scalar vector holds it (rollout k is pure noise when
    ``float(k) >= pure_thresh``; at K = 1920, k >= 1901)."""
    return float(np.float32(np.float32(cfg.pure_noise_frac * cfg.num_rollouts)
                            - np.float32(k_offset)))


def _rollout_masks(cfg, K: int, k_offset, device):
    """(zero_rollout, pure_noise) masks (K,) over the launch's rollouts."""
    k_idx = torch.arange(K, device=device, dtype=torch.float32)
    zero_rollout = (k_idx == 0) & (int(k_offset) == 0)
    return zero_rollout, k_idx >= _pure_thresh(cfg, k_offset)


def _perturb(cfg, t: int, U, eps, nu, zero_rollout, pure_noise):
    """Control of step t for every rollout: pre-clamp ``u`` (K, C) and the
    raw noise ``du`` (K, C), zeroed only where frozen (rollout 0, and
    ``t < optimization_stride``)."""
    frozen = (zero_rollout | (t < cfg.optimization_stride))[:, None]
    du = eps[t] * nu
    Ut = U[t]
    u = torch.where(frozen, Ut, torch.where(pure_noise[:, None], du, Ut + du))
    return u, torch.where(frozen, torch.zeros_like(du), du)


def _control_rngs(model_params, C: int) -> torch.Tensor:
    return model_params["control_rngs"].reshape(-1, 2)[-C:]


def launch_scalars(model, cfg, k_offset, T: int, K: int, cost_params=None,
                   costmap=None, l1_cost: bool = False, n_obs: int = 0,
                   obstacle_coeff: float = 0.0,
                   inflation: float = 1.0) -> Tuple[list, list]:
    """The kernels' host scalars (floats, ints) in the order of
    ``_FLOAT_SCALARS`` / ``_INT_SCALARS``; the cost entries are 0 for the
    chain kernel (no ``cost_params``), H and W 0 for a neural field;
    ``bf`` picks the kernels' basis-function instance, ``n_obs`` is the
    number of circle slots (0: no obstacle terms)."""
    nu0, nu1 = (float(np.float32(v)) for v in cfg.exploration_std)
    floats = [nu0, nu1, float(cfg.optimization_stride),
              _pure_thresh(cfg, k_offset), float(np.float32(model.dt))]
    ints = [T, K, int(int(k_offset) == 0), int(model.negate_yaw_der),
            int(type(model) is BasisFunctionDynamics)]
    if cost_params is None:
        floats += [0.0] * (len(_FLOAT_SCALARS) - len(floats))
        ints += [0] * (len(_INT_SCALARS) - len(ints))
        return floats, ints
    p = cost_params
    floats += list(costmap.transform) + [
        float(np.float32(v)) for v in (
            p.desired_speed, p.speed_coeff, p.track_coeff, p.max_slip_ang,
            p.slip_penalty, p.track_slop, p.crash_coeff, p.steering_coeff,
            p.throttle_coeff, p.boundary_threshold, p.discount,
            obstacle_coeff, inflation)]
    H, W = ((costmap.height, costmap.width) if type(costmap) is Costmap
            else (0, 0))
    ints += [H, W, int(bool(l1_cost)), int(n_obs)]
    return floats, ints


@functools.cache
def _kernel_lib() -> ctypes.CDLL:
    """The kernel library, checked once against the layouts this module
    packs."""
    lib = _build.load()
    built = (lib.artt_num_float_scalars(), lib.artt_num_int_scalars(),
             lib.artt_num_weights(), lib.artt_num_bf_weights(),
             lib.artt_num_field_weights(), lib.artt_max_obstacles(),
             lib.artt_update_block())
    want = (len(_FLOAT_SCALARS), len(_INT_SCALARS), KERNEL_NUM_WEIGHTS,
            KERNEL_BF_WEIGHTS, FIELD_NUM_WEIGHTS, MAX_OBSTACLES, UPDATE_BLOCK)
    if built != want:
        raise RuntimeError(f"kernel library layout {built} does not match "
                           f"the wrapper's {want}")
    return lib


def has_kernel_form(model) -> bool:
    """Whether the CUDA kernels can evaluate ``model``'s dynamics."""
    return (type(model) is BasisFunctionDynamics
            or (type(model) is NeuralNetDynamics
                and model.layers == KERNEL_LAYERS))


def _check_kernel_model(model) -> None:
    if type(model) not in (NeuralNetDynamics, BasisFunctionDynamics):
        raise NotImplementedError(
            f"{type(model).__name__} has no CUDA kernel form: the port's "
            "kernels evaluate NeuralNetDynamics and BasisFunctionDynamics "
            "(ROADMAP.md, Queue 1)")
    if type(model) is NeuralNetDynamics and model.layers != KERNEL_LAYERS:
        raise NotImplementedError(
            f"the CUDA kernels are compiled for layers {KERNEL_LAYERS}, got "
            f"{model.layers} (ROADMAP.md, Queue 2: other layer specs)")


def _check_kernel_field(field: NeuralCostmap) -> None:
    if (field.layers != FIELD_KERNEL_LAYERS
            or field.freqs.shape != (FIELD_KERNEL_FREQS,)):
        raise NotImplementedError(
            f"the CUDA field kernels are compiled for layers "
            f"{FIELD_KERNEL_LAYERS} with {FIELD_KERNEL_FREQS} frequencies, "
            f"got {field.layers} with {field.freqs.numel()} (ROADMAP.md, "
            "Queue 2: other field specs)")


def _surface(surface) -> Tuple[str, torch.Tensor]:
    """The fused kernels' surface operand: ('exact', channel 0) for a
    ``Costmap``, ('field', the packed field) for a ``NeuralCostmap``."""
    if type(surface) is Costmap:
        return "exact", surface.ch0
    if type(surface) is NeuralCostmap:
        _check_kernel_field(surface)
        return "field", _pack_field(surface)
    raise NotImplementedError(
        f"{type(surface).__name__} is not ported: the port's kernels sample "
        "a Costmap or a NeuralCostmap (ROADMAP.md, Queue 1)")


def _expect(surface, cls, fn: str) -> None:
    if type(surface) is not cls:
        raise TypeError(f"{fn} takes a {cls.__name__}, got "
                        f"{type(surface).__name__}")


def _device_args(device, **tensors):
    """Validate the kernel's tensor arguments (float32, contiguous, on
    ``device``) and return their data pointers."""
    ptrs = {}
    for name, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        ptrs[name] = t.data_ptr()
    return ptrs


def _cached_pack(owner, src, pack) -> torch.Tensor:
    """``pack()``, computed once per set of tensors ``src`` and kept on
    ``owner``; new tensors, or an in-place change of one, pack again."""
    key = tuple((id(t), t._version) for t in src)
    cached = getattr(owner, "_kernel_pack", None)
    if cached is not None and cached[1] == key:
        return cached[2]
    packed = pack().to(torch.float32).contiguous()
    # holding ``src`` keeps the ids in ``key`` from being reused; the
    # field is a frozen dataclass, hence object.__setattr__
    object.__setattr__(owner, "_kernel_pack", (src, key, packed))
    return packed


def _pack_weights(model, model_params) -> torch.Tensor:
    """The kernels' weight buffer, ``kernel_weights`` flattened in order:
    for the MLP the (out, in) panels and biases in layer order (1,412
    floats for 6-32-32-4), for the BF model theta^T (4, 25), row-major
    (100 floats).  Packed once per set of weight tensors."""
    src = ((model_params["theta"],) if type(model) is BasisFunctionDynamics
           else (*model_params["weights"], *model_params["biases"]))
    return _cached_pack(
        model, src, lambda: torch.cat([w.reshape(-1) for w in
                                       model.kernel_weights(model_params)]))


def _obstacle_circles(cost_params, obstacles) -> Optional[torch.Tensor]:
    """The circles to price, (N, 3) float32 as given (any device), or None
    without obstacle terms.  ``CostParams.obstacles`` without obstacle terms
    is refused rather than dropped: an ``ObstacleCost`` picks the circles
    and passes them with its coefficients (``ObstacleCost.kernel_kwargs``)."""
    if obstacles is None:
        if cost_params.obstacles is not None:
            raise NotImplementedError(
                "CostParams.obstacles is set but no obstacle terms were "
                "passed: circles are priced only through an ObstacleCost "
                "(obstacles=, obstacle_coeff=, inflation=; "
                "ObstacleCost.kernel_kwargs)")
        return None
    circles = torch.as_tensor(obstacles, dtype=torch.float32)
    if circles.dim() != 2 or circles.shape[1] != 3:
        raise ValueError(f"obstacles must be (N, 3) [x, y, radius], got "
                         f"{tuple(circles.shape)}")
    return circles


def _obstacle_launch(circles: Optional[torch.Tensor], dev):
    """(n_obs, packed) for a fused kernel: the circles as [x..., y...,
    radius...] (3 N,) float32 on ``dev``, copied anew for every launch so
    that a live update is never served from a stale copy; (0, None)
    without obstacle terms."""
    if circles is None:
        return 0, None
    n = circles.shape[0]
    if n > MAX_OBSTACLES:
        raise ValueError(f"the CUDA kernels stage at most {MAX_OBSTACLES} "
                         f"obstacle slots, got {n}")
    packed = torch.empty((3, n), dtype=torch.float32, device=dev)
    packed.copy_(circles.t())
    return n, packed.reshape(-1)


# Kernel launches by instance name (the wrapper's name, ``_field`` for pass
# 1's field mode, then ``_form``'s suffix), counted where a wrapper launches.
LAUNCHES = collections.Counter()


def _form(model, n_obs: int) -> str:
    """The suffix of a kernel instance's name: ``_bf`` for the BF model,
    ``_obstacles`` with circle slots."""
    return (("_bf" if type(model) is BasisFunctionDynamics else "")
            + ("_obstacles" if n_obs else ""))


def _pack_field(field: NeuralCostmap) -> torch.Tensor:
    """The field kernels' buffer (6,473 floats for 34-64-64-1, F = 8):
    W0 kept (in, out), so that each feature's column is contiguous for the
    kernel's first layer, streamed over the features; b0; W1 as its
    (out, in) panel, rows contiguous for the second layer, evaluated one
    neuron at a time; b1; W2 (64); b2; freqs.  Packed once per field."""
    (W0, W1, W2), (b0, b1, b2) = field.weights, field.biases
    return _cached_pack(
        field, (*field.weights, *field.biases, field.freqs),
        lambda: torch.cat([W0.reshape(-1), b0, W1.t().reshape(-1), b1,
                           W2.reshape(-1), b2, field.freqs]))


def _host_array(ctype, values):
    return (ctype * len(values))(*values)


def _check_launch(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed with CUDA error "
                           f"{err}")


def _dispatch(t: torch.Tensor) -> str:
    """'plain' for CPU tensors, 'kernel' for CUDA tensors, else raise."""
    if t.device.type == "cpu":
        return "plain"
    if t.device.type == "cuda":
        return "kernel"
    raise ValueError(f"no rollout kernel for device {t.device}")


def _kernel_inputs(model, model_params, state, U, K: int, eps=None,
                   max_T: int = MAX_KERNEL_T):
    """Shape checks and the device tensors every rollout kernel reads
    (with ``eps`` (T, K, C) for the kernels that read their noise)."""
    T, C = U.shape
    if (C != 2 or state.shape != (model.STATE_DIM,)
            or (eps is not None and eps.shape != (T, K, C))):
        raise ValueError(f"shapes: state {tuple(state.shape)}, U "
                         f"{tuple(U.shape)}, K {K}, eps "
                         f"{None if eps is None else tuple(eps.shape)}")
    if K < 1 or not 1 <= T <= max_T:
        raise ValueError(f"kernel needs K >= 1 and 1 <= T <= {max_T}")
    args = dict(
        s0=state.to(U.device, torch.float32).contiguous(),
        rngs=_control_rngs(model_params, C).to(torch.float32).contiguous(),
        U=U.to(torch.float32).contiguous(),
        weights=_pack_weights(model, model_params))
    if eps is not None:
        args["eps"] = eps
    return args


# ---------------------------------------------------------------------------
# kernel A and kernel 3: fused rollout + cost on the exact map or the field
# ---------------------------------------------------------------------------

def fused_rollout_cost_plain(model, model_params, cfg, cost_params, surface,
                             state, U, eps, l1_cost: bool = False,
                             k_offset=0, obstacles=None,
                             obstacle_coeff: float = 0.0,
                             inflation: float = 1.0):
    """Plain PyTorch version of the fused kernels, on either surface (a
    ``Costmap`` for kernel A, a ``NeuralCostmap`` for kernel 3), either
    model, with or without obstacle terms: the dynamics chain
    (:func:`dynamics_chain_plain`), then the kernels' per-step cost rules
    along it (:func:`trajectory_cost_plain`).
    Returns (costs (K,), u_seq (C, T, K) pre-clamp, crash (K,) int32)."""
    states, u_seq = dynamics_chain_plain(model, model_params, cfg, state, U,
                                         eps, k_offset=k_offset)
    costs, crash = trajectory_cost_plain(
        model, model_params, cfg, cost_params, surface, U, eps, states,
        l1_cost=l1_cost, k_offset=k_offset, obstacles=obstacles,
        obstacle_coeff=obstacle_coeff, inflation=inflation)
    return costs, u_seq, crash


def trajectory_cost_plain(model, model_params, cfg, cost_params, surface,
                          U, eps, states, l1_cost: bool = False, k_offset=0,
                          obstacles=None, obstacle_coeff: float = 0.0,
                          inflation: float = 1.0):
    """Running-average cost and crash latch of K rollouts along given
    trajectories ``states`` (S, T, K) (``states[:, t]`` after t+1 steps),
    with the fused kernels' per-step rules (``_make_cost_step`` and the
    kernel bodies) on ``surface``, anything with ``lookup_ch0`` (the exact
    ``Costmap`` or a ``NeuralCostmap``): cost step t = 1..T-1 prices s_t
    with the controls of step t; step 0 adds nothing and never latches; the
    roll latch on s_t precedes the boundary latch and the crash cost of
    step t.  With ``obstacles`` (N, 3), the step adds their
    ``obstacle_terms`` at the car's centre to the track term and the latch,
    as an ``ObstacleCost`` does.  Returns (costs (K,), crash (K,) int32)."""
    T, K, C = eps.shape
    dev = eps.device
    circles = _obstacle_circles(cost_params, obstacles)
    p = cost_params
    cost = MPPICost(l1_cost)
    nu = torch.tensor(cfg.exploration_std, dtype=torch.float32, device=dev)
    zero_rollout, pure_noise = _rollout_masks(cfg, K, k_offset, dev)
    one_minus_discount = float(np.float32(1.0) - np.float32(p.discount))

    running = torch.zeros(K, dtype=torch.float32, device=dev)
    crash = torch.zeros(K, dtype=torch.int32, device=dev)
    for t in range(1, T):
        s = states[:, t - 1].T                                # s_t (K, S)
        u, du = _perturb(cfg, t, U, eps, nu, zero_rollout, pure_noise)
        u_cl = model.enforce_constraints(model_params, u)
        crash = cost.get_crash(s, crash)
        control = cost.control_cost_c(p, u_cl[:, 0], u_cl[:, 1],
                                      du[:, 0], du[:, 1], nu)
        track, crash = cost.track_cost_c(p, surface, s[:, 0], s[:, 1],
                                         s[:, 2], crash)
        if circles is not None:
            obst, crash = obstacle_terms(circles, obstacle_coeff, inflation,
                                         s[:, 0], s[:, 1], crash)
            track = track + obst
        speed = cost.speed_cost_c(p, s[:, 4])
        crash_c = one_minus_discount * cost.crash_cost(p, crash)
        stab = cost.stabilizing_cost_c(p, s[:, 4], s[:, 5])
        c = cost.clamp_cost(control + speed + crash_c + track + stab)
        running = running + (c - running) / t
    return running, crash


def _prepare_fused(cls, fn: str, model, model_params, cfg, cost_params,
                   surface, state, U, eps, l1_cost, k_offset, obstacles,
                   obstacle_coeff, inflation):
    """Validate a fused kernel's inputs (``surface`` must be a ``cls``) and
    allocate its outputs.  Returns ``(launch, (costs, u_seq, crash))``:
    each ``launch()`` runs the kernel once into those outputs on the
    current stream (uncounted; the wrapper counts ``launch.name``)."""
    _expect(surface, cls, fn)
    _check_kernel_model(model)
    circles = _obstacle_circles(cost_params, obstacles)
    kind, buf = _surface(surface)
    T, K, C = eps.shape
    dev = eps.device
    args = _kernel_inputs(model, model_params, state, U, K, eps, max_T=(
        MAX_FIELD_KERNEL_T if kind == "field" else MAX_KERNEL_T))
    args["surface"] = buf
    ptrs = _device_args(dev, **args)
    n_obs, packed = _obstacle_launch(circles, dev)
    floats, ints = launch_scalars(model, cfg, k_offset, T, K, cost_params,
                                  surface, l1_cost, n_obs, obstacle_coeff,
                                  inflation)
    fsc = _host_array(ctypes.c_float, floats)
    isc = _host_array(ctypes.c_int, ints)

    costs = torch.empty(K, dtype=torch.float32, device=dev)
    crash = torch.empty(K, dtype=torch.int32, device=dev)
    u_seq = torch.empty((C, T, K), dtype=torch.float32, device=dev)
    entry = getattr(_kernel_lib(), {
        "exact": "artt_fused_exact_rollout_cost",
        "field": "artt_fused_field_rollout_cost"}[kind])

    def launch():
        err = entry(
            ctypes.addressof(fsc), ctypes.addressof(isc), dev.index or 0,
            ptrs["s0"], ptrs["rngs"], ptrs["U"], ptrs["eps"],
            ptrs["surface"], ptrs["weights"],
            None if packed is None else packed.data_ptr(), costs.data_ptr(),
            crash.data_ptr(), u_seq.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
        _check_launch(err, fn)

    launch.inputs = (args, packed)           # keeps the buffers alive
    launch.name = fn + _form(model, n_obs)
    return launch, (costs, u_seq, crash)


def prepare_fused_exact_rollout_cost(model, model_params, cfg, cost_params,
                                     costmap: Costmap, state, U, eps,
                                     l1_cost: bool = False, k_offset=0,
                                     obstacles=None,
                                     obstacle_coeff: float = 0.0,
                                     inflation: float = 1.0):
    """Kernel A's launch and outputs (see :func:`_prepare_fused`)."""
    return _prepare_fused(Costmap, "fused_exact_rollout_cost", model,
                          model_params, cfg, cost_params, costmap, state, U,
                          eps, l1_cost, k_offset, obstacles, obstacle_coeff,
                          inflation)


def prepare_fused_rollout_cost(model, model_params, cfg, cost_params,
                               field: NeuralCostmap, state, U, eps,
                               l1_cost: bool = False, k_offset=0,
                               obstacles=None, obstacle_coeff: float = 0.0,
                               inflation: float = 1.0):
    """Kernel 3's launch and outputs (see :func:`_prepare_fused`)."""
    return _prepare_fused(NeuralCostmap, "fused_rollout_cost", model,
                          model_params, cfg, cost_params, field, state, U,
                          eps, l1_cost, k_offset, obstacles, obstacle_coeff,
                          inflation)


def fused_exact_rollout_cost(model, model_params, cfg, cost_params,
                             costmap: Costmap, state, U, eps,
                             l1_cost: bool = False, k_offset=0,
                             obstacles=None, obstacle_coeff: float = 0.0,
                             inflation: float = 1.0):
    """Fused rollout + exact-costmap cost (``fused_exact_rollout_cost_pallas``).

    ``state`` (S,), ``U`` (T, C), ``eps`` (T, K, C) standard normal;
    ``k_offset`` is the global index of this batch's first rollout;
    ``obstacles`` (N, 3) circles priced with ``obstacle_coeff`` and
    ``inflation`` (``ObstacleCost.kernel_kwargs``), or None.
    Returns (costs (K,), u_seq (C, T, K), crash (K,) int32)."""
    _expect(costmap, Costmap, "fused_exact_rollout_cost")
    kw = dict(l1_cost=l1_cost, k_offset=k_offset, obstacles=obstacles,
              obstacle_coeff=obstacle_coeff, inflation=inflation)
    if _dispatch(eps) == "plain":
        return fused_rollout_cost_plain(model, model_params, cfg,
                                        cost_params, costmap, state, U, eps,
                                        **kw)
    launch, out = prepare_fused_exact_rollout_cost(
        model, model_params, cfg, cost_params, costmap, state, U, eps, **kw)
    launch()
    LAUNCHES[launch.name] += 1
    return out


def fused_rollout_cost(model, model_params, cfg, cost_params,
                       field: NeuralCostmap, state, U, eps,
                       l1_cost: bool = False, k_offset=0, obstacles=None,
                       obstacle_coeff: float = 0.0, inflation: float = 1.0):
    """Fused rollout + neural-field cost (``fused_rollout_cost_pallas``):
    :func:`fused_exact_rollout_cost`'s contract with a ``NeuralCostmap``.
    Returns (costs (K,), u_seq (C, T, K), crash (K,) int32)."""
    _expect(field, NeuralCostmap, "fused_rollout_cost")
    kw = dict(l1_cost=l1_cost, k_offset=k_offset, obstacles=obstacles,
              obstacle_coeff=obstacle_coeff, inflation=inflation)
    if _dispatch(eps) == "plain":
        return fused_rollout_cost_plain(model, model_params, cfg,
                                        cost_params, field, state, U, eps,
                                        **kw)
    launch, out = prepare_fused_rollout_cost(
        model, model_params, cfg, cost_params, field, state, U, eps, **kw)
    launch()
    LAUNCHES[launch.name] += 1
    return out


# ---------------------------------------------------------------------------
# kernel B: the dynamics chain
# ---------------------------------------------------------------------------

def dynamics_chain_plain(model, model_params, cfg, state, U, eps, k_offset=0):
    """Plain PyTorch version of the chain kernel: returns (states (S, T, K)
    with ``states[i, t]`` = component i after t+1 steps, u_seq (C, T, K))."""
    T, K, C = eps.shape
    dev = eps.device
    S = model.STATE_DIM
    nu = torch.tensor(cfg.exploration_std, dtype=torch.float32, device=dev)
    zero_rollout, pure_noise = _rollout_masks(cfg, K, k_offset, dev)
    s = state.to(dev, torch.float32).expand(K, S).clone()
    states = torch.empty((S, T, K), dtype=torch.float32, device=dev)
    u_seq = torch.empty((C, T, K), dtype=torch.float32, device=dev)
    for t in range(T):
        u, _ = _perturb(cfg, t, U, eps, nu, zero_rollout, pure_noise)
        u_seq[:, t] = u.T
        u_cl = model.enforce_constraints(model_params, u)
        s = s + model.state_deriv(model_params, s, u_cl) * model.dt
        states[:, t] = s.T
    return states, u_seq


def prepare_dynamics_chain(model, model_params, cfg, state, U, eps,
                           k_offset=0):
    """Validate the chain kernel's inputs and allocate its outputs; returns
    ``(launch, (states, u_seq))`` as :func:`prepare_fused_exact_rollout_cost`."""
    _check_kernel_model(model)
    T, K, C = eps.shape
    dev = eps.device
    args = _kernel_inputs(model, model_params, state, U, K, eps)
    ptrs = _device_args(dev, **args)
    floats, ints = launch_scalars(model, cfg, k_offset, T, K)
    fsc = _host_array(ctypes.c_float, floats)
    isc = _host_array(ctypes.c_int, ints)

    states = torch.empty((model.STATE_DIM, T, K), dtype=torch.float32,
                         device=dev)
    u_seq = torch.empty((C, T, K), dtype=torch.float32, device=dev)
    lib = _kernel_lib()

    def launch():
        err = lib.artt_dynamics_chain(
            ctypes.addressof(fsc), ctypes.addressof(isc), dev.index or 0,
            ptrs["s0"], ptrs["rngs"], ptrs["U"], ptrs["eps"],
            ptrs["weights"], states.data_ptr(), u_seq.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
        _check_launch(err, "dynamics_chain")

    launch.inputs = args
    launch.name = "dynamics_chain" + _form(model, 0)
    return launch, (states, u_seq)


def dynamics_chain(model, model_params, cfg, state, U, eps, k_offset=0):
    """The dynamics chain (``dynamics_chain_pallas``): same perturb/clamp/
    derivative/Euler as the fused kernel, emitting every state.
    Returns (states (S, T, K), u_seq (C, T, K))."""
    if _dispatch(eps) == "plain":
        return dynamics_chain_plain(model, model_params, cfg, state, U, eps,
                                    k_offset=k_offset)
    launch, out = prepare_dynamics_chain(model, model_params, cfg, state, U,
                                         eps, k_offset=k_offset)
    launch()
    LAUNCHES[launch.name] += 1
    return out


def nominal_trajectory(model, model_params, cfg, state, U):
    """Re-rollout of the solution (``computeNominalTraj``,
    ``mppi_controller.cu:501-519``; ``nominal_trajectory_pallas``): one
    noise-free rollout through :func:`dynamics_chain` (K = 1).  Returns
    (state_solution (T, S), control_solution (T, C)), recording each state
    before its update and the clamped controls."""
    T, C = U.shape
    state = state.to(U.device, torch.float32)
    eps = torch.zeros((T, 1, C), dtype=torch.float32, device=U.device)
    states, _ = dynamics_chain(model, model_params, cfg, state, U, eps)
    traj = states[:, :, 0].T                                 # s_1 .. s_T
    states_sol = torch.cat([state[None, :], traj[:-1]], dim=0)
    rngs = _control_rngs(model_params, C)
    return states_sol, torch.clamp(U, rngs[:, 0], rngs[:, 1])


# ---------------------------------------------------------------------------
# the kernel-RNG ("nothing-in-HBM") capacity mode: pass 1 and pass 2
# ---------------------------------------------------------------------------

class RngContext(NamedTuple):
    """What pass 2 needs to replay pass 1's noise stream (the JAX
    package's ``ctx``)."""

    model: object                   # NeuralNetDynamics or BF
    cfg: object
    U: torch.Tensor                 # (T, C) float32
    key: torch.Tensor               # int64 (2,): the stream's key
    k_offset: int                   # global index of rollout 0
    K: int
    theta: Optional[float]          # OU rate; None for white draws


def stream_theta(cfg) -> Optional[float]:
    """The OU rate of the in-kernel stream, None for white draws; raises
    for a sampler the stream cannot draw (as ``fused_rng_costs`` of the
    JAX package does)."""
    if cfg.noise_sampler == "ou":
        # a = 1 - theta must be a stationary AR(1) coefficient; a == 0
        # (theta == 1) is white noise
        a = 1.0 - float(cfg.noise_param)
        if not -1.0 < a < 1.0:
            raise ValueError(
                f"kernel-RNG OU needs theta in (0, 2): {cfg.noise_param}")
        return None if a == 0.0 else float(cfg.noise_param)
    if cfg.noise_sampler == "gaussian":
        return None
    raise NotImplementedError(
        f"kernel-RNG mode supports gaussian/ou noise, not "
        f"{cfg.noise_sampler!r} (DFT-shaped colored noise needs the whole "
        f"horizon axis live: host-noise path only)")


def _rng_context(model, cfg, cost_params, field, U, key, k_offset,
                 K_local) -> RngContext:
    if type(field) not in (Costmap, NeuralCostmap):
        raise NotImplementedError(
            f"kernel-RNG mode on {type(field).__name__} is not ported: the "
            "port's passes sample a Costmap or a NeuralCostmap (ROADMAP.md, "
            "Queue 1)")
    theta = stream_theta(cfg)
    if (key.dtype != torch.int64 or key.shape != (2,)
            or key.device != U.device):
        raise ValueError(f"key must be an int64 (2,) tensor on {U.device}, "
                         f"got {key.dtype} {tuple(key.shape)} on "
                         f"{key.device}")
    K = cfg.num_rollouts if K_local is None else int(K_local)
    return RngContext(model, cfg, U.to(torch.float32).contiguous(),
                      key.contiguous(), int(k_offset), K, theta)


def rng_noise(ctx: RngContext) -> torch.Tensor:
    """The (T, K, C) noise the passes draw for ``ctx``, in PyTorch."""
    return kernel_noise(ctx.key, ctx.k_offset, ctx.K, ctx.U.shape[0],
                        ctx.theta)


def _stream_launch_args(ctx: RngContext):
    """(k_offset, ou_a, ou_b) of the passes' launchers; a == 0 draws white
    noise."""
    a, b = (0.0, 0.0) if ctx.theta is None else ou_coefficients(ctx.theta)
    return ctx.k_offset, a, b


def fused_rng_costs_plain(model, model_params, cfg, cost_params, field,
                          state, U, key, l1_cost: bool = False, k_offset=0,
                          K_local=None, obstacles=None,
                          obstacle_coeff: float = 0.0,
                          inflation: float = 1.0):
    """Plain version of pass 1, both modes: the fused kernels' plain version
    (:func:`fused_rollout_cost_plain`) on the stream.  Returns (total (K,),
    crash (K,) int32, ctx)."""
    ctx = _rng_context(model, cfg, cost_params, field, U, key, k_offset,
                       K_local)
    costs, _, crash = fused_rollout_cost_plain(
        model, model_params, cfg, cost_params, field, state, ctx.U,
        rng_noise(ctx), l1_cost=l1_cost, k_offset=ctx.k_offset,
        obstacles=obstacles, obstacle_coeff=obstacle_coeff,
        inflation=inflation)
    return costs, crash, ctx


def prepare_fused_rng_costs(model, model_params, cfg, cost_params, field,
                            state, U, key, l1_cost: bool = False, k_offset=0,
                            K_local=None, obstacles=None,
                            obstacle_coeff: float = 0.0,
                            inflation: float = 1.0):
    """Validate pass 1's inputs and allocate its outputs.  Returns
    ``(launch, (costs, crash), ctx)``; each ``launch()`` runs the kernel of
    the surface's mode (``fused_rng_kernel`` for a ``Costmap``,
    ``fused_rng_field_kernel`` for a ``NeuralCostmap``) once on the current
    stream (uncounted; the wrapper counts); ``launch.mode`` names the
    mode, ``launch.name`` the kernel instance."""
    _check_kernel_model(model)
    circles = _obstacle_circles(cost_params, obstacles)
    ctx = _rng_context(model, cfg, cost_params, field, U, key, k_offset,
                       K_local)
    kind, buf = _surface(field)
    T, K = ctx.U.shape[0], ctx.K
    dev = ctx.U.device
    args = _kernel_inputs(model, model_params, state, ctx.U, K, max_T=(
        MAX_FIELD_KERNEL_T if kind == "field" else MAX_KERNEL_T))
    args["surface"] = buf
    ptrs = _device_args(dev, **args)
    n_obs, packed = _obstacle_launch(circles, dev)
    floats, ints = launch_scalars(model, cfg, ctx.k_offset, T, K,
                                  cost_params, field, l1_cost, n_obs,
                                  obstacle_coeff, inflation)
    fsc = _host_array(ctypes.c_float, floats)
    isc = _host_array(ctypes.c_int, ints)
    stream_args = _stream_launch_args(ctx)

    costs = torch.empty(K, dtype=torch.float32, device=dev)
    crash = torch.empty(K, dtype=torch.int32, device=dev)
    entry = getattr(_kernel_lib(), {
        "exact": "artt_fused_rng_costs",
        "field": "artt_fused_rng_field_costs"}[kind])

    def launch():
        err = entry(
            ctypes.addressof(fsc), ctypes.addressof(isc), *stream_args,
            dev.index or 0, ptrs["s0"], ptrs["rngs"], ptrs["U"],
            ctx.key.data_ptr(), ptrs["surface"], ptrs["weights"],
            None if packed is None else packed.data_ptr(), costs.data_ptr(),
            crash.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
        _check_launch(err, f"fused_rng_costs ({kind})")

    launch.inputs = (args, packed)           # keeps the buffers alive
    launch.mode = kind
    launch.name = ("fused_rng_costs" + ("_field" if kind == "field" else "")
                   + _form(model, n_obs))
    return launch, (costs, crash), ctx


def fused_rng_costs(model, model_params, cfg, cost_params, field, state, U,
                    key, l1_cost: bool = False, k_offset=0, K_local=None,
                    obstacles=None, obstacle_coeff: float = 0.0,
                    inflation: float = 1.0):
    """Pass 1 of the capacity mode (``fused_rng_costs`` of the JAX
    package): rollout costs with the noise drawn in the kernel; nothing per
    (t, k) reaches device memory.  ``field`` is the exact ``Costmap`` or a
    ``NeuralCostmap`` (the JAX kernel's ``cost_mode`` "exact" / "field");
    the two modes are two CUDA kernels, counted as ``fused_rng_costs`` and
    ``fused_rng_costs_field`` (and their ``_bf`` / ``_obstacles`` forms);
    ``obstacles`` as in :func:`fused_exact_rollout_cost`.

    ``key``: int64 (2,) on ``U``'s device, the stream's key; ``k_offset`` /
    ``K_local`` let a sharded caller run its own slice of the global batch.
    Returns (total (K,), crash (K,) int32, ctx), where ``ctx`` replays the
    same stream in :func:`fused_rng_numer`."""
    kw = dict(l1_cost=l1_cost, k_offset=k_offset, K_local=K_local,
              obstacles=obstacles, obstacle_coeff=obstacle_coeff,
              inflation=inflation)
    if _dispatch(U) == "plain":
        return fused_rng_costs_plain(model, model_params, cfg, cost_params,
                                     field, state, U, key, **kw)
    launch, (costs, crash), ctx = prepare_fused_rng_costs(
        model, model_params, cfg, cost_params, field, state, U, key, **kw)
    launch()
    LAUNCHES[launch.name] += 1
    return costs, crash, ctx


def fused_rng_numer_plain(ctx: RngContext, w):
    """Plain version of pass 2: sum_k w_k u_{k,t,c} over the replayed
    stream's pre-clamp controls, (C, T)."""
    eps = rng_noise(ctx)
    T, K, _ = eps.shape
    nu = torch.tensor(ctx.cfg.exploration_std, dtype=torch.float32,
                      device=eps.device)
    zero_rollout, pure_noise = _rollout_masks(ctx.cfg, K, ctx.k_offset,
                                              eps.device)
    u = torch.stack([_perturb(ctx.cfg, t, ctx.U, eps, nu, zero_rollout,
                              pure_noise)[0] for t in range(T)])  # (T, K, C)
    return torch.einsum("k,tkc->ct", w, u)


def prepare_fused_rng_numer(ctx: RngContext, w):
    """Validate pass 2's inputs and allocate its partial sums (G, C, T),
    G = ceil(K / UPDATE_BLOCK).  Returns ``(launch, partials)``."""
    T, C = ctx.U.shape
    dev = w.device
    if w.shape != (ctx.K,):
        raise ValueError(f"w must be ({ctx.K},), got {tuple(w.shape)}")
    ptrs = _device_args(dev, U=ctx.U, w=w)
    if ctx.key.device != dev:
        raise ValueError(f"key is on {ctx.key.device}, expected {dev}")
    floats, ints = launch_scalars(ctx.model, ctx.cfg, ctx.k_offset, T, ctx.K)
    fsc = _host_array(ctypes.c_float, floats)
    isc = _host_array(ctypes.c_int, ints)
    stream_args = _stream_launch_args(ctx)
    G = -(-ctx.K // UPDATE_BLOCK)
    partials = torch.empty((G, C, T), dtype=torch.float32, device=dev)
    lib = _kernel_lib()

    def launch():
        err = lib.artt_weighted_update(
            ctypes.addressof(fsc), ctypes.addressof(isc), *stream_args,
            dev.index or 0, ptrs["U"], ctx.key.data_ptr(), ptrs["w"],
            partials.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
        _check_launch(err, "fused_rng_numer")

    launch.inputs = (ctx, w)
    return launch, partials


def fused_rng_numer(ctx: RngContext, w):
    """Pass 2 of the capacity mode (``fused_rng_numer``): replay pass 1's
    stream and contract it with the softmax weights ``w`` (K,).  Returns
    the un-normalised (C, T) numerator (a sharded caller sums it over
    shards before dividing by the global eta).  The kernel's block sums
    come in a fixed order; their sum over blocks is a ``torch.sum``."""
    if _dispatch(w) == "plain":
        return fused_rng_numer_plain(ctx, w)
    launch, partials = prepare_fused_rng_numer(ctx, w)
    launch()
    LAUNCHES["fused_rng_numer"] += 1
    return torch.sum(partials, dim=0)


def _rng_iteration(costs_fn, numer_fn, model, model_params, cfg, cost_params,
                   field, state, U, key, l1_cost, k_offset, obstacle_kw):
    total, crash, ctx = costs_fn(model, model_params, cfg, cost_params, field,
                                 state, U, key, l1_cost=l1_cost,
                                 k_offset=k_offset, **obstacle_kw)
    baseline = torch.min(total)
    w = torch.exp(-effective_gamma(cfg, cost_params) * (total - baseline))
    U_new = (numer_fn(ctx, w) / torch.sum(w)).T
    return U_new, total, crash


def fused_rng_solve_iteration_plain(model, model_params, cfg, cost_params,
                                    field, state, U, key,
                                    l1_cost: bool = False, k_offset=0,
                                    **obstacle_kw):
    """:func:`fused_rng_solve_iteration` through the plain versions of both
    passes."""
    return _rng_iteration(fused_rng_costs_plain, fused_rng_numer_plain,
                          model, model_params, cfg, cost_params, field,
                          state, U, key, l1_cost, k_offset, obstacle_kw)


def fused_rng_solve_iteration(model, model_params, cfg, cost_params,
                              field, state, U, key,
                              l1_cost: bool = False, k_offset=0,
                              **obstacle_kw):
    """One MPPI iteration in the capacity mode: pass 1's costs, the softmax
    weights in PyTorch, pass 2's numerator; device-memory traffic is
    O(K + T C), independent of K T.  Runs the kernels for tensors on a
    GPU, the plain versions for tensors on the CPU (each pass counts its
    own launches); ``obstacle_kw`` (``obstacles``, ``obstacle_coeff``,
    ``inflation``) go to pass 1.  Returns (U_new (T, C), total (K,), crash
    (K,))."""
    return _rng_iteration(fused_rng_costs, fused_rng_numer, model,
                          model_params, cfg, cost_params, field, state, U,
                          key, l1_cost, k_offset, obstacle_kw)
