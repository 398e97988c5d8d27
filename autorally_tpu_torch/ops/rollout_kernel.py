"""The MPPI rollout kernels: CUDA wrappers and their plain PyTorch versions.

Port of the two TPU kernels of ``autorally_tpu/ops/rollout_kernel.py`` that
the main path runs:

- :func:`fused_exact_rollout_cost` (kernel in ``csrc/rollout_kernels.cu``,
  ``fused_exact_kernel``) replaces ``_fused_exact_kernel``: the whole
  ``rolloutKernel`` (``mppi_controller.cu:72-184``) with the exact
  point-sampled costmap;
- :func:`dynamics_chain` (``dynamics_chain_kernel``) replaces
  ``_rollout_kernel``: the dynamics chain alone, emitting every state; and
  :func:`nominal_trajectory` runs it for the single noise-free rollout.

Each wrapper runs the plain version (``*_plain``) for tensors on the CPU,
launches the CUDA kernel for tensors on a GPU, and raises for anything
else; there is no fallback from one to the other.  Each counts its kernel
launches in ``<wrapper>.launches``.  Layouts are those of the JAX package's
public functions: eps (T, K, C) in, u_seq (C, T, K), states (S, T, K),
costs and crash (K,) out.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import numpy as np
import torch

from autorally_tpu_torch.costs.costmap import Costmap
from autorally_tpu_torch.costs.mppi_cost import MPPICost
from autorally_tpu_torch.models.neural_net import NeuralNetDynamics
from autorally_tpu_torch.ops import _build

# The layer spec the CUDA kernels are compiled for (csrc kIn/kH1/kH2/kOut).
KERNEL_LAYERS = (6, 32, 32, 4)
KERNEL_NUM_WEIGHTS = sum(a * b + b for a, b in zip(KERNEL_LAYERS[:-1],
                                                    KERNEL_LAYERS[1:]))
# Dynamic shared memory holds the weights and U (T x 2); stay under the
# 48 KB a launch gets without opting in.
MAX_KERNEL_T = 4096

# Host launch scalars, in the order csrc/rollout_kernels.cu unpacks them.
_FLOAT_SCALARS = ("nu0", "nu1", "opt_delay", "pure_thresh", "dt",
                  "rc1x", "rc1y", "rc1w", "rc2x", "rc2y", "rc2w",
                  "trsx", "trsy", "trsw",
                  "desired_speed", "speed_coeff", "track_coeff",
                  "max_slip_ang", "slip_penalty", "track_slop", "crash_coeff",
                  "steering_coeff", "throttle_coeff", "boundary_threshold",
                  "discount")
_INT_SCALARS = ("T", "K", "k0_flag", "negate_yaw_der", "H", "W", "l1_cost")


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
                   costmap=None, l1_cost: bool = False) -> Tuple[list, list]:
    """The kernels' host scalars (floats, ints) in the order of
    ``_FLOAT_SCALARS`` / ``_INT_SCALARS``; the cost entries are 0 for the
    chain kernel (no ``cost_params``)."""
    nu0, nu1 = (float(np.float32(v)) for v in cfg.exploration_std)
    floats = [nu0, nu1, float(cfg.optimization_stride),
              _pure_thresh(cfg, k_offset), float(np.float32(model.dt))]
    ints = [T, K, int(int(k_offset) == 0), int(model.negate_yaw_der)]
    if cost_params is None:
        floats += [0.0] * (len(_FLOAT_SCALARS) - len(floats))
        ints += [0] * (len(_INT_SCALARS) - len(ints))
        return floats, ints
    p = cost_params
    floats += list(costmap.transform) + [
        float(np.float32(v)) for v in (
            p.desired_speed, p.speed_coeff, p.track_coeff, p.max_slip_ang,
            p.slip_penalty, p.track_slop, p.crash_coeff, p.steering_coeff,
            p.throttle_coeff, p.boundary_threshold, p.discount)]
    ints += [costmap.height, costmap.width, int(bool(l1_cost))]
    return floats, ints


@functools.cache
def _kernel_lib() -> ctypes.CDLL:
    """The kernel library, checked once against the layouts this module
    packs."""
    lib = _build.load()
    built = (lib.artt_num_float_scalars(), lib.artt_num_int_scalars(),
             lib.artt_num_weights())
    want = (len(_FLOAT_SCALARS), len(_INT_SCALARS), KERNEL_NUM_WEIGHTS)
    if built != want:
        raise RuntimeError(f"kernel library layout {built} does not match "
                           f"the wrapper's {want}")
    return lib


def _check_kernel_model(model) -> None:
    if type(model) is not NeuralNetDynamics:
        raise NotImplementedError(
            f"{type(model).__name__} has no CUDA kernel form yet: the port's "
            "kernels evaluate NeuralNetDynamics only (ROADMAP.md, Queue 1 "
            "item 2 and Queue 2: the basis-function form)")
    if model.layers != KERNEL_LAYERS:
        raise NotImplementedError(
            f"the CUDA kernels are compiled for layers {KERNEL_LAYERS}, got "
            f"{model.layers} (ROADMAP.md, Queue 2: other layer specs)")


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


def _pack_weights(model, model_params) -> torch.Tensor:
    """The kernels' weight buffer: (out, in) panels and biases, flattened
    in layer order (1,412 floats for 6-32-32-4).  Packed once per set of
    weight tensors and kept on the model; a new params dict, or an in-place
    change of one of its tensors, packs again."""
    src = (*model_params["weights"], *model_params["biases"])
    key = tuple((id(t), t._version) for t in src)
    cached = getattr(model, "_kernel_pack", None)
    if cached is not None and cached[1] == key:
        return cached[2]
    packed = torch.cat([w.reshape(-1) for w in model.kernel_weights(
        model_params)]).to(torch.float32).contiguous()
    # holding ``src`` keeps the ids in ``key`` from being reused
    model._kernel_pack = (src, key, packed)
    return packed


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


def _kernel_inputs(model, model_params, state, U, eps):
    """Shape checks and the common device tensors of both kernels."""
    T, K, C = eps.shape
    if C != 2 or U.shape != (T, C) or state.shape != (model.STATE_DIM,):
        raise ValueError(f"shapes: state {tuple(state.shape)}, U "
                         f"{tuple(U.shape)}, eps {tuple(eps.shape)}")
    if K < 1 or not 1 <= T <= MAX_KERNEL_T:
        raise ValueError(f"kernel needs K >= 1 and 1 <= T <= {MAX_KERNEL_T}")
    dev = eps.device
    return dict(
        s0=state.to(dev, torch.float32).contiguous(),
        rngs=_control_rngs(model_params, C).to(torch.float32).contiguous(),
        U=U.to(torch.float32).contiguous(),
        eps=eps,
        weights=_pack_weights(model, model_params))


# ---------------------------------------------------------------------------
# kernel A: fused rollout + exact-costmap cost
# ---------------------------------------------------------------------------

def fused_exact_rollout_cost_plain(model, model_params, cfg, cost_params,
                                   costmap: Costmap, state, U, eps,
                                   l1_cost: bool = False, k_offset=0):
    """Plain PyTorch version of the fused kernel: the dynamics chain
    (:func:`dynamics_chain_plain`), then the kernel's per-step cost rules
    along it (:func:`exact_cost_plain`).
    Returns (costs (K,), u_seq (C, T, K) pre-clamp, crash (K,) int32)."""
    states, u_seq = dynamics_chain_plain(model, model_params, cfg, state, U,
                                         eps, k_offset=k_offset)
    costs, crash = exact_cost_plain(model, model_params, cfg, cost_params,
                                    costmap, U, eps, states, l1_cost=l1_cost,
                                    k_offset=k_offset)
    return costs, u_seq, crash


def exact_cost_plain(model, model_params, cfg, cost_params, costmap: Costmap,
                     U, eps, states, l1_cost: bool = False, k_offset=0):
    """Running-average cost and crash latch of K rollouts along given
    trajectories ``states`` (S, T, K) (``states[:, t]`` after t+1 steps),
    with the fused kernel's per-step rules (``_make_cost_step`` and the
    ``_fused_exact_kernel`` body): cost step t = 1..T-1 prices s_t with
    the controls of step t; step 0 adds nothing and never latches; the roll
    latch on s_t precedes the boundary latch and the crash cost of step t.
    Returns (costs (K,), crash (K,) int32)."""
    T, K, C = eps.shape
    dev = eps.device
    cost = MPPICost(l1_cost)
    p = cost_params
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
        track, crash = cost.track_cost_c(p, costmap, s[:, 0], s[:, 1],
                                         s[:, 2], crash)
        speed = cost.speed_cost_c(p, s[:, 4])
        crash_c = one_minus_discount * cost.crash_cost(p, crash)
        stab = cost.stabilizing_cost_c(p, s[:, 4], s[:, 5])
        c = cost.clamp_cost(control + speed + crash_c + track + stab)
        running = running + (c - running) / t
    return running, crash


def prepare_fused_exact_rollout_cost(model, model_params, cfg, cost_params,
                                     costmap: Costmap, state, U, eps,
                                     l1_cost: bool = False, k_offset=0):
    """Validate the CUDA kernel's inputs and allocate its outputs.  Returns
    ``(launch, (costs, u_seq, crash))``: each ``launch()`` runs the kernel
    once into those outputs on the current stream (uncounted; the wrapper
    counts)."""
    _check_kernel_model(model)
    if cost_params.obstacles is not None:
        raise NotImplementedError("obstacle terms are not ported yet "
                                  "(ROADMAP.md, Queue 1 item 3)")
    T, K, C = eps.shape
    dev = eps.device
    args = _kernel_inputs(model, model_params, state, U, eps)
    args["ch0"] = costmap.ch0
    ptrs = _device_args(dev, **args)
    floats, ints = launch_scalars(model, cfg, k_offset, T, K, cost_params,
                                  costmap, l1_cost)
    fsc = _host_array(ctypes.c_float, floats)
    isc = _host_array(ctypes.c_int, ints)

    costs = torch.empty(K, dtype=torch.float32, device=dev)
    crash = torch.empty(K, dtype=torch.int32, device=dev)
    u_seq = torch.empty((C, T, K), dtype=torch.float32, device=dev)
    lib = _kernel_lib()

    def launch():
        err = lib.artt_fused_exact_rollout_cost(
            ctypes.addressof(fsc), ctypes.addressof(isc), dev.index or 0,
            ptrs["s0"], ptrs["rngs"], ptrs["U"], ptrs["eps"], ptrs["ch0"],
            ptrs["weights"], costs.data_ptr(), crash.data_ptr(),
            u_seq.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
        _check_launch(err, "fused_exact_rollout_cost")

    launch.inputs = args                     # keeps the buffers alive
    return launch, (costs, u_seq, crash)


def fused_exact_rollout_cost(model, model_params, cfg, cost_params,
                             costmap: Costmap, state, U, eps,
                             l1_cost: bool = False, k_offset=0):
    """Fused rollout + exact-costmap cost (``fused_exact_rollout_cost_pallas``).

    ``state`` (S,), ``U`` (T, C), ``eps`` (T, K, C) standard normal;
    ``k_offset`` is the global index of this batch's first rollout.
    Returns (costs (K,), u_seq (C, T, K), crash (K,) int32)."""
    if _dispatch(eps) == "plain":
        return fused_exact_rollout_cost_plain(
            model, model_params, cfg, cost_params, costmap, state, U, eps,
            l1_cost=l1_cost, k_offset=k_offset)
    launch, out = prepare_fused_exact_rollout_cost(
        model, model_params, cfg, cost_params, costmap, state, U, eps,
        l1_cost=l1_cost, k_offset=k_offset)
    launch()
    fused_exact_rollout_cost.launches += 1
    return out


fused_exact_rollout_cost.launches = 0


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
    args = _kernel_inputs(model, model_params, state, U, eps)
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
    dynamics_chain.launches += 1
    return out


dynamics_chain.launches = 0


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
