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

The kernels evaluate either model of the JAX package's kernels: a
``NeuralNetDynamics`` or the 25-function ``BasisFunctionDynamics``
(``_bf_deriv``), each its own instance of every kernel.  The default
library is compiled for the 6-32-32-4 MLP (``KERNEL_LAYERS``); kernels
1-4 take an MLP of any other layer spec from a library built for that spec
at first use (``ops/_build.py``), as the JAX kernels compile per spec, and
pass 2, which evaluates no model, runs the default library's kernel for
every spec.  Kernel 3 and pass 1's field mode take a ``NeuralCostmap`` of
any spec that the JAX field kernels take (any F and hidden widths,
``field_spec``; float32 or bf16 weights, packed in float32): a field of
another spec than 34-64-64-1 (``FIELD_KERNEL_SPEC``) runs from a library
built for it beside the MLP's spec.  A field whose staged pack would leave
no room in a block's shared memory keeps the pack in device memory in its
library (``field_global``); a launch is refused only where neither layout
leaves room (``_check_field_room``).  Every kernel takes any horizon
(``_check_horizon``): past what a block's shared memory holds, a launch
stages no U and reads it in device memory (``staged_u``).  The fused
kernels (A, 3, pass 1)
price the circles of an ``ObstacleCost`` (``_make_obstacle_terms``), any
number of slots, when the caller passes ``obstacles`` (with
``obstacle_coeff`` and ``inflation``), as the JAX package's wrappers take
them: up to ``MAX_OBSTACLES`` staged in shared memory, more read in device
memory.

Kernel 1 launches in the geometry that :func:`exact_geometry` picks from
K and the card's SM count: lane groups of G lanes a rollout (the MLP at
small K) or one rollout a thread, with the same bits in both.  Kernel 2
launches in the geometry of :func:`chain_geometry`: one rollout a warp at
small K (the nominal trajectory's K = 1 always) or one rollout a thread,
again with the same bits.  Exact pass 1 runs one rollout a thread; its BF
instance (``fused_rng_bf_kernel``) takes the basis functions' quotients by
constants without the division's slow path (:func:`const_quotient_check`
holds them against IEEE division on the card) and draws the stream a step
ahead, with the bits of the MLP's design.

``matmul_precision`` reaches every kernel that evaluates the dynamics, as
the JAX kernels take ``precision``: each wrapper of kernels 1-4, its
``prepare_*`` and its plain version take it, ``cfg.matmul_precision``
when it is None (the default).  ``"highest"`` and ``"high"`` (which the JAX
kernels round up to HIGHEST) run the float32 instances; ``"default"``, the
MXU's one bf16 pass, runs instances of their own from libraries built with
bf16 operands (``_build.load(..., bf16=True)``): each product's operands
rounded to bf16, the products summed in float32 (:func:`kernel_dynamics`
is their plain form).  Kernel 3's MLP rounds only layer 0's state inputs
and their weights, as the JAX ``_fused_kernel`` splits layer 0; the biases
stay float32, and the nominal trajectory (kernel 2 at K = 1), pass 2 and
the neural field's own products are float32 at every precision.

Every kernel also has a lane form (:func:`fused_exact_rollout_cost_lanes`,
:func:`fused_rollout_cost_lanes`, :func:`dynamics_chain_lanes`,
:func:`nominal_trajectory_lanes`, :func:`fused_rng_costs_lanes`,
:func:`fused_rng_numer_lanes`, composed by
:func:`fused_rng_solve_iteration_lanes`): L sets of cost parameters (a
stacked ``CostParams``, ``config.cost_params_lanes``), start states, plans,
circles (a lane's own, or one set for every lane) and pass 2's weights in
one launch, the eps or the stream's key, the weights and the map or field
shared, as the JAX package's sweep vmaps ``pallas_call`` over its scalars;
lane l gives the bits of the solo kernel with lane l's inputs.  Each runs
from the library of its solo twin (any MLP spec, field spec and
precision; pass 2 from the default float32 library).

Each wrapper runs the plain version (``*_plain``) for tensors on the CPU,
launches the CUDA kernel for tensors on a GPU, and raises for anything
else; there is no fallback from one to the other.  Each counts its kernel
launches in :data:`LAUNCHES` by instance: the wrapper's name for the MLP
without obstacles, with ``_bf``, ``_obstacles`` or ``_bf_obstacles`` for
the others (``fused_rng_costs_field*`` for pass 1's field mode) and the
MLP's spec for another spec than ``KERNEL_LAYERS`` (e.g.
``fused_exact_rollout_cost_6-64-64-64-64-4``), then the field's label for
another field spec (``fused_rollout_cost_F6-48-48``), then ``_default``
for the bf16-operand instances, then ``_lanes`` for the lane forms.  Layouts
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

from autorally_tpu_torch.config import (bf16_operands, effective_gamma,
                                        lane_cost_params)
from autorally_tpu_torch.costs.costmap import Costmap
from autorally_tpu_torch.costs.mppi_cost import MPPICost
from autorally_tpu_torch.costs.neural_costmap import NeuralCostmap
from autorally_tpu_torch.costs.obstacles import obstacle_terms
from autorally_tpu_torch.models.basis_function import (NUM_BFS,
                                                       car_basis_functions)
from autorally_tpu_torch.ops import _build
from autorally_tpu_torch.ops.kernel_rng import kernel_noise
from autorally_tpu_torch.ops.sampling import ou_coefficients

# The MLP spec of the default library, which every kernel takes (csrc
# ARTT_MLP_HIDDEN's default); kernels 1 and 2 take other specs from
# libraries of their own.
KERNEL_LAYERS = _build.DEFAULT_LAYERS


def num_weights(layers) -> int:
    """Floats of an MLP's packed weights (``kernel_weights``)."""
    return sum(a * b + b for a, b in zip(layers[:-1], layers[1:]))


KERNEL_NUM_WEIGHTS = num_weights(KERNEL_LAYERS)
# The basis-function form's weights: theta^T (4, 25) (csrc kNumBfs).
KERNEL_BF_WEIGHTS = NUM_BFS * 4
# The field spec of the default library and of each MLP spec's library
# (csrc ARTT_FIELD_SPEC's default): F and the hidden widths, (8, 64, 64),
# fit_neural_costmap's default, 34-64-64-1.  A field of another spec takes
# a library of its own (``field_spec``; ``_build.load(layers, field)``).
FIELD_KERNEL_SPEC = _build.DEFAULT_FIELD


def field_layers(fspec) -> tuple:
    """A field spec's layer widths: 2 + 4F features, the hidden widths, one
    output."""
    return (2 + 4 * fspec[0],) + tuple(fspec[1:]) + (1,)


FIELD_KERNEL_LAYERS = field_layers(FIELD_KERNEL_SPEC)
FIELD_KERNEL_FREQS = FIELD_KERNEL_SPEC[0]


def field_num_weights(fspec) -> int:
    """Floats of a field's weights, biases and freqs (its function)."""
    layers = field_layers(fspec)
    return sum(a * b + b for a, b in zip(layers[:-1], layers[1:])) + fspec[0]


FIELD_NUM_WEIGHTS = field_num_weights(FIELD_KERNEL_SPEC)


def field_tile_k(fspec) -> int:
    """The first layer's tile columns (csrc FieldSpec::kK1): u, v, two
    zeros and four a frequency, rounded up to a k-step of 8."""
    return -(-(4 + 4 * fspec[0]) // 8) * 8


def field_tile_features(fspec) -> tuple:
    """A warp's tile's columns, the order the packed W0's rows follow:
    [u, v, 0, 0, then for each frequency sin uF, sin vF, cos uF, cos vF,
    then zeros up to ``field_tile_k``]; entries index the features of
    ``NeuralCostmap._features``, -1 a zero column."""
    F = fspec[0]
    cols = (0, 1, -1, -1) + tuple(
        i for n in range(F)
        for i in (2 + n, 2 + F + n, 2 + 2 * F + n, 2 + 3 * F + n))
    return cols + (-1,) * (field_tile_k(fspec) - len(cols))


def field_pack_layout(fspec) -> dict:
    """The packed field's layout (csrc FieldSpec, FieldLayout): ``ntiles``
    each hidden layer's n-tiles of 8 (its width padded); ``pack`` its
    floats: each hidden layer's B fragments (4 floats a lane,
    [k-step][n-tile][lane]; the first layer's k-steps over
    ``field_tile_k``, each next one's over the layer before's n-tiles),
    each hidden bias and the output weights padded to their n-tiles
    (without a hidden layer, the output weights in the tile's order), the
    output bias and freqs, padded to a float4."""
    hidden = tuple(fspec[1:])
    ntiles = tuple(-(-h // 8) for h in hidden)
    ksteps = (field_tile_k(fspec) // 8,) + ntiles[:-1]
    frags = sum(k * n * 32 * 4 for k, n in zip(ksteps, ntiles))
    tail = (8 * sum(ntiles) + (8 * ntiles[-1] if hidden
                               else field_tile_k(fspec)) + 1 + fspec[0])
    return dict(ntiles=ntiles, pack=-(-(frags + tail) // 4) * 4)


def field_pack_floats(fspec) -> int:
    """Floats of the packed field (csrc kFieldPack)."""
    return field_pack_layout(fspec)["pack"]


def field_tile_floats(fspec) -> int:
    """A field warp's tile (csrc kTileFloats): 64 rows at a stride of
    ``field_tile_k`` + 4 floats, and the 64 values."""
    return 64 * (field_tile_k(fspec) + 4) + 64


# The default field's tile and pack (the first layer padded 34 -> 40, 44
# floats a tile row; 13,516 floats).
FIELD_TILE_K = field_tile_k(FIELD_KERNEL_SPEC)
FIELD_TILE_FEATURES = field_tile_features(FIELD_KERNEL_SPEC)
FIELD_PACK_FLOATS = field_pack_floats(FIELD_KERNEL_SPEC)
# Rollouts per block of the field kernels (csrc kFieldBlock): the default
# library's, and a library of another MLP spec's (csrc kSpecFieldBlock;
# ``field_block``).
FIELD_BLOCK = 128
SPEC_FIELD_BLOCK = 256
# Circles the fused kernels stage in shared memory (csrc kMaxObstacles); a
# launch with more stages none and reads them all in device memory
# (``staged_obstacles``).
MAX_OBSTACLES = 64
# Dynamic shared memory holds the weights, U (T x 2) and up to
# MAX_OBSTACLES circles; the other kernels stay under the 48 KB a launch
# gets without opting in (34,048 bytes at T = 4096) for the default spec,
# the field kernels, which add the field and their tiles, opt in to what T
# = 2048 needs (csrc kMaxFieldT; 122,944 bytes for the MLP with 64
# circles), and kernel 2's warp form, which adds its rollouts' eps, to what
# T = 4096 needs (csrc kMaxT; 170,048 bytes for the MLP).  A wide spec's
# kernels 1, 2 and exact pass 1 opt in too.  These are the horizons up to
# which a launch stages U (and kernel 2's warp form its eps): 4096, or what
# a wide spec's weights leave room for (``max_kernel_t``), and for the field
# kernels 2048, or what the weights and the field leave room for
# (``max_field_kernel_t``).  A launch past them stages none and reads them
# in device memory, with the same bits (``staged_u``); the kernels take any
# T with T x K x C below ``INDEX_LIMIT`` (``_check_horizon``).
MAX_KERNEL_T = 4096
MAX_FIELD_KERNEL_T = 2048
# The kernels take T and K as int32: a launch's T x K x C stays below 2^31.
INDEX_LIMIT = 2 ** 31
# A block's shared memory (232,448 bytes) in floats, and the default field
# warp's tile (csrc kTileFloats: 64 rows of 44 floats and the 64 values).
SMEM_FLOATS = 232448 // 4
FIELD_TILE_FLOATS = field_tile_floats(FIELD_KERNEL_SPEC)
# The floats a lane form's staged CostScalars (static shared memory) take
# from a field block's room (csrc kLaneScalarFloats).
LANE_SCALAR_FLOATS = 64
# The horizon (the reference's T) at which a lane form of the field kernels
# must find room for U beside the staged field, or the library keeps the
# packed field in device memory (csrc kFieldGlobalT; ``field_global``).
FIELD_GLOBAL_T = 100

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
# The block of kernel 1 and exact pass 1 in one rollout a thread (csrc
# kBlock), and of kernel 1 in lane groups (csrc kGroupBlock).
EXACT_BLOCK = 64
GROUP_BLOCK = 128
# The lane groups kernel 1 is built for, and every (G, block) it takes for
# the default spec (csrc geometry_ok; the BF model and exact pass 1 the
# first only; another spec ``geometries(layers)``).
LANE_GROUPS = (8, 16, 32)
GEOMETRIES = ((1, EXACT_BLOCK),) + tuple((G, GROUP_BLOCK)
                                         for G in LANE_GROUPS)
# A lane-group kernel's resident warps an SM at its launch bounds (128
# threads, 4 blocks), and the warps an SM it aims for: about one for each
# of an SM's four schedulers, where each warp's dependent chain sets the
# time and more lanes a rollout only add redundant work.
GROUP_WARPS_PER_SM = 16
GROUP_TARGET_WARPS_PER_SM = 3
# Up to how many of the smallest group's waves lane groups beat one rollout
# a thread, by MLP spec (``chip_smoke.py`` phase 28's sweep, PERF.md): one
# for 6-32-32-4; for 6-64-64-64-64-4, whose one rollout a thread runs four
# blocks an SM and takes about 6.3 ms at any K up to a wave, 3.5 (the
# 8-lane groups 3.58 against 6.38 ms at K=16896, 7.08 against 6.65 at
# 33792).  A spec not listed takes the default spec's.
GROUP_WAVES = {(6, 32, 32, 4): 1.0, (6, 64, 64, 64, 64, 4): 3.5}
# Kernel 2's geometries (csrc chain_geometry_ok): one rollout a thread in
# blocks of EXACT_BLOCK, or one rollout a warp in blocks of CHAIN_WARP_BLOCK
# (csrc kChainWarpBlock; an MLP whose hidden widths are multiples of 32,
# ``chain_geometries``); and, for each model, the most rollouts an SM for
# which the launcher takes the warp form (``chain_geometry``).
CHAIN_WARP_BLOCK = 128
CHAIN_GEOMETRIES = ((1, EXACT_BLOCK), (32, CHAIN_WARP_BLOCK))
CHAIN_WARP_ROLLOUTS_PER_SM = {False: 32, True: 20}
# the MLP's by spec where measured (phase 28's sweep): the 6-64-64-64-64-4
# warp form 5.24 against 6.29 ms at 128 rollouts an SM, 10.53 against 6.48
# at 256; a spec not listed takes 6-32-32-4's
CHAIN_WARP_ROLLOUTS_PER_SM_MLP = {(6, 64, 64, 64, 64, 4): 128}
# The outputs a rollout of kernel 2 stores a step: 7 states, 2 controls.
CHAIN_OUTPUTS = 9


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
            int(_is_bf(model))]
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


def lane_groups(layers=KERNEL_LAYERS) -> tuple:
    """The lane groups of ``LANE_GROUPS`` that kernel 1 takes for the MLP
    spec ``layers``: those that divide every hidden width (csrc
    ``groups_fit``), so that a group owns whole units."""
    hidden = tuple(layers[1:-1])
    return tuple(G for G in LANE_GROUPS
                 if hidden and all(h % G == 0 for h in hidden))


def geometries(layers=KERNEL_LAYERS) -> tuple:
    """Every (G, block) of kernel 1 for the MLP spec ``layers``."""
    return ((1, EXACT_BLOCK),) + tuple((G, GROUP_BLOCK)
                                       for G in lane_groups(layers))


def chain_geometries(layers=KERNEL_LAYERS, bf: bool = False) -> tuple:
    """Every (G, block) of kernel 2 for the model: one rollout a warp for
    the BF model and an MLP whose hidden widths are multiples of 32."""
    if bf or 32 in lane_groups(layers):
        return CHAIN_GEOMETRIES
    return CHAIN_GEOMETRIES[:1]


def kernel_layers(model) -> tuple:
    """The MLP spec of the library that runs ``model``'s kernels 1 and 2:
    its own layers (``KERNEL_LAYERS`` for the BF model)."""
    return KERNEL_LAYERS if _is_bf(model) else tuple(model.layers)


def _read_ints(fn) -> tuple:
    """The ints a library query writes (``artt_mlp_layers``,
    ``artt_field_spec``: called once for the count, once to fill)."""
    out = (ctypes.c_int * fn(None))()
    fn(out)
    return tuple(out)


@functools.cache
def _kernel_lib(layers: tuple = KERNEL_LAYERS,
                field: Optional[tuple] = None,
                bf16: bool = False) -> ctypes.CDLL:
    """The kernel library of the MLP spec ``layers`` (the default one for
    ``KERNEL_LAYERS``), or with a field spec ``field`` (not
    ``FIELD_KERNEL_SPEC``) the library of that pair, which holds only the
    field kernels; of bf16 operands when ``bf16``; checked once against
    the layouts this module packs."""
    fspec = FIELD_KERNEL_SPEC if field is None else field
    kw = {"bf16": True} if bf16 else {}
    lib = (_build.load(layers, **kw) if field is None
           else _build.load(layers, field, **kw))
    built = (_read_ints(lib.artt_mlp_layers), _read_ints(lib.artt_field_spec),
             lib.artt_num_float_scalars(), lib.artt_num_int_scalars(),
             lib.artt_num_weights(), lib.artt_max_obstacles(),
             lib.artt_field_pack_floats(), lib.artt_field_block(),
             lib.artt_max_field_t(), lib.artt_max_field_lanes_t(),
             lib.artt_field_global(), lib.artt_bf16_operands())
    want = (tuple(layers), tuple(fspec), len(_FLOAT_SCALARS),
            len(_INT_SCALARS), num_weights(layers), MAX_OBSTACLES,
            field_pack_floats(fspec), field_block(layers),
            max_field_kernel_t(layers, fspec),
            max_field_kernel_t(layers, fspec, lanes=True),
            int(field_global(layers, fspec)), int(bf16))
    if field is None:
        groups = lib.artt_lane_groups()
        built += (tuple(G for i, G in enumerate(LANE_GROUPS)
                        if groups >> i & 1), lib.artt_exact_block(),
                  lib.artt_group_block(), lib.artt_chain_warp_block())
        want += (lane_groups(layers), EXACT_BLOCK, GROUP_BLOCK,
                 CHAIN_WARP_BLOCK)
    if layers == KERNEL_LAYERS and field is None:
        built += (lib.artt_num_bf_weights(), lib.artt_max_t())
        want += (KERNEL_BF_WEIGHTS, MAX_KERNEL_T)
        if not bf16:                       # pass 2: the float32 library's
            built += (lib.artt_update_block(),)
            want += (UPDATE_BLOCK,)
    if built != want:
        raise RuntimeError(f"kernel library layout {built} does not match "
                           f"the wrapper's {want}")
    if field is None and lib.artt_max_t() < 1:
        raise NotImplementedError(
            f"the weights of layers {layers} ({num_weights(layers)} floats) "
            "do not fit in a block's shared memory beside U")
    return lib


def _spec_lib(layers, bf16: bool = False) -> ctypes.CDLL:
    """The library of the MLP spec ``layers`` (``_kernel_lib()`` for the
    default spec), of bf16 operands when ``bf16``."""
    layers = tuple(layers)
    if layers == KERNEL_LAYERS and not bf16:
        return _kernel_lib()
    return _kernel_lib(layers, None, bf16)


def _field_lib(layers, fspec, bf16: bool = False) -> ctypes.CDLL:
    """The library that runs the field kernels of the MLP spec ``layers``
    on a field of spec ``fspec``: the MLP spec's own for the default field
    (``_spec_lib``), else the pair's field library; of bf16 operands when
    ``bf16``."""
    fspec = tuple(fspec)
    if fspec == FIELD_KERNEL_SPEC:
        return _spec_lib(layers, bf16)
    return _kernel_lib(tuple(layers), fspec, bf16)


def max_kernel_t(layers=KERNEL_LAYERS, bf16: bool = False) -> int:
    """The longest horizon at which kernels 1, 2, exact pass 1 and pass 2
    stage U in shared memory for the MLP spec ``layers`` (csrc kMaxT:
    ``MAX_KERNEL_T`` for the default spec), asked of the library of bf16
    operands when ``bf16`` (the same horizon).  A longer launch reads U
    (and kernel 2's warp form its eps) in device memory."""
    if tuple(layers) == KERNEL_LAYERS:
        return MAX_KERNEL_T
    return _spec_lib(layers, bf16).artt_max_t()


def field_block(layers=KERNEL_LAYERS) -> int:
    """Rollouts per block of the field kernels of the MLP spec ``layers``'s
    library (csrc kFieldBlock): 4 warps, two blocks an SM, in the default
    library; 8 warps, one block an SM, in a library of another spec, whose
    wide weights leave room for one block beside the field and the tiles."""
    return FIELD_BLOCK if tuple(layers) == KERNEL_LAYERS else SPEC_FIELD_BLOCK


def staged_u(T: int, cap: int) -> int:
    """The steps of U a launch at ``T`` stages in shared memory when ``cap``
    is its staged layout's longest horizon (csrc staged_u): all of them up
    to ``cap``, else none (U read in device memory)."""
    return T if T <= cap else 0


def staged_obstacles(n_obs: int) -> int:
    """The circles a launch with ``n_obs`` slots stages in shared memory
    (csrc staged_obstacles): all of them up to ``MAX_OBSTACLES``, else none
    (every circle read in device memory)."""
    return n_obs if n_obs <= MAX_OBSTACLES else 0


def _field_room_t(layers, field, pack: int, lanes: bool) -> int:
    """The field kernels' room for U in steps (csrc field_room_t): what
    the weights, ``pack`` floats of the packed field, the tiles,
    ``MAX_OBSTACLES`` circles and a lane form's staged scalars (with
    ``lanes``) leave of a block's shared memory."""
    f = -(-num_weights(layers) // 4) * 4
    tiles = field_block(layers) // 32 * field_tile_floats(field)
    return (SMEM_FLOATS - f - pack - tiles - 3 * MAX_OBSTACLES
            - (LANE_SCALAR_FLOATS if lanes else 0)) // 2


def field_global(layers=KERNEL_LAYERS, field=FIELD_KERNEL_SPEC) -> bool:
    """Whether the library of the MLP spec ``layers`` and the field spec
    ``field`` keeps the packed field in device memory (csrc kFieldGlobal):
    where staging it leaves a lane form no room for U at
    ``FIELD_GLOBAL_T`` steps (34-128-128-1 beside 6-64-64-64-64-4 or
    6-24-4).  Otherwise the field is staged in each block's shared
    memory."""
    return _field_room_t(layers, field, field_pack_floats(field),
                         True) < FIELD_GLOBAL_T


def field_smem_layout(layers=KERNEL_LAYERS, T: int = 0, n_obs: int = 0,
                      field=FIELD_KERNEL_SPEC, lanes: bool = False) -> dict:
    """The MLP field kernels' dynamic shared memory (csrc FieldSmem) on a
    field of spec ``field``, in floats from its start: the packed weights
    first (``num_weights`` floats), the packed field at ``f`` (the weights
    rounded up to a float4, so that the field is read as float4; no floats
    where ``layout`` is "global": the field stays in device memory,
    ``field_global``), the warps' tiles at ``tiles``, U at ``U`` (2 T
    floats where ``u_layout`` is "staged"; none where it is "global", past
    ``max_field_kernel_t``, the lane forms' with ``lanes``: U stays in
    device memory), the staged circles (3 ``staged_obstacles(n_obs)``) at
    ``obs``; ``bytes`` in all for a launch at ``T`` with ``n_obs``
    slots."""
    glob = field_global(layers, field)
    f = -(-num_weights(layers) // 4) * 4
    tiles = f + (0 if glob else field_pack_floats(field))
    U = tiles + field_block(layers) // 32 * field_tile_floats(field)
    Tu = staged_u(T, max_field_kernel_t(layers, field, lanes))
    obs = U + 2 * Tu
    return dict(layout="global" if glob else "staged",
                u_layout="staged" if Tu == T else "global", f=f,
                tiles=tiles, U=U, obs=obs,
                bytes=4 * (obs + 3 * staged_obstacles(n_obs)))


def max_field_kernel_t(layers=KERNEL_LAYERS, field=FIELD_KERNEL_SPEC,
                       lanes: bool = False) -> int:
    """The longest horizon at which the field kernels stage U for the MLP
    spec ``layers`` on a field of spec ``field`` (csrc kLibMaxFieldT; their
    lane forms' with ``lanes``, kLibMaxFieldLanesT): ``MAX_FIELD_KERNEL_T``,
    or what the weights and the field as the library's layout stages it
    (``field_smem_layout``) leave room for beside the tiles and
    ``MAX_OBSTACLES`` circles in a block's shared memory, less the lane
    forms' staged scalars (``LANE_SCALAR_FLOATS``) for ``lanes`` (0: no
    room).  A longer launch reads U in device memory."""
    pack = (0 if field_global(layers, field) else field_pack_floats(field))
    room = _field_room_t(layers, field, pack, lanes)
    return max(0, min(MAX_FIELD_KERNEL_T, room))


def _check_field_room(layers, fspec, lanes: bool = False) -> None:
    """Raise, before any build, where the library of the MLP spec
    ``layers`` and the field spec ``fspec`` has no room in a block's shared
    memory even with U in device memory: the weights, the field as its
    layout stages it (``field_smem_layout``), the tiles and
    ``MAX_OBSTACLES`` circles (with a lane form's staged scalars when
    ``lanes``) leave nothing (6-128-128-128-128-4 beside the default
    field; ROADMAP.md, Queue 2 A9)."""
    pack = (0 if field_global(layers, fspec) else field_pack_floats(fspec))
    if _field_room_t(layers, fspec, pack, lanes) < 0:
        lay = field_smem_layout(layers, 0, MAX_OBSTACLES, fspec, lanes)
        raise NotImplementedError(
            f"the field kernels of layers {tuple(layers)} on a field "
            f"{_build.field_label(fspec)} ({field_pack_floats(fspec) * 4} "
            f"bytes packed, the {lay['layout']} layout) need "
            f"{lay['bytes']} bytes of shared memory a block with U in "
            f"device memory and {MAX_OBSTACLES} circle slots, over the "
            f"{SMEM_FLOATS * 4} a block can take (ROADMAP.md, Queue 2 A9: "
            "an MLP that leaves the field kernels no room)")


def _check_horizon(T: int, K: int, C: int = 2) -> None:
    """Raise unless a launch of ``T`` steps and ``K`` rollouts (a lane's)
    has T, K >= 1 and T x K x C below ``INDEX_LIMIT``: the kernels take
    every such horizon, U staged or in device memory."""
    if K < 1 or T < 1:
        raise ValueError(f"kernel needs K >= 1 and T >= 1, got K={K}, "
                         f"T={T}")
    if T * K * C >= INDEX_LIMIT:
        raise ValueError(f"T={T} x K={K} x C={C} = {T * K * C} elements: "
                         "the kernels take T and K as int32 and need T x K "
                         f"x C < 2^31 ({INDEX_LIMIT})")


def field_kernel_info(rng: bool, bf: bool, T: int, n_obs: int = 0,
                      device: int = 0, layers=KERNEL_LAYERS,
                      field=FIELD_KERNEL_SPEC,
                      precision: str = "highest") -> dict:
    """What the CUDA runtime reports of a field kernel instance (pass 1's
    field mode when ``rng``, else kernel 3; the BF model when ``bf``) of
    the library of the MLP spec ``layers``, the field spec ``field`` and
    ``precision``, for a launch at ``T`` with ``n_obs`` circle slots:
    registers and local-memory bytes a thread, dynamic shared memory
    bytes, resident blocks an SM."""
    out = (ctypes.c_int * 4)()
    _check_launch(_field_lib(layers, field, bf16_operands(precision)
                             ).artt_field_kernel_info(
        int(rng), int(bf), T, n_obs, device, out), "field_kernel_info")
    return dict(zip(("registers", "local_bytes", "smem_bytes",
                     "blocks_per_sm"), out))


class ExactGeometry(NamedTuple):
    """A launch of kernel 1 or exact pass 1: ``group`` lanes share one
    rollout (G; 1: one rollout a thread), ``block`` threads a block,
    ``grid`` blocks."""

    group: int
    block: int
    grid: int


def exact_geometry(K: int, num_sms: int, bf: bool = False,
                   layers=KERNEL_LAYERS) -> ExactGeometry:
    """The geometry of kernel 1 for K rollouts on a card of ``num_sms``
    SMs.  The MLP takes lane groups (those of its spec, ``lane_groups``)
    while the smallest group's K G / 32 warps fit in one wave of the group
    kernel: the smallest G that gives every SM
    ``GROUP_TARGET_WARPS_PER_SM`` warps, or the largest.  Beyond that, for
    the BF model and for a spec that takes no group, one rollout a thread;
    a spec whose one rollout a thread is slower keeps the groups for more
    waves (``GROUP_WAVES``).  (The lane groups' times against K:
    ``tools/exact_variants.py``, ``chip_smoke.py`` phase 28.)"""
    groups = () if bf else lane_groups(layers)
    waves = GROUP_WAVES.get(tuple(layers), GROUP_WAVES[KERNEL_LAYERS])
    if (groups and K * groups[0]
            <= 32 * GROUP_WARPS_PER_SM * num_sms * waves):
        for G in groups:
            if K * G >= 32 * GROUP_TARGET_WARPS_PER_SM * num_sms:
                break
        return _geometry(K, G, GROUP_BLOCK)
    return _geometry(K, 1, EXACT_BLOCK)


def _geometry(K: int, group: int, block: int) -> ExactGeometry:
    return ExactGeometry(group, block, -(-K // (block // group)))


def exact_rollout_slots(geom: ExactGeometry, K: int, k_offset: int = 0):
    """What each thread of a launch of ``geom`` over K rollouts runs, as the
    kernels compute it (csrc ``group_slot`` and the one-rollout kernels):
    ``(k, store)``, arrays (grid, block) of the global rollout index
    (``k_offset`` + local; -1 where the thread has left) and whether the
    thread stores that rollout's results.  A rollout past K runs rollout
    K - 1 and stores nothing."""
    G, B = geom.group, geom.block
    b = np.arange(geom.grid)[:, None]
    i = np.arange(B)[None, :]
    k = b * (B // G) + i // G
    if G > 1:
        # a lane group leaves only with its whole warp
        leave = b * (B // G) + (i & ~31) // G >= K
        store = (k < K) & (i % G == 0)
    else:
        leave = k >= K
        store = k < K
    k = np.where(leave, -1, np.minimum(k, K - 1) + int(k_offset))
    return k, store & ~leave


def _launch_geometry(K: int, dev, model) -> ExactGeometry:
    """The geometry a launch of kernel 1 takes on ``dev``
    (``exact_geometry``, looked up in this module at call time)."""
    return exact_geometry(K, num_sms(dev.index or 0), bf=_is_bf(model),
                          layers=kernel_layers(model))


def chain_geometry(K: int, num_sms: int, bf: bool = False,
                   layers=KERNEL_LAYERS) -> ExactGeometry:
    """The geometry of kernel 2 for K rollouts on a card of ``num_sms``
    SMs: one rollout a warp (G = 32, where the model takes it,
    ``chain_geometries``) while K is at most
    ``CHAIN_WARP_ROLLOUTS_PER_SM[bf]`` rollouts an SM (an MLP spec's own in
    ``CHAIN_WARP_ROLLOUTS_PER_SM_MLP``), the nominal
    trajectory's K = 1 always; beyond that one rollout a thread.  (The two
    forms' times against K: ``tools/exact_variants.py``.)"""
    geoms = chain_geometries(layers, bf)
    per_sm = (CHAIN_WARP_ROLLOUTS_PER_SM[True] if bf else
              CHAIN_WARP_ROLLOUTS_PER_SM_MLP.get(
                  tuple(layers), CHAIN_WARP_ROLLOUTS_PER_SM[False]))
    if len(geoms) > 1 and K <= per_sm * num_sms:
        return _geometry(K, *geoms[1])
    return _geometry(K, *geoms[0])


def chain_store_slots(geom: ExactGeometry, K: int, k_offset: int = 0):
    """What each thread of a launch of kernel 2 in ``geom`` over K rollouts
    stores, as the kernels compute it: ``(k, stores)``, ``k`` as
    :func:`exact_rollout_slots` gives it and ``stores`` a bool array (grid,
    block, ``CHAIN_OUTPUTS``) of the outputs of rollout k that the thread
    writes every step (states 0..6, then u_seq rows 0 and 1): all of them
    in one rollout a thread, output l on lane l in one rollout a warp."""
    k, first = exact_rollout_slots(geom, K, k_offset)
    out = np.arange(CHAIN_OUTPUTS)
    if geom.group == 1:
        return k, np.broadcast_to(first[..., None], first.shape + out.shape)
    lane = np.arange(geom.block)[None, :, None] % 32
    # the warp's own rollout, past K for the dummy rollouts
    local = (np.arange(geom.grid)[:, None] * (geom.block // geom.group)
             + np.arange(geom.block)[None, :] // geom.group)
    valid = (k >= 0) & (local < K)
    return k, valid[..., None] & (lane == out)


def _chain_launch_geometry(K: int, dev, model) -> ExactGeometry:
    """The geometry a launch of kernel 2 takes on ``dev``
    (``chain_geometry``, looked up in this module at call time)."""
    return chain_geometry(K, num_sms(dev.index or 0), bf=_is_bf(model),
                          layers=kernel_layers(model))


@functools.cache
def num_sms(index: int) -> int:
    """The SM count of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def exact_kernel_info(rng: bool, bf: bool, geom: ExactGeometry, T: int,
                      n_obs: int = 0, device: int = 0,
                      layers=KERNEL_LAYERS, precision: str = "highest") -> dict:
    """What the CUDA runtime reports of the instance of kernel 1 (pass 1
    when ``rng``) that ``geom`` launches for the MLP spec ``layers`` at
    ``precision``, for a launch at ``T`` with ``n_obs`` circle slots:
    registers and local-memory bytes a thread, dynamic shared memory bytes,
    resident blocks an SM, and the launch's waves (its blocks over one
    wave's)."""
    out = (ctypes.c_int * 4)()
    _check_launch(_spec_lib(layers, bf16_operands(precision)
                            ).artt_exact_kernel_info(
        int(rng), int(bf), geom.group, geom.block, T, n_obs, device, out),
        "exact_kernel_info")
    return _info(out, geom, device)


def chain_kernel_info(bf: bool, geom: ExactGeometry, T: int,
                      device: int = 0, layers=KERNEL_LAYERS,
                      precision: str = "highest") -> dict:
    """:func:`exact_kernel_info` of the instance of kernel 2 that ``geom``
    launches."""
    out = (ctypes.c_int * 4)()
    _check_launch(_spec_lib(layers, bf16_operands(precision)
                            ).artt_chain_kernel_info(
        int(bf), geom.group, geom.block, T, device, out),
        "chain_kernel_info")
    return _info(out, geom, device)


def _info(out, geom: ExactGeometry, device: int) -> dict:
    info = dict(zip(("registers", "local_bytes", "smem_bytes",
                     "blocks_per_sm"), out))
    info["waves"] = geom.grid / max(1, info["blocks_per_sm"] * num_sms(device))
    return info


def const_quotient_check(device: int = 0) -> dict:
    """The exhaustive check, on the card, of BF exact pass 1's branch-free
    arithmetic: {divisor: the count of the 2^32 float32 bit patterns x
    whose quotient (csrc ``div_const`` with its guard) differs from IEEE
    ``x / d``, a NaN equal to any NaN}, and under "stream_div" and
    "stream_sqrt" the counts of the stream's 2^23 uniforms u1 whose
    quotient in log u1 or root of -2 log u1 differs from the IEEE one."""
    lib = _kernel_lib()
    n = lib.artt_const_divisors(None)
    divisors = (ctypes.c_longlong * n)()
    lib.artt_const_divisors(divisors)
    dev = torch.device("cuda", device)
    counts = torch.zeros(n + 2, dtype=torch.int64, device=dev)
    _check_launch(lib.artt_div_const_check(
        device, counts.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream), "const_quotient_check")
    return dict(zip([*divisors, "stream_div", "stream_sqrt"],
                    counts.tolist()))


def _is_bf(model) -> bool:
    return model.KERNEL_KIND == "bf"


def kernel_form_applies(model, cfg=None) -> bool:
    """Whether the kernels evaluate ``model`` (the solver's choice, as the
    JAX package's ``_decide_pallas`` makes it): its ``KERNEL_KIND`` is set,
    and the class that declared it owns every method the kernels replace
    (``solver.mppi._kernel_form_consistent``), unless
    ``cfg.use_pallas_rollout`` is True, which forces the kernel form: the
    kernels then evaluate the declaring class's math."""
    from autorally_tpu_torch.solver.mppi import _kernel_form_consistent

    if model.KERNEL_KIND is None:
        return False
    forced = cfg is not None and cfg.use_pallas_rollout is True
    return forced or _kernel_form_consistent(model)


def has_kernel_form(model, cfg=None, kernel: int = 1) -> bool:
    """Whether CUDA kernel ``kernel`` (1-4, the TPU kernels' numbers in
    ROADMAP.md Queue 2: kernel A, the chain, the field kernel, pass 1) can
    evaluate ``model``'s dynamics: its kernel form applies
    (:func:`kernel_form_applies`); every kernel takes the BF model and an
    MLP of any layer spec (from a library built for the spec)."""
    return kernel_form_applies(model, cfg)


def _check_kernel_model(model, cfg=None, kernel: int = 1) -> None:
    """Raise unless CUDA kernel ``kernel`` can evaluate ``model``
    (:func:`has_kernel_form`), before any build or launch."""
    if not has_kernel_form(model, cfg, kernel):
        raise NotImplementedError(
            f"{type(model).__name__} has no CUDA kernel form: the kernels "
            "evaluate a model whose KERNEL_KIND is set and whose declaring "
            "class owns every method they replace (the MPPI solver runs its "
            "plain chain for any other; cfg.use_pallas_rollout=True forces "
            "the declaring class's form; ROADMAP.md)")


def field_spec(field: NeuralCostmap) -> tuple:
    """A field's spec, F and its hidden widths (``(8, 64, 64)`` for
    34-64-64-1): the library its kernels take.  Its layers must be the
    Fourier features of its F frequencies, ReLU layers of any width and one
    output, as ``_make_field_eval`` evaluates them."""
    F = field.freqs.numel()
    layers = field.layers
    if layers[0] != 2 + 4 * F or layers[-1] != 1:
        raise ValueError(f"a field of {F} frequencies takes {2 + 4 * F} "
                         f"features and gives one value, got layers "
                         f"{layers}")
    return (F,) + tuple(layers[1:-1])


def _surface(surface) -> Tuple[str, torch.Tensor, Optional[tuple]]:
    """The fused kernels' surface operand: ('exact', channel 0, None) for a
    ``Costmap``, ('field', the packed field, its spec) for a
    ``NeuralCostmap``."""
    if type(surface) is Costmap:
        return "exact", surface.ch0, None
    if type(surface) is NeuralCostmap:
        return "field", _pack_field(surface), field_spec(surface)
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
    return _cached_pack(model, _weight_tensors(model, model_params),
                        lambda: _flat_weights(model, model_params))


def _weight_tensors(model, model_params) -> tuple:
    """The tensors of ``model_params`` that the weight buffer packs."""
    return ((model_params["theta"],) if _is_bf(model)
            else (*model_params["weights"], *model_params["biases"]))


def _flat_weights(model, model_params) -> torch.Tensor:
    return torch.cat([w.reshape(-1) for w in
                      model.kernel_weights(model_params)])


def pack_members(model, stacked_params, owner) -> torch.Tensor:
    """The weight buffers of M members, (M, 1,412) for the MLP ((M, 100)
    for the BF model), from stacked params (leading axis M on every
    tensor; ``models/ensemble.py``), packed once per set of stacked tensors
    and kept on ``owner``: member m's launches take row m
    (``packed_weights=``), so that M launches share one pack."""
    from autorally_tpu_torch.models.ensemble import member_params

    src = _weight_tensors(model, stacked_params)
    M = src[0].shape[0]
    return _cached_pack(owner, src, lambda: torch.stack(
        [_flat_weights(model, member_params(stacked_params, m))
         for m in range(M)]))


def pack_member(model, stacked_params, m: int, owner) -> torch.Tensor:
    """Member m's weight buffer alone (1,412 floats for the MLP, 100 for the
    BF model), from stacked params, packed once per set of stacked tensors
    and kept on ``owner``: a rank that evaluates one member
    (``parallel/ensemble_sharded.py``) packs only its own."""
    from autorally_tpu_torch.models.ensemble import member_params

    return _cached_pack(owner, _weight_tensors(model, stacked_params),
                        lambda: _flat_weights(
                            model, member_params(stacked_params, m)))


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
    """(n_obs, packed) for a fused kernel: the circles (N, 3), or a lane
    launch's (L, N, 3), as [x..., y..., radius...] (3 N,) float32 a lane
    on ``dev``, copied anew for every launch so that a live update is never
    served from a stale copy (the kernels stage up to ``MAX_OBSTACLES`` of
    a lane's in shared memory and read more from this copy); (0, None)
    without obstacle terms."""
    if circles is None:
        return 0, None
    n = circles.shape[-2]
    packed = torch.empty((*circles.shape[:-2], 3, n), dtype=torch.float32,
                         device=dev)
    packed.copy_(circles.transpose(-1, -2))
    return n, packed.reshape(-1)


# Kernel launches by instance name (the wrapper's name, ``_field`` for pass
# 1's field mode, then ``_form``'s suffix), counted where a wrapper launches;
# kernels 1, 2 and 3 also by (instance name, K) in LAUNCHES_BY_K.
LAUNCHES = collections.Counter()
LAUNCHES_BY_K = collections.Counter()


def _launch_counted(launch, K: int) -> None:
    """Run a prepared launch of kernel 1, 2 or 3 over K rollouts and count
    it."""
    launch()
    LAUNCHES[launch.name] += 1
    LAUNCHES_BY_K[launch.name, K] += 1


def _form(model, n_obs: int, fspec=None, bf16: bool = False) -> str:
    """The suffix of a kernel instance's name: ``_bf`` for the BF model,
    the spec (``_6-64-64-64-64-4``) for an MLP of another spec than
    ``KERNEL_LAYERS``, the field's label (``_F6-48-48``) for a field of
    another spec than ``FIELD_KERNEL_SPEC``, ``_obstacles`` with circle
    slots, ``_default`` for the bf16-operand instances
    (``matmul_precision="default"``)."""
    layers = kernel_layers(model)
    spec = ("" if layers == KERNEL_LAYERS
            else "_" + "-".join(str(n) for n in layers))
    field = ("" if fspec is None or tuple(fspec) == FIELD_KERNEL_SPEC
             else "_" + _build.field_label(fspec))
    return (("_bf" if _is_bf(model) else "") + spec + field
            + ("_obstacles" if n_obs else "") + ("_default" if bf16 else ""))


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32 (10 mantissa bits), to nearest with
    ties away from zero, as ``cvt.rna.tf32.f32``: on the float32 bits,
    add half of the 13 dropped bits' unit to the magnitude and clear them."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_split(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) = (tf32(x), tf32(x - hi)): the kernels' 3xTF32 operands."""
    hi = tf32_round(x)
    return hi, tf32_round(x - hi)


def _b_fragments(W: torch.Tensor, permuted: bool) -> torch.Tensor:
    """One layer's m16n8k8 B fragments, W (in, out) with ``in`` a multiple
    of 8, in the kernel's order [k-step][n-tile][lane] x {b0 hi, b1 hi,
    b0 lo, b1 lo}: b0 = W[8 ks + t][8 nt + g], b1 = W[8 ks + t + 4][8 nt +
    g] (g = lane // 4, t = lane % 4); ``permuted`` (layer 2) permutes the
    input index within each group of 8, b0 = W[8 ks + 2t], b1 = W[8 ks +
    2t + 1], so that layer 1's accumulator columns 2t, 2t + 1 are the A
    fragment's columns t, t + 4."""
    dev = W.device
    ks = torch.arange(W.shape[0] // 8, device=dev)[:, None, None]
    nt = torch.arange(W.shape[1] // 8, device=dev)[None, :, None]
    lane = torch.arange(32, device=dev)
    g, t = lane // 4, lane % 4
    r0 = 8 * ks + (2 * t if permuted else t)
    r1 = r0 + (1 if permuted else 4)
    col = 8 * nt + g
    (h0, l0), (h1, l1) = tf32_split(W[r0, col]), tf32_split(W[r1, col])
    return torch.stack([h0, h1, l0, l1], dim=-1).reshape(-1)


def _pack_field(field: NeuralCostmap) -> torch.Tensor:
    """The field kernels' buffer (``field_pack_layout``; 13,516 floats for
    34-64-64-1, F = 8), from the weights in float32 (bf16 weights upcast,
    as the JAX kernels' wrappers upcast them): the first hidden layer's B
    fragments from W0 with its rows in the tile's feature order
    (``field_tile_features``), zero-padded to ``field_tile_k``; each next
    one's from its W with the input index permuted; each hidden width
    zero-padded to its n-tiles; all split into TF32 hi and lo; then the
    hidden biases and the output weights (each padded to its n-tiles), the
    output bias and freqs in float32, zero-padded to a whole float4.
    Without a hidden layer, the output weights in the tile's order.  Packed
    once per field."""
    fspec = field_spec(field)
    lay = field_pack_layout(fspec)

    def pad(t, n):
        return torch.cat([t, t.new_zeros(n - t.shape[0], *t.shape[1:])])

    def pack():
        W = [w.to(torch.float32) for w in field.weights]
        b = [v.to(torch.float32) for v in field.biases]
        dev = W[0].device
        order = torch.tensor(field_tile_features(fspec), device=dev)
        W0p = torch.where((order >= 0)[:, None], W[0][order.clamp(min=0)],
                          torch.zeros((), device=dev))
        widths = [8 * n for n in lay["ntiles"]]
        parts = []
        for i, n in enumerate(widths):         # (in, out), both padded
            w = W0p if i == 0 else pad(W[i], widths[i - 1])
            parts.append(_b_fragments(pad(w.T, n).T, i > 0))
        parts += [pad(b[i], n) for i, n in enumerate(widths)]
        parts += [pad(W[-1].reshape(-1), widths[-1]) if widths
                  else W0p.reshape(-1), b[-1], field.freqs]
        tail = torch.cat(parts)
        return torch.cat([tail, tail.new_zeros(lay["pack"] - tail.numel())])

    return _cached_pack(field, (*field.weights, *field.biases, field.freqs),
                        pack)


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
                   packed_weights=None):
    """Shape checks and the device tensors every rollout kernel reads
    (with ``eps`` (T, K, C) for the kernels that read their noise; the
    weight buffer ``packed_weights`` when given, a row of
    :func:`pack_members`, else :func:`_pack_weights`); any horizon that
    ``_check_horizon`` takes."""
    T, C = U.shape
    if (C != 2 or state.shape != (model.STATE_DIM,)
            or (eps is not None and eps.shape != (T, K, C))):
        raise ValueError(f"shapes: state {tuple(state.shape)}, U "
                         f"{tuple(U.shape)}, K {K}, eps "
                         f"{None if eps is None else tuple(eps.shape)}")
    _check_horizon(T, K, C)
    args = dict(
        s0=state.to(U.device, torch.float32).contiguous(),
        rngs=_control_rngs(model_params, C).to(torch.float32).contiguous(),
        U=U.to(torch.float32).contiguous(),
        weights=(_pack_weights(model, model_params) if packed_weights is None
                 else packed_weights))
    if eps is not None:
        args["eps"] = eps
    return args


# ---------------------------------------------------------------------------
# the dynamics the kernels evaluate, at each matmul_precision
# ---------------------------------------------------------------------------

def _precision(cfg, precision: Optional[str]) -> str:
    """The precision a kernel runs at: ``precision``, or
    ``cfg.matmul_precision`` when it is None."""
    return cfg.matmul_precision if precision is None else precision


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to bf16 (to nearest, ties to even, as the MXU
    rounds its operands and as ``__float2bfloat16_rn``; NaN stays NaN),
    back in float32."""
    return x.to(torch.bfloat16).to(torch.float32)


def kernel_dynamics(model, model_params, states, controls,
                    precision: str = "highest", split: bool = False):
    """The learned derivative (..., 4) as kernels 1-4 evaluate it at
    ``precision``: ``model.dynamics`` for ``"highest"`` and ``"high"``;
    for ``"default"`` each product of the MXU's one bf16 pass (the JAX
    ``Precision.DEFAULT`` dots), its operands rounded to bf16 and summed
    in float32, each bias added in float32 after it.  The MLP's layer 0
    takes the concatenated [roll, u_x, u_y, yaw_der, steer, throttle]
    (``_mlp_deriv_concat``: kernels 1, 2 and 4), or with ``split`` (kernel
    3, ``_fused_kernel``) the four state inputs in the rounded product and
    the controls' columns as float32 products beside it; the BF model
    rounds theta and the 25 basis functions (``_bf_deriv``)."""
    if not bf16_operands(precision):
        return model.dynamics(model_params, states, controls)
    if _is_bf(model):
        return (bf16_round(car_basis_functions(states, controls))
                @ bf16_round(model_params["theta"]))
    weights, biases = model_params["weights"], model_params["biases"]
    d4 = states[..., model.KINEMATICS_DIM:]
    W0 = weights[0]
    if split:
        acts = (bf16_round(d4) @ bf16_round(W0[:4])
                + controls[..., :1] * W0[4] + controls[..., 1:] * W0[5])
    else:
        acts = (bf16_round(torch.cat([d4, controls], dim=-1))
                @ bf16_round(W0))
    acts = acts + biases[0]
    for W, b in zip(weights[1:], biases[1:]):
        acts = bf16_round(torch.tanh(acts)) @ bf16_round(W) + b
    return acts


def kernel_state_deriv(model, model_params, states, controls,
                       precision: str = "highest", split: bool = False):
    """The full (..., S) state derivative as the kernels evaluate it
    (:func:`kernel_dynamics` beside the kinematics): ``model.state_deriv``
    for ``"highest"`` and ``"high"``, bit for bit."""
    if not bf16_operands(precision):
        return model.state_deriv(model_params, states, controls)
    return torch.cat([model.kinematics(states),
                      kernel_dynamics(model, model_params, states, controls,
                                      precision, split)], dim=-1)


# ---------------------------------------------------------------------------
# kernel A and kernel 3: fused rollout + cost on the exact map or the field
# ---------------------------------------------------------------------------

def fused_rollout_cost_plain(model, model_params, cfg, cost_params, surface,
                             state, U, eps, l1_cost: bool = False,
                             k_offset=0, obstacles=None,
                             obstacle_coeff: float = 0.0,
                             inflation: float = 1.0,
                             precision: Optional[str] = None,
                             split: Optional[bool] = None):
    """Plain PyTorch version of the fused kernels, on either surface (a
    ``Costmap`` for kernel A, a ``NeuralCostmap`` for kernel 3), either
    model, with or without obstacle terms, at ``precision``: the dynamics
    chain (:func:`dynamics_chain_plain`; ``split``: kernel 3's layer 0,
    by default on a ``NeuralCostmap``), then the kernels' per-step cost
    rules along it (:func:`trajectory_cost_plain`).
    Returns (costs (K,), u_seq (C, T, K) pre-clamp, crash (K,) int32)."""
    if split is None:
        split = type(surface) is NeuralCostmap
    precision = _precision(cfg, precision)
    states, u_seq = dynamics_chain_plain(model, model_params, cfg, state, U,
                                         eps, k_offset=k_offset,
                                         precision=precision, split=split)
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
    if type(surface) is NeuralCostmap:
        # the kernels evaluate a bf16 field from its weights upcast
        surface = surface.to_float32()
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
                   obstacle_coeff, inflation, packed_weights, precision):
    """Validate a fused kernel's inputs (``surface`` must be a ``cls``) and
    allocate its outputs.  Returns ``(launch, (costs, u_seq, crash))``:
    each ``launch()`` runs the kernel once into those outputs on the
    current stream (uncounted; the wrapper counts ``launch.name``)."""
    _expect(surface, cls, fn)
    _check_kernel_model(model, cfg, 3 if cls is NeuralCostmap else 1)
    bf16 = bf16_operands(_precision(cfg, precision))
    circles = _obstacle_circles(cost_params, obstacles)
    T, K, C = eps.shape
    dev = eps.device
    layers = kernel_layers(model)
    kind, buf, fspec = _surface(surface)
    if kind == "field":
        _check_field_room(layers, fspec)
    args = _kernel_inputs(model, model_params, state, U, K, eps,
                          packed_weights=packed_weights)
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
    if kind == "exact":
        entry = _spec_lib(layers, bf16).artt_fused_exact_rollout_cost
        geom = _launch_geometry(K, dev, model)
        geo_args = geom[:2]
    else:
        geom, geo_args = None, ()
        entry = _field_lib(layers, fspec, bf16).artt_fused_field_rollout_cost

    def launch():
        err = entry(
            ctypes.addressof(fsc), ctypes.addressof(isc), *geo_args,
            dev.index or 0,
            ptrs["s0"], ptrs["rngs"], ptrs["U"], ptrs["eps"],
            ptrs["surface"], ptrs["weights"],
            None if packed is None else packed.data_ptr(), costs.data_ptr(),
            crash.data_ptr(), u_seq.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
        _check_launch(err, fn)

    launch.inputs = (args, packed)           # keeps the buffers alive
    launch.name = fn + _form(model, n_obs, fspec, bf16)
    launch.geometry = geom
    return launch, (costs, u_seq, crash)


def prepare_fused_exact_rollout_cost(model, model_params, cfg, cost_params,
                                     costmap: Costmap, state, U, eps,
                                     l1_cost: bool = False, k_offset=0,
                                     obstacles=None,
                                     obstacle_coeff: float = 0.0,
                                     inflation: float = 1.0,
                                     packed_weights=None,
                                     precision: Optional[str] = None):
    """Kernel A's launch and outputs (see :func:`_prepare_fused`)."""
    return _prepare_fused(Costmap, "fused_exact_rollout_cost", model,
                          model_params, cfg, cost_params, costmap, state, U,
                          eps, l1_cost, k_offset, obstacles, obstacle_coeff,
                          inflation, packed_weights, precision)


def prepare_fused_rollout_cost(model, model_params, cfg, cost_params,
                               field: NeuralCostmap, state, U, eps,
                               l1_cost: bool = False, k_offset=0,
                               obstacles=None, obstacle_coeff: float = 0.0,
                               inflation: float = 1.0, packed_weights=None,
                               precision: Optional[str] = None):
    """Kernel 3's launch and outputs (see :func:`_prepare_fused`)."""
    return _prepare_fused(NeuralCostmap, "fused_rollout_cost", model,
                          model_params, cfg, cost_params, field, state, U,
                          eps, l1_cost, k_offset, obstacles, obstacle_coeff,
                          inflation, packed_weights, precision)


def fused_exact_rollout_cost(model, model_params, cfg, cost_params,
                             costmap: Costmap, state, U, eps,
                             l1_cost: bool = False, k_offset=0,
                             obstacles=None, obstacle_coeff: float = 0.0,
                             inflation: float = 1.0, packed_weights=None,
                             precision: Optional[str] = None):
    """Fused rollout + exact-costmap cost (``fused_exact_rollout_cost_pallas``).

    ``state`` (S,), ``U`` (T, C), ``eps`` (T, K, C) standard normal;
    ``k_offset`` is the global index of this batch's first rollout;
    ``obstacles`` (N, 3) circles priced with ``obstacle_coeff`` and
    ``inflation`` (``ObstacleCost.kernel_kwargs``), or None;
    ``packed_weights``: the kernel's weight buffer when the caller packed
    it (a row of :func:`pack_members`; the plain version reads
    ``model_params``); ``precision``: one of ``cfg.matmul_precision``'s
    names, ``cfg.matmul_precision`` when None (the module's docstring).
    Returns (costs (K,), u_seq (C, T, K), crash (K,) int32)."""
    _expect(costmap, Costmap, "fused_exact_rollout_cost")
    kw = dict(l1_cost=l1_cost, k_offset=k_offset, obstacles=obstacles,
              obstacle_coeff=obstacle_coeff, inflation=inflation,
              precision=precision)
    if _dispatch(eps) == "plain":
        return fused_rollout_cost_plain(model, model_params, cfg,
                                        cost_params, costmap, state, U, eps,
                                        **kw)
    launch, out = prepare_fused_exact_rollout_cost(
        model, model_params, cfg, cost_params, costmap, state, U, eps,
        packed_weights=packed_weights, **kw)
    _launch_counted(launch, eps.shape[1])
    return out


def fused_rollout_cost(model, model_params, cfg, cost_params,
                       field: NeuralCostmap, state, U, eps,
                       l1_cost: bool = False, k_offset=0, obstacles=None,
                       obstacle_coeff: float = 0.0, inflation: float = 1.0,
                       packed_weights=None, precision: Optional[str] = None):
    """Fused rollout + neural-field cost (``fused_rollout_cost_pallas``):
    :func:`fused_exact_rollout_cost`'s contract with a ``NeuralCostmap``.
    Returns (costs (K,), u_seq (C, T, K), crash (K,) int32)."""
    _expect(field, NeuralCostmap, "fused_rollout_cost")
    kw = dict(l1_cost=l1_cost, k_offset=k_offset, obstacles=obstacles,
              obstacle_coeff=obstacle_coeff, inflation=inflation,
              precision=precision)
    if _dispatch(eps) == "plain":
        return fused_rollout_cost_plain(model, model_params, cfg,
                                        cost_params, field, state, U, eps,
                                        **kw)
    launch, out = prepare_fused_rollout_cost(
        model, model_params, cfg, cost_params, field, state, U, eps,
        packed_weights=packed_weights, **kw)
    _launch_counted(launch, eps.shape[1])
    return out


# ---------------------------------------------------------------------------
# kernel B: the dynamics chain
# ---------------------------------------------------------------------------

def dynamics_chain_plain(model, model_params, cfg, state, U, eps, k_offset=0,
                         precision: Optional[str] = None, split: bool = False):
    """Plain PyTorch version of the chain kernel at ``precision`` (the
    derivative :func:`kernel_state_deriv`, kernel 3's with ``split``):
    returns (states (S, T, K) with ``states[i, t]`` = component i after
    t+1 steps, u_seq (C, T, K))."""
    precision = _precision(cfg, precision)
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
        s = s + kernel_state_deriv(model, model_params, s, u_cl, precision,
                                   split) * model.dt
        states[:, t] = s.T
    return states, u_seq


def prepare_dynamics_chain(model, model_params, cfg, state, U, eps,
                           k_offset=0, packed_weights=None,
                           precision: Optional[str] = None):
    """Validate the chain kernel's inputs and allocate its outputs; returns
    ``(launch, (states, u_seq))`` as :func:`prepare_fused_exact_rollout_cost`."""
    _check_kernel_model(model, cfg, 2)
    bf16 = bf16_operands(_precision(cfg, precision))
    T, K, C = eps.shape
    dev = eps.device
    layers = kernel_layers(model)
    args = _kernel_inputs(model, model_params, state, U, K, eps,
                          packed_weights=packed_weights)
    ptrs = _device_args(dev, **args)
    floats, ints = launch_scalars(model, cfg, k_offset, T, K)
    fsc = _host_array(ctypes.c_float, floats)
    isc = _host_array(ctypes.c_int, ints)

    states = torch.empty((model.STATE_DIM, T, K), dtype=torch.float32,
                         device=dev)
    u_seq = torch.empty((C, T, K), dtype=torch.float32, device=dev)
    lib = _spec_lib(layers, bf16)
    geom = _chain_launch_geometry(K, dev, model)

    def launch():
        err = lib.artt_dynamics_chain(
            ctypes.addressof(fsc), ctypes.addressof(isc), geom.group,
            geom.block, dev.index or 0,
            ptrs["s0"], ptrs["rngs"], ptrs["U"], ptrs["eps"],
            ptrs["weights"], states.data_ptr(), u_seq.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
        _check_launch(err, "dynamics_chain")

    launch.inputs = args
    launch.name = "dynamics_chain" + _form(model, 0, bf16=bf16)
    launch.geometry = geom
    return launch, (states, u_seq)


def dynamics_chain(model, model_params, cfg, state, U, eps, k_offset=0,
                   packed_weights=None, precision: Optional[str] = None):
    """The dynamics chain (``dynamics_chain_pallas``): same perturb/clamp/
    derivative/Euler as the fused kernel, emitting every state
    (``packed_weights`` and ``precision`` as
    :func:`fused_exact_rollout_cost` takes them).
    Returns (states (S, T, K), u_seq (C, T, K))."""
    if _dispatch(eps) == "plain":
        return dynamics_chain_plain(model, model_params, cfg, state, U, eps,
                                    k_offset=k_offset, precision=precision)
    launch, out = prepare_dynamics_chain(model, model_params, cfg, state, U,
                                         eps, k_offset=k_offset,
                                         packed_weights=packed_weights,
                                         precision=precision)
    _launch_counted(launch, eps.shape[1])
    return out


def nominal_trajectory(model, model_params, cfg, state, U,
                       packed_weights=None):
    """Re-rollout of the solution (``computeNominalTraj``,
    ``mppi_controller.cu:501-519``; ``nominal_trajectory_pallas``): one
    noise-free rollout through :func:`dynamics_chain` (K = 1), in float32
    at every ``matmul_precision``, as the JAX solver calls
    ``nominal_trajectory_pallas`` without one.  Returns
    (state_solution (T, S), control_solution (T, C)), recording each state
    before its update and the clamped controls."""
    T, C = U.shape
    state = state.to(U.device, torch.float32)
    eps = torch.zeros((T, 1, C), dtype=torch.float32, device=U.device)
    states, _ = dynamics_chain(model, model_params, cfg, state, U, eps,
                               packed_weights=packed_weights,
                               precision="highest")
    traj = states[:, :, 0].T                                 # s_1 .. s_T
    states_sol = torch.cat([state[None, :], traj[:-1]], dim=0)
    rngs = _control_rngs(model_params, C)
    return states_sol, torch.clamp(U, rngs[:, 0], rngs[:, 1])


# ---------------------------------------------------------------------------
# the lane forms of kernels 1-3: L cost-parameter sets in one launch
# ---------------------------------------------------------------------------

def lane_scalar_rows(model, cfg, cost_params, costmap, k_offset=0,
                     obstacle_coeff: float = 0.0,
                     inflation: float = 1.0) -> tuple:
    """A stacked ``CostParams``'s (``config.cost_params_lanes``) rows of
    the lane forms' scalars, on the host: row l lane l's float scalars as
    :func:`launch_scalars` gives them for one launch (the chain entries,
    the surface's transform, lane l's coefficients, and the circles'
    ``obstacle_coeff`` and ``inflation``, the cost object's for every
    lane)."""
    return tuple(tuple(launch_scalars(
        model, cfg, k_offset, 0, 0, cp, costmap,
        obstacle_coeff=obstacle_coeff, inflation=inflation)[0])
        for cp in lane_cost_params(cost_params))


def lane_scalars(model, cfg, cost_params, costmap, device, k_offset=0,
                 obstacle_coeff: float = 0.0,
                 inflation: float = 1.0) -> torch.Tensor:
    """:func:`lane_scalar_rows` packed for the lane forms of kernels 1 and
    3: (L, ``len(_FLOAT_SCALARS)``) float32 on ``device``, a copy from the
    host.  A captured tick takes them packed before its capture
    (``MPPISolver.rollout_costs_lanes``)."""
    return torch.tensor(lane_scalar_rows(model, cfg, cost_params, costmap,
                                         k_offset, obstacle_coeff,
                                         inflation),
                        dtype=torch.float32, device=device)


def _lane_circles(cost_params, obstacles, L: int) -> Optional[torch.Tensor]:
    """The circles of a lane launch, (L, N, 3) float32 as given (any
    device): a stacked (L, N, 3), a lane's own rows each, or one (N, 3)
    set that every lane prices (an ``ObstacleCost``'s own, or a moving
    obstacle's tick), expanded; None without obstacle terms, whose
    ``CostParams.obstacles`` is refused as :func:`_obstacle_circles`
    refuses it."""
    if obstacles is None:
        return _obstacle_circles(cost_params, None)
    circles = torch.as_tensor(obstacles, dtype=torch.float32)
    if circles.dim() == 2:
        circles = _obstacle_circles(cost_params, circles)
        return circles.expand(L, *circles.shape)
    if circles.dim() != 3 or circles.shape[0] != L or circles.shape[2] != 3:
        raise ValueError(f"lane circles must be (N, 3) or ({L}, N, 3) [x, "
                         f"y, radius], got {tuple(circles.shape)}")
    return circles


def _lane_inputs(model, model_params, state, U, eps=None,
                 packed_weights=None, K: int = 1):
    """Shape checks of a lane launch, state (L, S), U (L, T, C) and, for
    the kernels that read it, eps (T, K, C) shared (else ``K`` rollouts a
    lane); the device tensors it reads."""
    L = state.shape[0] if state.dim() == 2 else 0
    T, C = U.shape[-2:] if U.dim() == 3 else (0, 0)
    if (L < 1 or state.shape != (L, model.STATE_DIM) or U.shape != (L, T, C)
            or C != 2 or (eps is not None and (eps.dim() != 3 or eps.shape[0]
                                               != T or eps.shape[2] != C))):
        raise ValueError(f"lane shapes: state {tuple(state.shape)}, U "
                         f"{tuple(U.shape)}, eps "
                         f"{None if eps is None else tuple(eps.shape)}")
    _check_horizon(T, K if eps is None else eps.shape[1], C)
    args = dict(
        s0=state.to(U.device, torch.float32).contiguous(),
        rngs=_control_rngs(model_params, C).to(torch.float32).contiguous(),
        U=U.to(torch.float32).contiguous(),
        weights=(_pack_weights(model, model_params) if packed_weights is None
                 else packed_weights))
    if eps is not None:
        args["eps"] = eps
    return L, args


def _lanes_geometry(kernel: int, L: int, K: int, dev, model):
    """A lane launch's geometry of kernel 1, 2 or 3, with the blocks of one
    lane (the launcher's grid is (blocks, L)).  Kernels 1 and 2 choose it
    from L x K rollouts, in the geometries of the model's spec.  Kernel 3
    has one: its blocks of ``field_block`` (a warp's tile and the staged
    field fix it: 4 warps, two blocks an SM, in the default library),
    K / block of them a lane, whatever L x K is."""
    if kernel == 3:
        return _geometry(K, 1, field_block(kernel_layers(model)))
    pick = _chain_launch_geometry if kernel == 2 else _launch_geometry
    geom = pick(L * K, dev, model)
    return _geometry(K, geom.group, geom.block)


def fused_rollout_cost_lanes_plain(model, model_params, cfg, cost_params,
                                   surface, state, U, eps,
                                   l1_cost: bool = False, k_offset=0,
                                   obstacles=None,
                                   obstacle_coeff: float = 0.0,
                                   inflation: float = 1.0,
                                   precision: Optional[str] = None):
    """Plain version of the lane forms of kernels 1 and 3 on either
    surface: the solo plain version (:func:`fused_rollout_cost_plain`)
    applied lane by lane, lane l with ``lane_cost_params``'s lane l,
    ``state[l]``, ``U[l]`` and lane l's circles
    (:func:`fused_exact_rollout_cost_lanes`).  Returns (costs (L, K), u_seq
    (L, C, T, K), crash (L, K))."""
    circles = _lane_circles(cost_params, obstacles, state.shape[0])
    outs = [fused_rollout_cost_plain(
        model, model_params, cfg, cp, surface, state[i], U[i], eps,
        l1_cost=l1_cost, k_offset=k_offset,
        obstacles=None if circles is None else circles[i],
        obstacle_coeff=obstacle_coeff, inflation=inflation,
        precision=precision)
        for i, cp in enumerate(lane_cost_params(cost_params))]
    return tuple(torch.stack(o) for o in zip(*outs))


def _lane_launch(model, cfg, cost_params, surface, L: int, T: int, K: int,
                 dev, args, k_offset, l1_cost, circles, obstacle_coeff,
                 inflation, lane_fsc):
    """The launch scalars of a lane form that prices (kernels 1, 3 and pass
    1): ``args`` gains ``lane_fsc`` (:func:`lane_scalars`, with the
    circles' coefficients, packed here when None); returns (fsc, isc, the
    device pointers of ``args``, n_obs, the circles' (L, 3 n_obs) copy)."""
    args["lane_fsc"] = (lane_scalars(model, cfg, cost_params, surface, dev,
                                     k_offset, obstacle_coeff, inflation)
                        if lane_fsc is None else lane_fsc)
    if args["lane_fsc"].shape[0] != L:
        raise ValueError(f"{args['lane_fsc'].shape[0]} lanes of cost "
                         f"params, state of {L}")
    ptrs = _device_args(dev, **args)
    n_obs, packed = _obstacle_launch(circles, dev)
    floats, ints = launch_scalars(model, cfg, k_offset, T, K,
                                  lane_cost_params(cost_params)[0], surface,
                                  l1_cost, n_obs, obstacle_coeff, inflation)
    return (_host_array(ctypes.c_float, floats),
            _host_array(ctypes.c_int, ints), ptrs, n_obs, packed)


def _prepare_lanes(fn: str, model, model_params, cfg, cost_params, surface,
                   state, U, eps, l1_cost, k_offset, obstacles,
                   obstacle_coeff, inflation, packed_weights, precision,
                   lane_fsc):
    """Validate a lane form's inputs (kernel 1 on a ``Costmap``, kernel 3
    on a ``NeuralCostmap``) and allocate its outputs; returns ``(launch,
    (costs, u_seq, crash))`` as :func:`_prepare_fused`, ``launch.lanes``
    its L.  The lane form runs from the library of its solo twin: the
    model's spec, the field's spec and ``precision``'s operands.
    ``lane_fsc``: the lane scalars (:func:`lane_scalars`, with the circles'
    coefficients) on the device, packed here when None."""
    field = type(surface) is NeuralCostmap
    _expect(surface, NeuralCostmap if field else Costmap, fn)
    _check_kernel_model(model, cfg, 3 if field else 1)
    bf16 = bf16_operands(_precision(cfg, precision))
    kind, buf, fspec = _surface(surface)
    T, K, C = eps.shape
    dev = eps.device
    layers = kernel_layers(model)
    if field:
        _check_field_room(layers, fspec, lanes=True)
    L, args = _lane_inputs(model, model_params, state, U, eps,
                           packed_weights)
    circles = _lane_circles(cost_params, obstacles, L)
    args["surface"] = buf
    fsc, isc, ptrs, n_obs, packed = _lane_launch(
        model, cfg, cost_params, surface, L, T, K, dev, args, k_offset,
        l1_cost, circles, obstacle_coeff, inflation, lane_fsc)
    costs = torch.empty((L, K), dtype=torch.float32, device=dev)
    crash = torch.empty((L, K), dtype=torch.int32, device=dev)
    u_seq = torch.empty((L, C, T, K), dtype=torch.float32, device=dev)
    geom = _lanes_geometry(3 if field else 1, L, K, dev, model)
    entry, geo_args = (
        (_field_lib(layers, fspec, bf16).artt_fused_field_lanes, ())
        if field else (_spec_lib(layers, bf16).artt_fused_exact_lanes,
                       geom[:2]))

    def launch():
        err = entry(
            ctypes.addressof(fsc), ctypes.addressof(isc), ptrs["lane_fsc"],
            L, *geo_args, dev.index or 0, ptrs["s0"], ptrs["rngs"],
            ptrs["U"], ptrs["eps"], ptrs["surface"], ptrs["weights"],
            None if packed is None else packed.data_ptr(), costs.data_ptr(),
            crash.data_ptr(), u_seq.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
        _check_launch(err, fn)

    launch.inputs = (args, packed)           # keeps the buffers alive
    launch.name = (fn.removesuffix("_lanes") + _form(model, n_obs, fspec, bf16)
                   + "_lanes")
    launch.geometry = geom
    launch.lanes = L
    return launch, (costs, u_seq, crash)


def prepare_fused_exact_rollout_cost_lanes(model, model_params, cfg,
                                           cost_params, costmap: Costmap,
                                           state, U, eps,
                                           l1_cost: bool = False, k_offset=0,
                                           obstacles=None,
                                           obstacle_coeff: float = 0.0,
                                           inflation: float = 1.0,
                                           packed_weights=None,
                                           precision: Optional[str] = None,
                                           lane_fsc=None):
    """Kernel 1's lane launch and outputs (see :func:`_prepare_lanes`)."""
    return _prepare_lanes("fused_exact_rollout_cost_lanes", model,
                          model_params, cfg, cost_params, costmap, state, U,
                          eps, l1_cost, k_offset, obstacles, obstacle_coeff,
                          inflation, packed_weights, precision, lane_fsc)


def prepare_fused_rollout_cost_lanes(model, model_params, cfg, cost_params,
                                     field: NeuralCostmap, state, U, eps,
                                     l1_cost: bool = False, k_offset=0,
                                     obstacles=None,
                                     obstacle_coeff: float = 0.0,
                                     inflation: float = 1.0,
                                     packed_weights=None,
                                     precision: Optional[str] = None,
                                     lane_fsc=None):
    """Kernel 3's lane launch and outputs (see :func:`_prepare_lanes`)."""
    return _prepare_lanes("fused_rollout_cost_lanes", model, model_params,
                          cfg, cost_params, field, state, U, eps, l1_cost,
                          k_offset, obstacles, obstacle_coeff, inflation,
                          packed_weights, precision, lane_fsc)


def fused_exact_rollout_cost_lanes(model, model_params, cfg, cost_params,
                                   costmap: Costmap, state, U, eps,
                                   l1_cost: bool = False, k_offset=0,
                                   obstacles=None,
                                   obstacle_coeff: float = 0.0,
                                   inflation: float = 1.0,
                                   packed_weights=None,
                                   precision: Optional[str] = None,
                                   lane_fsc=None):
    """Kernel 1 over the L lanes of a stacked ``cost_params`` in one launch
    (the JAX package's vmap of ``fused_exact_rollout_cost_pallas``): lane l
    prices ``state[l]`` (L, S) and ``U[l]`` (L, T, C) with lane l's
    coefficients; ``eps`` (T, K, C), the weights and the map are shared.
    ``obstacles``: (L, N, 3) circles, lane l's its row, or (N, 3) that
    every lane prices, with ``obstacle_coeff`` and ``inflation``
    (``ObstacleCost.kernel_kwargs``), or None.  ``lane_fsc``: as
    :func:`prepare_fused_exact_rollout_cost_lanes` takes it; the other
    arguments as :func:`fused_exact_rollout_cost` takes them.  Counted as
    the solo instance's name with ``_lanes``
    (``fused_exact_rollout_cost[_bf][_<spec>][_obstacles][_default]_lanes``).
    Returns (costs (L, K), u_seq (L, C, T, K), crash (L, K) int32)."""
    kw = dict(l1_cost=l1_cost, k_offset=k_offset, obstacles=obstacles,
              obstacle_coeff=obstacle_coeff, inflation=inflation,
              precision=precision)
    if _dispatch(eps) == "plain":
        return fused_rollout_cost_lanes_plain(
            model, model_params, cfg, cost_params, costmap, state, U, eps,
            **kw)
    launch, out = prepare_fused_exact_rollout_cost_lanes(
        model, model_params, cfg, cost_params, costmap, state, U, eps,
        packed_weights=packed_weights, lane_fsc=lane_fsc, **kw)
    _launch_counted(launch, eps.shape[1])
    return out


def fused_rollout_cost_lanes(model, model_params, cfg, cost_params,
                             field: NeuralCostmap, state, U, eps,
                             l1_cost: bool = False, k_offset=0,
                             obstacles=None, obstacle_coeff: float = 0.0,
                             inflation: float = 1.0, packed_weights=None,
                             precision: Optional[str] = None, lane_fsc=None):
    """Kernel 3 over the L lanes of a stacked ``cost_params`` in one launch
    (the JAX package's vmap of ``fused_rollout_cost_pallas``):
    :func:`fused_exact_rollout_cost_lanes`'s contract with a
    ``NeuralCostmap`` of any spec (the packed field shared).  Counted as
    ``fused_rollout_cost[...]_lanes``.  Returns (costs (L, K), u_seq (L,
    C, T, K), crash (L, K) int32)."""
    kw = dict(l1_cost=l1_cost, k_offset=k_offset, obstacles=obstacles,
              obstacle_coeff=obstacle_coeff, inflation=inflation,
              precision=precision)
    if _dispatch(eps) == "plain":
        return fused_rollout_cost_lanes_plain(
            model, model_params, cfg, cost_params, field, state, U, eps,
            **kw)
    launch, out = prepare_fused_rollout_cost_lanes(
        model, model_params, cfg, cost_params, field, state, U, eps,
        packed_weights=packed_weights, lane_fsc=lane_fsc, **kw)
    _launch_counted(launch, eps.shape[1])
    return out


def dynamics_chain_lanes_plain(model, model_params, cfg, state, U, eps,
                               k_offset=0, precision: Optional[str] = None):
    """Plain version of kernel 2's lane form: :func:`dynamics_chain_plain`
    lane by lane.  Returns (states (L, S, T, K), u_seq (L, C, T, K))."""
    outs = [dynamics_chain_plain(model, model_params, cfg, s, u, eps,
                                 k_offset=k_offset, precision=precision)
            for s, u in zip(state, U)]
    return tuple(torch.stack(o) for o in zip(*outs))


def prepare_dynamics_chain_lanes(model, model_params, cfg, state, U, eps,
                                 k_offset=0, packed_weights=None,
                                 precision: Optional[str] = None):
    """Validate kernel 2's lane-form inputs and allocate its outputs;
    returns ``(launch, (states, u_seq))`` as :func:`prepare_dynamics_chain`,
    from the library of the solo twin."""
    _check_kernel_model(model, cfg, 2)
    bf16 = bf16_operands(_precision(cfg, precision))
    T, K, C = eps.shape
    dev = eps.device
    layers = kernel_layers(model)
    L, args = _lane_inputs(model, model_params, state, U, eps,
                           packed_weights)
    ptrs = _device_args(dev, **args)
    floats, ints = launch_scalars(model, cfg, k_offset, T, K)
    fsc = _host_array(ctypes.c_float, floats)
    isc = _host_array(ctypes.c_int, ints)
    states = torch.empty((L, model.STATE_DIM, T, K), dtype=torch.float32,
                         device=dev)
    u_seq = torch.empty((L, C, T, K), dtype=torch.float32, device=dev)
    geom = _lanes_geometry(2, L, K, dev, model)
    lib = _spec_lib(layers, bf16)

    def launch():
        err = lib.artt_dynamics_chain_lanes(
            ctypes.addressof(fsc), ctypes.addressof(isc), L, geom.group,
            geom.block, dev.index or 0, ptrs["s0"], ptrs["rngs"], ptrs["U"],
            ptrs["eps"], ptrs["weights"], states.data_ptr(),
            u_seq.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
        _check_launch(err, "dynamics_chain_lanes")

    launch.inputs = args
    launch.name = "dynamics_chain" + _form(model, 0, bf16=bf16) + "_lanes"
    launch.geometry = geom
    launch.lanes = L
    return launch, (states, u_seq)


def dynamics_chain_lanes(model, model_params, cfg, state, U, eps, k_offset=0,
                         packed_weights=None, precision: Optional[str] = None):
    """Kernel 2 over L lanes in one launch (the JAX package's vmap of
    ``dynamics_chain_pallas`` over its start states and U): lane l runs
    ``state[l]`` (L, S) and ``U[l]`` (L, T, C); ``eps`` (T, K, C) shared.
    Counted as ``dynamics_chain[_bf][_<spec>][_default]_lanes``.  Returns
    (states (L, S, T, K), u_seq (L, C, T, K))."""
    if _dispatch(eps) == "plain":
        return dynamics_chain_lanes_plain(model, model_params, cfg, state, U,
                                          eps, k_offset=k_offset,
                                          precision=precision)
    launch, out = prepare_dynamics_chain_lanes(
        model, model_params, cfg, state, U, eps, k_offset=k_offset,
        packed_weights=packed_weights, precision=precision)
    _launch_counted(launch, eps.shape[1])
    return out


def nominal_trajectory_lanes(model, model_params, cfg, state, U,
                             packed_weights=None):
    """:func:`nominal_trajectory` of L lanes, state (L, S) and U (L, T, C),
    in one launch of kernel 2's lane form (K = 1 a lane).  Returns
    (state_solution (L, T, S), control_solution (L, T, C))."""
    L, T, C = U.shape
    state = state.to(U.device, torch.float32)
    eps = torch.zeros((T, 1, C), dtype=torch.float32, device=U.device)
    states, _ = dynamics_chain_lanes(model, model_params, cfg, state, U, eps,
                                     packed_weights=packed_weights,
                                     precision="highest")
    traj = states[..., 0].transpose(1, 2)                 # (L, T, S)
    states_sol = torch.cat([state[:, None, :], traj[:, :-1]], dim=1)
    rngs = _control_rngs(model_params, C)
    return states_sol, torch.clamp(U, rngs[:, 0], rngs[:, 1])


def lanes_kernel_info(kernel: int, bf: bool, geom: ExactGeometry, T: int,
                      n_obs: int = 0, device: int = 0, layers=KERNEL_LAYERS,
                      field=FIELD_KERNEL_SPEC, precision: str = "highest",
                      field_mode: bool = False) -> dict:
    """:func:`exact_kernel_info` of the lane form's instance of kernel
    ``kernel`` that ``geom`` launches at ``T`` with ``n_obs`` circle slots,
    the waves of one lane, from the library of the MLP spec ``layers``, the
    field spec ``field`` and ``precision``: 1 and 2 kernels 1 and 2; 3
    kernel 3 (``geom`` ``_geometry(K, 1, field_block(layers))``); 4 pass 1,
    its field mode when ``field_mode`` (the same geometry) or on the exact
    map (``_geometry(K, 1, EXACT_BLOCK)``); 5 pass 2 (``_geometry(K, 1,
    UPDATE_BLOCK)``, the default float32 library)."""
    bf16 = bf16_operands(precision)
    lib = (_kernel_lib() if kernel == 5 else
           _field_lib(layers, field, bf16) if kernel == 3 or field_mode
           else _spec_lib(layers, bf16))
    out = (ctypes.c_int * 4)()
    _check_launch(lib.artt_lanes_kernel_info(
        int(kernel), int(field_mode), int(bf), geom.group, geom.block, T,
        n_obs, device, out), "lanes_kernel_info")
    return _info(out, geom, device)


# ---------------------------------------------------------------------------
# the kernel-RNG ("nothing-in-HBM") capacity mode: pass 1 and pass 2
# ---------------------------------------------------------------------------

class RngContext(NamedTuple):
    """What pass 2 needs to replay pass 1's noise stream (the JAX
    package's ``ctx``)."""

    model: object                   # NeuralNetDynamics or BF
    cfg: object
    U: torch.Tensor                 # (T, C) float32; a lane form's (L, T, C)
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
    return kernel_noise(ctx.key, ctx.k_offset, ctx.K, ctx.U.shape[-2],
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
                          inflation: float = 1.0,
                          precision: Optional[str] = None):
    """Plain version of pass 1, both modes: the fused kernels' plain version
    (:func:`fused_rollout_cost_plain`, layer 0 concatenated in both, as
    ``_fused_rng_kernel`` takes it) on the stream.  Returns (total (K,),
    crash (K,) int32, ctx)."""
    ctx = _rng_context(model, cfg, cost_params, field, U, key, k_offset,
                       K_local)
    costs, _, crash = fused_rollout_cost_plain(
        model, model_params, cfg, cost_params, field, state, ctx.U,
        rng_noise(ctx), l1_cost=l1_cost, k_offset=ctx.k_offset,
        obstacles=obstacles, obstacle_coeff=obstacle_coeff,
        inflation=inflation, precision=precision, split=False)
    return costs, crash, ctx


def prepare_fused_rng_costs(model, model_params, cfg, cost_params, field,
                            state, U, key, l1_cost: bool = False, k_offset=0,
                            K_local=None, obstacles=None,
                            obstacle_coeff: float = 0.0,
                            inflation: float = 1.0,
                            precision: Optional[str] = None):
    """Validate pass 1's inputs and allocate its outputs.  Returns
    ``(launch, (costs, crash), ctx)``; each ``launch()`` runs the kernel of
    the surface's mode (``fused_rng_kernel`` for a ``Costmap``,
    ``fused_rng_field_kernel`` for a ``NeuralCostmap``) once on the current
    stream (uncounted; the wrapper counts); ``launch.mode`` names the
    mode, ``launch.name`` the kernel instance."""
    _check_kernel_model(model, cfg, 4)
    bf16 = bf16_operands(_precision(cfg, precision))
    circles = _obstacle_circles(cost_params, obstacles)
    ctx = _rng_context(model, cfg, cost_params, field, U, key, k_offset,
                       K_local)
    T, K = ctx.U.shape[0], ctx.K
    dev = ctx.U.device
    layers = kernel_layers(model)
    kind, buf, fspec = _surface(field)
    if kind == "field":
        _check_field_room(layers, fspec)
    args = _kernel_inputs(model, model_params, state, ctx.U, K)
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
    entry = (_spec_lib(layers, bf16).artt_fused_rng_costs if kind == "exact"
             else _field_lib(layers, fspec, bf16).artt_fused_rng_field_costs)

    def launch():
        err = entry(
            ctypes.addressof(fsc), ctypes.addressof(isc), *stream_args,
            dev.index or 0, ptrs["s0"], ptrs["rngs"], ptrs["U"],
            ctx.key.data_ptr(), ptrs["surface"], ptrs["weights"],
            None if packed is None else packed.data_ptr(), costs.data_ptr(),
            crash.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
        _check_launch(err, f"fused_rng_costs ({kind})")

    launch.inputs = (args, packed)           # keeps the buffers alive
    # exact pass 1 runs one rollout a thread at every K
    launch.geometry = (_geometry(K, 1, EXACT_BLOCK) if kind == "exact"
                       else None)
    launch.mode = kind
    launch.name = ("fused_rng_costs" + ("_field" if kind == "field" else "")
                   + _form(model, n_obs, fspec, bf16))
    return launch, (costs, crash), ctx


def fused_rng_costs(model, model_params, cfg, cost_params, field, state, U,
                    key, l1_cost: bool = False, k_offset=0, K_local=None,
                    obstacles=None, obstacle_coeff: float = 0.0,
                    inflation: float = 1.0, precision: Optional[str] = None):
    """Pass 1 of the capacity mode (``fused_rng_costs`` of the JAX
    package): rollout costs with the noise drawn in the kernel; nothing per
    (t, k) reaches device memory.  ``field`` is the exact ``Costmap`` or a
    ``NeuralCostmap`` (the JAX kernel's ``cost_mode`` "exact" / "field");
    the two modes are two CUDA kernels, counted as ``fused_rng_costs`` and
    ``fused_rng_costs_field`` (and their ``_bf`` / ``_obstacles`` forms);
    ``obstacles`` and ``precision`` as in :func:`fused_exact_rollout_cost`.

    ``key``: int64 (2,) on ``U``'s device, the stream's key; ``k_offset`` /
    ``K_local`` let a sharded caller run its own slice of the global batch.
    Returns (total (K,), crash (K,) int32, ctx), where ``ctx`` replays the
    same stream in :func:`fused_rng_numer`."""
    kw = dict(l1_cost=l1_cost, k_offset=k_offset, K_local=K_local,
              obstacles=obstacles, obstacle_coeff=obstacle_coeff,
              inflation=inflation, precision=precision)
    if _dispatch(U) == "plain":
        return fused_rng_costs_plain(model, model_params, cfg, cost_params,
                                     field, state, U, key, **kw)
    launch, (costs, crash), ctx = prepare_fused_rng_costs(
        model, model_params, cfg, cost_params, field, state, U, key, **kw)
    launch()
    LAUNCHES[launch.name] += 1
    return costs, crash, ctx


def fused_rng_numer_plain(ctx: RngContext, w, eps=None):
    """Plain version of pass 2: sum_k w_k u_{k,t,c} over the replayed
    stream's pre-clamp controls, (C, T); ``eps``: the stream
    (:func:`rng_noise`), drawn here when None."""
    eps = rng_noise(ctx) if eps is None else eps
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
    G = ceil(K / UPDATE_BLOCK).  Returns ``(launch, partials)``.  Pass 2
    evaluates no model: the default library's kernel runs it for every
    MLP spec."""
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
                   field, state, U, key, l1_cost, k_offset, precision,
                   obstacle_kw):
    total, crash, ctx = costs_fn(model, model_params, cfg, cost_params, field,
                                 state, U, key, l1_cost=l1_cost,
                                 k_offset=k_offset, precision=precision,
                                 **obstacle_kw)
    baseline = torch.min(total)
    w = torch.exp(-effective_gamma(cfg, cost_params) * (total - baseline))
    U_new = (numer_fn(ctx, w) / torch.sum(w)).T
    return U_new, total, crash


def fused_rng_solve_iteration_plain(model, model_params, cfg, cost_params,
                                    field, state, U, key,
                                    l1_cost: bool = False, k_offset=0,
                                    precision: Optional[str] = None,
                                    **obstacle_kw):
    """:func:`fused_rng_solve_iteration` through the plain versions of both
    passes."""
    return _rng_iteration(fused_rng_costs_plain, fused_rng_numer_plain,
                          model, model_params, cfg, cost_params, field,
                          state, U, key, l1_cost, k_offset, precision,
                          obstacle_kw)


def fused_rng_solve_iteration(model, model_params, cfg, cost_params,
                              field, state, U, key,
                              l1_cost: bool = False, k_offset=0,
                              precision: Optional[str] = None, **obstacle_kw):
    """One MPPI iteration in the capacity mode: pass 1's costs, the softmax
    weights in PyTorch, pass 2's numerator; device-memory traffic is
    O(K + T C), independent of K T.  Runs the kernels for tensors on a
    GPU, the plain versions for tensors on the CPU (each pass counts its
    own launches); ``precision`` and ``obstacle_kw`` (``obstacles``,
    ``obstacle_coeff``, ``inflation``) go to pass 1 (pass 2 evaluates no
    model).  Returns (U_new (T, C), total (K,), crash (K,))."""
    return _rng_iteration(fused_rng_costs, fused_rng_numer, model,
                          model_params, cfg, cost_params, field, state, U,
                          key, l1_cost, k_offset, precision, obstacle_kw)


# ---------------------------------------------------------------------------
# the capacity passes' lane forms: L cost-parameter sets on one stream
# ---------------------------------------------------------------------------

def fused_rng_costs_lanes_plain(model, model_params, cfg, cost_params, field,
                                state, U, key, l1_cost: bool = False,
                                k_offset=0, K_local=None, obstacles=None,
                                obstacle_coeff: float = 0.0,
                                inflation: float = 1.0,
                                precision: Optional[str] = None):
    """Plain version of pass 1's lane form: :func:`fused_rng_costs_plain`
    lane by lane, lane l with ``lane_cost_params``'s lane l, ``state[l]``,
    ``U[l]`` and lane l's circles, every lane on the stream of ``key``
    (drawn once).  Returns (total (L, K), crash (L, K) int32, ctx with U
    (L, T, C))."""
    ctx = _rng_context(model, cfg, cost_params, field, U, key, k_offset,
                       K_local)
    eps = rng_noise(ctx)
    circles = _lane_circles(cost_params, obstacles, state.shape[0])
    outs = [fused_rollout_cost_plain(
        model, model_params, cfg, cp, field, state[i], ctx.U[i], eps,
        l1_cost=l1_cost, k_offset=ctx.k_offset,
        obstacles=None if circles is None else circles[i],
        obstacle_coeff=obstacle_coeff, inflation=inflation,
        precision=precision, split=False)
        for i, cp in enumerate(lane_cost_params(cost_params))]
    return (torch.stack([o[0] for o in outs]),
            torch.stack([o[2] for o in outs]), ctx)


def prepare_fused_rng_costs_lanes(model, model_params, cfg, cost_params,
                                  field, state, U, key,
                                  l1_cost: bool = False, k_offset=0,
                                  K_local=None, obstacles=None,
                                  obstacle_coeff: float = 0.0,
                                  inflation: float = 1.0,
                                  precision: Optional[str] = None,
                                  lane_fsc=None):
    """Validate pass 1's lane-form inputs and allocate its outputs, from
    the library of its solo twin.  Returns ``(launch, (costs, crash),
    ctx)`` as :func:`prepare_fused_rng_costs`, ``launch.lanes`` its L;
    ``lane_fsc`` as :func:`prepare_fused_exact_rollout_cost_lanes` takes
    it."""
    _check_kernel_model(model, cfg, 4)
    bf16 = bf16_operands(_precision(cfg, precision))
    ctx = _rng_context(model, cfg, cost_params, field, U, key, k_offset,
                       K_local)
    K, dev = ctx.K, ctx.U.device
    layers = kernel_layers(model)
    kind, buf, fspec = _surface(field)
    if kind == "field":
        _check_field_room(layers, fspec, lanes=True)
    L, args = _lane_inputs(model, model_params, state, ctx.U, K=K)
    T = ctx.U.shape[1]
    args["surface"] = buf
    fsc, isc, ptrs, n_obs, packed = _lane_launch(
        model, cfg, cost_params, field, L, T, K, dev, args, ctx.k_offset,
        l1_cost, _lane_circles(cost_params, obstacles, L), obstacle_coeff,
        inflation, lane_fsc)
    stream_args = _stream_launch_args(ctx)
    costs = torch.empty((L, K), dtype=torch.float32, device=dev)
    crash = torch.empty((L, K), dtype=torch.int32, device=dev)
    entry = (_spec_lib(layers, bf16).artt_fused_rng_costs_lanes
             if kind == "exact" else _field_lib(
                 layers, fspec, bf16).artt_fused_rng_field_costs_lanes)

    def launch():
        err = entry(
            ctypes.addressof(fsc), ctypes.addressof(isc), ptrs["lane_fsc"],
            L, *stream_args, dev.index or 0, ptrs["s0"], ptrs["rngs"],
            ptrs["U"], ctx.key.data_ptr(), ptrs["surface"], ptrs["weights"],
            None if packed is None else packed.data_ptr(), costs.data_ptr(),
            crash.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
        _check_launch(err, f"fused_rng_costs_lanes ({kind})")

    launch.inputs = (args, packed)           # keeps the buffers alive
    launch.geometry = _geometry(K, 1, EXACT_BLOCK if kind == "exact"
                                else field_block(layers))
    launch.mode = kind
    launch.name = ("fused_rng_costs" + ("_field" if kind == "field" else "")
                   + _form(model, n_obs, fspec, bf16) + "_lanes")
    launch.lanes = L
    return launch, (costs, crash), ctx


def fused_rng_costs_lanes(model, model_params, cfg, cost_params, field,
                          state, U, key, l1_cost: bool = False, k_offset=0,
                          K_local=None, obstacles=None,
                          obstacle_coeff: float = 0.0, inflation: float = 1.0,
                          precision: Optional[str] = None, lane_fsc=None):
    """Pass 1 over the L lanes of a stacked ``cost_params`` in one launch
    (the JAX package's vmap of ``fused_rng_costs``): lane l prices
    ``state[l]`` (L, S) and ``U[l]`` (L, T, C) with lane l's coefficients
    and circles (``obstacles`` as :func:`fused_exact_rollout_cost_lanes`
    takes them), every lane on the one stream of ``key`` (the vmap passes
    the controller's key unbatched), so that lane l gives the bits of the
    solo pass run with lane l's inputs.  Counted as the solo instance's
    name with ``_lanes``.  Returns (total (L, K), crash (L, K) int32, ctx),
    ``ctx.U`` (L, T, C) for :func:`fused_rng_numer_lanes`."""
    kw = dict(l1_cost=l1_cost, k_offset=k_offset, K_local=K_local,
              obstacles=obstacles, obstacle_coeff=obstacle_coeff,
              inflation=inflation, precision=precision)
    if _dispatch(U) == "plain":
        return fused_rng_costs_lanes_plain(model, model_params, cfg,
                                           cost_params, field, state, U,
                                           key, **kw)
    launch, (costs, crash), ctx = prepare_fused_rng_costs_lanes(
        model, model_params, cfg, cost_params, field, state, U, key,
        lane_fsc=lane_fsc, **kw)
    launch()
    LAUNCHES[launch.name] += 1
    return costs, crash, ctx


def fused_rng_numer_lanes_plain(ctx: RngContext, w):
    """Plain version of pass 2's lane form: :func:`fused_rng_numer_plain`
    lane by lane, ``ctx.U`` (L, T, C) and ``w`` (L, K), on the stream
    drawn once.  Returns (L, C, T)."""
    eps = rng_noise(ctx)
    return torch.stack([fused_rng_numer_plain(ctx._replace(U=u), w_l, eps)
                        for u, w_l in zip(ctx.U, w)])


def prepare_fused_rng_numer_lanes(ctx: RngContext, w):
    """Validate pass 2's lane-form inputs and allocate its partial sums
    (L, G, C, T).  Returns ``(launch, partials)``; the default float32
    library's kernel runs it for every spec and precision, as the solo
    pass."""
    L, T, C = ctx.U.shape
    dev = w.device
    if w.shape != (L, ctx.K):
        raise ValueError(f"w must be ({L}, {ctx.K}), got {tuple(w.shape)}")
    ptrs = _device_args(dev, U=ctx.U, w=w)
    if ctx.key.device != dev:
        raise ValueError(f"key is on {ctx.key.device}, expected {dev}")
    floats, ints = launch_scalars(ctx.model, ctx.cfg, ctx.k_offset, T, ctx.K)
    fsc = _host_array(ctypes.c_float, floats)
    isc = _host_array(ctypes.c_int, ints)
    stream_args = _stream_launch_args(ctx)
    G = -(-ctx.K // UPDATE_BLOCK)
    partials = torch.empty((L, G, C, T), dtype=torch.float32, device=dev)
    lib = _kernel_lib()

    def launch():
        err = lib.artt_weighted_update_lanes(
            ctypes.addressof(fsc), ctypes.addressof(isc), L, *stream_args,
            dev.index or 0, ptrs["U"], ctx.key.data_ptr(), ptrs["w"],
            partials.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
        _check_launch(err, "fused_rng_numer_lanes")

    launch.inputs = (ctx, w)
    launch.lanes = L
    launch.geometry = _geometry(ctx.K, 1, UPDATE_BLOCK)
    return launch, partials


def fused_rng_numer_lanes(ctx: RngContext, w):
    """Pass 2 over L lanes in one launch: replay pass 1's stream and
    contract it with each lane's softmax weights ``w`` (L, K) and its U
    (``ctx.U`` (L, T, C), :func:`fused_rng_costs_lanes`'s ctx).  Counted
    as ``fused_rng_numer_lanes``.  Each lane's block partials are summed by
    a ``torch.sum`` of their own, as the solo pass sums its (a batched
    reduction may add in another order).  Returns the un-normalised (L, C,
    T) numerators."""
    if _dispatch(w) == "plain":
        return fused_rng_numer_lanes_plain(ctx, w)
    launch, partials = prepare_fused_rng_numer_lanes(ctx, w)
    launch()
    LAUNCHES["fused_rng_numer_lanes"] += 1
    return torch.stack([torch.sum(p, dim=0) for p in partials])


def lane_sums(x: torch.Tensor) -> torch.Tensor:
    """The sum of each lane's row of ``x`` (L, ...), one ``torch.sum`` a
    lane, as a solo solve sums it: a reduction over the last axis of (L,
    K) may add in another order (on the card at L=12, K=1920), and a
    closed loop carries the difference on."""
    return torch.stack([torch.sum(row) for row in x])


def lane_weights(cfg, cost_params, total: torch.Tensor) -> torch.Tensor:
    """The softmax weights ``exp(-gamma (c - min c))`` (L, K) of the lanes'
    costs ``total`` (L, K), each lane at its own gamma (a stacked gamma
    (L,), or the config's), elementwise as a solo solve forms them."""
    baseline = torch.amin(total, dim=-1, keepdim=True)
    gamma = effective_gamma(cfg, cost_params)
    if torch.is_tensor(gamma):
        gamma = gamma.to(total.device)[:, None]
    return torch.exp(-gamma * (total - baseline))


def _rng_iteration_lanes(costs_fn, numer_fn, model, model_params, cfg,
                         cost_params, field, state, U, key, l1_cost,
                         k_offset, precision, kw):
    total, crash, ctx = costs_fn(model, model_params, cfg, cost_params, field,
                                 state, U, key, l1_cost=l1_cost,
                                 k_offset=k_offset, precision=precision, **kw)
    w = lane_weights(cfg, cost_params, total)
    U_new = (numer_fn(ctx, w) / lane_sums(w)[:, None, None]).transpose(1, 2)
    return U_new, total, crash


def fused_rng_solve_iteration_lanes_plain(model, model_params, cfg,
                                          cost_params, field, state, U, key,
                                          l1_cost: bool = False, k_offset=0,
                                          precision: Optional[str] = None,
                                          **obstacle_kw):
    """:func:`fused_rng_solve_iteration_lanes` through the plain versions
    of both lane forms."""
    return _rng_iteration_lanes(fused_rng_costs_lanes_plain,
                                fused_rng_numer_lanes_plain, model,
                                model_params, cfg, cost_params, field, state,
                                U, key, l1_cost, k_offset, precision,
                                obstacle_kw)


def fused_rng_solve_iteration_lanes(model, model_params, cfg, cost_params,
                                    field, state, U, key,
                                    l1_cost: bool = False, k_offset=0,
                                    precision: Optional[str] = None,
                                    lane_fsc=None, **obstacle_kw):
    """One capacity-mode iteration of the L lanes of a stacked
    ``cost_params`` (the JAX package's vmap of
    ``fused_rng_solve_iteration``): pass 1's lane form, each lane's
    softmax weights at its own gamma (:func:`lane_weights`), pass 2's lane
    form; lane l gives the bits of :func:`fused_rng_solve_iteration` run
    with lane l's inputs.  ``lane_fsc`` and ``obstacle_kw`` go to pass 1.
    Returns (U_new (L, T, C), total (L, K), crash (L, K))."""
    if lane_fsc is not None:
        obstacle_kw = dict(obstacle_kw, lane_fsc=lane_fsc)
    return _rng_iteration_lanes(fused_rng_costs_lanes, fused_rng_numer_lanes,
                                model, model_params, cfg, cost_params, field,
                                state, U, key, l1_cost, k_offset, precision,
                                obstacle_kw)
