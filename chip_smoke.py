#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``autorally_tpu_torch``) on one GPU.

Drives the port's main path — BASELINE config #1 (``path_integral_nn``):
the 6-32-32-4 tanh MLP at full width with seeded Glorot weights, K=1920
rollouts, T=100, gaussian exploration, the exact 560 x 800 oval costmap —
the kernel-RNG capacity mode — the same model and map at K=262144
(BASELINE config #5; ``bench.py``'s ``rng_exact_K262144`` and
``rng_exact_ou_K262144``), gaussian and OU (theta 0.15) exploration drawn
inside the kernels — and the neural-field costmap path — the same model on
a 34-64-64-1 field fitted to that map on the card (``bench.py``'s
``neural_K65536`` and ``rng_K262144``) — the basis-function path —
BASELINE config #2 (``path_integral_bf``), the 25-basis-function model with
seeded theta at K=2560 — and the obstacle path — the main path with an
``ObstacleCost`` of 16 slots whose circles move every tick — and the tube
loop — the main path's configuration in ``run_tube_mppi``'s two
controllers with DDP gains — and the closed-loop episode — the same tube
with the tick captured as one CUDA graph — and checks every CUDA kernel of
these paths,
in every form, against its plain PyTorch version.  Phases (any failure
exits non-zero):

1. build the kernels from ``autorally_tpu_torch/csrc/rollout_kernels.cu``
   (one nvcc), require seventeen kernels (kernels A, B, 3 and both modes
   of pass 1 in an MLP and a BF instance each, BF exact pass 1 being
   ``fused_rng_bf_kernel``, pass 2, kernel A in each MLP lane group,
   kernel B one rollout a warp, MLP and BF, and phase 19's check) and zero
   spill bytes in every one
   (ptxas -v); print the four field instances'
   registers, dynamic shared memory and blocks an SM (at least 8 warps),
   and require TF32 tensor-core instructions (HMMA) in their SASS
   (``cuobjdump -sass``);
2. kernel A (fused rollout + exact cost) against its plain version at
   K=1920, T=100 in four cases: nominal start, wide swarm (exploration
   std x4), NaN x coordinate, and a fine random map on which the crash
   flags differ between rollouts (there against the plain cost along
   kernel B's trajectories), and at K=1921 and on a shard's slice
   (k_offset != 0), each in every launch geometry that the launcher picks
   for some K (``launcher_geometries``: one rollout a thread, lane
   groups), every geometry bit for bit equal to the first;
3. kernel B (dynamics chain) against its plain version on the same inputs,
   on a shard's slice and at its main-path shape (the nominal trajectory,
   K=1), each in both of its geometries (``rk.CHAIN_GEOMETRIES``: one
   rollout a thread, one a warp), bit for bit equal to one rollout a
   thread;
4. the main path: one MPPI iteration on the GPU against the same iteration
   on the CPU, then ``MPPISolver`` on ``cuda`` for one untimed solve and
   200 ticks of slide + solve + plant step, with both kernels' launch
   counters reset just before and read just after; the same drive in ten
   pairs whose order alternates, kernel A in one rollout a thread and in
   the launcher's geometry (the same controls), each pair's medians, and
   again for kernel B (one rollout a thread, one a warp); the host time
   that the controller state's key adds to a solve;
5. timing of each kernel at its main-path shape against its plain version
   and its bound, kernel A's launch geometry (G, block, registers, blocks
   an SM, waves), and kernel B in both geometries with its latency floor
   (T times the step's longest dependent chain, counted from its SASS by
   ``tools/sass_chain.py`` at the card's highest SM clock);
6. a torch.profiler trace of 50 ticks: device time by kernel and the
   device's idle share;
7. pass 1 of the capacity mode against its plain version at K=262144,
   T=100, gaussian and OU, in phase 2's four cases, and at K=262143 and on
   a shard's slice (one rollout a thread); its in-kernel stream
   must equal the plain stream bit for bit (pass 1 equals kernel A fed the
   plain stream); and two models with different weights whose launches
   alternate on one stream, each bit for bit kernel A with its own weights
   and held against its own plain versions;
8. pass 2 against its plain version with pass 1's softmax weights, the
   same with three warps of every four zeroed (sparse) and all 1 (dense),
   with a NaN in U (NaN where the plain version has it, and every other
   partial bit for bit the run's without the NaN), and one-hot weights
   that extract single rollouts' controls;
9. the capacity path: one iteration on the GPU against the CPU at
   K=16384, then 100 ticks of ``drive_oval.drive`` on a capacity-mode
   solver at K=262144 for each sampler, launch counters reset before and
   read after each (1 pass 1, 1 pass 2, 1 kernel B and no kernel A per
   solve), then one more, untimed tick whose pass-2 inputs are held
   against the plain version;
10. timing of both passes at K=262144 against their plain versions and
    bounds (with pass 1's launch geometry; the integer-pipe and issue
    floors of a step of their stream loop in the SASS printed beside,
    with the step's FCHK, MUFU.RCP, BSSY and BSYNC), BF exact pass 1
    gaussian and OU with its registers, warps an SM, waves and floors
    (outside forward branches and over the whole loop body),
    pass 2 on the nominal weights, the closed loop's tick's and dense
    ones, each with its share of all-zero warps, of kernel A at the same
    K, and
    of whole solves at K=262144 in
    the capacity and the host-noise modes; a torch.profiler trace of 20
    capacity-mode ticks;
11. the field: ``drive_oval.build(neural_costmap=True)`` fits it on the
    card with ``fit_neural_costmap``'s defaults (seconds, mae, flip rate);
    kernel 3 (fused rollout + field cost) against its plain version at
    K=65536, T=100 in four cases: nominal, wide swarm, NaN x, and a
    seeded random field whose values cross the 0.65 boundary (costs
    rtol 1e-4 / atol 1e-3 and crash flags equal in every rollout in the
    nominal case, in all but 1 % elsewhere; u_seq exactly), and the
    nominal case at K=65536-19;
12. pass 1 in field mode against its plain version at K=262144, the same
    cases, gaussian and OU, at K=262144-13 and on a shard's slice
    (``SHARD``: k_offset != 0), each bit for bit against kernel 3 fed the
    plain stream;
13. the field path closed-loop: 100 ticks at K=65536 in the host-noise
    mode and 50 ticks at K=262144 in the capacity mode, launch counters
    reset before and read after each (1 kernel 3 and 1 kernel B per
    host-noise solve; 1 field pass 1, 1 pass 2 and 1 kernel B per capacity
    solve; nothing else), and no plain version called;
14. timing of kernel 3 and of pass 1's field mode against their plain
    versions and two bounds (the tensor cores' for the field's hidden
    layers, and all fp32 on the CUDA cores), beside kernel A and exact
    pass 1 at the same K;
    whole field solves; torch.profiler traces of 10 ticks of each mode;
15. the BF instances of kernels A and B against their plain versions at
    K=2560 in phase 2's cases (kernel A also at K=2561 and on a shard's
    slice, in each of its launch geometries; kernel B in both of its
    geometries, bit for bit) and at the nominal trajectory (K=1), with
    the seeded theta and with a strong theta whose slip and tan rows are
    scaled by their denominators (dropping any of those rows must move the
    plain chain's states by more than 5 x the tolerance);
16. the BF path: one iteration on the GPU against the CPU, then 200 ticks
    of ``drive_oval.build(model="bf")`` (1 BF kernel A and 1 BF kernel B
    per solve, nothing else, no plain version), then one more, untimed
    tick whose inputs of BF kernel A phase 18 times;
17. the obstacle forms: two circles in 16 slots placed so that some
    rollouts hit them and some do not, kernel A (K=1920), kernel 3
    (K=65536) and pass 1 on both surfaces (K=262144) against their plain
    versions (the exact-map forms in every launch geometry), and the BF
    forms of kernel 3 and pass 1 with the strong theta; BF exact pass 1
    without circles, seeded and strong theta, gaussian and OU, at
    K=262144, at K=262144-13 and on a shard's slice; pass 1 bit for bit
    the eps-reading kernel fed the plain stream;
    the field obstacle forms also at K=65536-19 and on a shard's slice;
18. the obstacle path: a live ``CostParams.obstacles`` reaching the kernel,
    200 ticks with the circles moved every tick (1 obstacle kernel A and 1
    kernel B per solve), 20 ticks of each other BF and obstacle form,
    every form's timing against its plain version and bound (BF kernel B
    in both geometries, with its latency floor; BF kernel A on random
    noise and on phase 16's tick; BF exact pass 1 also OU), the MLP
    kernels without obstacles re-timed in the same run, and a 50-tick
    torch.profiler trace of the BF path;
19. BF exact pass 1's branch-free arithmetic, on every input: its
    quotients by the 16 constant divisors (``div_const`` with its guard)
    against IEEE division for all 2^32 float32 bit patterns, and its
    stream's quotient and square root against ``__fdiv_rn`` and
    ``__fsqrt_rn`` for all 2^23 uniforms the stream forms; 0 mismatches,
    the seconds printed;
20. the tube loop (``run_tube_mppi``: two controllers at K=1920 solving
    every tick, DDP gains on, a lockstep ``SyntheticPlant`` at 50 Hz):
    (a) the DDP on a warmed-up tick's inputs, captured bit for bit the
    eager run and within DDP_CPU_REL of the port's CPU run, timed captured,
    eager and as two overlapped runs, the eager run's launches counted by
    the profiler; (b) 200 ticks with exactly 2 launches of kernels A and B
    a tick, no plain-version call, finite controls, the car accelerating
    and moving, status 0, the arbitration's outcomes and the tick's p50 /
    p99 split into the solves, the DDP runs, the plant step and the rest;
    (c) a weight push (the next solve bit for bit a fresh solver's on the
    new weights, the next DDP run an eager run's on them), a cost push
    reaching both controllers and a throttle cut zeroing the DDP's
    throttle limit, mid-run; (d) 20 ticks with the BF model (K=2560), its
    DDP captured bit for bit its eager run, a captured run's graph nodes
    (device events) and time with the fused BF Euler step, then 200 BF
    ticks; each drive also prints Python's collections inside it;
21. the closed-loop episode (``runtime/episode.py``'s ``EpisodeRunner``,
    the tick captured once as one CUDA graph and replayed) at the main
    path's width on the oval of ``tools/lap_eval.load_track("oval")``:
    (a) 50 ticks with DDP gains, two plant substeps a tick and an ESS
    target, captured against the same ticks run eagerly on the card, every
    ``EpisodeResult`` field bit for bit; again with another desired speed
    (captured anew, other states: no stale graph) and with other seeds (the
    same graph); (b) 10 replayed ticks under the profiler: exactly 2
    launches of kernel 1 and 2 of kernel 2 a tick, no plain-version call;
    (c) 20 ticks each, captured bit for bit eager and finite: moving
    obstacles (16 slots), the capacity mode (K=262144), the asymmetric
    tube (K_pred=480); (d) the capture's seconds, ms a replayed tick (CUDA
    events), ticks/s and sim-seconds a wall-second and ``episode_metrics``
    for 1,000 ticks without gains, 200 with, and the BF model at K=2560
    with gains (200 ticks); (e) ``tools/lap_suite.run_config`` on an oval
    and a winding row, 500 ticks, the artifact checked by
    ``validate_laps``'s rules (the winding track allowed);
22. the async loop (``runtime/async_loop.py`` through ``run_tube_mppi``'s
    ``--async-loop`` path: both controllers one dispatched tick, captured
    once as one CUDA graph, DDP gains on, a lockstep ``SyntheticPlant``):
    (a) 50 dispatches of a captured tube bit for bit an eager one's, the
    strides 0, 1, 2 and T-1 mixed and a cost push at tick 25 (one more
    capture); (b) 10 replayed dispatches under the profiler: exactly 2 + 2
    kernel launches a tick, the graph's nodes; (c)-(e) 200 ticks at depth
    1 and 2 with ``EssTuner.attach_async`` moving gamma every harvest: the
    solution published exactly ``depth`` dispatches late, one capture in
    all, the host's dispatch ms, the harvest's wait, each dispatch's device
    span (CUDA events), and at depth 1 the device's busy share of the
    period over 20 ticks under ``runtime/profiling.device_trace``;
23. the realtime gates (``runtime/realtime_gate.py``; the simulator
    ``tools/sim_node.py --cpu`` a second process on seeded weights, UDP
    over loopback, the native pacer): the sequential loop at K=64, T=16
    and the async loop at K=1920, T=100, depth 2 adaptive, both with
    gains, 3 s passes, at most 3 attempts; each must pace natively, reach
    100 valid ticks, p99 under 20 ms, missed 0, missed_raw 0 (or at most
    the tainted ticks + 2 when some were tainted) and capture nothing in
    the measured passes; the sequential loop's kernel launches counted.

Prints the card's name and power limit, one ``{"kernels": [...]}`` line
(each kernel with its CUDA instance and its geometry or design, every
compiled instance with its registers, the paths' latencies, the tube's and
the BF tube's tick p50 / p99, the BF DDP run's nodes, the episode's
launches and timings, the async tick's launches and timings and both
gates' results), and as its last line
``{"ok": true, "device": {...}}``.  Needs one CUDA
GPU; exits non-zero without one, or without the package beside it.

Usage::

    python3 chip_smoke.py
"""

import dataclasses
import gc
import json
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet; dense, at the 700 W limit).
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOP_PER_S = 67e12
PEAK_TF32_FLOP_PER_S = 495e12         # tensor cores, dense

K, T = 1920, 100
TICKS = 200
# phase 4's drives of kernel A in the old and the new geometry, in pairs
# whose order alternates (ten, so that a gain can be told from the spread)
TURN_PAIRS = 10
PROFILE_TICKS = 50
COST_RTOL, COST_ATOL = 1e-4, 1e-3     # 100 fp32 steps, other summation order
STATE_RTOL, STATE_ATOL = 1e-4, 1e-3
ITER_ATOL = 1e-3                      # U_new of one iteration, GPU vs CPU
# rollouts whose cost may differ from the whole plain version on the 2 cm
# random map, where a rounding-level change of position moves a texel
MAX_RANDOM_MAP_DIFFER = K // 100

# The capacity mode (kernel_rng=True).
KC = 262144
K_ITER_CHECK = 16384                  # GPU vs CPU iteration
CAP_TICKS = 100
CAP_PROFILE_TICKS = 20
SAMPLERS = {"gaussian": {}, "ou": dict(noise_sampler="ou", noise_param=0.15)}
KEY = (0x2545F491, 0x9E3779B9)
# pass 2 against its plain version, relative to sum_k |w_k u_{k,t,c}|:
# fp32 sums of 262144 terms in another order (a shuffle tree per block,
# then the blocks, against cuBLAS's gemv)
NUMER_RTOL = 1e-5
ONEHOT_ATOL = 1e-5
# Operations of the in-kernel stream per rollout-step, counted in
# csrc/rollout_kernels.cu: Threefry-2x32-20 79 (key schedule 4, 20 rounds
# of add, funnel shift and xor, 5 key injections of 3), uniforms 5, log
# 29, square root 2, sine and cosine 31, Box-Muller products 2; the OU
# recursion adds 6.  Integer operations are counted at the fp32 rate, the
# higher of the two (Hopper has 64 INT32 to 128 FP32 lanes per SM), which
# keeps the bound a lower bound.
STREAM_OPS, OU_OPS = 148, 6
# pass 2 per rollout-step: the perturbation (2 mul, 2 add), w u (2 mul),
# the reduction (2 add)
UPDATE_OPS = 8

# The neural-field path (bench.py's neural_K65536 and rng_K262144): kernel 3
# in the host-noise mode at K=65536, pass 1's field mode at K=262144; a
# shard's slice of pass 1, (k_offset, K_local): neither a multiple of 32.
KF = 65536
SHARD = (KC // 2 - 69, KC - (KC // 2 - 69) - 7)
FIELD_TICKS = 100
FIELD_CAP_TICKS = 50
FIELD_PROFILE_TICKS = 10

# The basis-function path: BASELINE config #2 (path_integral_bf), the
# 25-basis-function model with seeded theta at K=2560 (bench.py's
# bf_K2560); the obstacle path: the main path's configuration with an
# ObstacleCost of 16 slots, two circles active, moved every tick.
KB = 2560
BF_TICKS = 200
OBS_TICKS = 200
BF_PROFILE_TICKS = 50
FORM_TICKS = 20                       # each other BF and obstacle form
N_SLOTS = 16
# Operations counted in csrc/rollout_kernels.cu: one BF step is the 25
# basis functions (60, atan, tan and sin one each), theta^T phi (100
# multiply-adds) and the Euler update (14); one active circle per cost step
# 13 (2 differences, 2 squares, a sum, the root, the margin, the quotient,
# 1 - q, the clip's 2 compares, the max, the hit compare), an inactive slot
# 1, and the coefficient's product 1.
BF_STEP_OPS = 60 + 2 * 100 + 14
CIRCLE_OPS, SLOT_OPS = 13, 1
# The seeded theta (std 0.01) moves the states by 1e-5 or less through the
# slip and tan rows 2-4 and 9-15, whose denominators reach 2.7e9: far under
# the tolerance, so a wrong tan branch, moving test or dropped row there
# would pass.  The strong theta scales those rows by their denominators
# (14 and 15, whose r13 is small, by 30x and 300x more) and every row by 10:
# then dropping any one of them moves some case's states by more than
# 5 x STATE_ATOL (checked on the plain chain), and the chain stays finite
# from the starts it is held on.
BF_SUSPECT_ROWS = {2: 1200.0, 3: 1.44e6, 4: 1.728e9, 9: 40.0, 10: 1400.0,
                   11: 1.96e6, 12: 2.744e9, 13: 40.0, 14: 4.8e4, 15: 1.92e7}
BF_ROW_SCALE = 10.0 * np.array([BF_SUSPECT_ROWS.get(i, 1.0)
                                for i in range(25)], np.float32)


# The tube loop (phase 20): BASELINE #1 in run_tube_mppi's loop, both
# controllers at K=1920, DDP gains on, a lockstep SyntheticPlant at 50 Hz.
TUBE_TICKS = 200
WARM_TICKS = 10                       # (a)'s inputs: a warmed-up tick's
HOT_TICKS = 12                        # (c): pushes at tick 10, cut at 11
TUBE_BF_TICKS = 20
# (d) again for a p99 that is not the slowest of 20 ticks
TUBE_BF_LONG_TICKS = 200
DDP_REPS, DDP_EAGER_REPS = 50, 5
# the DDP on the card against the port's CPU run on the same inputs, each
# field's max |error| over its max |value|: fp32 rollouts of 100 steps and
# a 99-step recursion whose sums cuBLAS and the CPU's BLAS order apart
DDP_CPU_REL = 1e-3
# The car accelerates from rest: u_x over 0.5 m/s after TUBE_TICKS ticks.
# tests/test_runtime.py holds the loop to 1.5 m/s with the reference
# weights, which the repository does not hold; the seeded MLP (Glorot,
# seed 0) is weaker: the same loop reaches 1.13 m/s in 200 ticks on the
# plain path (run_tube_mppi --cpu --ticks 200) and 0.868 on the card
TUBE_MIN_SPEED = 0.5

# The closed-loop episode (phase 21): BASELINE #1 (the MLP, seeded Glorot
# weights, K=1920, T=100) as runtime/episode.py's EpisodeRunner on the 60 m
# x 36 m oval of tools/lap_eval.load_track("oval"), the tick one CUDA graph.
EP_BIT_TICKS = 50                     # (a) captured against eager
EP_PROFILE_TICKS = 10                 # (b) launches counted by the profiler
EP_SHORT_TICKS = 20                   # (c) obstacles, capacity, asymmetric
EP_K_PRED = 480
EP_TICKS, EP_GAIN_TICKS, EP_BF_TICKS = 1000, 200, 200     # (d) timing
EP_LAP_TICKS = 500                    # (e) the lap suite's run_config
EP_LAP_ROWS = (
    {"name": "oval_nn_gaussian", "track": "oval", "K": K, "T": T,
     "desired_speed": 6.0, "noise": "gaussian"},
    {"name": "winding_nn_gaussian", "track": "winding", "K": K, "T": T,
     "desired_speed": 6.0, "noise": "gaussian"})

# The async loop (phase 22): BASELINE #1 in run_tube_mppi's async loop, the
# tick one CUDA graph, gains on, a lockstep SyntheticPlant at 50 Hz.
ASYNC_BIT_TICKS = 50                  # (a) captured against eager
ASYNC_PUSH_AT = 25                    # (a) a cost push: one more capture
ASYNC_PROFILE_TICKS = 10              # (b) launches counted by the profiler
ASYNC_TICKS = 200                     # (c)-(e) at depth 1 and 2
ASYNC_TRACE_TICKS = 20                # (e) under device_trace
# The realtime gates (phase 23): 3 s passes, at most 3 attempts each.
GATE_SECONDS, GATE_ATTEMPTS = 3.0, 3
GATE_WARMUP = 8                       # the sequential gate's warm-up ticks

# registers of each kernel instance, from the build's ptxas report; the
# library's SASS (phase 1)
PTXAS = {}
SASS = []


class PhaseFailed(Exception):
    pass


def agreement(tag, name, kc, kx, pc, px, n, limit=None):
    """Costs within COST_RTOL/COST_ATOL and equal crash flags: in every
    rollout in the nominal case, in all but 1 % elsewhere (a value within
    rounding of a boundary, a texel edge or a circle can latch on one side
    only; near tan's pole the BF model turns a rounding difference into a
    large one), or in all but ``limit``.  Returns the max cost error over
    rollouts with equal flags."""
    import torch

    same = kx == px
    near = torch.isclose(kc, pc, rtol=COST_RTOL, atol=COST_ATOL)
    n_differ = int((~near | ~same).sum().item())
    n_crash = int((~same).sum().item())
    err = (kc - pc)[same].abs().max().item()
    if limit is None:
        limit = 0 if name == "nominal" else n // 100
    print(f"[{tag}] {name}: max|cost err| {err:.3e} over rollouts with "
          f"equal crash flags (cost range {pc.min().item():.4g}.."
          f"{pc.max().item():.4g}), crash {int(px.sum().item())}/{n}, "
          f"crash mismatches {n_crash}, {n_differ} rollouts differ "
          f"(limit {limit})")
    check(torch.isfinite(kc).all().item(), f"{tag} {name}: non-finite")
    check(n_differ <= limit, f"{tag} {name}: {n_differ} rollouts differ "
          f"from the plain version, limit {limit}")
    if name.startswith("random"):
        check(0 < px.sum().item() < n, f"{tag} {name}: crash flags do not "
              "differ between rollouts")
    return err


def check(ok, msg):
    if not ok:
        raise PhaseFailed(msg)


def launcher_geometries(rk, bf: bool, k_max: int = KC) -> list:
    """Every geometry (G, block) of kernel 1 that the launcher
    (``rk.exact_geometry``) picks on this card for some K in
    1..k_max, the one at K=1920 (BF: K=2560) first."""
    import torch

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    first = rk.exact_geometry(KB if bf else K, sms, bf)[:2]
    picked = {rk.exact_geometry(k, sms, bf)[:2] for k in range(1, k_max + 1)}
    return [first] + sorted(picked - {first})


def bit_equal(a, b) -> bool:
    """Equal bit for bit: float32 tensors compared as their int32 bits, so
    that a NaN (a state of the NaN-x case) equals the same NaN."""
    import torch

    if a.dtype == b.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def geometry_label(geom) -> str:
    return "G%d block %d" % tuple(geom[:2])


def hold_geometries(tag, geoms, run, check_one, chain: bool = False):
    """``run()`` under each forced geometry in ``geoms`` (of kernel 1, or
    of kernel 2 when ``chain``): ``check_one(label, outputs)`` on each, and
    every geometry's outputs bit for bit equal to the first's (lane groups
    and warps evaluate the same arithmetic as one rollout a thread).
    Returns the first geometry's outputs."""
    import torch
    from autorally_tpu_torch.tools.exact_variants import (
        forced_chain_geometry, forced_geometry)

    force = forced_chain_geometry if chain else forced_geometry
    first = None
    for geom in geoms:
        label = geometry_label(geom)
        with force(*geom):
            out = run()
        torch.cuda.synchronize()
        check_one(label, out)
        if first is None:
            first = out
            continue
        same = all(bit_equal(a, b) for a, b in zip(out, first)
                   if torch.is_tensor(a))
        print(f"[{tag}] {label}: bit equal to {geometry_label(geoms[0])}: "
              f"{same}")
        check(same, f"{tag} {label}: differs from "
              f"{geometry_label(geoms[0])}")
    return first


def exact_instance(geom, rng: bool, bf: bool) -> str:
    """The CUDA instance of kernel 1 (exact pass 1 when ``rng``) that
    ``geom`` launches, by its short name."""
    if geom.group > 1:
        return f"fused_exact_group_kernel<{geom.group}>"
    if rng and bf:
        return "fused_rng_bf_kernel"
    return (f"{'fused_rng' if rng else 'fused_exact'}_kernel"
            f"<{'Bf' if bf else 'Mlp'}>")


def geometry_line(rk, tag, launch, rng: bool, bf: bool, card):
    """Prints the geometry of a launch of kernel 1 or exact pass 1: G,
    block, grid, registers (ptxas and the runtime), resident blocks an SM
    and waves (one rollout a thread: R = 1 always)."""
    g = launch.geometry
    info = rk.exact_kernel_info(rng, bf, g, T, 0)
    kern = exact_instance(g, rng, bf)
    print(f"[{tag}] geometry {geometry_label(g)}, grid {g.grid}: {kern}, "
          f"{PTXAS.get(kern, '?')} registers (ptxas), {info['registers']} "
          f"(runtime), {info['local_bytes']} bytes of local memory, "
          f"{info['blocks_per_sm']} blocks "
          f"({info['blocks_per_sm'] * g.block // 32} warps) an SM, "
          f"{info['waves']:.2f} waves ({card})")


def drive_turns(drive_oval, what, chain, old, new, solver, params,
                cost_params, costmap, controls, card) -> list:
    """The main path's drive with ``what`` (kernel 1, or kernel 2 when
    ``chain``) forced into geometry ``old`` and ``new`` in TURN_PAIRS pairs
    whose order alternates (old then new, new then old, ...), each drive's
    controls equal to ``controls``: each pair's p50 and p99 and the p50's
    gain, and a summary line."""
    from autorally_tpu_torch.tools.exact_variants import (
        forced_chain_geometry, forced_geometry)

    force = forced_chain_geometry if chain else forced_geometry
    turns = []
    for i in range(TURN_PAIRS):
        pair = {}
        for geom in ((old, new) if i % 2 == 0 else (new, old)):
            with force(*geom):
                o = drive_oval.drive(solver, params, cost_params, costmap,
                                     TICKS, log=lambda m: None)
            check(np.array_equal(o["controls"], controls),
                  f"main path with {what} in {geometry_label(geom)}: other "
                  "controls")
            pair["old" if geom == old else "new"] = (
                float(np.percentile(o["solve_ms"], 50)),
                float(np.percentile(o["solve_ms"], 99)))
        pair["first"] = "old" if i % 2 == 0 else "new"
        pair["gain_p50"] = pair["old"][0] - pair["new"][0]
        turns.append(pair)
        print(f"[main path] {what} pair {i} ({pair['first']} first), the "
              f"same controls: in {geometry_label(old)} p50 "
              f"{pair['old'][0]:.3f} p99 {pair['old'][1]:.3f} ms, in "
              f"{geometry_label(new)} p50 {pair['new'][0]:.3f} p99 "
              f"{pair['new'][1]:.3f} ms, p50 gain {pair['gain_p50']:.3f} ms")
    gains = [p["gain_p50"] for p in turns]
    q = {g: np.percentile([p[g][0] for p in turns], [25, 50, 75])
         for g in ("old", "new")}
    print(f"[main path] {what}: p50 gain of {geometry_label(new)} over "
          f"{geometry_label(old)} over {TURN_PAIRS} pairs: median "
          f"{statistics.median(gains):.3f} ms, range {min(gains):.3f}.."
          f"{max(gains):.3f} ms, won {sum(g > 0 for g in gains)} of "
          f"{TURN_PAIRS}; the drives' p50 median {q['old'][1]:.3f} against "
          f"{q['new'][1]:.3f} ms, quartile spread "
          f"{q['old'][2] - q['old'][0]:.3f} against "
          f"{q['new'][2] - q['new'][0]:.3f} ms ({TICKS} ticks a drive; "
          f"{card})")
    return turns


def chain_timing(rk, tag, model, params, cfg, start, U, eps, bf, reps,
                 card) -> dict:
    """Kernel 2 at ``eps``'s K in the launcher's geometry and in one rollout
    a thread (CUDA events), and its latency floor in the launcher's
    geometry (``chain_floor``): {ms, geometry, one_thread_ms, floor_ms}."""
    from autorally_tpu_torch.tools.exact_variants import forced_chain_geometry

    launch, _ = rk.prepare_dynamics_chain(model, params, cfg, start, U, eps)
    with forced_chain_geometry(*rk.CHAIN_GEOMETRIES[0]):
        one, _ = rk.prepare_dynamics_chain(model, params, cfg, start, U, eps)
    ms, ms_one = cuda_ms(launch, reps), cuda_ms(one, reps)
    floor = chain_floor(SASS[0], bf, launch.geometry, max_sm_clock_mhz())
    print(f"[timing] {tag} K={eps.shape[1]} in {geometry_label(launch.geometry)}"
          f": {ms:.4f} ms; in one rollout a thread {ms_one:.4f} ms; latency "
          f"floor {floor['ms']:.4f} ms: the step's longest dependent chain "
          f"{floor['cycles']} clocks ({floor['chain']} instructions on it; "
          f"{floor['in_order']} clocks in issue order; {floor['body']} "
          f"instructions a step, {floor['skipped']} behind forward branches "
          f"left out) x T={T} at {floor['clock_mhz']:.0f} MHz (clocks.max.sm)"
          f", a floor for a dependent chain at assumed latencies, not a "
          f"roofline ({card})")
    return {"ms": ms, "geometry": launch.geometry, "one_thread_ms": ms_one,
            "floor_ms": floor["ms"]}


def chain_entry(chain: dict) -> dict:
    """Kernel 2's own keys in the ``kernels`` line."""
    return {"geometry": geometry_label(chain["geometry"]),
            "one_thread_ms": chain["one_thread_ms"]}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise PhaseFailed(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 3) -> float:
    """Median device time of ``fn`` in ms over ``reps`` runs (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def mlp_flops(layers) -> int:
    """fp32 operations of one rollout-step: MLP multiply-adds and bias adds,
    plus the 7-component Euler update."""
    return sum(2 * a * b + b for a, b in zip(layers[:-1], layers[1:])) + 14


def field_eval_ops(layers, num_freqs: int) -> int:
    """Operations of one field evaluation: the MLP's multiply-adds and bias
    adds, the transform (6 products, 6 sums, 2 quotients), the 2F angle
    products and the 4F sines and cosines, each counted as one operation
    (which keeps the bound a lower bound)."""
    return (sum(2 * a * b + b for a, b in zip(layers[:-1], layers[1:]))
            + 14 + 6 * num_freqs)


def bound(nbytes: float, flops: float, tf32_flops: float = 0.0):
    """The least time for ``nbytes`` at the memory rate, ``flops`` at the
    fp32 rate and ``tf32_flops`` on the tensor cores: (ms, what bounds it)."""
    t_b = nbytes / PEAK_BYTES_PER_S * 1e3
    t_f = max(flops / PEAK_FP32_FLOP_PER_S,
              tf32_flops / PEAK_TF32_FLOP_PER_S) * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def field_bounds(nbytes: float, other_ops: float, n_evals: float, field):
    """A field kernel's two bounds, each (ms, what bounds it): the fp32 one
    (every operation on the CUDA cores) and the tensor-core one, in which
    the two hidden layers' products as the function has them (34 features;
    the kernels' zero padding to 40 is their own overhead, not the
    function's work), tripled by 3xTF32, run at the TF32 rate and the rest
    of the field's operations (``field_eval_ops`` less the products) and
    ``other_ops`` at the fp32 rate."""
    layers, n_freqs = field.layers, field.freqs.numel()
    ops = field_eval_ops(layers, n_freqs)
    products = 2 * sum(a * b for a, b in zip(layers[:-2], layers[1:-1]))
    return (bound(nbytes, other_ops + n_evals * ops),
            bound(nbytes, other_ops + n_evals * (ops - products),
                  n_evals * 3 * products))


def library_sass() -> str:
    """``cuobjdump -sass`` of the built kernel library."""
    from autorally_tpu_torch.ops import _build

    objdump = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    out = subprocess.run([objdump, "-sass", str(_build.library_path())],
                         capture_output=True, text=True, timeout=300)
    if out.returncode != 0:
        raise PhaseFailed(f"cuobjdump failed: {out.stderr.strip()}")
    return out.stdout


def check_field_sass(sass: str) -> dict:
    """The TF32 tensor-core instructions (HMMA ... TF32) in the SASS of each
    field kernel instance of the built library."""
    found = {}
    for fn in re.split(r"\n\s*Function : ", sass)[1:]:
        short = re.search(r"\d+((?:fused_rng_field|fused_field)_kernel)I.*?"
                          r"(Mlp|Bf)Deriv", fn.split("\n", 1)[0])
        if short:
            found[f"{short.group(1)}<{short.group(2)}>"] = sum(
                1 for line in fn.splitlines()
                if "HMMA" in line and "TF32" in line)
    return found


def max_sm_clock_mhz() -> float:
    """The card's highest SM clock (``nvidia-smi clocks.max.sm``), MHz."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        raise PhaseFailed(f"nvidia-smi failed: {out.stderr.strip()}")
    return float(out.stdout.strip().splitlines()[0])


def chain_floor(sass: str, bf: bool, geom, clock_mhz: float) -> dict:
    """Kernel 2's latency floor in ``geom``: T times the longest dependent
    chain of a step of its time loop, counted from its SASS at assumed
    latencies (``tools/sass_chain.py``), at ``clock_mhz``; the loop's body
    must hold one step's stores (the warp's one store instruction, or the
    thread's 7 states and 2 controls).  A floor for a dependent chain, not
    a roofline and not a measurement."""
    from autorally_tpu_torch.ops.rollout_kernel import CHAIN_OUTPUTS
    from autorally_tpu_torch.tools import sass_chain

    warp = geom.group > 1
    name = "dynamics_chain_warp_kernel" if warp else "dynamics_chain_kernel"
    chain = sass_chain.loop_chain(sass_chain.instructions(
        sass, rf"\d{name}I\w*?{'Bf' if bf else 'Mlp'}Deriv"),
        stores=1 if warp else CHAIN_OUTPUTS)
    chain["ms"] = T * chain["cycles"] / (clock_mhz * 1e3)
    chain["clock_mhz"] = clock_mhz
    return chain


def stream_mix(sass: str) -> dict:
    """A step of the stream loop of exact pass 1 (MLP and BF) and of pass 2
    in the built library's SASS, by pipe, with its IEEE divisions' and
    branches' marks (``tools/sass_chain.loop_mix``)."""
    from autorally_tpu_torch.tools import sass_chain

    return {name: sass_chain.loop_mix(sass_chain.instructions(sass, regex))
            for name, regex in (
                ("pass1_mlp", r"\dfused_rng_kernelI\w*?MlpDeriv"),
                ("pass1_bf", r"\dfused_rng_bf_kernel"),
                ("pass2", r"\dweighted_update_kernel"))}



def ptxas_report(log: str):
    """(kernel, registers, spill store + load bytes) for each entry
    function in ``ptxas -v`` output."""
    rows, name, spill = [], None, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            short = re.search(r"\d+([a-z_]+_kernel)(?:E|ILi(\d+)E|I.*?"
                              r"(Mlp|Bf)Deriv|IJ)", m.group(1))
            arg = short and (short.group(2) or short.group(3))
            name = (short.group(1) + (f"<{arg}>" if arg else "") if short
                    else m.group(1))
            spill = None
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and name is not None:
            rows.append((name, int(m.group(1)), spill))
            name = None
    return rows


def next_tick_args(rk, name, solver, params, cost_params, costmap, out):
    """The arguments (args, kwargs) with which one more tick after a drive
    (``out``: ``drive_oval.drive``'s result) calls ``rk.<name>``: the
    inputs that the closed loop sends that function, taken with it wrapped
    (``tools/ab_builds.last_call``) outside the drive's timed ticks."""
    from autorally_tpu_torch.tools.ab_builds import last_call

    with last_call(rk, name) as got:
        cs = solver.slide(out["control_state"],
                          solver.cfg.optimization_stride)
        solver.solve(params, cost_params, costmap, out["state"], cs)
    return got["args"]


def random_costmap(device):
    """A 10 m x 10 m map beside the start, 2 cm texels, channel 0 uniform
    in [0, 0.66) from seed 0, cleared within 0.7 m of y = 0 so that the
    rollouts' first, shared, steps do not all cross the 0.65 boundary."""
    from autorally_tpu_torch.costs import make_costmap

    n, ppm = 500, 50.0
    data = np.zeros((n, n, 4), np.float32)
    data[..., 0] = np.random.default_rng(0).uniform(0, 0.66, (n, n))
    ys = -5.0 + (np.arange(n) + 0.5) / ppm
    data[np.abs(ys) < 0.7, :, 0] = 0.0
    return make_costmap(data, (25.0, 35.0), (-5.0, 5.0), device=device)


def profile_ticks(drive_oval, solver, params, cost_params, costmap, card,
                  ticks: int = PROFILE_TICKS, tag: str = "profile") -> None:
    """Device time by kernel over ``ticks`` ticks of ``solver``'s path
    (torch.profiler, CUPTI) and the device's busy share of their wall
    time, profiler overhead included; lines start with ``[tag]``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        drive_oval.drive(solver, params, cost_params, costmap, ticks,
                         log=lambda m: None)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue                 # host ops: their kernels are rows too
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0))
        if us > 0:
            rows.append((us / 1e3, e.count, e.key))
    if not rows:
        print(f"[{tag}] device time not measured: the profiler recorded "
              f"no device events ({card})")
        return
    busy = sum(r[0] for r in rows)
    print(f"[{tag}] {ticks} ticks (+1 first solve): wall {wall_ms:.3f} ms, "
          f"device busy {busy:.3f} ms ({100 * busy / wall_ms:.1f}%, idle "
          f"{100 - 100 * busy / wall_ms:.1f}%) ({card})")
    for ms, n, key in sorted(rows, reverse=True)[:8]:
        print(f"[{tag}]   {ms / (ticks + 1):8.4f} ms/tick  x{n:<5d} "
              f"{key[:90]}")


def capacity_phases(drive_oval, solver, params, cost_params, costmap, cases,
                    U, start, cpu, card):
    """Phases 7-10: the kernel-RNG capacity mode at K=262144.  Returns the
    two passes' ``kernels`` entries and the capacity solves' latencies."""
    import torch
    from autorally_tpu_torch.config import effective_gamma
    from autorally_tpu_torch.ops import rollout_kernel as rk
    from autorally_tpu_torch.solver.mppi import MPPISolver
    from autorally_tpu_torch.tools import sass_chain
    from autorally_tpu_torch.tools.ab_builds import zero_warp_share

    cfg, model = solver.cfg, solver.model
    dev = U.device
    key = torch.tensor(KEY, dtype=torch.int64, device=dev)
    cap_cfg = {s: cfg.replace(num_rollouts=KC, kernel_rng=True, **kw)
               for s, kw in SAMPLERS.items()}

    # -- phase 7: pass 1 against its plain version ---------------------------
    # The in-kernel stream is the plain stream bit for bit, so pass 1 must
    # equal kernel A fed the plain stream (the same step body); against the
    # whole plain version it differs by the MLP's summation order, and on
    # the random map it is held, as kernel A is, against the plain cost
    # along kernel B's trajectories on that stream.
    err_p1, nominal = 0.0, {}
    for sname, ccfg0 in cap_cfg.items():
        for name, (ccfg, s0, cmap) in cases.items():
            c = ccfg0.replace(steering_std=ccfg.steering_std,
                              throttle_std=ccfg.throttle_std)
            kc, kx, ctx = rk.fused_rng_costs(model, params, c, cost_params,
                                             cmap, s0, U, key)
            pc, px, _ = rk.fused_rng_costs_plain(model, params, c,
                                                 cost_params, cmap, s0, U,
                                                 key)
            eps = rk.rng_noise(ctx)
            ac, _, ax = rk.fused_exact_rollout_cost(model, params, c,
                                                    cost_params, cmap, s0, U,
                                                    eps)
            torch.cuda.synchronize()
            same_as_a = torch.equal(kc, ac) and torch.equal(kx, ax)
            near = torch.isclose(kc, pc, rtol=COST_RTOL, atol=COST_ATOL)
            n_differ = int((~near | (kx != px)).sum().item())
            note = ""
            if name == "random_map":
                check(n_differ <= KC // 100, f"pass 1 {sname} random_map: "
                      f"{n_differ} rollouts differ from the plain version, "
                      f"more than {KC // 100}")
                kb, _ = rk.dynamics_chain(model, params, c, s0, U, eps)
                pc, px = rk.trajectory_cost_plain(model, params, c,
                                                  cost_params, cmap, U, eps,
                                                  kb)
                del kb
                check(0 < px.sum().item() < KC, f"pass 1 {sname} random_map:"
                      " crash flags do not differ between rollouts")
                note = (" (held against the plain cost along kernel B's "
                        "trajectories)")
            e_cost = (kc - pc).abs().max().item()
            n_crash_diff = int((kx != px).sum().item())
            print(f"[pass 1] {sname} {name} K={KC}: max|cost err| "
                  f"{e_cost:.3e}{note} (cost range {pc.min().item():.4g}.."
                  f"{pc.max().item():.4g}), crash {int(px.sum().item())}/"
                  f"{KC}, crash mismatches {n_crash_diff}, {n_differ} "
                  f"rollouts differ from the whole plain version; equal to "
                  f"kernel A on the plain stream: {same_as_a}")
            check(torch.isfinite(kc).all().item(),
                  f"pass 1 {sname} {name}: non-finite costs")
            check(torch.allclose(kc, pc, rtol=COST_RTOL, atol=COST_ATOL),
                  f"pass 1 {sname} {name}: costs differ beyond rtol "
                  f"{COST_RTOL} atol {COST_ATOL}")
            check(n_crash_diff == 0, f"pass 1 {sname} {name}: crash flags "
                  "differ")
            check(same_as_a, f"pass 1 {sname} {name}: differs from kernel A "
                  "on the plain stream (the in-kernel stream is not the "
                  "plain one)")
            err_p1 = max(err_p1, e_cost)
            if name == "nominal":
                nominal[sname] = (c, ctx, kc)
            del eps, ac, pc
    # a K that is a multiple of neither a block nor a warp, and a shard's
    # slice of the global batch (k_offset != 0): bit for bit kernel A on the
    # slice's plain stream
    for name, case, k_off, k_loc in (("ragged_K", "nominal", 0, KC - 1),
                                     ("shard", "random_map", *SHARD)):
        ccfg, s0, cmap = cases[case]
        c = cap_cfg["ou"].replace(steering_std=ccfg.steering_std,
                                  throttle_std=ccfg.throttle_std)
        kw = dict(k_offset=k_off, K_local=k_loc)
        kc, kx, ctx = rk.fused_rng_costs(model, params, c, cost_params, cmap,
                                         s0, U, key, **kw)
        pc, px, _ = rk.fused_rng_costs_plain(model, params, c, cost_params,
                                             cmap, s0, U, key, **kw)
        eps = rk.rng_noise(ctx)
        ac, _, ax = rk.fused_exact_rollout_cost(model, params, c, cost_params,
                                                cmap, s0, U, eps,
                                                k_offset=k_off)
        kb, _ = rk.dynamics_chain(model, params, c, s0, U, eps,
                                  k_offset=k_off)
        bc, bx = rk.trajectory_cost_plain(model, params, c, cost_params, cmap,
                                          U, eps, kb, k_offset=k_off)
        del kb, eps
        torch.cuda.synchronize()
        same_as_a = torch.equal(kc, ac) and torch.equal(kx, ax)
        print(f"[pass 1] ou {name} K={k_loc} k_offset={k_off}: equal to "
              f"kernel A on the plain stream: {same_as_a}")
        check(same_as_a, f"pass 1 {name}: differs from kernel A on the plain "
              "stream")
        err_p1 = max(err_p1, agreement(
            f"pass 1 ou K={k_loc} k_offset={k_off} along kernel B", name, kc,
            kx, bc, bx, k_loc, limit=0))
        agreement(f"pass 1 ou K={k_loc} k_offset={k_off}", name, kc, kx, pc,
                  px, k_loc, limit=0 if name == "ragged_K" else None)
        del kc, pc, ac, bc
    # two models with different weights, their launches alternating on one
    # stream with no synchronisation between them (as an ensemble's members
    # run): each bit for bit kernel A fed the plain stream with its own
    # weights, and held against its own plain cost along kernel B's
    # trajectories (every rollout) and its whole plain version (the second
    # model's seeded weights drive some rollouts off the track, where the
    # summation order moves a cost: 1 %, as in the other non-nominal cases)
    other, _, _, _, _ = drive_oval.build(rollouts=K, device=dev)
    oparams = other.model.init_params(1)
    ccfg = cap_cfg["gaussian"]
    runs = []
    for mdl, prm in ((model, params), (other.model, oparams)):
        launch, (kc, kx), ctx = rk.prepare_fused_rng_costs(
            mdl, prm, ccfg, cost_params, costmap, start, U, key)
        runs.append((mdl, prm, launch, kc, kx, ctx))
    for _ in range(3):
        for run in runs:
            run[2]()
    torch.cuda.synchronize()
    for i, (mdl, prm, _, kc, kx, ctx) in enumerate(runs):
        name = "nominal" if i == 0 else "other_weights"
        eps = rk.rng_noise(ctx)
        ac, _, ax = rk.fused_exact_rollout_cost(mdl, prm, ccfg, cost_params,
                                                costmap, start, U, eps)
        kb, _ = rk.dynamics_chain(mdl, prm, ccfg, start, U, eps)
        bc, bx = rk.trajectory_cost_plain(mdl, prm, ccfg, cost_params,
                                          costmap, U, eps, kb)
        del kb, eps
        pc, px, _ = rk.fused_rng_costs_plain(mdl, prm, ccfg, cost_params,
                                             costmap, start, U, key)
        torch.cuda.synchronize()
        same_as_a = torch.equal(kc, ac) and torch.equal(kx, ax)
        print(f"[pass 1] two models alternating on one stream, model {i} "
              f"(weights seed {i}): equal to kernel A on the plain stream "
              f"with its own weights: {same_as_a}")
        check(same_as_a, f"pass 1 two models: model {i} differs from kernel "
              "A with its own weights")
        err_p1 = max(err_p1, agreement(
            f"pass 1 two models, model {i} along kernel B", name, kc, kx, bc,
            bx, KC, limit=0))
        agreement(f"pass 1 two models, model {i}", name, kc, kx, pc, px, KC)
        del ac, bc, pc
    check(not torch.equal(runs[0][3], runs[1][3]), "pass 1 two models: the "
          "two models' costs are equal")
    del runs

    # -- phase 8: pass 2 against its plain version ---------------------------
    def abs_controls(c, ctx):
        """|u| (C, T, K) of ``ctx``'s rollouts: kernel A's u_seq on the
        plain stream (the controls do not depend on the state)."""
        _, u_seq, _ = rk.fused_exact_rollout_cost(
            model, params, c, cost_params, costmap, start, ctx.U,
            rk.rng_noise(ctx), k_offset=ctx.k_offset)
        return u_seq.abs_()

    def hold_numer(tag, ctx, w, u_abs):
        """Pass 2 on weights ``w`` against its plain version, within
        NUMER_RTOL of sum_k |w_k u_k|; prints the share of warps whose
        32 weights are all 0.  Returns the max abs error."""
        kn = rk.fused_rng_numer(ctx, w)
        pn = rk.fused_rng_numer_plain(ctx, w)
        scale = torch.einsum("k,ctk->ct", w.abs(), u_abs)
        torch.cuda.synchronize()
        err = (kn - pn).abs()
        rel = (err / scale.clamp(min=1e-30)).max().item()
        print(f"[pass 2] {tag} K={ctx.K}: max|numer err| "
              f"{err.max().item():.3e}, max err / sum|w u| {rel:.3e} (limit "
              f"{NUMER_RTOL}), ess {(w.sum() ** 2 / (w * w).sum()).item():.1f}"
              f", {int((w != 0).sum().item())} non-zero weights, "
              f"{100 * zero_warp_share(w):.2f} % all-zero warps")
        check(bool((err <= NUMER_RTOL * scale).all()), f"pass 2 {tag}: "
              f"numerator differs beyond {NUMER_RTOL} of sum|w u|")
        return err.max().item()

    err_p2 = 0.0
    first_pure = int(np.ceil(np.float32(cfg.pure_noise_frac * KC)))
    for sname, (c, ctx, kc) in nominal.items():
        w = torch.exp(-effective_gamma(c, cost_params) * (kc - kc.min()))
        u_abs = abs_controls(c, ctx)
        # the nominal weights; three warps of every four zeroed (sparse);
        # all 1 (dense)
        sparse = torch.where(torch.arange(KC, device=dev) // 32 % 4 == 0, w,
                             torch.zeros_like(w))
        for wname, wv in (("nominal", w), ("sparse", sparse),
                          ("dense", torch.ones_like(w))):
            err_p2 = max(err_p2, hold_numer(f"{sname} {wname}", ctx, wv,
                                            u_abs))
        del u_abs
        # a NaN in U: NaN exactly where the plain version has it, and every
        # other partial bit for bit the run's without the NaN
        U_nan = ctx.U.clone()
        U_nan[T // 2, 1] = float("nan")
        ctx_nan = ctx._replace(U=U_nan)
        kn, ks = rk.fused_rng_numer(ctx_nan, sparse), rk.fused_rng_numer(
            ctx, sparse)
        launch, part_nan = rk.prepare_fused_rng_numer(ctx_nan, sparse)
        launch()
        launch, part = rk.prepare_fused_rng_numer(ctx, sparse)
        launch()
        pn = rk.fused_rng_numer_plain(ctx_nan, sparse)
        torch.cuda.synchronize()
        keep = torch.ones_like(part, dtype=torch.bool)
        keep[:, 1, T // 2] = False
        same_nan = torch.equal(torch.isnan(kn), torch.isnan(pn))
        same_bits = bit_equal(part_nan[keep], part[keep])
        print(f"[pass 2] {sname} NaN in U[{T // 2}, 1], sparse weights: NaN "
              f"in {int(torch.isnan(kn).sum().item())} numerator entries, "
              f"where the plain version has them: {same_nan}; the other "
              f"partials bit equal to the run's without the NaN: "
              f"{same_bits}")
        check(same_nan and bool(torch.isnan(kn[1, T // 2])),
              f"pass 2 {sname} NaN in U: NaN pattern differs")
        check(torch.equal(kn[~torch.isnan(kn)], ks[~torch.isnan(kn)]),
              f"pass 2 {sname} NaN in U: other entries differ")
        check(same_bits, f"pass 2 {sname} NaN in U: other partials differ")
        del kn, ks, pn, part, part_nan
        for k in (0, 1, first_pure, KC - 1):
            onehot = torch.zeros(KC, device=dev)
            onehot[k] = 1.0
            got = rk.fused_rng_numer(ctx, onehot)
            want = rk.fused_rng_numer_plain(ctx, onehot)   # U + nu eps, masked
            e = (got - want).abs().max().item()
            print(f"[pass 2] {sname} one-hot k={k}: max|u err| {e:.3e}")
            check(e <= ONEHOT_ATOL, f"pass 2 {sname} one-hot k={k}: {e}")

    # -- phase 9: the capacity path ------------------------------------------
    cpu_solver, cpu_params, _, cpu_map = cpu
    ci = cap_cfg["gaussian"].replace(num_rollouts=K_ITER_CHECK)
    Ug, _, _ = rk.fused_rng_solve_iteration(model, params, ci, cost_params,
                                            costmap, start, U, key)
    Uc, _, _ = rk.fused_rng_solve_iteration(cpu_solver.model, cpu_params, ci,
                                            cost_params, cpu_map, start.cpu(),
                                            U.cpu(), key.cpu())
    e_it = (Ug.cpu() - Uc).abs().max().item()
    print(f"[capacity] one iteration K={K_ITER_CHECK} GPU vs CPU: max|U_new "
          f"err| {e_it:.3e}")
    check(e_it <= ITER_ATOL, f"capacity iterate: GPU and CPU differ by {e_it}")

    want = {"fused_rng_costs": 1, "fused_rng_numer": 1, "dynamics_chain": 1}
    cap_solvers, latency, run_launches = {}, {}, {}
    # each drive's pass-2 inputs (ctx, weights) of one more, untimed tick
    closed_loop = {}
    for sname, c in cap_cfg.items():
        cap = MPPISolver(model, solver.cost, c, device=dev)
        check(cap._use_kernel_rng(costmap), f"{sname}: not in capacity mode")
        cap_solvers[sname] = cap
        rk.LAUNCHES.clear()
        out = drive_oval.drive(cap, params, cost_params, costmap, CAP_TICKS,
                               log=lambda m: print(f"[capacity] {m}"))
        launches = dict(rk.LAUNCHES)
        st, stats = out["solve_ms"], out["stats"]
        latency[sname] = (float(np.percentile(st, 50)),
                          float(np.percentile(st, 99)))
        print(f"[capacity] {sname} K={KC} {CAP_TICKS} ticks: solve latency "
              f"p50 {latency[sname][0]:.3f} ms p99 {latency[sname][1]:.3f} "
              f"ms (slide + solve + control readback, host clock; {card}); "
              f"ess {stats.ess.item():.1f}, crash% "
              f"{stats.crash_frac.item() * 100:.1f}; launches {launches}")
        check(np.isfinite(out["controls"]).all(), f"{sname}: non-finite "
              "controls")
        solves = CAP_TICKS + 1
        check(launches == {n: v * solves for n, v in want.items()},
              f"{sname}: launches {launches} in {solves} solves, expected "
              f"{want} per solve (and nothing else)")
        run_launches[sname] = launches
        closed_loop[sname] = next_tick_args(rk, "fused_rng_numer", cap,
                                            params, cost_params, costmap,
                                            out)[0]
        err_p2 = max(err_p2, hold_numer(
            f"{sname} closed loop, tick {CAP_TICKS + 1}",
            *closed_loop[sname], abs_controls(c, closed_loop[sname][0])))

    # -- phase 10: timing ----------------------------------------------------
    flops_step = mlp_flops(model.layers)
    n_w = sum(a * b + b for a, b in zip(model.layers[:-1], model.layers[1:]))
    T_ = U.shape[0]
    times = {}
    mix = stream_mix(SASS[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock = max_sm_clock_mhz()
    for name, m in mix.items():
        print(f"[timing] {name}: a step of its stream loop "
              f"{m['instructions']:.1f} instructions, {m['int']:.1f} of them "
              f"integer; {m['instructions_always']:.1f} and "
              f"{m['int_always']:.1f} outside forward branches ({m['steps']} "
              f"steps a pass of the loop); a step's "
              + ", ".join(f"{op} {n:.1f}" for op, n in m["ops"].items())
              + " (SASS of the built library)")
    for sname, c in cap_cfg.items():
        ou = OU_OPS if sname == "ou" else 0
        launch1, (kc, _), ctx = rk.prepare_fused_rng_costs(
            model, params, c, cost_params, costmap, start, U, key)
        ms1 = cuda_ms(launch1, 20)
        geometry_line(rk, f"timing pass 1 {sname}", launch1, True, False,
                      card)
        plain1 = cuda_ms(lambda: rk.fused_rng_costs_plain(
            model, params, c, cost_params, costmap, start, U, key), 3, 1)
        # inputs read once (U, weights, state, control ranges, key, at most
        # the whole map or one texel per lookup), costs and crash written
        bytes1 = (4 * (T_ * 2 + n_w + 7 + 4 + 2 * KC)
                  + 4 * min(costmap.height * costmap.width, 2 * KC * (T_ - 1))
                  + 16)
        bound1 = bound(bytes1, (flops_step + STREAM_OPS + ou) * KC * T_)
        floors1 = sass_chain.pipe_bounds(mix["pass1_mlp"], KC, T_, sms,
                                         clock)
        w = torch.exp(-effective_gamma(c, cost_params) * (kc - kc.min()))
        plain2 = cuda_ms(lambda: rk.fused_rng_numer_plain(ctx, w), 3, 1)
        # pass 2 on the nominal weights (phase 8's), the closed loop's tick
        # (phase 9's) and dense ones; its bound counts the rollouts whose
        # weight is not 0, the work that these weights need; the design's
        # floors, all K rollouts, which it replays whatever the weights
        # (its loop's one forward branch over the stream is the test of
        # rollouts past K, which every rollout here takes)
        p2 = {}
        floors2 = sass_chain.pipe_bounds(mix["pass2"], KC, T_, sms, clock,
                                         branched=True)
        for wname, (cx, wv) in (("nominal", (ctx, w)),
                                ("closed_loop", closed_loop[sname]),
                                ("dense", (ctx, torch.ones_like(w)))):
            launch2, partials = rk.prepare_fused_rng_numer(cx, wv)
            ms2 = cuda_ms(launch2, 50)
            k_need = int((wv != 0).sum().item())
            bytes2 = 4 * (KC + T_ * 2 + partials.numel()) + 16
            p2[wname] = (ms2, bound(bytes2, (STREAM_OPS + ou + UPDATE_OPS)
                                    * k_need * T_))
            print(f"[timing] pass 2 fused_rng_numer {sname} {wname} K={KC} "
                  f"T={T_}: {ms2:.4f} ms; {k_need} non-zero weights, "
                  f"{100 * zero_warp_share(wv):.2f} % all-zero warps; bound "
                  f"{p2[wname][1][0]:.5f} ms ({p2[wname][1][1]}) ({card})")
        times[sname] = (ms1, plain1, bound1, plain2, p2)
        print(f"[timing] pass 1 fused_rng_costs {sname} K={KC} T={T_}: "
              f"{ms1:.4f} ms, plain {plain1:.3f} ms, bound {bound1[0]:.5f} "
              f"ms ({bound1[1]}); its SASS's floors: integer pipe "
              f"{floors1['int_ms']:.5f} ms, issue {floors1['issue_ms']:.5f} "
              f"ms ({sms} SMs at {clock:.0f} MHz) ({card})")
        print(f"[timing] pass 2 fused_rng_numer {sname}: plain {plain2:.3f} "
              f"ms; its SASS's floors at K={KC}: integer pipe "
              f"{floors2['int_ms']:.5f} ms, issue {floors2['issue_ms']:.5f} "
              f"ms ({sms} SMs at {clock:.0f} MHz) ({card})")

    # BF exact pass 1 (fused_rng_bf_kernel) at the same K: its floors from
    # the instructions outside forward branches and from the whole loop
    # body (the draws a step ahead and the rare IEEE step sit behind
    # forward branches)
    bsolver, bparams, _, _, _ = drive_oval.build(model="bf", rollouts=KB,
                                                 device=dev)
    n_bf = rk.KERNEL_BF_WEIGHTS
    floors_bf = {b: sass_chain.pipe_bounds(mix["pass1_bf"], KC, T_, sms,
                                           clock, branched=b)
                 for b in (False, True)}
    for sname, kw in SAMPLERS.items():
        c = bsolver.cfg.replace(num_rollouts=KC, kernel_rng=True, **kw)
        launch_bf, _, _ = rk.prepare_fused_rng_costs(
            bsolver.model, bparams, c, cost_params, costmap, start, U, key)
        ms_bf = cuda_ms(launch_bf, 20)
        geometry_line(rk, f"timing BF pass 1 {sname}", launch_bf, True, True,
                      card)
        bytes_bf = (4 * (T_ * 2 + n_bf + 7 + 4 + 2 * KC)
                    + 4 * min(costmap.height * costmap.width,
                              2 * KC * (T_ - 1)) + 16)
        bound_bf = bound(bytes_bf, (BF_STEP_OPS + STREAM_OPS
                                    + (OU_OPS if sname == "ou" else 0))
                         * KC * T_)
        print(f"[timing] BF pass 1 fused_rng_costs_bf {sname} K={KC} "
              f"T={T_}: {ms_bf:.4f} ms, bound {bound_bf[0]:.5f} ms "
              f"({bound_bf[1]}); its SASS's floors outside forward "
              f"branches: integer pipe {floors_bf[False]['int_ms']:.5f} ms, "
              f"issue {floors_bf[False]['issue_ms']:.5f} ms; over the whole "
              f"loop body: integer pipe {floors_bf[True]['int_ms']:.5f} ms, "
              f"issue {floors_bf[True]['issue_ms']:.5f} ms ({sms} SMs at "
              f"{clock:.0f} MHz) ({card})")
        del launch_bf

    # kernel A at the same K on the plain stream: pass 1 less the generator
    # (and plus the eps reads and u_seq writes)
    eps = rk.rng_noise(ctx)
    launch_a, _ = rk.prepare_fused_exact_rollout_cost(
        model, params, cap_cfg["ou"], cost_params, costmap, start, U, eps)
    print(f"[timing] kernel A fused_exact_rollout_cost K={KC} T={T_}: "
          f"{cuda_ms(launch_a, 20):.4f} ms ({card})")
    geometry_line(rk, f"timing kernel A K={KC}", launch_a, False, False, card)
    del eps, launch_a

    host = MPPISolver(model, solver.cost, cfg.replace(num_rollouts=KC),
                      device=dev)
    for label, s in (("capacity gaussian", cap_solvers["gaussian"]),
                     ("capacity ou", cap_solvers["ou"]),
                     ("host-noise gaussian", host)):
        cs = s.init_state()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        ms = cuda_ms(lambda: s.solve(params, cost_params, costmap, start, cs),
                     10)
        peak = (torch.cuda.max_memory_allocated(dev) - base) / 2 ** 20
        print(f"[timing] whole solve, {label}, K={KC} T={T_}: {ms:.4f} ms "
              f"(CUDA events), peak device memory {peak:.1f} MiB above the "
              f"inputs ({card})")

    profile_ticks(drive_oval, cap_solvers["gaussian"], params, cost_params,
                  costmap, card, ticks=CAP_PROFILE_TICKS,
                  tag="capacity profile")

    src = "autorally_tpu_torch/csrc/rollout_kernels.cu"
    ms1, plain1, bound1, plain2, p2 = times["gaussian"]
    ms2, bound2 = p2["nominal"]
    kernels = [
        {"name": "fused_rng_costs", "route": "cuda", "source": src,
         "replaces": "autorally_tpu/ops/rollout_kernel.py:1221",
         "launches": run_launches["gaussian"]["fused_rng_costs"],
         "max_abs_err": err_p1, "ms": ms1, "plain_ms": plain1,
         "bound_ms": bound1[0], "bound_by": bound1[1], "library_ms": None},
        {"name": "fused_rng_numer", "route": "cuda", "source": src,
         "replaces": "autorally_tpu/ops/rollout_kernel.py:1346",
         "launches": run_launches["gaussian"]["fused_rng_numer"],
         "max_abs_err": err_p2, "ms": ms2, "plain_ms": plain2,
         "bound_ms": bound2[0], "bound_by": bound2[1], "library_ms": None,
         "weights_ms": {wname: r[0] for wname, r in p2.items()}},
    ]
    return kernels, latency


def random_field(field, model, params, cfg, start, U, seed: int = 1):
    """A field of the fitted field's spec and transform with seeded
    He-normal weights, its output rescaled to a standard deviation of 0.25
    over the map and shifted so that the 0.65 crash boundary lies at the
    median of the highest value that each of 2048 rollouts from ``start``
    under ``cfg`` meets (plain chain and plain lookups, on noise of their
    own): about half of the checked rollouts crash, at different steps."""
    import torch
    from autorally_tpu_torch.costs import NeuralCostmap
    from autorally_tpu_torch.ops import rollout_kernel as rk

    dev = field.device
    rs = np.random.default_rng(seed)
    layers = field.layers
    W = [np.sqrt(2.0 / a) * rs.standard_normal((a, b))
         for a, b in zip(layers[:-1], layers[1:])]
    B = [0.1 * rs.standard_normal(b) for b in layers[1:]]
    build = lambda: NeuralCostmap.build(W, B, field.freqs.cpu(),
                                        field.r_c1.cpu(), field.r_c2.cpu(),
                                        field.trs.cpu(), device=dev)
    g = torch.linspace(0, 1, 201, device=dev)
    uu, vv = torch.meshgrid(g, g, indexing="xy")
    sd = build().forward_norm(uu.reshape(-1), vv.reshape(-1)).std().item()
    W[-1], B[-1] = W[-1] * (0.25 / sd), B[-1] * (0.25 / sd)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    eps = torch.randn((U.shape[0], 2048, 2), generator=gen, device=dev)
    states, _ = rk.dynamics_chain_plain(model, params, cfg, start, U, eps)
    x, y, yaw = states[0, :-1], states[1, :-1], states[2, :-1]   # s_1..s_T-1
    hx, hy = 0.5 * torch.cos(yaw), 0.5 * torch.sin(yaw)
    f = build()
    peak = torch.maximum(f.lookup_ch0(x + hx, y + hy),
                         f.lookup_ch0(x - hx, y - hy)).amax(dim=0)
    B[-1] = B[-1] + (0.65 - torch.median(peak).item())
    return build()


class PlainCalls:
    """Counts calls of the plain versions while active (each wrapper looks
    its plain version up in the module at call time), to show that a run
    on the card never took one."""

    NAMES = ("fused_rollout_cost_plain", "trajectory_cost_plain",
             "dynamics_chain_plain", "fused_rng_costs_plain",
             "fused_rng_numer_plain")

    def __init__(self, rk):
        self.rk, self.calls = rk, dict.fromkeys(self.NAMES, 0)

    def __enter__(self):
        self.saved = {n: getattr(self.rk, n) for n in self.NAMES}
        for n, fn in self.saved.items():
            def counted(*a, _n=n, _fn=fn, **kw):
                self.calls[_n] += 1
                return _fn(*a, **kw)
            setattr(self.rk, n, counted)
        return self

    def __exit__(self, *exc):
        for n, fn in self.saved.items():
            setattr(self.rk, n, fn)


def field_phases(drive_oval, model, params, cost_params, costmap, U, start,
                 edge_start, nan_start, slow_start, card):
    """Phases 11-14: the neural-field costmap path, kernel 3 at K=65536 and
    pass 1's field mode at K=262144.  Returns the two kernels' ``kernels``
    entries, the field solves' latencies and the fitted field."""
    import torch
    from autorally_tpu_torch.ops import rollout_kernel as rk
    from autorally_tpu_torch.solver.mppi import MPPISolver

    dev = U.device
    T_ = U.shape[0]
    key = torch.tensor(KEY, dtype=torch.int64, device=dev)

    # -- the field, fitted on the card through the entry point ---------------
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    host, _, _, field, note = drive_oval.build(
        rollouts=KF, device=dev, neural_costmap=True)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    print(f"[field] drive_oval.build(neural_costmap=True) with "
          f"fit_neural_costmap's defaults (4000 Adam steps, batch 16384): "
          f"{fit_s:.3f} s ({card}); {note.splitlines()[-1]}; layers "
          f"{field.layers}")
    check(field.layers == rk.FIELD_KERNEL_LAYERS, f"field layers "
          f"{field.layers}, kernels compiled for {rk.FIELD_KERNEL_LAYERS}")
    # the same seeded weights as the main path (both built from seed 0)
    for w, hw in zip(params["weights"], host.model.params()["weights"]):
        check(torch.equal(w, hw), "the field solver's weights differ")
    cfg = host.cfg
    wide = cfg.replace(steering_std=4 * cfg.steering_std,
                       throttle_std=4 * cfg.throttle_std)
    cases = {
        "nominal": (cfg, start, field),
        "wide_swarm": (wide, edge_start, field),
        "nan_x": (cfg, nan_start, field),
        "random_field": (wide, slow_start, random_field(
            field, model, params, wide, slow_start, U)),
    }

    # -- phase 11: kernel 3 against its plain version ------------------------
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    eps = torch.randn((T_, KF, 2), generator=gen, device=dev)
    err_3 = 0.0
    for name, (ccfg, s0, f) in cases.items():
        kc, ku, kx = rk.fused_rollout_cost(model, params, ccfg, cost_params,
                                           f, s0, U, eps)
        pc, pu, px = rk.fused_rollout_cost_plain(model, params, ccfg,
                                                 cost_params, f, s0, U, eps)
        torch.cuda.synchronize()
        err_3 = max(err_3, agreement(f"kernel 3 K={KF}", name, kc, kx, pc,
                                     px, KF))
        check(torch.equal(ku, pu), f"kernel 3 {name}: u_seq differs")
        del kc, ku, pc, pu
    # a K that is a multiple of neither the block nor the warp: the last
    # warp's idle lanes run dummy rollouts and store nothing
    k_r = KF - 19
    ccfg, s0, f = cases["nominal"]
    e_r = eps[:, :k_r].contiguous()
    kc, ku, kx = rk.fused_rollout_cost(model, params, ccfg, cost_params, f,
                                       s0, U, e_r)
    pc, pu, px = rk.fused_rollout_cost_plain(model, params, ccfg,
                                             cost_params, f, s0, U, e_r)
    torch.cuda.synchronize()
    err_3 = max(err_3, agreement(f"kernel 3 K={k_r}", "ragged_K", kc, kx, pc,
                                 px, k_r, limit=0))
    check(torch.equal(ku, pu), "kernel 3 ragged_K: u_seq differs")
    del eps, e_r, kc, ku, pc, pu

    # -- phase 12: pass 1 in field mode against its plain version ------------
    # and bit for bit against kernel 3 fed the plain stream (the same step
    # body and the same stream)
    err_p1 = 0.0
    for sname, kw in SAMPLERS.items():
        for name, (ccfg, s0, f) in cases.items():
            c = ccfg.replace(num_rollouts=KC, kernel_rng=True, **kw)
            kc, kx, ctx = rk.fused_rng_costs(model, params, c, cost_params,
                                             f, s0, U, key)
            pc, px, _ = rk.fused_rng_costs_plain(model, params, c,
                                                 cost_params, f, s0, U, key)
            ac, _, ax = rk.fused_rollout_cost(model, params, c, cost_params,
                                              f, s0, U, rk.rng_noise(ctx))
            torch.cuda.synchronize()
            same_as_3 = torch.equal(kc, ac) and torch.equal(kx, ax)
            err_p1 = max(err_p1, agreement(
                f"pass 1 field {sname} K={KC}", name, kc, kx, pc, px, KC))
            print(f"[pass 1 field] {sname} {name}: equal to kernel 3 on the "
                  f"plain stream: {same_as_3}")
            check(same_as_3, f"pass 1 field {sname} {name}: differs from "
                  "kernel 3 on the plain stream")
            del kc, pc, ac
    # a K that is not a multiple of 32, and a shard's slice of the global
    # batch (k_offset != 0): bit for bit kernel 3 on the slice's plain stream
    for name, case, k_off, k_loc in (
            ("ragged_K", "nominal", 0, KC - 13),
            ("shard", "random_field", *SHARD)):
        ccfg, s0, f = cases[case]
        c = ccfg.replace(num_rollouts=KC, kernel_rng=True)
        kw = dict(k_offset=k_off, K_local=k_loc)
        kc, kx, ctx = rk.fused_rng_costs(model, params, c, cost_params, f, s0,
                                         U, key, **kw)
        pc, px, _ = rk.fused_rng_costs_plain(model, params, c, cost_params,
                                             f, s0, U, key, **kw)
        ac, _, ax = rk.fused_rollout_cost(model, params, c, cost_params, f,
                                          s0, U, rk.rng_noise(ctx),
                                          k_offset=k_off)
        torch.cuda.synchronize()
        same_as_3 = torch.equal(kc, ac) and torch.equal(kx, ax)
        err_p1 = max(err_p1, agreement(
            f"pass 1 field K={k_loc} k_offset={k_off}", name, kc, kx, pc, px,
            k_loc, limit=0 if name == "ragged_K" else None))
        print(f"[pass 1 field] {name} K={k_loc} k_offset={k_off}: equal to "
              f"kernel 3 on the plain stream: {same_as_3}")
        check(same_as_3, f"pass 1 field {name}: differs from kernel 3 on "
              "the plain stream")
        del kc, pc, ac

    # -- phase 13: the field path closed-loop --------------------------------
    cap = MPPISolver(host.model, host.cost, cfg.replace(
        num_rollouts=KC, kernel_rng=True), device=dev)
    check(not host._use_kernel_rng(field) and cap._use_kernel_rng(field),
          "field solvers: wrong mode")
    runs = {"host-noise": (host, FIELD_TICKS, {
                "fused_rollout_cost": 1, "dynamics_chain": 1}),
            "capacity": (cap, FIELD_CAP_TICKS, {
                "fused_rng_costs_field": 1, "fused_rng_numer": 1,
                "dynamics_chain": 1})}
    latency, launches = {}, {}
    for label, (s, ticks, per_solve) in runs.items():
        latency[label], launches[label], _ = drive_counted(
            drive_oval, rk, f"field path {label}", s, params, cost_params,
            field, ticks, per_solve, card)

    # -- phase 14: timing ----------------------------------------------------
    flops_step = mlp_flops(model.layers)
    n_w = sum(a * b + b for a, b in zip(model.layers[:-1], model.layers[1:]))
    field_ops = field_eval_ops(field.layers, field.freqs.numel())
    n_f = rk.FIELD_NUM_WEIGHTS
    eps = torch.randn((T_, KF, 2), generator=gen, device=dev)
    launch_3, _ = rk.prepare_fused_rollout_cost(model, params, cfg,
                                                cost_params, field, start, U,
                                                eps)
    launch_a, _ = rk.prepare_fused_exact_rollout_cost(
        model, params, cfg, cost_params, costmap, start, U, eps)
    ms_3 = cuda_ms(launch_3, 10)
    ms_a = cuda_ms(launch_a, 10)
    plain_3 = cuda_ms(lambda: rk.fused_rollout_cost_plain(
        model, params, cfg, cost_params, field, start, U, eps), 3, 1)
    # eps read, u_seq, costs and crash written, the weights, the field,
    # U, the state and the control ranges read once
    bytes_3 = 4 * (3 * T_ * KF * 2 + 2 * KF + T_ * 2 + n_w + n_f + 7 + 4)
    ops_3 = KF * (T_ * flops_step + (T_ - 1) * 2 * field_ops)
    bound_3, tc_3 = field_bounds(bytes_3, KF * T_ * flops_step,
                                 KF * (T_ - 1) * 2, field)
    print(f"[timing] kernel 3 fused_rollout_cost K={KF} T={T_}: "
          f"{ms_3:.4f} ms, plain {plain_3:.3f} ms, tensor-core bound "
          f"{tc_3[0]:.4f} ms ({tc_3[1]}), fp32 bound {bound_3[0]:.4f} ms "
          f"({bound_3[1]}; {ops_3 / 1e9:.1f} GFLOP, {bytes_3 / 1e6:.1f} MB); "
          f"kernel A on the exact map at the same K: {ms_a:.4f} ms, field / "
          f"exact {ms_3 / ms_a:.2f}x ({card})")
    del eps, launch_3, launch_a

    times = {}
    for sname, kw in SAMPLERS.items():
        c = cfg.replace(num_rollouts=KC, kernel_rng=True, **kw)
        ou = OU_OPS if sname == "ou" else 0
        launch_f, _, _ = rk.prepare_fused_rng_costs(
            model, params, c, cost_params, field, start, U, key)
        launch_e, _, _ = rk.prepare_fused_rng_costs(
            model, params, c, cost_params, costmap, start, U, key)
        check((launch_f.mode, launch_e.mode) == ("field", "exact"),
              "pass 1 modes")
        ms_f = cuda_ms(launch_f, 5)
        ms_e = cuda_ms(launch_e, 5)
        plain_f = cuda_ms(lambda: rk.fused_rng_costs_plain(
            model, params, c, cost_params, field, start, U, key), 2, 1)
        bytes_f = 4 * (2 * KC + T_ * 2 + n_w + n_f + 7 + 4) + 16
        ops_f = KC * (T_ * (flops_step + STREAM_OPS + ou)
                      + (T_ - 1) * 2 * field_ops)
        bound_f, tc_f = field_bounds(
            bytes_f, KC * T_ * (flops_step + STREAM_OPS + ou),
            KC * (T_ - 1) * 2, field)
        times[sname] = (ms_f, plain_f, bound_f, tc_f)
        print(f"[timing] pass 1 field fused_rng_costs {sname} K={KC} "
              f"T={T_}: {ms_f:.4f} ms, plain {plain_f:.3f} ms, tensor-core "
              f"bound {tc_f[0]:.4f} ms ({tc_f[1]}), fp32 bound "
              f"{bound_f[0]:.4f} ms ({bound_f[1]}; {ops_f / 1e9:.1f} GOP, "
              f"{bytes_f / 1e6:.2f} MB); pass 1 on the exact map at the same "
              f"K: {ms_e:.4f} ms, field / exact {ms_f / ms_e:.2f}x ({card})")
    for label, s in (("host-noise K=%d" % KF, host), ("capacity K=%d" % KC,
                                                      cap)):
        cs = s.init_state()
        ms = cuda_ms(lambda: s.solve(params, cost_params, field, start, cs),
                     5, 1)
        print(f"[timing] whole field solve, {label} T={T_}: {ms:.4f} ms "
              f"(CUDA events; {card})")
    profile_ticks(drive_oval, host, params, cost_params, field, card,
                  ticks=FIELD_PROFILE_TICKS, tag="field profile")
    profile_ticks(drive_oval, cap, params, cost_params, field, card,
                  ticks=FIELD_PROFILE_TICKS, tag="field capacity profile")

    src = "autorally_tpu_torch/csrc/rollout_kernels.cu"
    ms_f, plain_f, bound_f, tc_f = times["gaussian"]
    kernels = [
        {"name": "fused_rollout_cost", "route": "cuda", "source": src,
         "replaces": "autorally_tpu/ops/rollout_kernel.py:606",
         "launches": launches["host-noise"]["fused_rollout_cost"],
         "max_abs_err": err_3, "ms": ms_3, "plain_ms": plain_3,
         "bound_ms": tc_3[0], "bound_by": tc_3[1],
         "fp32_bound_ms": bound_3[0], "library_ms": None},
        {"name": "fused_rng_costs_field", "route": "cuda", "source": src,
         "replaces": "autorally_tpu/ops/rollout_kernel.py:1221",
         "launches": launches["capacity"]["fused_rng_costs_field"],
         "max_abs_err": err_p1, "ms": ms_f, "plain_ms": plain_f,
         "bound_ms": tc_f[0], "bound_by": tc_f[1],
         "fp32_bound_ms": bound_f[0], "library_ms": None},
    ]
    return kernels, latency, field


def obstacle_circles(model, params, cfg, start, U, radius: float = 0.5,
                     seed: int = 2):
    """Two active circles on the lane of 2048 plain rollouts from ``start``
    (noise of their own): at steps T/2 and T-2 each circle's edge runs
    through the swarm's mean position, its centre ``radius`` to the side,
    and its radius is then set to the median of the rollouts' closest
    approach, so that about half of them pass inside: some rollouts hit,
    some do not."""
    import torch
    from autorally_tpu_torch.ops import rollout_kernel as rk

    dev = U.device
    T_ = U.shape[0]
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    eps = torch.randn((T_, 2048, 2), generator=gen, device=dev)
    states, _ = rk.dynamics_chain_plain(
        model, params, cfg.replace(num_rollouts=2048), start, U, eps)
    xy = states[:2, :-1].double()            # the priced states s_1..s_T-1
    m = xy.mean(dim=2)
    circles = []
    for t in (T_ // 2, T_ - 2):
        v = m[:, t - 1] - m[:, t - 6]
        v = v / v.norm() if v.norm() > 1e-9 else torch.tensor(
            [1.0, 0.0], dtype=torch.float64, device=dev)
        c = m[:, t - 1] + radius * torch.stack([-v[1], v[0]])
        closest = (xy - c[:, None, None]).norm(dim=0).amin(dim=0)
        circles.append([c[0].item(), c[1].item(), closest.median().item()])
    return circles


def drive_counted(drive_oval, rk, tag, solver, params, cost_params, surface,
                  ticks, per_solve, card, tick_params=None):
    """``ticks`` ticks of ``drive_oval.drive`` with every launch counter set
    to 0 just before and read just after: exactly ``per_solve`` launches of
    each form in every solve (ticks + the untimed first), none of any other
    and no plain-version call.  Returns (latency p50, p99 in ms, the
    counts, the drive's result)."""
    rk.LAUNCHES.clear()
    with PlainCalls(rk) as plain:
        out = drive_oval.drive(solver, params, cost_params, surface, ticks,
                               log=lambda m: print(f"[{tag}] {m}"),
                               tick_params=tick_params)
    got = dict(rk.LAUNCHES)
    st, stats = out["solve_ms"], out["stats"]
    latency = (float(np.percentile(st, 50)), float(np.percentile(st, 99)))
    print(f"[{tag}] K={solver.cfg.num_rollouts} {ticks} ticks: solve latency "
          f"p50 {latency[0]:.3f} ms p99 {latency[1]:.3f} ms (slide + solve + "
          f"control readback, host clock; {card}); ess {stats.ess.item():.1f}"
          f", crash% {stats.crash_frac.item() * 100:.1f}; launches {got}; "
          f"plain-version calls {plain.calls}")
    check(np.isfinite(out["controls"]).all(), f"{tag}: non-finite controls")
    want = {n: v * (ticks + 1) for n, v in per_solve.items()}
    check(got == want, f"{tag}: launches {got}, expected {want}")
    check(not any(plain.calls.values()), f"{tag}: a plain version ran on "
          f"the card: {plain.calls}")
    return latency, got, out


def bf_obstacle_phases(drive_oval, model, params, cost_params, costmap,
                       field, cases, eps, U, start, slow_start, card):
    """Phases 15-18: the BF model (kernels 1 and 2 at its main-path shapes,
    its closed loop at K=2560) and the obstacle terms (kernels 1, 3 and 4,
    the obstacle closed loop at K=1920 with the circles moved every tick),
    the other BF and obstacle forms driven through their entry points, and
    every new form's timing.  Returns the forms' ``kernels`` entries and the
    two paths' latencies."""
    import torch
    from autorally_tpu_torch.costs import MPPICost, make_obstacles
    from autorally_tpu_torch.ops import rollout_kernel as rk
    from autorally_tpu_torch.solver.mppi import MPPISolver

    dev = U.device
    T_ = U.shape[0]
    key = torch.tensor(KEY, dtype=torch.int64, device=dev)
    cfg = cases["nominal"][0]
    wide = cases["random_map"][0]
    errs = {}

    def note_err(form, err):
        errs[form] = max(errs.get(form, 0.0), err)

    def pass1_forms(tag, name, form, mdl, prm, ccfg, s0, surf, kw, limit_b,
                    k_offset=0, k_local=KC):
        """Pass 1 on ``surf`` (``ccfg``'s sampler) for the ``k_local``
        rollouts from ``k_offset`` of K=262144: bit for bit the eps-reading
        kernel fed the plain stream, against the plain cost along kernel
        2's trajectories on that stream (``limit_b`` rollouts may differ;
        None: ``agreement``'s rule) and against the whole plain version
        (1 %)."""
        c = ccfg.replace(num_rollouts=KC, kernel_rng=True)
        kc, kx, ctx = rk.fused_rng_costs(mdl, prm, c, cost_params, surf, s0,
                                         U, key, k_offset=k_offset,
                                         K_local=k_local, **kw)
        e = rk.rng_noise(ctx)
        fused = (rk.fused_exact_rollout_cost if type(surf) is type(costmap)
                 else rk.fused_rollout_cost)
        ac, _, ax = fused(mdl, prm, c, cost_params, surf, s0, U, e,
                          k_offset=k_offset, **kw)
        kb, _ = rk.dynamics_chain(mdl, prm, c, s0, U, e, k_offset=k_offset)
        bc, bx = rk.trajectory_cost_plain(mdl, prm, c, cost_params, surf, U,
                                          e, kb, k_offset=k_offset, **kw)
        del kb, e
        pc, px, _ = rk.fused_rng_costs_plain(mdl, prm, c, cost_params, surf,
                                             s0, U, key, k_offset=k_offset,
                                             K_local=k_local, **kw)
        torch.cuda.synchronize()
        same = torch.equal(kc, ac) and torch.equal(kx, ax)
        print(f"[{tag}] equal to the eps-reading kernel on the plain stream: "
              f"{same}")
        check(same, f"{tag}: differs from the eps-reading kernel on the "
              "plain stream")
        note_err(form, agreement(f"{tag} along kernel 2", name, kc, kx, bc,
                                 bx, k_local, limit=limit_b))
        agreement(tag, name, kc, kx, pc, px, k_local, limit=k_local // 100)
        if name == "ahead":
            check(0 < kx.sum().item() < k_local, f"{tag}: the circles are "
                  "hit by no rollout or by all")

    # -- phase 15: BF kernels 1 and 2 against their plain versions -----------
    # kernel 1 in every geometry that the launcher picks for the BF model
    bf_geoms = launcher_geometries(rk, bf=True)
    geoms = launcher_geometries(rk, bf=False)
    bf, bparams, _, _, note = drive_oval.build(model="bf", rollouts=KB,
                                               device=dev)
    bmodel, bcfg = bf.model, bf.cfg
    print(f"[bf] K={KB} T={T_} {type(bmodel).__name__}; {note}")
    strong = dict(bparams, theta=bparams["theta"] * torch.tensor(
        BF_ROW_SCALE, device=dev)[:, None])
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    beps = torch.randn((T_, KB, 2), generator=gen, device=dev)
    # the strong theta's random map from the slow start with the nominal
    # exploration (4x of it diverges there)
    strong_cases = dict(cases, random_map=(cfg, slow_start,
                                           cases["random_map"][2]))
    # its power: the most that dropping each suspect row moves the plain
    # chain's states (256 rollouts) in any of the cases
    power = {}
    for name, (ccfg, s0, _) in strong_cases.items():
        if name == "nan_x":
            continue                       # the same dynamics as nominal
        c = bcfg.replace(steering_std=ccfg.steering_std,
                         throttle_std=ccfg.throttle_std)
        ref, _ = rk.dynamics_chain_plain(bmodel, strong, c, s0, U,
                                         beps[:, :256])
        for row in BF_SUSPECT_ROWS:
            th = strong["theta"].clone()
            th[row] = 0.0
            alt, _ = rk.dynamics_chain_plain(bmodel, dict(strong, theta=th),
                                             c, s0, U, beps[:, :256])
            power[row] = max(power.get(row, 0.0),
                             (alt - ref).abs().max().item())
    print(f"[bf strong theta] max|state change| from dropping each row: "
          + ", ".join(f"{r}: {v:.2e}" for r, v in power.items()))
    check(all(v > 5 * STATE_ATOL for v in power.values()), "bf strong "
          "theta: a suspect row moves the states by less than 5 x "
          "STATE_ATOL")
    for theta_name, prm, tcases in (("seeded", bparams, cases),
                                    ("strong", strong, strong_cases)):
        for name, (ccfg, s0, cmap) in tcases.items():
            tag = f"bf {theta_name}"
            c = bcfg.replace(steering_std=ccfg.steering_std,
                             throttle_std=ccfg.throttle_std)
            kc, ku, kx = hold_geometries(
                f"{tag} kernel 1 {name}", bf_geoms,
                lambda: tuple(rk.fused_exact_rollout_cost(
                    bmodel, prm, c, cost_params, cmap, s0, U, beps)),
                lambda label, out: None)
            pc, pu, px = rk.fused_rollout_cost_plain(bmodel, prm, c,
                                                     cost_params, cmap, s0,
                                                     U, beps)
            ks, kbu = hold_geometries(
                f"{tag} kernel 2 {name}", rk.CHAIN_GEOMETRIES,
                lambda: tuple(rk.dynamics_chain(bmodel, prm, c, s0, U,
                                                beps)),
                lambda label, out: None, chain=True)
            ps, _ = rk.dynamics_chain_plain(bmodel, prm, c, s0, U, beps)
            bc, bx = rk.trajectory_cost_plain(bmodel, prm, c, cost_params,
                                              cmap, U, beps, ks)
            torch.cuda.synchronize()
            check(torch.equal(ku, pu) and torch.equal(kbu, pu),
                  f"{tag} {name}: u_seq differs")
            # the whole plain version: strict in the nominal case, 1 %
            # elsewhere (near tan's pole a rounding difference grows);
            # along kernel 2's trajectories the same cost arithmetic:
            # strict but for a texel edge on the 2 cm random map
            note_err("fused_exact_rollout_cost_bf", agreement(
                f"{tag} kernel 1 K={KB}", name, kc, kx, pc, px, KB))
            agreement(f"{tag} kernel 1 along kernel 2 K={KB}", name, kc, kx,
                      bc, bx, KB, limit=0)
            close = torch.isclose(ks, ps, rtol=STATE_RTOL, atol=STATE_ATOL,
                                  equal_nan=True).all(dim=1).all(dim=0)
            n_differ = int((~close).sum().item())
            fin = torch.isfinite(ps)
            e_s = (ks[fin] - ps[fin]).abs().max().item() if fin.any() else 0.0
            moving = (ps[4] > 0.1).float().mean().item()
            limit = 0 if name == "nominal" else KB // 100
            print(f"[{tag} kernel 2 K={KB}] {name}: max|state err| "
                  f"{e_s:.3e}, {n_differ} rollouts differ beyond rtol "
                  f"{STATE_RTOL} atol {STATE_ATOL} (limit {limit}); state "
                  f"range {ps[fin].min().item():.3g}.."
                  f"{ps[fin].max().item():.3g}, moving (u_x > 0.1) in "
                  f"{100 * moving:.1f}% of steps")
            check(n_differ <= limit, f"{tag} kernel 2 {name}: {n_differ} "
                  "rollouts differ")
            if name != "nan_x":
                note_err("dynamics_chain_bf", e_s)
            del ks, ps
        ks, _ = hold_geometries(
            f"bf {theta_name} kernel 2 nominal trajectory (K=1)",
            rk.CHAIN_GEOMETRIES, lambda: tuple(rk.nominal_trajectory(
                bmodel, prm, bcfg, start, U)), lambda label, out: None,
            chain=True)
        ps, _ = rk.dynamics_chain_plain(bmodel, prm, bcfg, start, U,
                                        torch.zeros((T_, 1, 2), device=dev))
        ps = torch.cat([start[None], ps[:, :, 0].T[:-1]])
        e_nom = (ks - ps).abs().max().item()
        print(f"[bf {theta_name} kernel 2] nominal trajectory (K=1): "
              f"max|state err| {e_nom:.3e}")
        check(torch.allclose(ks, ps, rtol=STATE_RTOL, atol=STATE_ATOL),
              f"bf {theta_name} nominal trajectory differs")
        note_err("dynamics_chain_bf", e_nom)
    # a K that is a multiple of neither a block nor a warp, and a shard's
    # slice (k_offset != 0), of BF kernel 1 in each of its geometries
    beps_r = torch.randn((T_, KB + 1, 2), generator=gen, device=dev)
    for name, e, k_off in (("ragged_K", beps_r, 0),
                           ("shard", beps[:, 301:].contiguous(), 301)):
        pc, pu, px = rk.fused_rollout_cost_plain(
            bmodel, bparams, bcfg, cost_params, costmap, start, U, e,
            k_offset=k_off)

        def check_bf(label, out):
            kc, ku, kx = out
            note_err("fused_exact_rollout_cost_bf", agreement(
                f"bf seeded kernel 1 {label} K={e.shape[1]} k_offset={k_off}",
                name, kc, kx, pc, px, e.shape[1], limit=0))
            check(torch.equal(ku, pu), f"bf kernel 1 {name}: u_seq differs")

        hold_geometries(f"bf kernel 1 {name}", bf_geoms, lambda: tuple(
            rk.fused_exact_rollout_cost(bmodel, bparams, bcfg, cost_params,
                                        costmap, start, U, e,
                                        k_offset=k_off)), check_bf)
    del beps_r

    # -- phase 16: the BF path, closed loop ----------------------------------
    cpu_bf, cpu_bparams, _, cpu_map, _ = drive_oval.build(
        model="bf", rollouts=KB, device="cpu")
    Ug, stg = bf.iterate(bparams, cost_params, costmap, start, U, beps)
    Uc, stc = cpu_bf.iterate(cpu_bparams, cost_params, cpu_map, start.cpu(),
                             U.cpu(), beps.cpu())
    e_it = (Ug.cpu() - Uc).abs().max().item()
    print(f"[bf path] one iteration GPU vs CPU: max|U_new err| {e_it:.3e}, "
          f"ess {stg.ess.item():.2f} vs {stc.ess.item():.2f}")
    check(e_it <= ITER_ATOL, f"bf iterate: GPU and CPU differ by {e_it}")
    # each run's counts, set to 0 just before it and read just after
    latency, launches = {}, {}

    def run(label, solver, prm, surface, ticks, per_solve, tick_params=None):
        latency[label], launches[label], out = drive_counted(
            drive_oval, rk, label, solver, prm, cost_params, surface, ticks,
            per_solve, card, tick_params)
        return out

    out = run("bf path", bf, bparams, costmap, BF_TICKS,
              {"fused_exact_rollout_cost_bf": 1, "dynamics_chain_bf": 1})
    # BF kernel 1's inputs (state, U, eps) of one more tick, timed in 18
    bf_tick = next_tick_args(rk, "fused_exact_rollout_cost", bf, bparams,
                             cost_params, costmap, out)

    # -- phase 17: obstacles, kernel forms against their plain versions ------
    # the seeded car hardly moves from rest: the circles lie ahead of a
    # start moving up the lane at 1 m/s ("ahead"), where the check that
    # some rollouts hit them and some do not is made
    circles = obstacle_circles(model, params, cfg, slow_start, U)
    cases = dict(cases, ahead=(cfg, slow_start, costmap))
    print(f"[obstacles] circles {circles} in {N_SLOTS} slots, coefficient "
          f"{drive_oval.OBSTACLE_COEFF}, inflation "
          f"{drive_oval.OBSTACLE_INFLATION}")
    okw = dict(obstacles=make_obstacles(circles, N_SLOTS, device=dev),
               obstacle_coeff=drive_oval.OBSTACLE_COEFF,
               inflation=drive_oval.OBSTACLE_INFLATION)
    # Against the plain cost along kernel 2's trajectories (the same chain
    # code) the flags must agree in every rollout; against the whole plain
    # version, whose trajectories differ by rounding, a rollout that grazes
    # a circle's edge (or a texel's) may latch on one side only: 1 %.
    for name, (ccfg, s0, cmap) in cases.items():
        kc, ku, kx = hold_geometries(
            f"obstacles kernel 1 {name}", geoms, lambda: tuple(
                rk.fused_exact_rollout_cost(model, params, ccfg, cost_params,
                                            cmap, s0, U, eps, **okw)),
            lambda label, out: None)
        pc, pu, px = rk.fused_rollout_cost_plain(model, params, ccfg,
                                                 cost_params, cmap, s0, U,
                                                 eps, **okw)
        kb, _ = rk.dynamics_chain(model, params, ccfg, s0, U, eps)
        bc, bx = rk.trajectory_cost_plain(model, params, ccfg, cost_params,
                                          cmap, U, eps, kb, **okw)
        torch.cuda.synchronize()
        check(torch.equal(ku, pu), f"obstacles kernel 1 {name}: u_seq "
              "differs")
        note_err("fused_exact_rollout_cost_obstacles", agreement(
            f"obstacles kernel 1 along kernel 2 K={K}", name, kc, kx, bc, bx,
            K, limit=0))
        agreement(f"obstacles kernel 1 K={K}", name, kc, kx, pc, px, K,
                  limit=K // 100)
        if name == "ahead":
            check(0 < kx.sum().item() < K, "obstacles kernel 1 ahead: the "
                  "circles are hit by no rollout or by all")
    wide_f, cfg_f = wide.replace(num_rollouts=KF), cfg.replace(num_rollouts=KF)
    field_cases = {"nominal": (cfg_f, start, field),
                   "ahead": (cfg_f, slow_start, field),
                   "random_field": (wide_f, slow_start, random_field(
                       field, model, params, wide_f, slow_start, U))}
    eps3 = torch.randn((T_, KF, 2), generator=gen, device=dev)
    for name, (ccfg, s0, f) in field_cases.items():
        kc, ku, kx = rk.fused_rollout_cost(model, params, ccfg, cost_params,
                                           f, s0, U, eps3, **okw)
        pc, pu, px = rk.fused_rollout_cost_plain(model, params, ccfg,
                                                 cost_params, f, s0, U, eps3,
                                                 **okw)
        kb, _ = rk.dynamics_chain(model, params, ccfg, s0, U, eps3)
        bc, bx = rk.trajectory_cost_plain(model, params, ccfg, cost_params,
                                          f, U, eps3, kb, **okw)
        del kb
        torch.cuda.synchronize()
        check(torch.equal(ku, pu), f"obstacles kernel 3 {name}: u_seq "
              "differs")
        note_err("fused_rollout_cost_obstacles", agreement(
            f"obstacles kernel 3 along kernel 2 K={KF}", name, kc, kx, bc, bx,
            KF))
        agreement(f"obstacles kernel 3 K={KF}", name, kc, kx, pc, px, KF,
                  limit=KF // 100)
        if name == "ahead":
            check(0 < kx.sum().item() < KF, "obstacles kernel 3 ahead: the "
                  "circles are hit by no rollout or by all")
    for name in ("nominal", "ahead", "random_map"):
        ccfg, s0, cmap = cases[name]
        pass1_forms(f"obstacles pass 1 K={KC}", name,
                    "fused_rng_costs_obstacles", model, params, ccfg, s0,
                    cmap, okw, 0)
    for name, (ccfg, s0, f) in field_cases.items():
        pass1_forms(f"obstacles pass 1 field K={KC}", name,
                    "fused_rng_costs_field_obstacles", model, params, ccfg,
                    s0, f, okw, None)
    # the field forms at a K that is not a multiple of 32: kernel 3, and a
    # shard's slice of pass 1 (k_offset != 0)
    k_r = KF - 19
    ccfg, s0, f = field_cases["ahead"]
    e_r = eps3[:, :k_r].contiguous()
    kc, ku, kx = rk.fused_rollout_cost(model, params, ccfg, cost_params, f,
                                       s0, U, e_r, **okw)
    pc, pu, px = rk.fused_rollout_cost_plain(model, params, ccfg,
                                             cost_params, f, s0, U, e_r,
                                             **okw)
    kb, _ = rk.dynamics_chain(model, params, ccfg, s0, U, e_r)
    bc, bx = rk.trajectory_cost_plain(model, params, ccfg, cost_params, f, U,
                                      e_r, kb, **okw)
    torch.cuda.synchronize()
    check(torch.equal(ku, pu), "obstacles kernel 3 ragged_K: u_seq differs")
    note_err("fused_rollout_cost_obstacles", agreement(
        f"obstacles kernel 3 along kernel 2 K={k_r}", "ragged_K", kc, kx, bc,
        bx, k_r))
    agreement(f"obstacles kernel 3 K={k_r}", "ragged_K", kc, kx, pc, px, k_r,
              limit=k_r // 100)
    del e_r, kb, kc, ku, pc, pu
    pass1_forms(f"obstacles pass 1 field K={SHARD[1]} k_offset={SHARD[0]}",
                "ahead",
                "fused_rng_costs_field_obstacles", model, params, ccfg, s0, f,
                okw, None, k_offset=SHARD[0], k_local=SHARD[1])
    # the BF forms of kernels 3 and 4: the strong theta from the slow start,
    # the circles placed on its swarm as above (some rollouts hit, some not)
    bcircles = obstacle_circles(bmodel, strong, bcfg, slow_start, U)
    bokw = dict(okw, obstacles=make_obstacles(bcircles, N_SLOTS, device=dev))
    print(f"[bf obstacles] strong theta, circles {bcircles}")
    bcfg_f = bcfg.replace(num_rollouts=KF)
    kc, ku, kx = rk.fused_rollout_cost(bmodel, strong, bcfg_f, cost_params,
                                       field, slow_start, U, eps3, **bokw)
    pc, pu, px = rk.fused_rollout_cost_plain(bmodel, strong, bcfg_f,
                                             cost_params, field, slow_start,
                                             U, eps3, **bokw)
    kb, _ = rk.dynamics_chain(bmodel, strong, bcfg_f, slow_start, U, eps3)
    bc, bx = rk.trajectory_cost_plain(bmodel, strong, bcfg_f, cost_params,
                                      field, U, eps3, kb, **bokw)
    del kb
    torch.cuda.synchronize()
    check(torch.equal(ku, pu), "bf kernel 3: u_seq differs")
    note_err("fused_rollout_cost_bf", agreement(
        f"bf obstacles kernel 3 along kernel 2 K={KF}", "ahead", kc, kx, bc,
        bx, KF))
    agreement(f"bf obstacles kernel 3 K={KF}", "ahead", kc, kx, pc, px, KF,
              limit=KF // 100)
    check(0 < kx.sum().item() < KF, "bf obstacles kernel 3: the circles are "
          "hit by no rollout or by all")
    del eps3
    pass1_forms(f"bf obstacles pass 1 K={KC}", "ahead", "fused_rng_costs_bf",
                bmodel, strong, bcfg, slow_start, costmap, bokw, 0)
    # BF exact pass 1 without circles: the seeded and the strong theta,
    # gaussian and OU, at K=262144, at a K that is not a multiple of 32 and
    # on a shard's slice (k_offset != 0), each bit for bit the eps-reading
    # BF kernel 1 fed the plain stream
    for theta_name, prm in (("seeded", bparams), ("strong", strong)):
        for sname, kw in SAMPLERS.items():
            pass1_forms(f"bf {theta_name} pass 1 K={KC}", sname,
                        "fused_rng_costs_bf", bmodel, prm,
                        bcfg.replace(**kw), start, costmap, {}, None)
    pass1_forms(f"bf seeded pass 1 K={KC - 13}", "ragged_K",
                "fused_rng_costs_bf", bmodel, bparams, bcfg, start, costmap,
                {}, None, k_local=KC - 13)
    pass1_forms(f"bf strong pass 1 K={SHARD[1]} k_offset={SHARD[0]}", "ou",
                "fused_rng_costs_bf", bmodel, strong,
                bcfg.replace(**SAMPLERS["ou"]), start, costmap, {}, None,
                k_offset=SHARD[0], k_local=SHARD[1])
    pass1_forms(f"bf obstacles pass 1 field K={KC}", "ahead",
                "fused_rng_costs_field_bf", bmodel, strong, bcfg, slow_start,
                field, bokw, None)

    # -- phase 18: the obstacle path, closed loop; the other forms; timing --
    obs, oparams, _, _, onote = drive_oval.build(rollouts=K, device=dev,
                                                 obstacles=circles)
    print(f"[obstacle path] {onote}")
    # a live update reaches the kernel: the same solver from the "ahead"
    # start, the circles moved away
    far = make_obstacles([[c[0] + 100.0, c[1], c[2]] for c in circles],
                         N_SLOTS, device=dev)
    moved = cost_params.replace(obstacles=far)
    _, _, x_near = obs.rollout_costs(oparams, cost_params, costmap,
                                     slow_start, U, eps)
    t_far, _, x_far = obs.rollout_costs(oparams, moved, costmap, slow_start,
                                        U, eps)
    t_ref, _, _ = rk.fused_exact_rollout_cost(model, params, cfg,
                                              cost_params, costmap,
                                              slow_start, U, eps)
    torch.cuda.synchronize()
    print(f"[obstacle path] live update: crash {int(x_near.sum().item())} "
          f"rollouts with the circles, {int(x_far.sum().item())} with them "
          f"moved 100 m away (costs then equal to no obstacles: "
          f"{torch.equal(t_far, t_ref)})")
    check(x_far.sum().item() < x_near.sum().item() and torch.equal(
        t_far, t_ref), "a live CostParams.obstacles did not reach the kernel")

    def moving(step, state):
        """The circles drift 1 cm a tick across the lane, a new array each
        tick through CostParams.obstacles (two_car_demo.py's live path)."""
        return cost_params.replace(obstacles=make_obstacles(
            [[c[0] + 0.01 * step, c[1], c[2]] for c in circles], N_SLOTS,
            device=dev))

    run("obstacle path", obs, oparams, costmap, OBS_TICKS,
        {"fused_exact_rollout_cost_obstacles": 1, "dynamics_chain": 1},
        moving)
    ocost = obs.cost
    bcap = bcfg.replace(num_rollouts=KC, kernel_rng=True)
    ocap = cfg.replace(num_rollouts=KC, kernel_rng=True)
    forms = (
        ("bf capacity", MPPISolver(bmodel, MPPICost(), bcap, device=dev),
         bparams, costmap, {"fused_rng_costs_bf": 1, "fused_rng_numer": 1,
                            "dynamics_chain_bf": 1}),
        ("bf field", MPPISolver(bmodel, MPPICost(), bcfg.replace(
            num_rollouts=KF), device=dev), bparams, field,
         {"fused_rollout_cost_bf": 1, "dynamics_chain_bf": 1}),
        ("bf field capacity", MPPISolver(bmodel, MPPICost(), bcap,
                                         device=dev), bparams, field,
         {"fused_rng_costs_field_bf": 1, "fused_rng_numer": 1,
          "dynamics_chain_bf": 1}),
        ("obstacles capacity", MPPISolver(model, ocost, ocap, device=dev),
         params, costmap, {"fused_rng_costs_obstacles": 1,
                           "fused_rng_numer": 1, "dynamics_chain": 1}),
        ("obstacles field", MPPISolver(model, ocost, cfg.replace(
            num_rollouts=KF), device=dev), params, field,
         {"fused_rollout_cost_obstacles": 1, "dynamics_chain": 1}),
        ("obstacles field capacity", MPPISolver(model, ocost, ocap,
                                                device=dev), params, field,
         {"fused_rng_costs_field_obstacles": 1, "fused_rng_numer": 1,
          "dynamics_chain": 1}),
    )
    for label, solver, prm, surface, per_solve in forms:
        run(label, solver, prm, surface, FORM_TICKS, per_solve)

    # timing: each form at its shape against its plain version and bound
    n_mlp = rk.KERNEL_NUM_WEIGHTS
    n_bf = rk.KERNEL_BF_WEIGHTS
    n_f = rk.FIELD_NUM_WEIGHTS
    mlp_step = mlp_flops(model.layers)
    n_active = sum(1 for c in circles if c[2] > 0)
    circle_ops = n_active * CIRCLE_OPS + (N_SLOTS - n_active) * SLOT_OPS + 1
    texels = 2 * (T_ - 1)
    gen.manual_seed(5)

    def surface_bound(nbytes, k, step, obstacles, surface):
        """(ms, what bounds it) for the exact map; for the field the
        tensor-core bound and then the fp32 one (``field_bounds``)."""
        other = k * (T_ * step + (T_ - 1) * (circle_ops if obstacles else 0))
        if surface != "field":
            return bound(nbytes, other)
        fp32, tc = field_bounds(nbytes, other, k * (T_ - 1) * 2, field)
        return tc + fp32

    def fused_bound(k, n_w, step, obstacles, surface):
        """Kernel 1 / 3: eps read, u_seq, costs and crash written, U, the
        weights, the state, the control ranges (and the circles, the
        field) read once; the exact map one texel per lookup."""
        nbytes = 4 * (T_ * k * 2 + 2 * T_ * k + 2 * k + T_ * 2 + n_w + 7 + 4
                      + (3 * N_SLOTS if obstacles else 0)
                      + (n_f if surface == "field" else texels * k))
        return surface_bound(nbytes, k, step, obstacles, surface)

    def pass1_bound(n_w, step, obstacles, surface):
        nbytes = (4 * (T_ * 2 + n_w + 7 + 4 + 2 * KC
                       + (3 * N_SLOTS if obstacles else 0)
                       + (n_f if surface == "field" else min(
                           costmap.height * costmap.width, texels * KC)))
                  + 16)
        return surface_bound(nbytes, KC, step + STREAM_OPS, obstacles,
                             surface)

    e_b = torch.randn((T_, KB, 2), generator=gen, device=dev)
    e_1 = eps
    e_3 = torch.randn((T_, KF, 2), generator=gen, device=dev)
    z_1 = torch.zeros((T_, 1, 2), device=dev)
    bcfg3, cfg3 = bcfg.replace(num_rollouts=KF), cfg.replace(num_rollouts=KF)
    fkw = dict(okw)
    # name -> (launch, plain, reps, plain reps, bound, TPU kernel line)
    timed = {
        "fused_exact_rollout_cost_bf": (
            rk.prepare_fused_exact_rollout_cost(
                bmodel, bparams, bcfg, cost_params, costmap, start, U,
                e_b)[0],
            lambda: rk.fused_rollout_cost_plain(
                bmodel, bparams, bcfg, cost_params, costmap, start, U, e_b),
            100, 10, fused_bound(KB, n_bf, BF_STEP_OPS, False, "exact"),
            1013),
        "dynamics_chain_bf": (
            rk.prepare_dynamics_chain(bmodel, bparams, bcfg, start, U,
                                      z_1)[0],
            lambda: rk.dynamics_chain_plain(bmodel, bparams, bcfg, start, U,
                                            z_1),
            100, 10, bound(4 * (T_ * 2 + 7 * T_ + 2 * T_ + T_ * 2 + n_bf + 7
                                + 4), BF_STEP_OPS * T_), 389),
        "fused_exact_rollout_cost_obstacles": (
            rk.prepare_fused_exact_rollout_cost(
                model, params, cfg, cost_params, costmap, start, U, e_1,
                **fkw)[0],
            lambda: rk.fused_rollout_cost_plain(
                model, params, cfg, cost_params, costmap, start, U, e_1,
                **fkw),
            100, 10, fused_bound(K, n_mlp, mlp_step, True, "exact"), 1013),
        "fused_rollout_cost_bf": (
            rk.prepare_fused_rollout_cost(bmodel, bparams, bcfg3,
                                          cost_params, field, start, U,
                                          e_3)[0],
            lambda: rk.fused_rollout_cost_plain(
                bmodel, bparams, bcfg3, cost_params, field, start, U, e_3),
            10, 2, fused_bound(KF, n_bf, BF_STEP_OPS, False, "field"), 606),
        "fused_rollout_cost_obstacles": (
            rk.prepare_fused_rollout_cost(model, params, cfg3, cost_params,
                                          field, start, U, e_3, **fkw)[0],
            lambda: rk.fused_rollout_cost_plain(
                model, params, cfg3, cost_params, field, start, U, e_3,
                **fkw),
            10, 2, fused_bound(KF, n_mlp, mlp_step, True, "field"), 606),
    }
    for form, mdl, prm, c, surf, kw, step, n_w in (
            ("fused_rng_costs_bf", bmodel, bparams, bcap, costmap, {},
             BF_STEP_OPS, n_bf),
            ("fused_rng_costs_bf_ou", bmodel, bparams,
             bcap.replace(**SAMPLERS["ou"]), costmap, {},
             BF_STEP_OPS + OU_OPS, n_bf),
            ("fused_rng_costs_obstacles", model, params, ocap, costmap, fkw,
             mlp_step, n_mlp),
            ("fused_rng_costs_field_bf", bmodel, bparams, bcap, field, {},
             BF_STEP_OPS, n_bf),
            ("fused_rng_costs_field_obstacles", model, params, ocap, field,
             fkw, mlp_step, n_mlp),
            # the MLP kernels without obstacles, re-timed in this run
            ("fused_rng_costs", model, params, ocap, costmap, {}, mlp_step,
             n_mlp)):
        timed[form] = (
            rk.prepare_fused_rng_costs(mdl, prm, c, cost_params, surf, start,
                                       U, key, **kw)[0],
            lambda mdl=mdl, prm=prm, c=c, surf=surf, kw=kw:
                rk.fused_rng_costs_plain(mdl, prm, c, cost_params, surf,
                                         start, U, key, **kw),
            5 if surf is field else 20, 2,
            pass1_bound(n_w, step, bool(kw), "field" if surf is field
                        else "exact"), 1221)
    timed["fused_exact_rollout_cost"] = (
        rk.prepare_fused_exact_rollout_cost(model, params, cfg, cost_params,
                                            costmap, start, U, e_1)[0],
        None, 100, 0, fused_bound(K, n_mlp, mlp_step, False, "exact"), 1013)
    times = {}
    for form, (launch, plain, reps, plain_reps, bnd, _) in timed.items():
        ms = cuda_ms(launch, reps)
        if (getattr(launch, "geometry", None) is not None
                and not form.startswith("dynamics_chain")):
            geometry_line(rk, f"timing {form}", launch, "rng" in form,
                          "_bf" in form, card)
        plain_ms = cuda_ms(plain, plain_reps, 1) if plain else None
        times[form] = (ms, plain_ms)
        fp32 = (f", fp32 bound {bnd[2]:.5f} ms ({bnd[3]})" if len(bnd) > 2
                else "")
        print(f"[timing] {form}: {ms:.4f} ms, plain "
              f"{'-' if plain_ms is None else f'{plain_ms:.3f}'} ms, "
              f"{'tensor-core ' if fp32 else ''}bound {bnd[0]:.5f} ms "
              f"({bnd[1]}){fp32} ({card})")
    chain_bf = chain_timing(rk, "dynamics_chain_bf", bmodel, bparams, bcfg,
                            start, U, z_1, True, 100, card)
    # BF kernel 1 at K=2560 on e_b (above) and on phase 16's closed-loop
    # tick (state, U, eps), in turns, three rounds
    bf1 = {"e_b": rk.prepare_fused_exact_rollout_cost(
               bmodel, bparams, bcfg, cost_params, costmap, start, U,
               e_b)[0],
           "closed_loop": rk.prepare_fused_exact_rollout_cost(
               *bf_tick[0], **bf_tick[1])[0]}
    ms = {inputs: [] for inputs in bf1}
    for _ in range(3):
        for inputs, launch in bf1.items():
            ms[inputs].append(cuda_ms(launch, 100))
    bf1_ms = {inputs: statistics.median(v) for inputs, v in ms.items()}
    print(f"[timing] fused_exact_rollout_cost_bf K={KB}: "
          + ", ".join(f"{t:.4f} ms on {inputs}" for inputs, t in
                      bf1_ms.items())
          + f" (medians of three rounds of 100 in turns, "
          f"{geometry_label(bf1['e_b'].geometry)}) ({card})")
    print(f"[timing] MLP without obstacles in this run: kernel A K={K} "
          f"{times['fused_exact_rollout_cost'][0]:.4f} ms, exact pass 1 "
          f"K={KC} {times['fused_rng_costs'][0]:.4f} ms; with {N_SLOTS} slots "
          f"({n_active} active): kernel A "
          f"{times['fused_exact_rollout_cost_obstacles'][0]:.4f} ms, exact "
          f"pass 1 {times['fused_rng_costs_obstacles'][0]:.4f} ms ({card})")
    profile_ticks(drive_oval, bf, bparams, cost_params, costmap, card,
                  ticks=BF_PROFILE_TICKS, tag="bf profile")

    # each form's launches from the one run that is its path
    path_of = {"fused_exact_rollout_cost_bf": "bf path",
               "dynamics_chain_bf": "bf path",
               "fused_exact_rollout_cost_obstacles": "obstacle path",
               "fused_rollout_cost_bf": "bf field",
               "fused_rollout_cost_obstacles": "obstacles field",
               "fused_rng_costs_bf": "bf capacity",
               "fused_rng_costs_obstacles": "obstacles capacity",
               "fused_rng_costs_field_bf": "bf field capacity",
               "fused_rng_costs_field_obstacles": "obstacles field capacity"}
    src = "autorally_tpu_torch/csrc/rollout_kernels.cu"
    kernels = []
    for form, path in path_of.items():
        ms, plain_ms = times[form]
        bnd, line = timed[form][4:]
        kernels.append(
            {"name": form, "route": "cuda", "source": src,
             "replaces": f"autorally_tpu/ops/rollout_kernel.py:{line}",
             "launches": launches[path][form],
             "max_abs_err": errs[form], "ms": ms, "plain_ms": plain_ms,
             "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": None,
             **({"fp32_bound_ms": bnd[2]} if len(bnd) > 2 else {}),
             **(chain_entry(chain_bf) if form == "dynamics_chain_bf"
                else {})})
        if form == "fused_exact_rollout_cost_bf":
            kernels[-1]["inputs_ms"] = bf1_ms
        if form == "fused_rng_costs_bf":
            kernels[-1]["ou_ms"] = times["fused_rng_costs_bf_ou"][0]
    return kernels, latency


# -- phase 20: the tube loop -------------------------------------------------

def _ddp_inputs(ctrl, state):
    """The DDP's inputs as ``Controller.compute_feedback_gains`` passes them
    (the measured state, U, the state and control solutions, the limits)."""
    import torch

    rngs = ctrl.model_params["control_rngs"]
    x0 = torch.as_tensor(np.asarray(state, np.float32), device=ctrl.device)
    return (x0, ctrl.cs.U, ctrl.cs.state_solution, ctrl.cs.control_solution,
            rngs[:, 0], rngs[:, 1])


def _numpy_params(params) -> dict:
    """A params dict as numpy arrays, as ``params_from_jax`` takes them."""
    return {k: ([t.cpu().numpy() for t in v] if isinstance(v, list)
                else v.cpu().numpy()) for k, v in params.items()}


def _ddp_results_equal(a, b) -> bool:
    return all(bit_equal(x, y) for x, y in zip(a, b))


def _rel_err(a, b) -> float:
    """max |a - b| over max |b|: a field's error relative to its scale."""
    a, b = a.detach().cpu().double(), b.detach().cpu().double()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def _timed(fn, samples: list):
    """``fn`` that appends its host time in ms to ``samples``."""
    def timed(*a, **kw):
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        samples.append((time.perf_counter() - t0) * 1e3)
        return out
    return timed


def ddp_on_card(tube, state, card) -> dict:
    """Phase 20 (a): the DDP on a warmed-up tick's inputs: captured against
    eager (bit for bit) and against the CPU run, timed both ways, and the
    eager run's kernel launches counted by the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from autorally_tpu_torch.solver.ddp import DDPSolver

    ctrl, ddp = tube.actual, tube.actual.ddp
    params, inputs = ctrl.model_params, _ddp_inputs(ctrl, state)
    check(ddp.captures, "the default DDP configuration does not capture")
    captured = ddp.run(params, *inputs)
    eager = ddp.run(params, *inputs, eager=True)
    torch.cuda.synchronize()
    same = _ddp_results_equal(captured, eager)
    print(f"[tube ddp] captured against eager on a warmed-up tick's inputs "
          f"(K={tube.cfg.num_rollouts} solve, T={ddp.T}): bit for bit "
          f"{same}; cost {float(captured.cost):.6g}, max|K| "
          f"{captured.feedback_gain.abs().max().item():.4g}")
    check(same, "the captured DDP run differs from the eager run")
    for name, t in zip(captured._fields, captured):
        check(torch.isfinite(t).all().item(), f"DDP {name} not finite")

    cls = type(ctrl.model)
    cpu_model = cls(ddp.dt, control_ranges=tube.cfg.control_ranges,
                    device="cpu")
    cpu_params = cpu_model.params_from_jax(_numpy_params(params))
    cpu_res = DDPSolver(cpu_model, ddp.dt, ddp.T, ddp.cfg, device="cpu").run(
        cpu_params, *(t.cpu() for t in inputs))
    errs = {n: _rel_err(g, c) for n, g, c in zip(captured._fields, captured,
                                                 cpu_res)}
    print(f"[tube ddp] GPU against the port's CPU run, max|err| over the "
          f"field's max|value|: {errs} (limit {DDP_CPU_REL})")
    check(all(e <= DDP_CPU_REL for e in errs.values()),
          f"DDP on the card and on the CPU differ: {errs}")

    def host_ms(fn, reps):
        fn()
        torch.cuda.synchronize()
        out = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(out)

    run_c = lambda: ddp.run(params, *inputs)
    run_e = lambda: ddp.run(params, *inputs, eager=True)
    # two runs at once, each on its own stream, as the tube's controllers
    # run theirs
    streams = [torch.cuda.Stream() for _ in range(2)]
    run_pair = lambda: [ddp.run(params, *inputs, stream=s) for s in streams]
    t = {"eager_ms": cuda_ms(run_e, DDP_EAGER_REPS, warmup=1),
         "eager_host_ms": host_ms(run_e, DDP_EAGER_REPS),
         "captured_ms": cuda_ms(run_c, DDP_REPS),
         "captured_host_ms": host_ms(run_c, DDP_REPS),
         "pair_host_ms": host_ms(run_pair, DDP_REPS)}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run_e()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    launches = sum(1 for e in prof.events()
                   if e.name in ("cudaLaunchKernel", "cudaLaunchKernelExC",
                                 "cuLaunchKernel", "cuLaunchKernelEx"))
    t["eager_device_events"] = len(kernels)
    t["eager_kernel_launches"] = launches
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run_c()
        torch.cuda.synchronize()
    t["captured_device_events"] = sum(
        1 for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA)
    print(f"[tube ddp] one DDP run (T={ddp.T}): eager {t['eager_ms']:.3f} ms "
          f"(CUDA events) / {t['eager_host_ms']:.3f} ms (host clock), "
          f"{launches} kernel launches from the host, {len(kernels)} device "
          f"events (profiler); captured {t['captured_ms']:.3f} ms (CUDA "
          f"events) / {t['captured_host_ms']:.3f} ms (host clock, one graph "
          f"launch and the copies in and out), "
          f"{t['captured_device_events']} device events; two captured runs "
          f"on two streams at once {t['pair_host_ms']:.3f} ms (host clock) "
          f"({card})")
    return t


def tube_drive(run_tube_mppi, rk, tag, model, ticks, card):
    """``ticks`` ticks of ``run_tube_mppi``'s loop with the launch counters
    set to 0 just before and read just after: exactly two launches of
    kernel 1 and two of kernel 2 a tick, no plain-version call; the tick's
    host time split into the solves, the DDP runs, the plant step and the
    rest.  Returns (tube, drive result, split, the car's final u_x and
    distance from the start)."""
    import torch

    from autorally_tpu_torch import drive_oval

    tube = run_tube_mppi.build(ticks=ticks, model=model,
                               device=torch.device("cuda", 0))
    split = {"solve": [], "ddp": [], "gains": [], "plant": []}
    for ctrl in (tube.actual, tube.predicted):
        ctrl.compute_control = _timed(ctrl.compute_control, split["solve"])
        # each DDP run is enqueued on its controller's stream; the loop
        # waits for the chosen one's when it reads its gains
        ctrl.compute_feedback_gains = _timed(ctrl.compute_feedback_gains,
                                             split["ddp"])
        ctrl.get_feedback_gains = _timed(ctrl.get_feedback_gains,
                                         split["gains"])
    tube.plant.step_sim = _timed(tube.plant.step_sim, split["plant"])
    sfx = "_bf" if model == "bf" else ""
    # Python's collections during the drive (a full one over this process's
    # heap can outlast a tick): generation and ms of each
    collections, started = [], []

    def on_gc(phase, info):
        if phase == "start":
            started[:] = [time.perf_counter()]
        elif started:
            collections.append((info["generation"],
                                (time.perf_counter() - started[0]) * 1e3))

    rk.LAUNCHES.clear()
    gc.callbacks.append(on_gc)
    try:
        with PlainCalls(rk) as plain:
            out = run_tube_mppi.drive(tube,
                                      log=lambda m: print(f"[{tag}] {m}"))
    finally:
        gc.callbacks.remove(on_gc)
    got = dict(rk.LAUNCHES)
    want = {"fused_exact_rollout_cost" + sfx: 2 * ticks,
            "dynamics_chain" + sfx: 2 * ticks}
    timing, plant = out["timing"], tube.plant
    tick_ms = np.array(timing.tick_samples_ms)
    # the loop's first DDP runs (before tick 1) are not in a tick; a tick
    # enqueues two and waits for the chosen one's gains
    ddp = (np.array(split["ddp"][2:]).reshape(ticks, 2).sum(1)
           + np.array(split["gains"]))
    solve = np.array(split["solve"]).reshape(ticks, 2).sum(1)
    plant_ms = np.array(split["plant"])
    rest = tick_ms - solve - ddp
    pct = lambda a: (float(np.percentile(a, 50)), float(np.percentile(a, 99)))
    res = {"tick": pct(tick_ms), "solves": pct(solve), "ddp": pct(ddp),
           "plant": pct(plant_ms), "rest": pct(rest)}
    s = plant.true_state
    moved = float(np.hypot(*(s[:2] - np.array(drive_oval.START[:2]))))
    pub = np.array([p[1:] for p in plant.published], np.float64)
    status = plant.check_status(plant.get_last_pose_time())
    print(f"[{tag}] K={tube.cfg.num_rollouts} {ticks} ticks in "
          f"{out['wall_s']:.2f} s: arbitration {out['used']}; launches {got};"
          f" plain-version calls {plain.calls}; final u_x {s[4]:.3f} m/s, "
          f"moved {moved:.2f} m, status {status}, controls published "
          f"{len(pub)} ({card})")
    print(f"[{tag}] tick p50 / p99 (ms, host clock; ddp: enqueueing both "
          f"runs and waiting for the chosen one's gains; the plant step "
          f"comes after the tick): " + ", ".join(
              f"{k} {v[0]:.3f} / {v[1]:.3f}" for k, v in res.items())
          + f"; the slowest tick {tick_ms.max():.3f} (tick "
          f"{int(tick_ms.argmax()) + 1})")
    slow = max(collections, key=lambda c: c[1], default=(None, 0.0))
    print(f"[{tag}] Python's collections in the drive (the DDP's captures "
          f"collect once a stream, before the first tick): {len(collections)}"
          f", {sum(1 for g, _ in collections if g == 2)} of generation 2; "
          f"the slowest {slow[1]:.3f} ms (generation {slow[0]})")
    check(got == want, f"{tag}: launches {got}, expected {want}")
    check(not any(plain.calls.values()), f"{tag}: a plain version ran on "
          f"the card: {plain.calls}")
    check(len(pub) >= ticks and np.isfinite(pub).all(),
          f"{tag}: {len(pub)} controls published, or not finite")
    check(status == 0, f"{tag}: status {status} at the end")
    return tube, out, res, (float(s[4]), moved)


def tube_hot_updates(run_tube_mppi, rk, card):
    """Phase 20 (c): a model push and a cost-params push in the middle of
    a run, each seen by the next tick's solves and DDP runs, and a throttle
    cut seen by the next DDP clamp."""
    import torch

    from autorally_tpu_torch.models import NeuralNetDynamics
    from autorally_tpu_torch.solver.mppi import MPPISolver

    tube = run_tube_mppi.build(ticks=HOT_TICKS,
                               device=torch.device("cuda", 0))
    actual, predicted, plant = tube.actual, tube.predicted, tube.plant
    model, ddp, solver = actual.model, actual.ddp, actual.solver
    old = actual.model_params
    new = {**old, "weights": [w * 1.1 for w in old["weights"]],
           "biases": [b * 1.1 for b in old["biases"]]}
    new_cost = actual.cost_params.replace(desired_speed=4.0)
    push = HOT_TICKS - 2
    calls = {"rollouts": [], "ddp": []}
    rollout_costs, run = solver.rollout_costs, ddp.run

    def recorder(fn, name):
        def recorded(*a, **kw):
            out = fn(*a, **kw)
            calls[name].append((a, kw, out))
            return out
        return recorded

    solver.rollout_costs = recorder(rollout_costs, "rollouts")
    ddp.run = recorder(run, "ddp")
    ticks = {}

    def on_tick(i, chosen, used, state):
        ticks[i] = {k: list(v) for k, v in calls.items()}
        for v in calls.values():
            v.clear()
        if i == push:
            plant.push_model_params(new)
            plant.push_cost_params(new_cost)
        elif i == push + 1:
            ticks["cost"] = (actual.cost_params is new_cost
                             and predicted.cost_params is new_cost)
            actual.cut_throttle()

    run_tube_mppi.drive(tube, log=lambda m: None, on_tick=on_tick)
    torch.cuda.synchronize()             # the DDP streams' last runs
    # the actual controller's solve after the push (its first rollouts)
    # against a fresh solver and model on the new weights, and the old
    a, kw, out = ticks[push + 1]["rollouts"][0]
    fresh_model = NeuralNetDynamics(model.dt,
                                    control_ranges=tube.cfg.control_ranges,
                                    device=model.device)
    fresh_params = fresh_model.params_from_jax(_numpy_params(new))
    fresh = MPPISolver(fresh_model, solver.cost, tube.cfg,
                       device=model.device).rollout_costs(
                           fresh_params, *a[1:], **kw)
    stale = rollout_costs(old, *a[1:], **kw)
    check(a[0] is new, "the solve after the push was not given the new "
          "weights")
    same_costs = bit_equal(out[0], fresh[0])
    moved_costs = not bit_equal(out[0], stale[0])
    # the actual controller's DDP run after the push against eager runs
    da, _, dout = ticks[push + 1]["ddp"][0]
    same_ddp = _ddp_results_equal(dout, run(*da, eager=True))
    moved_ddp = not bit_equal(dout.feedback_gain,
                              run(old, *da[1:], eager=True).feedback_gain)
    ca, _, cout = ticks[push + 2]["ddp"][0]
    cut_max = float(ca[6][1])
    cut_thr = float(cout.control_traj[:, 1].max())
    print(f"[tube hot] model push (weights x1.1) at tick {push}: kernel 1's "
          f"costs of the next solve bit for bit a fresh solver's on the new "
          f"weights {same_costs}, and not the old weights' {moved_costs}; "
          f"the next DDP run bit for bit an eager run on the new weights "
          f"{same_ddp}, its gains not the old weights' {moved_ddp}; cost "
          f"params on both controllers {ticks['cost']}; after cut_throttle "
          f"the DDP's throttle limit {cut_max} and its highest throttle "
          f"{cut_thr:.4g} ({card})")
    check(same_costs and moved_costs, "the solve after a model push did "
          "not run on the new weights")
    check(same_ddp and moved_ddp, "the DDP run after a model push did not "
          "run on the new weights")
    check(ticks["cost"], "a cost-params push did not reach both "
          "controllers")
    check(cut_max == 0.0 and cut_thr <= 0.0,
          "cut_throttle did not zero the DDP's throttle limit")


def tube_phase(run_tube_mppi, rk, card) -> dict:
    """Phase 20: the tube loop at BASELINE #1's width (a)-(d)."""
    import torch

    # (a) the DDP on the inputs of a warmed-up tick
    warm = tube_drive(run_tube_mppi, rk, "tube warm-up", "nn", WARM_TICKS,
                      card)[0]
    ddp_t = ddp_on_card(warm, warm.plant.full_state.to_vector(), card)
    # (b) 200 ticks, lockstep, DDP gains on
    _, out, split, (u_x, moved) = tube_drive(run_tube_mppi, rk, "tube",
                                             "nn", TUBE_TICKS, card)
    check(u_x > TUBE_MIN_SPEED, f"tube: the car did not accelerate: u_x "
          f"{u_x:.3f} m/s, not over {TUBE_MIN_SPEED}")
    check(moved > 1.0, f"tube: the car moved {moved:.2f} m")
    # (c) hot updates mid-run
    tube_hot_updates(run_tube_mppi, rk, card)
    # (d) the BF model's Jacobians through the DDP on the card
    bf, _, bf_split, _ = tube_drive(run_tube_mppi, rk, "tube BF", "bf",
                                    TUBE_BF_TICKS, card)
    bf_inputs = _ddp_inputs(bf.actual, bf.plant.full_state.to_vector())
    bf_same = _ddp_results_equal(
        bf.actual.ddp.run(bf.actual.model_params, *bf_inputs),
        bf.actual.ddp.run(bf.actual.model_params, *bf_inputs, eager=True))
    torch.cuda.synchronize()
    print(f"[tube BF] captured DDP bit for bit the eager run on the last "
          f"tick's inputs: {bf_same}")
    check(bf_same, "tube BF: the captured DDP differs from the eager run")
    bf_ddp = ddp_nodes(bf.actual.ddp, bf.actual.model_params, bf_inputs)
    print(f"[tube BF] one captured BF DDP run (the fused BF step): "
          f"{bf_ddp['nodes']} device events (graph nodes), "
          f"{bf_ddp['ms']:.3f} ms (CUDA events); the MLP's "
          f"{ddp_t['captured_device_events']} and {ddp_t['captured_ms']:.3f} "
          f"ms; BF tube tick p50 / p99 {bf_split['tick'][0]:.3f} / "
          f"{bf_split['tick'][1]:.3f} ms against the 20 ms budget ({card})")
    _, _, bf_long, _ = tube_drive(run_tube_mppi, rk, "tube BF long", "bf",
                                  TUBE_BF_LONG_TICKS, card)
    return {"ddp": ddp_t, "split": split, "bf_split": bf_split,
            "bf_long_split": bf_long, "used": out["used"], "bf_ddp": bf_ddp}


def ddp_nodes(ddp, params, inputs) -> dict:
    """One captured DDP run's device events (its graph's kernel nodes,
    profiler) and its time (CUDA events, median of DDP_REPS)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    run = lambda: ddp.run(params, *inputs)
    ms = cuda_ms(run, DDP_REPS)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    nodes = sum(1 for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA)
    return {"nodes": nodes, "ms": ms}


def episode_equal(a, b) -> bool:
    """Every field of two ``EpisodeResult``s bit for bit."""
    return all(bit_equal(x, y) for x, y in zip(a, b))


class Captures:
    """Counts and times a runner's captures (``EpisodeRunner._capture``:
    the eager warm-up tick and the capture)."""

    def __init__(self, runner):
        self.seconds = []
        capture = runner._capture

        def timed(*a, **kw):
            t0 = time.perf_counter()
            capture(*a, **kw)
            self.seconds.append(time.perf_counter() - t0)
        runner._capture = timed


def episode_setup(dev, model: str = "nn", rollouts: int = K, cost=None,
                  **cfg_kw):
    """(solver, params, costmap, start, lap line, crossings) of phase 21:
    the oval of ``load_track``, seeded weights (``init_params(0)``)."""
    from autorally_tpu_torch.config import MPPIConfig
    from autorally_tpu_torch.costs import MPPICost
    from autorally_tpu_torch.models import (BasisFunctionDynamics,
                                            NeuralNetDynamics)
    from autorally_tpu_torch.solver.mppi import MPPISolver
    from autorally_tpu_torch.tools.lap_eval import load_track

    cm, start_pose, line, xings = load_track("oval", device=dev)
    cfg = MPPIConfig(num_rollouts=rollouts, num_timesteps=T, **cfg_kw)
    cls = BasisFunctionDynamics if model == "bf" else NeuralNetDynamics
    dyn = cls(cfg.dt, control_ranges=cfg.control_ranges, device=dev)
    params = dyn.init_params(0)
    solver = MPPISolver(dyn, cost or MPPICost(cfg.l1_cost), cfg, device=dev)
    start = [start_pose[0], start_pose[1], start_pose[2], 0, 0, 0, 0]
    return solver, params, cm, start, line, xings


def episode_held(tag, runner, args, kw=None) -> dict:
    """One captured run of ``runner`` against the same run eagerly on the
    card: every field bit for bit, every value finite.  Returns the
    captured run's result and the captures it took."""
    import torch

    kw = kw or {}
    caps = getattr(runner, "_smoke_captures", None)
    if caps is None:
        caps = runner._smoke_captures = Captures(runner)
    n0 = len(caps.seconds)
    cap = runner.run(*args, **kw)
    eag = runner.run(*args, eager=True, **kw)
    torch.cuda.synchronize()
    same = episode_equal(cap, eag)
    finite = all(torch.isfinite(t.float()).all().item() for t in cap)
    used = int(cap.used_actual.sum().item())
    print(f"[episode] {tag}: {runner.n_ticks} ticks captured ("
          f"{len(caps.seconds) - n0} capture(s)) bit for bit the eager run "
          f"{same}, finite {finite}, actual-state controller used {used} / "
          f"{runner.n_ticks}, final u_x {cap.states[-1, 4].item():.3f} m/s")
    check(same, f"episode {tag}: the captured run differs from the eager "
          f"run")
    check(finite, f"episode {tag}: a value is not finite")
    return {"result": cap, "captures": len(caps.seconds) - n0}


def episode_launches(rk, runner, args, card) -> dict:
    """Phase 21 (b): ``EP_PROFILE_TICKS`` replayed ticks under the
    profiler: exactly two launches of kernel 1's and two of kernel 2's
    instances a tick, and no plain-version call in the capture or the
    replays.  (``rk.LAUNCHES`` counts in Python: under replay it sees the
    capture only.)"""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with PlainCalls(rk) as plain:
        runner.run(*args)                     # captures
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            runner.run(*args)                 # replays only
            torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    ours = {"kernel 1": [n for n in names if "fused_exact" in n],
            "kernel 2": [n for n in names if "dynamics_chain" in n],
            "other": [n for n in names if any(
                k in n for k in ("fused_rng", "fused_field",
                                 "weighted_update"))]}
    count = {k: len(v) for k, v in ours.items()}
    n = runner.n_ticks
    print(f"[episode launches] {n} replayed ticks (profiler): kernel 1 "
          f"{count['kernel 1']} ({sorted(set(ours['kernel 1']))[:1]}), "
          f"kernel 2 {count['kernel 2']} "
          f"({sorted(set(ours['kernel 2']))[:1]}), other rollout kernels "
          f"{count['other']}; {len(names)} device events in all "
          f"({len(names) / n:.0f} a tick); plain-version calls "
          f"{plain.calls} ({card})")
    check(names, "episode: the profiler recorded no device events")
    check(count == {"kernel 1": 2 * n, "kernel 2": 2 * n, "other": 0},
          f"episode: launches {count}, expected 2 + 2 a tick")
    check(not any(plain.calls.values()), f"episode: a plain version ran "
          f"on the card: {plain.calls}")
    return {"kernel 1": count["kernel 1"] / n, "kernel 2":
            count["kernel 2"] / n, "device_events_per_tick": len(names) / n}


def episode_timing(tag, runner, args, line, xings, card) -> dict:
    """Phase 21 (d): a first run (the capture, timed) and a second,
    replayed run timed with CUDA events (ms a tick, the host's staging and
    noise draws included) and the host clock (ticks/s, sim-seconds a
    wall-second); the second run's ``episode_metrics``."""
    import torch

    from autorally_tpu_torch.tools.lap_eval import episode_metrics

    caps = Captures(runner)
    t0 = time.perf_counter()
    runner.run(*args)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    e0.record()
    res = runner.run(*args)
    e1.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n, dt = runner.n_ticks, runner.solver.cfg.dt
    ms = e0.elapsed_time(e1) / n
    m = episode_metrics(res, args[2], line, xings, dt,
                        float(args[1].boundary_threshold))
    out = {"capture_s": caps.seconds[0] if caps.seconds else None,
           "first_run_s": first_s, "ms_per_tick": ms,
           "ticks_per_s": n / wall, "sim_s_per_wall_s": n * dt / wall,
           "laps": m["laps"], "mean_speed": m["mean_speed"],
           "offtrack_frac": m["offtrack_frac"], "mean_ess": m["mean_ess"]}
    check(len(caps.seconds) == 1, f"episode {tag}: {len(caps.seconds)} "
          f"captures in two runs, expected 1")
    print(f"[episode timing] {tag}: capture {out['capture_s']:.3f} s "
          f"(warm-up tick and capture; first run {first_s:.3f} s); "
          f"{n} replayed ticks {ms:.4f} ms a tick (CUDA events), "
          f"{out['ticks_per_s']:.1f} ticks/s, "
          f"{out['sim_s_per_wall_s']:.3f} sim-s a wall-s (host clock); laps "
          f"{m['laps']}, mean speed {m['mean_speed']} m/s, off-track "
          f"{m['offtrack_frac']}, mean ESS {m['mean_ess']} ({card})")
    check(torch.isfinite(res.states).all().item(), f"episode {tag}: "
          f"states not finite")
    return out


def laps_artifact_errors(d: dict) -> list:
    """The rules of ``tests/test_artifacts.py::validate_laps``, the
    winding track allowed beside ccrf, marietta and oval: a list of what
    breaks them."""
    num = lambda x: isinstance(x, (int, float)) and not isinstance(x, bool)
    errs = []
    if d.get("artifact") != "laps" or not isinstance(d.get("round"), int):
        errs.append("header")
    for row in d.get("rows") or [None]:
        if not isinstance(row, dict):
            errs.append("no rows")
            continue
        if not (isinstance(row.get("name"), str)
                and row.get("track") in ("ccrf", "marietta", "oval",
                                         "winding")
                and isinstance(row.get("K"), int)
                and isinstance(row.get("T"), int)
                and num(row.get("desired_speed")) and row.get("runs")):
            errs.append(f"row {row.get('name')}")
        for r in row.get("runs") or []:
            keys = ("mean_speed", "max_speed", "max_slip", "offtrack_frac",
                    "rollout_crash_frac", "mean_ess")
            if not (isinstance(r.get("laps"), int)
                    and isinstance(r.get("lap_times_s"), list)
                    and (r.get("best_lap_s") is None
                         or num(r.get("best_lap_s")))
                    and all(num(r.get(k)) for k in keys)
                    and 0.0 <= r["offtrack_frac"] <= 1.0):
                errs.append(f"run of {row.get('name')}")
    return errs


def episode_phase(rk, card, dev=None) -> dict:
    """Phase 21: the closed-loop episode on the card (a)-(e)."""
    import torch

    from autorally_tpu_torch.config import CostParams
    from autorally_tpu_torch.costs import ObstacleCost, make_obstacles
    from autorally_tpu_torch.drive_oval import (OBSTACLE_COEFF,
                                                OBSTACLE_INFLATION)
    from autorally_tpu_torch.models import NeuralNetDynamics
    from autorally_tpu_torch.runtime.episode import EpisodeRunner
    from autorally_tpu_torch.tools import lap_suite

    dev = torch.device("cuda", 0) if dev is None else dev
    cp = CostParams(desired_speed=6.0)
    solver, params, cm, start, line, xings = episode_setup(dev)
    cfg = solver.cfg
    out = {}

    def tube(n_ticks, **kw):
        """The tube with gains, two plant substeps a tick and an ESS
        target on the seeded MLP."""
        true = NeuralNetDynamics(cfg.dt / 2, control_ranges=cfg.control_ranges,
                                 device=dev)
        return EpisodeRunner(solver, true_model=true, n_ticks=n_ticks,
                             use_feedback_gains=True, pose_substeps=2,
                             ess_target_frac=0.25, **kw)

    # (a) bit equality, and no stale graph after other cost params
    runner = tube(EP_BIT_TICKS)
    first = episode_held("gains, 2 substeps, ESS target 0.25", runner,
                         (params, cp, cm, start))
    cp2 = cp.replace(desired_speed=4.0)
    second = episode_held("the same runner, desired speed 4 m/s", runner,
                          (params, cp2, cm, start))
    reseeded = episode_held("the same runner and cost params, seeds 2, 3",
                            runner, (params, cp2, cm, start),
                            dict(seed_a=2, seed_p=3))
    moved = not bit_equal(first["result"].states, second["result"].states)
    g = first["result"].gamma
    print(f"[episode] other cost params captured again "
          f"{second['captures'] == 1} and gave other states {moved}; other "
          f"seeds replayed the same graph {reseeded['captures'] == 0}; "
          f"gamma {g[0].item():.4g} -> {g[-1].item():.4g} (ESS target "
          f"{0.25 * cfg.num_rollouts:.0f}) ({card})")
    check(first["captures"] == 1 and second["captures"] == 1
          and reseeded["captures"] == 0, "episode: captures "
          f"{first['captures']}, {second['captures']}, "
          f"{reseeded['captures']}, expected 1, 1, 0")
    check(moved, "episode: a run with other cost params replayed the "
          "stale graph")
    check(g[-1].item() != g[0].item(), "episode: the ESS law kept gamma")
    del runner, first, second, reseeded

    # (b) launches of the replayed tick
    out["launches"] = episode_launches(rk, tube(EP_PROFILE_TICKS),
                                       (params, cp, cm, start), card)

    # (c) short runs: moving obstacles, the capacity mode, the asymmetric
    # tube
    traj = torch.full((EP_SHORT_TICKS, N_SLOTS, 3), -1.0, device=dev)
    steps = torch.arange(EP_SHORT_TICKS, device=dev, dtype=torch.float32)
    traj[:, 0, 0], traj[:, 0, 1], traj[:, 0, 2] = 30.3, 2.0 - 0.01 * steps, 0.5
    traj[:, 1, 0], traj[:, 1, 1], traj[:, 1, 2] = 29.5 + 0.01 * steps, 3.5, 0.5
    osolver, oparams, *_ = episode_setup(dev, cost=ObstacleCost(
        make_obstacles(traj[0].tolist(), N_SLOTS, device=dev),
        OBSTACLE_COEFF, OBSTACLE_INFLATION))
    episode_held("moving obstacles (16 slots)",
                 EpisodeRunner(osolver, n_ticks=EP_SHORT_TICKS),
                 (oparams, cp, cm, start), dict(obstacle_traj=traj))
    csolver, cparams, *_ = episode_setup(dev, rollouts=KC, kernel_rng=True)
    check(csolver._use_kernel_rng(cm), "the capacity solver's mode")
    episode_held(f"the capacity mode (K={KC})",
                 EpisodeRunner(csolver, n_ticks=EP_SHORT_TICKS),
                 (cparams, cp, cm, start))
    episode_held(f"the asymmetric tube (K_pred={EP_K_PRED})",
                 EpisodeRunner(solver, n_ticks=EP_SHORT_TICKS,
                               solver_predicted=solver.with_rollouts(
                                   EP_K_PRED)),
                 (params, cp, cm, start))
    del osolver, csolver
    gc.collect()
    torch.cuda.empty_cache()

    # (d) timing
    out["timing"] = {
        "nn": episode_timing(f"MLP K={K}, {EP_TICKS} ticks", EpisodeRunner(
            solver, n_ticks=EP_TICKS), (params, cp, cm, start), line, xings,
            card),
        "nn_gains": episode_timing(
            f"MLP K={K} with gains, {EP_GAIN_TICKS} ticks", EpisodeRunner(
                solver, n_ticks=EP_GAIN_TICKS, use_feedback_gains=True),
            (params, cp, cm, start), line, xings, card)}
    bsolver, bparams, *_ = episode_setup(dev, model="bf", rollouts=KB)
    out["timing"]["bf_gains"] = episode_timing(
        f"BF K={KB} with gains, {EP_BF_TICKS} ticks", EpisodeRunner(
            bsolver, n_ticks=EP_BF_TICKS, use_feedback_gains=True),
        (bparams, cp, cm, start), line, xings, card)
    gc.collect()
    torch.cuda.empty_cache()

    # (e) the lap suite's rows
    artifact = {"artifact": "laps", "round": 6, "ticks": EP_LAP_TICKS,
                "seeds": 1, "smoke": False, "rows": []}
    for row in EP_LAP_ROWS:
        t0 = time.perf_counter()
        runs = lap_suite.run_config(row, EP_LAP_TICKS, 1, device=dev)
        artifact["rows"].append({**row, "weights": runs[0]["weights"],
                                 "runs": runs})
        r = runs[0]
        print(f"[episode laps] {row['name']}: {EP_LAP_TICKS} ticks in "
              f"{time.perf_counter() - t0:.2f} s (capture included): laps "
              f"{r['laps']}, mean speed {r['mean_speed']} m/s, max speed "
              f"{r['max_speed']}, off-track {r['offtrack_frac']}, rollout "
              f"crash {r['rollout_crash_frac']}, mean ESS {r['mean_ess']}; "
              f"weights {r['weights']} ({card})")
    errs = laps_artifact_errors(artifact)
    print(f"[episode laps] the artifact against validate_laps's rules "
          f"(winding allowed): {errs or 'valid'}")
    check(not errs, f"episode laps: the artifact breaks {errs}")
    return out


# -- phase 22: the async loop -------------------------------------------------

def _bits(out_a, out_b) -> bool:
    """Two harvested ``TubeTickOutput``s bit for bit."""
    return all((x is None and y is None) or (
        x is not None and y is not None
        and np.asarray(x).tobytes() == np.asarray(y).tobytes())
        for x, y in zip(out_a, out_b))


def _busy_ms(events) -> float:
    """The union of the device events' intervals (profiler, us) in ms."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, end = 0.0, None
    for a, b in spans:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy / 1e3


def async_captured_vs_eager(run_tube_mppi, card) -> dict:
    """Phase 22 (a): one tube captured, one eager on the card, the same
    states and strides (0, 1, 2, T-1 mixed) and a cost push at tick
    ASYNC_PUSH_AT: every harvested output and the final carries bit for
    bit; the captured tube captured twice (the push), the eager one never."""
    import torch

    from autorally_tpu_torch.runtime.async_loop import AsyncTubeController
    from autorally_tpu_torch.runtime.profiling import count_solve_traces

    tube = run_tube_mppi.build(ticks=1, device=torch.device("cuda", 0))
    a = tube.actual
    tubes = [AsyncTubeController(a.solver, a.model_params, a.cost_params,
                                 a.costmap, eager=eager)
             for eager in (False, True)]
    traces = [count_solve_traces(t) for t in tubes]
    rs = np.random.default_rng(22)
    start = np.array(tube.plant.true_state, np.float32)
    strides = [(0, 1, 2, T - 1, 1)[i % 5] for i in range(ASYNC_BIT_TICKS)]
    for t in tubes:
        t.reset(start)
    same, finite = 0, True
    for i, stride in enumerate(strides):
        if i == ASYNC_PUSH_AT:
            for t in tubes:
                t.update_cost_params(t.cost_params.replace(
                    desired_speed=4.0))
        state = start + rs.normal(0, 0.05, 7).astype(np.float32)
        outs = [t.dispatch(state, stride).result() for t in tubes]
        same += _bits(*outs)
        finite &= all(np.isfinite(np.asarray(x, np.float64)).all()
                      for x in outs[0] if x is not None)
    carries = all(
        torch.equal(getattr(getattr(tubes[0], h), f),
                    getattr(getattr(tubes[1], h), f))
        for h in ("cs_a", "cs_p") for f in ("U", "control_hist",
                                            "state_solution",
                                            "control_solution"))
    n = ASYNC_BIT_TICKS
    print(f"[async] (a) {n} dispatches, strides {sorted(set(strides))} "
          f"mixed, a cost push at tick {ASYNC_PUSH_AT}: captured bit for bit "
          f"the eager tick in {same} / {n}, final carries equal {carries}, "
          f"finite {finite}; captures {traces[0]['n']} (captured tube), "
          f"{traces[1]['n']} (eager) ({card})")
    check(same == n and carries, f"async (a): captured dispatches differ "
          f"from eager ones ({same} / {n} equal, carries {carries})")
    check(finite, "async (a): a harvested value is not finite")
    check(traces == [{"n": 2}, {"n": 0}], f"async (a): captures {traces}, "
          f"expected 2 (the first dispatch and the push) and 0")
    return {"bit_equal": same, "captures": traces[0]["n"]}


def async_launches(run_tube_mppi, rk, card) -> dict:
    """Phase 22 (b): ASYNC_PROFILE_TICKS replayed dispatches under the
    profiler: exactly two launches of kernel 1's instances and two of
    kernel 2's a tick, no other rollout kernel, no plain-version call; and
    the graph's nodes (the device events of one bare replay)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    tube = run_tube_mppi.build(ticks=1, device=torch.device("cuda", 0))
    atube = run_tube_mppi.async_tube(tube)
    state = np.array(tube.plant.true_state, np.float32)
    atube.reset(state)
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with PlainCalls(rk) as plain:
        atube.dispatch(state, 1).result()           # captures
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            for i in range(ASYNC_PROFILE_TICKS):
                atube.dispatch(state, i % 3).result()
            torch.cuda.synchronize()
        with profile(activities=acts) as bare:
            with torch.cuda.stream(atube._stream):
                atube._graph.replay()
            torch.cuda.synchronize()
    dev = torch.autograd.DeviceType.CUDA
    names = [e.name for e in prof.events() if e.device_type == dev]
    nodes = sum(1 for e in bare.events() if e.device_type == dev)
    count = {"kernel 1": sum("fused_exact" in x for x in names),
             "kernel 2": sum("dynamics_chain" in x for x in names),
             "other": sum(any(k in x for k in ("fused_rng", "fused_field",
                                                "weighted_update"))
                          for x in names)}
    n = ASYNC_PROFILE_TICKS
    print(f"[async] (b) {n} replayed dispatches (profiler): kernel 1 "
          f"{count['kernel 1']}, kernel 2 {count['kernel 2']}, other rollout "
          f"kernels {count['other']}; {len(names)} device events "
          f"({len(names) / n:.0f} a dispatch: the graph, the noise draws, "
          f"the copies); the graph alone {nodes} device events; plain-"
          f"version calls {plain.calls} ({card})")
    check(names, "async (b): the profiler recorded no device events")
    check(count == {"kernel 1": 2 * n, "kernel 2": 2 * n, "other": 0},
          f"async (b): launches {count}, expected 2 + 2 a tick")
    check(not any(plain.calls.values()), f"async (b): a plain version ran "
          f"on the card: {plain.calls}")
    return {"kernel 1": count["kernel 1"] / n,
            "kernel 2": count["kernel 2"] / n, "graph_nodes": nodes,
            "device_events_per_dispatch": len(names) / n}


def async_drive(run_tube_mppi, depth: int, card, trace_dir=None) -> dict:
    """Phase 22 (c)-(e): ASYNC_TICKS lockstep ticks of ``run_tube_mppi``'s
    async loop at ``depth`` with ``EssTuner.attach_async`` moving gamma
    every harvest: the first harvest at tick depth + 1 and every later
    solution exactly ``depth`` periods old; one capture in all; finite
    controls, status 0, the car moving; each tick's host dispatch ms, the
    harvest's wait and the dispatch's device span (CUDA events on the
    tube's stream).  With ``trace_dir`` the last ASYNC_TRACE_TICKS ticks run
    under ``device_trace`` for the device's busy share of the period."""
    import torch

    from autorally_tpu_torch.runtime.ess_tuner import EssTuner
    from autorally_tpu_torch.runtime.profiling import (count_solve_traces,
                                                       device_trace)

    n = ASYNC_TICKS
    tube = run_tube_mppi.build(ticks=n, device=torch.device("cuda", 0))
    atube = run_tube_mppi.async_tube(tube)
    traces = count_solve_traces(atube)
    tuner = EssTuner(tube.cfg, target_frac=0.25)
    ess_hook = tuner.attach_async(atube)
    ages, gammas = [], []
    dispatch_ms, spans = [], []
    dispatch = atube.dispatch

    def timed_dispatch(state, stride):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record(atube._stream)
        t0 = time.perf_counter()
        out = dispatch(state, stride)
        dispatch_ms.append((time.perf_counter() - t0) * 1e3)
        e1.record(atube._stream)
        spans.append((e0, e1))
        return out

    atube.dispatch = timed_dispatch

    def hook(num_iter, used, state, out, harvest_ms, age_s):
        ess_hook(num_iter, used, state, out, harvest_ms, age_s)
        ages.append((num_iter, age_s))
        gammas.append(atube.cost_params.gamma)

    out = run_tube_mppi.drive(tube, log=lambda m: None, atube=atube,
                              depth=depth, on_tick_async=hook)
    torch.cuda.synchronize()
    timing, plant = out["timing"], tube.plant
    dev_ms = [a.elapsed_time(b) for a, b in spans]
    harvest = list(timing.harvest_samples_ms)
    dt = tube.cfg.dt
    # the loop harvests n - depth solutions, the drain the last depth
    steady = [a for _, a in ages[:n - depth]]
    lag_ok = (ages[0][0] == depth + 1 and len(ages) == n and all(
        abs(a - depth * dt) < dt / 2 for a in steady))
    s = plant.true_state
    pub = np.array([p[1:] for p in plant.published], np.float64)
    status = plant.check_status(plant.get_last_pose_time())
    pct = lambda a: (float(np.percentile(a, 50)), float(np.percentile(a, 99)))
    res = {"depth": depth, "dispatch_ms": pct(dispatch_ms[1:]),
           "harvest_ms": pct(harvest[depth:]), "device_ms": pct(dev_ms[1:]),
           "tick_ms": pct(list(timing.tick_samples_ms)[1:]),
           "first_dispatch_ms": dispatch_ms[0], "captures": traces["n"],
           "u_x": float(s[4])}
    print(f"[async] depth {depth}: {n} lockstep ticks in {out['wall_s']:.2f}"
          f" s, arbitration {out['used']}; the first harvest at tick "
          f"{ages[0][0]}, solution ages {min(steady):.4f}..{max(steady):.4f} "
          f"s (depth x dt = {depth * dt:.4f}); captures {traces['n']} "
          f"(gamma {gammas[0]:.4g} -> {gammas[-1]:.4g} by attach_async); "
          f"final u_x {s[4]:.3f} m/s, status {status}, controls published "
          f"{len(pub)} ({card})")
    print(f"[async] depth {depth} p50 / p99 (ms): host dispatch "
          f"{res['dispatch_ms'][0]:.3f} / {res['dispatch_ms'][1]:.3f} (the "
          f"first, which captures, {dispatch_ms[0]:.3f}), harvest wait "
          f"{res['harvest_ms'][0]:.3f} / {res['harvest_ms'][1]:.3f}, device "
          f"span of a dispatch (CUDA events) {res['device_ms'][0]:.3f} / "
          f"{res['device_ms'][1]:.3f}, the loop's tick "
          f"{res['tick_ms'][0]:.3f} / {res['tick_ms'][1]:.3f} ({card})")
    check(lag_ok, f"async depth {depth}: the published solution does not "
          f"lag by exactly {depth} dispatches: {ages[:4]}...")
    check(traces["n"] == 1, f"async depth {depth}: {traces['n']} captures "
          f"in {n} ticks with gamma moving, expected 1")
    check(len(set(gammas)) > 2, f"async depth {depth}: gamma did not move")
    check(len(pub) >= n - depth and np.isfinite(pub).all(),
          f"async depth {depth}: {len(pub)} controls published, or not "
          f"finite")
    check(status == 0, f"async depth {depth}: status {status} at the end")
    if trace_dir is not None:
        import tempfile

        atube.dispatch = dispatch
        tube2 = tube._replace(loop_cfg=dataclasses.replace(
            tube.loop_cfg, max_iter=ASYNC_TRACE_TICKS))
        with tempfile.TemporaryDirectory(dir=trace_dir) as d:
            with device_trace(d) as prof:
                t0 = time.perf_counter()
                run_tube_mppi.drive(tube2, log=lambda m: None, atube=atube,
                                    depth=depth)
                wall = (time.perf_counter() - t0) * 1e3
            cuda = [e for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA]
            size = os.path.getsize(prof.trace_path)
        busy = _busy_ms(cuda) / ASYNC_TRACE_TICKS
        period = 1e3 / tube.cfg.hz
        res["busy_ms_per_tick"] = busy
        res["busy_share_of_period"] = busy / period
        print(f"[async] depth {depth} device_trace over {ASYNC_TRACE_TICKS} "
              f"lockstep ticks ({wall:.1f} ms wall under the profiler, a "
              f"{size / 2**20:.1f} MiB Chrome trace): device busy "
              f"{busy:.3f} ms a tick (the union of {len(cuda)} device "
              f"events), {100 * busy / period:.1f} % of the {period:.0f} ms "
              f"period ({card})")
        check(cuda, "async: device_trace recorded no device events")
    return res


def async_phase(run_tube_mppi, rk, card) -> dict:
    """Phase 22: the async loop on the card (a)-(e)."""
    out = {"captured_vs_eager": async_captured_vs_eager(run_tube_mppi, card),
           "launches": async_launches(run_tube_mppi, rk, card)}
    for depth in (1, 2):
        out[f"depth{depth}"] = async_drive(
            run_tube_mppi, depth, card,
            trace_dir=os.path.join(HERE, "autorally_tpu_torch", "_build")
            if depth == 1 else None)
    return out


# -- phase 23: the realtime gates ---------------------------------------------

def gate_lines(tag, res, card) -> None:
    g = lambda k: res.get(k)
    print(f"[gate] {tag}: p50 {g('p50_ms')} ms, p99 {g('p99_ms')} ms "
          f"(budget {g('budget_ms')}), missed {g('missed')}, missed_raw "
          f"{g('missed_raw')}, valid {g('valid_ticks')} / {g('ticks')} ticks, "
          f"tainted {g('tainted_ticks')}, attempts {g('attempts_used')}, "
          f"p99 over all ticks {g('p99_all_ms')}; pacer {g('pacer')}; the "
          f"warm-up's first tick {g('first_tick_ms'):.3f} ms; captures in "
          f"the measured passes {g('captures')}, full collections in "
          f"measured ticks {g('full_collections')}; {g('weights')} ({card})")
    if "depth_final" in res:
        print(f"[gate] {tag}: harvest p50 / p99 {g('harvest_p50_ms')} / "
              f"{g('harvest_p99_ms')} ms, solution age p50 / p99 "
              f"{g('age_p50_s')} / {g('age_p99_s')} s, depth "
              f"{g('depth')} -> final {g('depth_final')} (max "
              f"{g('depth_max')}), p99 net of the harvest {g('p99_net_ms')} "
              f"ms, best attempt p99 {g('best_attempt_p99_ms')} ms ({card})")


def gate_passes(tag, res) -> None:
    """The JAX test's rules (tests/test_realtime_gate.py), without its
    skip, the native pacer, and no capture in the measured passes."""
    check(res["pacer"] == "native", f"gate {tag}: the loop paced with "
          f"{res['pacer']}, not the native pacer")
    check(res["valid_ticks"] >= 100, f"gate {tag}: {res['valid_ticks']} "
          f"valid ticks, fewer than 100")
    check(res["p99_ms"] < res["budget_ms"], f"gate {tag}: p99 "
          f"{res['p99_ms']} ms over the {res['budget_ms']} ms budget")
    check(res["missed"] == 0, f"gate {tag}: {res['missed']} missed")
    bound = 0 if res["tainted_ticks"] == 0 else res["tainted_ticks"] + 2
    check(res["missed_raw"] <= bound, f"gate {tag}: missed_raw "
          f"{res['missed_raw']} over {bound}")
    check(res["captures"] == 0, f"gate {tag}: {res['captures']} captures "
          f"in the measured passes")


def gate_phase(rk, card) -> dict:
    """Phase 23: both realtime gates on the card, the simulator a second
    process (``sim_node --cpu``, seeded weights) over loopback UDP."""
    from autorally_tpu_torch.runtime import realtime_gate as gate

    rk.LAUNCHES.clear()
    t0 = time.perf_counter()
    seq = gate.run_realtime_gate(seconds=GATE_SECONDS,
                                 attempts=GATE_ATTEMPTS,
                                 warmup_iters=GATE_WARMUP)
    seq_s = time.perf_counter() - t0
    launches = {n: rk.LAUNCHES[n] for n in ("fused_exact_rollout_cost",
                                            "dynamics_chain")}
    gate_lines(f"sequential K={seq['num_rollouts']} "
               f"T={seq['num_timesteps']} with gains ({seq_s:.1f} s)", seq,
               card)
    # warm-up included: the sequential loop solves uncaptured, two solves
    # a tick, so the counters see every launch
    want = 2 * (GATE_WARMUP + seq["ticks"])
    print(f"[gate] sequential: launches {launches} over the warm-up's "
          f"{GATE_WARMUP} and "
          f"the passes' {seq['ticks']} ticks (expected {want} each)")
    check(all(v == want for v in launches.values()),
          f"gate sequential: launches {launches}, expected {want} each")
    t0 = time.perf_counter()
    asy = gate.run_realtime_gate_async(seconds=GATE_SECONDS,
                                       attempts=GATE_ATTEMPTS, depth=2,
                                       adaptive_depth=True)
    asy_s = time.perf_counter() - t0
    gate_lines(f"async K={asy['num_rollouts']} T={asy['num_timesteps']} "
               f"with gains, depth 2 adaptive ({asy_s:.1f} s)", asy, card)
    gate_passes("sequential", seq)
    gate_passes("async", asy)
    keep = ("p50_ms", "p99_ms", "missed", "missed_raw", "valid_ticks",
            "tainted_ticks", "ticks", "first_tick_ms", "captures",
            "full_collections", "harvest_p50_ms", "harvest_p99_ms",
            "age_p50_s", "age_p99_s", "depth_final", "depth_max",
            "p99_net_ms")
    return {"sequential": {k: seq[k] for k in keep if k in seq},
            "async": {k: asy[k] for k in keep if k in asy}}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "test needs a CUDA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    try:
        import autorally_tpu_torch
    except ImportError as e:
        print(f"chip_smoke: autorally_tpu_torch not found beside "
              f"chip_smoke.py ({e})", file=sys.stderr)
        return 1
    pkg_dir = os.path.dirname(os.path.abspath(autorally_tpu_torch.__file__))
    if os.path.dirname(pkg_dir) != HERE:
        print(f"chip_smoke: autorally_tpu_torch imported from {pkg_dir}, "
              "not from beside chip_smoke.py", file=sys.stderr)
        return 1

    from autorally_tpu_torch import drive_oval
    from autorally_tpu_torch.ops import _build
    from autorally_tpu_torch.ops import rollout_kernel as rk

    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    dev = torch.device("cuda", 0)
    results = {}

    # -- phase 1: build ------------------------------------------------------
    t0 = time.perf_counter()
    lib = _build.load()
    build_s = time.perf_counter() - t0
    if lib.build is None:
        print(f"[build] {_build.library_path().name} was already built")
    else:
        print(f"[build] {_build.SOURCE.name}: nvcc {lib.build[0]:.1f}s")
        for line in lib.build[1].splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build]   {line.strip()}")
        report = ptxas_report(lib.build[1])
        for name, regs, spill in report:
            print(f"[build] {name}: {regs} registers, {spill} bytes of "
                  f"spill stores and loads")
        # kernels 1-4 in an MLP and a BF instance each (4 fused, 1 chain;
        # BF exact pass 1 is fused_rng_bf_kernel), pass 2, kernel 1 in its
        # lane groups (the MLP), kernel 2 one rollout a warp (MLP and BF),
        # and the constant quotients' check (phase 19)
        n_kernels = 11 + len(rk.LANE_GROUPS) + 2 + 1
        check(len(report) == n_kernels, f"ptxas reported {len(report)} "
              f"kernels, expected {n_kernels}")
        check(all(spill == 0 for _, _, spill in report), "a kernel spills")
        PTXAS.update((name, regs) for name, regs, _ in report)
    print(f"[build] total {build_s:.1f}s ({card})")
    # the field kernels: resources at the main path's T, and their SASS
    for rng, name in ((False, "fused_field_kernel"),
                      (True, "fused_rng_field_kernel")):
        for bf in (False, True):
            info = rk.field_kernel_info(rng, bf, T)
            print(f"[build] {name}<{'Bf' if bf else 'Mlp'}>: "
                  f"{info['registers']} registers, {info['local_bytes']} "
                  f"bytes of local memory a thread, {info['smem_bytes']} "
                  f"bytes of dynamic shared memory at T={T}, "
                  f"{info['blocks_per_sm']} blocks "
                  f"({info['blocks_per_sm'] * rk.FIELD_BLOCK // 32} warps) "
                  f"an SM")
            check(info["blocks_per_sm"] * rk.FIELD_BLOCK >= 256,
                  f"{name}: fewer than 8 resident warps an SM")
    SASS.append(library_sass())
    hmma = check_field_sass(SASS[0])
    print(f"[build] TF32 HMMA instructions in the field kernels' SASS: "
          f"{hmma}")
    check(len(hmma) == 4 and all(n > 0 for n in hmma.values()),
          "the four field kernel instances do not all hold TF32 HMMA")

    # -- shared inputs: the drive_oval configuration -------------------------
    solver, params, cost_params, costmap, note = drive_oval.build(
        rollouts=K, device=dev)
    cfg, model = solver.cfg, solver.model
    print(f"[setup] K={K} T={T} layers={model.layers} map "
          f"{costmap.height}x{costmap.width}; {note}")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    eps = torch.randn((T, K, 2), generator=gen, device=dev)
    U = torch.tensor([0.0, 0.3], device=dev).repeat(T, 1)
    start = torch.tensor(drive_oval.START, dtype=torch.float32, device=dev)
    nan_start = start.clone()
    nan_start[0] = float("nan")
    # wide swarm: exploration std x4 from a start at 6 m/s heading off the
    # map's right edge, so the lookups also clamp at the border
    edge_start = torch.tensor([37.0, 0.0, 0.3, 0.0, 6.0, 0.0, 0.0],
                              device=dev)
    slow_start = start.clone()
    slow_start[4] = 1.0
    wide = cfg.replace(steering_std=4 * cfg.steering_std,
                       throttle_std=4 * cfg.throttle_std)
    cases = {
        "nominal": (cfg, start, costmap),
        "wide_swarm": (wide, edge_start, costmap),
        "nan_x": (cfg, nan_start, costmap),
        # 2 cm texels of random cost: crash flags differ between rollouts
        # and a texel index off by one changes a cost
        "random_map": (wide, slow_start, random_costmap(dev)),
    }

    # -- phase 2: kernel A against its plain version -------------------------
    # On the random map the plain version's trajectories differ from the
    # kernel's by fp32 rounding (another summation order in the MLP), which
    # moves a few of the ~380k lookups across a 2 cm texel edge.  There
    # kernel A is held against the plain cost along kernel B's trajectories
    # (the same chain code), which isolates its cost and lookup arithmetic;
    # at most 1 % of the rollouts may differ from the whole plain version.
    # Every geometry that the launcher picks for some K (lane groups, one
    # or two rollouts a thread) runs each case, and also a K that is a
    # multiple of neither a block nor a warp and a shard's slice
    # (k_offset != 0); each bit for bit equal to the first.
    geoms = launcher_geometries(rk, bf=False)
    bf_geoms = launcher_geometries(rk, bf=True)
    print(f"[geometry] the launcher picks {[geometry_label(g) for g in geoms]}"
          f" (MLP), {[geometry_label(g) for g in bf_geoms]} (BF); at K={K} "
          f"{geometry_label(geoms[0])}, at K={KB} (BF) "
          f"{geometry_label(bf_geoms[0])}")
    err_a = 0.0
    eps_r = torch.randn((T, K + 1, 2), generator=gen, device=dev)
    shard_a = (K // 3 + 61, K - K // 3 - 61)  # (k_offset, K_local): 701
    a_cases = dict(cases, ragged_K=(cfg, start, costmap),
                   shard=(cfg, start, costmap))
    for name, (ccfg, s0, cmap) in a_cases.items():
        e, kw = {"ragged_K": (eps_r, {}),
                 "shard": (eps[:, shard_a[0]:].contiguous(),
                           dict(k_offset=shard_a[0]))}.get(name, (eps, {}))
        k_n = e.shape[1]
        pc, pu, px = rk.fused_rollout_cost_plain(
            model, params, ccfg, cost_params, cmap, s0, U, e, **kw)
        note = ""
        if name == "random_map":
            kb, _ = rk.dynamics_chain(model, params, ccfg, s0, U, e)
            pc0 = pc
            pc, px = rk.trajectory_cost_plain(model, params, ccfg,
                                              cost_params, cmap, U, e, kb)
            check(0 < px.sum().item() < K, "A random_map: crash flags do "
                  "not differ between rollouts")
            note = (", held against the plain cost along kernel B's "
                    "trajectories")

        def check_a(label, out):
            kc, ku, kx = out
            nonlocal err_a
            if name == "random_map":
                near = torch.isclose(kc, pc0, rtol=COST_RTOL, atol=COST_ATOL)
                n_differ = int((~near).sum().item())
                print(f"[kernel A] {label} random_map: {n_differ} rollouts "
                      f"differ from the plain version's own trajectories")
                check(n_differ <= MAX_RANDOM_MAP_DIFFER, f"A random_map: "
                      f"{n_differ} rollouts differ from the plain version, "
                      f"more than {MAX_RANDOM_MAP_DIFFER}")
            e_cost = (kc - pc).abs().max().item()
            e_u = (ku - pu).abs().max().item()
            n_crash_diff = int((kx != px).sum().item())
            print(f"[kernel A] {label} {name} K={k_n}: max|cost err| "
                  f"{e_cost:.3e} (cost range {pc.min().item():.4g}.."
                  f"{pc.max().item():.4g}), max|u_seq err| {e_u:.3e}, crash "
                  f"{int(px.sum().item())}/{k_n} rollouts, crash mismatches "
                  f"{n_crash_diff}{note}")
            check(torch.isfinite(kc).all().item(),
                  f"A {label} {name}: non-finite costs")
            check(torch.allclose(kc, pc, rtol=COST_RTOL, atol=COST_ATOL),
                  f"A {label} {name}: costs differ beyond rtol {COST_RTOL} "
                  f"atol {COST_ATOL}")
            check(n_crash_diff == 0, f"A {label} {name}: crash flags differ")
            check(torch.equal(ku, pu), f"A {label} {name}: u_seq differs")
            err_a = max(err_a, e_cost)

        hold_geometries(f"kernel A {name}", geoms, lambda: tuple(
            rk.fused_exact_rollout_cost(model, params, ccfg, cost_params,
                                        cmap, s0, U, e, **kw)), check_a)
    del eps_r

    # -- phase 3: kernel B against its plain version -------------------------
    # in each of its geometries (one rollout a thread, one a warp), each bit
    # for bit equal to one rollout a thread: at the cases' K=1920 (the fine
    # random map's included), on a shard's slice at a K that is not a
    # multiple of the warp form's block, and at the nominal trajectory (K=1)
    err_b = 0.0
    shard_b = 701
    b_cases = dict(cases, shard=(cfg, start, costmap))
    for name, (ccfg, s0, _) in b_cases.items():
        e, kw = ((eps[:, shard_b:].contiguous(), dict(k_offset=shard_b))
                 if name == "shard" else (eps, {}))
        ks, ku = hold_geometries(f"kernel B {name}", rk.CHAIN_GEOMETRIES,
                                 lambda: tuple(rk.dynamics_chain(
                                     model, params, ccfg, s0, U, e, **kw)),
                                 lambda label, out: None, chain=True)
        ps, pu = rk.dynamics_chain_plain(model, params, ccfg, s0, U, e, **kw)
        torch.cuda.synchronize()
        same_nan = torch.equal(torch.isnan(ks), torch.isnan(ps))
        fin = torch.isfinite(ps)
        e_s = (ks[fin] - ps[fin]).abs().max().item() if fin.any() else 0.0
        print(f"[kernel B] {name} K={e.shape[1]}: max|state err| {e_s:.3e}, "
              f"max|u_seq err| {(ku - pu).abs().max().item():.3e}")
        check(same_nan, f"B {name}: NaN pattern differs")
        check(torch.allclose(ks, ps, rtol=STATE_RTOL, atol=STATE_ATOL,
                             equal_nan=True), f"B {name}: states differ")
        check(torch.equal(ku, pu), f"B {name}: u_seq differs")
        err_b = max(err_b, e_s)
    ks, _ = hold_geometries("kernel B nominal trajectory (K=1)",
                            rk.CHAIN_GEOMETRIES, lambda: tuple(
                                rk.nominal_trajectory(model, params, cfg,
                                                      start, U)),
                            lambda label, out: None, chain=True)
    eps1 = torch.zeros((T, 1, 2), device=dev)
    ps, _ = rk.dynamics_chain_plain(model, params, cfg, start, U, eps1)
    ps = torch.cat([start[None], ps[:, :, 0].T[:-1]])
    e_nom = (ks - ps).abs().max().item()
    print(f"[kernel B] nominal trajectory (K=1): max|state err| {e_nom:.3e}")
    check(torch.allclose(ks, ps, rtol=STATE_RTOL, atol=STATE_ATOL),
          "B nominal trajectory differs")
    err_b = max(err_b, e_nom)

    # -- phase 4: the main path ----------------------------------------------
    # the same seeded configuration on the CPU (plain PyTorch path)
    cpu_solver, cpu_params, _, cpu_map, _ = drive_oval.build(
        rollouts=K, device="cpu")
    Ug, stg = solver.iterate(params, cost_params, costmap, start, U, eps)
    Uc, stc = cpu_solver.iterate(cpu_params, cost_params, cpu_map,
                                 start.cpu(), U.cpu(), eps.cpu())
    e_it = (Ug.cpu() - Uc).abs().max().item()
    print(f"[main path] one iteration GPU vs CPU: max|U_new err| {e_it:.3e}, "
          f"ess {stg.ess.item():.2f} vs {stc.ess.item():.2f}")
    check(e_it <= ITER_ATOL, f"iterate: GPU and CPU differ by {e_it}")

    rk.LAUNCHES.clear()
    out = drive_oval.drive(solver, params, cost_params, costmap, TICKS,
                           log=lambda m: print(f"[main path] {m}"))
    launches = {n: rk.LAUNCHES[n] for n in ("fused_exact_rollout_cost",
                                            "dynamics_chain")}
    st = out["solve_ms"]
    stats = out["stats"]
    print(f"[main path] {TICKS} ticks: solve latency p50 "
          f"{np.percentile(st, 50):.3f} ms p99 {np.percentile(st, 99):.3f} ms "
          f"(slide + solve + control readback, host clock; {card}); "
          f"ess {stats.ess.item():.1f}, crash% "
          f"{stats.crash_frac.item() * 100:.1f}; launches {launches}")
    check(np.isfinite(out["controls"]).all(), "non-finite controls")
    for name, n in launches.items():
        check(n >= TICKS, f"{name} launched {n} times in {TICKS} ticks")
    results["latency"] = (float(np.percentile(st, 50)),
                          float(np.percentile(st, 99)))
    # the same drive with kernel A, then kernel 2, in one rollout a thread
    # (the previous design, the same bits: the same trajectory) and in the
    # launcher's geometry, in TURN_PAIRS pairs whose order alternates
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    results["latency_turns"] = {
        "kernel A": drive_turns(
            drive_oval, "kernel A", False, rk.GEOMETRIES[0],
            launcher_geometries(rk, False)[0], solver, params, cost_params,
            costmap, out["controls"], card),
        "kernel B": drive_turns(
            drive_oval, "kernel B", True, rk.CHAIN_GEOMETRIES[0],
            rk.chain_geometry(1, sms)[:2], solver, params, cost_params,
            costmap, out["controls"], card)}
    # what the controller state's key adds to a solve on the host: the
    # split and the host-noise generator seeded from the subkey
    from autorally_tpu_torch.ops import kernel_rng
    key = solver.init_state().key
    t0 = time.perf_counter()
    for _ in range(1000):
        key, sub = kernel_rng.split(key)
        solver._noise_generator(sub)
    key_us = (time.perf_counter() - t0) * 1e3
    print(f"[main path] the key's host time a solve: {key_us:.1f} us "
          f"(split + generator, host clock, mean of 1000; {card})")

    # -- phase 5: timing -----------------------------------------------------
    flops_step = mlp_flops(model.layers)
    n_w = sum(a * b + b for a, b in zip(model.layers[:-1], model.layers[1:]))
    launch_a, _ = rk.prepare_fused_exact_rollout_cost(
        model, params, cfg, cost_params, costmap, start, U, eps)
    ms_a = cuda_ms(launch_a, 100)
    plain_a = cuda_ms(lambda: rk.fused_rollout_cost_plain(
        model, params, cfg, cost_params, costmap, start, U, eps), 10)
    bytes_a = 4 * (T * K * 2 + 2 * T * K + 2 * K + T * 2 + n_w + 7 + 4
                   + 2 * K * (T - 1))        # + one texel per front/back lookup
    bound_a, by_a = bound(bytes_a, flops_step * K * T)

    chain_b = chain_timing(rk, "B dynamics_chain", model, params, cfg, start,
                           U, eps1, False, 100, card)
    ms_b = chain_b["ms"]
    plain_b = cuda_ms(lambda: rk.dynamics_chain_plain(
        model, params, cfg, start, U, eps1), 10)
    bytes_b = 4 * (T * 2 + 7 * T + 2 * T + T * 2 + n_w + 7 + 4)
    bound_b, by_b = bound(bytes_b, flops_step * T)
    print(f"[timing] A fused_exact_rollout_cost K={K} T={T}: {ms_a:.4f} ms, "
          f"plain {plain_a:.3f} ms, bound {bound_a:.5f} ms ({by_a}) ({card})")
    geometry_line(rk, "timing A", launch_a, False, False, card)
    print(f"[timing] B dynamics_chain K=1 T={T}: {ms_b:.4f} ms, plain "
          f"{plain_b:.3f} ms, bound {bound_b:.7f} ms ({by_b}), latency floor "
          f"{chain_b['floor_ms']:.4f} ms ({card})")

    # -- phase 6: where a tick's time goes ---------------------------------
    profile_ticks(drive_oval, solver, params, cost_params, costmap, card)

    # -- phases 7-10: the kernel-RNG capacity mode ---------------------------
    cap_kernels, cap_latency = capacity_phases(
        drive_oval, solver, params, cost_params, costmap, cases, U, start,
        (cpu_solver, cpu_params, None, cpu_map), card)

    # -- phases 11-14: the neural-field costmap path -------------------------
    field_kernels, field_latency, field = field_phases(
        drive_oval, model, params, cost_params, costmap, U, start,
        edge_start, nan_start, slow_start, card)

    # -- phases 15-18: the BF model and the obstacle terms -------------------
    bf_obs_kernels, bf_obs_latency = bf_obstacle_phases(
        drive_oval, model, params, cost_params, costmap, field, cases, eps,
        U, start, slow_start, card)

    # -- phase 19: BF exact pass 1's constant quotients, every input ------
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mismatches = rk.const_quotient_check()
    quotient_s = time.perf_counter() - t0
    print(f"[quotients] div_const with its guard against __fdiv_rn, all "
          f"2^32 float32 bit patterns for each of {len(mismatches) - 2} "
          f"divisors, and the branch-free stream's quotient and root "
          f"against __fdiv_rn and __fsqrt_rn for all 2^23 uniforms: "
          f"mismatches {mismatches} ({sum(mismatches.values())} in all), "
          f"{quotient_s:.2f} s ({card})")
    check(len(mismatches) == 18 and not any(mismatches.values()),
          f"BF pass 1's branch-free arithmetic differs from IEEE "
          f"division or root: {mismatches}")

    # -- phase 20: the tube loop ----------------------------------------
    from autorally_tpu_torch import run_tube_mppi
    tube = tube_phase(run_tube_mppi, rk, card)

    # -- phase 21: the closed-loop episode, the tick one CUDA graph -------
    episode = episode_phase(rk, card)

    # -- phase 22: the async loop, the tick one CUDA graph ----------------
    async_loop = async_phase(run_tube_mppi, rk, card)

    # -- phase 23: the realtime gates, the simulator a second process -----
    gates = gate_phase(rk, card)

    src = "autorally_tpu_torch/csrc/rollout_kernels.cu"
    kernels = [
        {"name": "fused_exact_rollout_cost", "route": "cuda", "source": src,
         "replaces": "autorally_tpu/ops/rollout_kernel.py:1013",
         "launches": launches["fused_exact_rollout_cost"],
         "max_abs_err": err_a, "ms": ms_a, "plain_ms": plain_a,
         "bound_ms": bound_a, "bound_by": by_a, "library_ms": None,
         "geometry": geometry_label(launch_a.geometry)},
        {"name": "dynamics_chain", "route": "cuda", "source": src,
         "replaces": "autorally_tpu/ops/rollout_kernel.py:389",
         "launches": launches["dynamics_chain"],
         "max_abs_err": err_b, "ms": ms_b, "plain_ms": plain_b,
         "bound_ms": bound_b, "bound_by": by_b, "library_ms": None,
         **chain_entry(chain_b)},
    ] + cap_kernels + field_kernels + bf_obs_kernels
    # each kernel's geometry (kernels 1 and 2, as the launcher picks it at
    # the form's K) or design
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    field_design = ("a lane a rollout, the field on the warp's mma.sync "
                    "3xTF32 tiles, blocks of %d" % rk.FIELD_BLOCK)
    for k in kernels:
        name = k["name"]
        model = "Bf" if "_bf" in name else "Mlp"
        if name.startswith("fused_exact_rollout_cost"):
            geom = rk.exact_geometry(KB if "_bf" in name else K, sms,
                                     "_bf" in name)
            k.setdefault("geometry", geometry_label(geom))
            k["instance"] = exact_instance(geom, False, "_bf" in name)
        elif name.startswith("dynamics_chain"):
            k["instance"] = ("dynamics_chain_warp_kernel" if rk.chain_geometry(
                1, sms, "_bf" in name).group > 1 else "dynamics_chain_kernel"
                ) + f"<{model}>"
        elif name.startswith(("fused_rollout_cost", "fused_rng_costs_field")):
            k["design"] = field_design
            k["instance"] = ("fused_field_kernel" if name.startswith(
                "fused_rollout_cost") else "fused_rng_field_kernel") + (
                f"<{model}>")
        elif name.startswith("fused_rng_costs"):
            geom = rk._geometry(KC, 1, rk.EXACT_BLOCK)
            k["design"] = ("one rollout a thread, blocks of %d, weights in "
                           "shared memory" % rk.EXACT_BLOCK)
            k["instance"] = exact_instance(geom, True, "_bf" in name)
            if "_bf" in name:
                info = rk.exact_kernel_info(True, True, geom, T)
                k["design"] += (
                    "; the basis functions' quotients by constants without "
                    "the division's slow path (BfConstDivDeriv), the stream "
                    "drawn a step ahead (StreamNoiseAhead); %d registers, "
                    "%d warps an SM, %.2f waves at K=%d" % (
                        info["registers"],
                        info["blocks_per_sm"] * rk.EXACT_BLOCK // 32,
                        info["waves"], KC))
        elif name == "fused_rng_numer":
            k["design"] = ("a thread a rollout, fixed-order block sums, "
                           "blocks of %d" % rk.UPDATE_BLOCK)
            k["instance"] = "weighted_update_kernel"
    # every compiled instance with its registers (ptxas, phase 1), the ones
    # that no form above launches at its K included
    print(json.dumps({"kernels": kernels, "instances": PTXAS, "card": card,
                      "solve_ms_p50_p99": results["latency"],
                      "solve_ms_turns": results["latency_turns"],
                      "capacity_solve_ms_p50_p99": cap_latency,
                      "field_solve_ms_p50_p99": field_latency,
                      "bf_obstacle_solve_ms_p50_p99": bf_obs_latency,
                      "tube_tick_ms_p50_p99": tube["split"]["tick"],
                      "bf_tube_tick_ms_p50_p99": tube["bf_split"]["tick"],
                      "bf_tube_200_tick_ms_p50_p99":
                          tube["bf_long_split"]["tick"],
                      "bf_ddp": tube["bf_ddp"],
                      "episode_launches_per_tick": episode["launches"],
                      "episode_timing": episode["timing"],
                      "async_launches_per_tick": async_loop["launches"],
                      "async_depth1": async_loop["depth1"],
                      "async_depth2": async_loop["depth2"],
                      "gates": gates}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    except PhaseFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        rc = 1
    sys.exit(rc)
