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
``neural_K65536`` and ``rng_K262144``) — and checks every CUDA kernel of
the three paths against its plain PyTorch version.  Phases (any failure
exits non-zero):

1. build the kernels from ``autorally_tpu_torch/csrc/rollout_kernels.cu``
   (one nvcc), require six kernels and zero spill bytes in every one
   (ptxas -v);
2. kernel A (fused rollout + exact cost) against its plain version at
   K=1920, T=100 in four cases: nominal start, wide swarm (exploration
   std x4), NaN x coordinate, and a fine random map on which the crash
   flags differ between rollouts (there against the plain cost along
   kernel B's trajectories);
3. kernel B (dynamics chain) against its plain version on the same inputs,
   and at its main-path shape (the nominal trajectory, K=1);
4. the main path: one MPPI iteration on the GPU against the same iteration
   on the CPU, then ``MPPISolver`` on ``cuda`` for one untimed solve and
   200 ticks of slide + solve + plant step, with both kernels' launch
   counters reset just before and read just after;
5. timing of each kernel at its main-path shape against its plain version
   and its bound;
6. a torch.profiler trace of 50 ticks: device time by kernel and the
   device's idle share;
7. pass 1 of the capacity mode against its plain version at K=262144,
   T=100, gaussian and OU, in phase 2's four cases; its in-kernel stream
   must equal the plain stream bit for bit (pass 1 equals kernel A fed the
   plain stream);
8. pass 2 against its plain version with pass 1's softmax weights, and
   one-hot weights that extract single rollouts' controls;
9. the capacity path: one iteration on the GPU against the CPU at
   K=16384, then 100 ticks of ``drive_oval.drive`` on a capacity-mode
   solver at K=262144 for each sampler, launch counters reset before and
   read after each (1 pass 1, 1 pass 2, 1 kernel B and no kernel A per
   solve);
10. timing of both passes at K=262144 against their plain versions and
    bounds, of kernel A at the same K, and of whole solves at K=262144 in
    the capacity and the host-noise modes; a torch.profiler trace of 20
    capacity-mode ticks;
11. the field: ``drive_oval.build(neural_costmap=True)`` fits it on the
    card with ``fit_neural_costmap``'s defaults (seconds, mae, flip rate);
    kernel 3 (fused rollout + field cost) against its plain version at
    K=65536, T=100 in four cases: nominal, wide swarm, NaN x, and a
    seeded random field whose values cross the 0.65 boundary (costs
    rtol 1e-4 / atol 1e-3 and crash flags equal in every rollout in the
    nominal case, in all but 1 % elsewhere; u_seq exactly);
12. pass 1 in field mode against its plain version at K=262144, the same
    cases, gaussian and OU, and bit for bit against kernel 3 fed the plain
    stream;
13. the field path closed-loop: 100 ticks at K=65536 in the host-noise
    mode and 50 ticks at K=262144 in the capacity mode, launch counters
    reset before and read after each (1 kernel 3 and 1 kernel B per
    host-noise solve; 1 field pass 1, 1 pass 2 and 1 kernel B per capacity
    solve; nothing else), and no plain version called;
14. timing of kernel 3 and of pass 1's field mode against their plain
    versions and bounds, beside kernel A and exact pass 1 at the same K;
    whole field solves; torch.profiler traces of 10 ticks of each mode.

Prints the card's name and power limit, one ``{"kernels": [...]}`` line,
and as its last line ``{"ok": true, "device": {...}}``.  Needs one CUDA
GPU; exits non-zero without one, or without the package beside it.

Usage::

    python3 chip_smoke.py
"""

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

K, T = 1920, 100
TICKS = 200
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
# in the host-noise mode at K=65536, pass 1's field mode at K=262144.
KF = 65536
FIELD_TICKS = 100
FIELD_CAP_TICKS = 50
FIELD_PROFILE_TICKS = 10


class PhaseFailed(Exception):
    pass


def check(ok, msg):
    if not ok:
        raise PhaseFailed(msg)


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


def bound(nbytes: float, flops: float):
    t_b = nbytes / PEAK_BYTES_PER_S * 1e3
    t_f = flops / PEAK_FP32_FLOP_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def ptxas_report(log: str):
    """(kernel, registers, spill store + load bytes) for each entry
    function in ``ptxas -v`` output."""
    rows, name, spill = [], None, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            short = re.search(r"\d+([a-z_]+_kernel)E", m.group(1))
            name, spill = (short.group(1) if short else m.group(1)), None
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and name is not None:
            rows.append((name, int(m.group(1)), spill))
            name = None
    return rows


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
    # -- phase 8: pass 2 against its plain version ---------------------------
    err_p2 = 0.0
    first_pure = int(np.ceil(np.float32(cfg.pure_noise_frac * KC)))
    for sname, (c, ctx, kc) in nominal.items():
        w = torch.exp(-effective_gamma(c, cost_params) * (kc - kc.min()))
        kn = rk.fused_rng_numer(ctx, w)
        pn = rk.fused_rng_numer_plain(ctx, w)
        _, u_seq, _ = rk.fused_exact_rollout_cost(
            model, params, c, cost_params, costmap, start, U,
            rk.rng_noise(ctx))
        scale = torch.einsum("k,ctk->ct", w.abs(), u_seq.abs())
        del u_seq
        torch.cuda.synchronize()
        err = (kn - pn).abs()
        rel = (err / scale.clamp(min=1e-30)).max().item()
        print(f"[pass 2] {sname} K={KC}: max|numer err| {err.max().item():.3e}"
              f", max err / sum|w u| {rel:.3e} (limit {NUMER_RTOL}), ess "
              f"{(w.sum() ** 2 / (w * w).sum()).item():.1f}")
        check(bool((err <= NUMER_RTOL * scale).all()), f"pass 2 {sname}: "
              f"numerator differs beyond {NUMER_RTOL} of sum|w u|")
        err_p2 = max(err_p2, err.max().item())
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

    counters = {"fused_rng_costs": rk.fused_rng_costs,
                "fused_rng_numer": rk.fused_rng_numer,
                "dynamics_chain": rk.dynamics_chain,
                "fused_exact_rollout_cost": rk.fused_exact_rollout_cost}
    want = {"fused_rng_costs": 1, "fused_rng_numer": 1, "dynamics_chain": 1,
            "fused_exact_rollout_cost": 0}
    cap_solvers, latency = {}, {}
    total_launches = dict.fromkeys(counters, 0)
    for sname, c in cap_cfg.items():
        cap = MPPISolver(model, solver.cost, c, device=dev)
        check(cap._use_kernel_rng(costmap), f"{sname}: not in capacity mode")
        cap_solvers[sname] = cap
        for fn in counters.values():
            fn.launches = 0
        out = drive_oval.drive(cap, params, cost_params, costmap, CAP_TICKS,
                               log=lambda m: print(f"[capacity] {m}"))
        launches = {n: fn.launches for n, fn in counters.items()}
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
              f"{want} per solve")
        for n in counters:
            total_launches[n] += launches[n]

    # -- phase 10: timing ----------------------------------------------------
    flops_step = mlp_flops(model.layers)
    n_w = sum(a * b + b for a, b in zip(model.layers[:-1], model.layers[1:]))
    T_ = U.shape[0]
    times = {}
    for sname, c in cap_cfg.items():
        ou = OU_OPS if sname == "ou" else 0
        launch1, (kc, _), ctx = rk.prepare_fused_rng_costs(
            model, params, c, cost_params, costmap, start, U, key)
        ms1 = cuda_ms(launch1, 20)
        plain1 = cuda_ms(lambda: rk.fused_rng_costs_plain(
            model, params, c, cost_params, costmap, start, U, key), 3, 1)
        # inputs read once (U, weights, state, control ranges, key, at most
        # the whole map or one texel per lookup), costs and crash written
        bytes1 = (4 * (T_ * 2 + n_w + 7 + 4 + 2 * KC)
                  + 4 * min(costmap.height * costmap.width, 2 * KC * (T_ - 1))
                  + 16)
        bound1 = bound(bytes1, (flops_step + STREAM_OPS + ou) * KC * T_)
        w = torch.exp(-effective_gamma(c, cost_params) * (kc - kc.min()))
        launch2, partials = rk.prepare_fused_rng_numer(ctx, w)
        ms2 = cuda_ms(launch2, 50)
        plain2 = cuda_ms(lambda: rk.fused_rng_numer_plain(ctx, w), 3, 1)
        bytes2 = 4 * (KC + T_ * 2 + partials.numel()) + 16
        bound2 = bound(bytes2, (STREAM_OPS + ou + UPDATE_OPS) * KC * T_)
        times[sname] = (ms1, plain1, bound1, ms2, plain2, bound2)
        print(f"[timing] pass 1 fused_rng_costs {sname} K={KC} T={T_}: "
              f"{ms1:.4f} ms, plain {plain1:.3f} ms, bound {bound1[0]:.5f} "
              f"ms ({bound1[1]}) ({card})")
        print(f"[timing] pass 2 fused_rng_numer {sname} K={KC} T={T_}: "
              f"{ms2:.4f} ms, plain {plain2:.3f} ms, bound {bound2[0]:.5f} "
              f"ms ({bound2[1]}) ({card})")

    # kernel A at the same K on the plain stream: pass 1 less the generator
    # (and plus the eps reads and u_seq writes)
    eps = rk.rng_noise(ctx)
    launch_a, _ = rk.prepare_fused_exact_rollout_cost(
        model, params, cap_cfg["ou"], cost_params, costmap, start, U, eps)
    print(f"[timing] kernel A fused_exact_rollout_cost K={KC} T={T_}: "
          f"{cuda_ms(launch_a, 20):.4f} ms ({card})")
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
    ms1, plain1, bound1, ms2, plain2, bound2 = times["gaussian"]
    kernels = [
        {"name": "fused_rng_costs", "route": "cuda", "source": src,
         "replaces": "autorally_tpu/ops/rollout_kernel.py:1221",
         "launches": total_launches["fused_rng_costs"],
         "max_abs_err": err_p1, "ms": ms1, "plain_ms": plain1,
         "bound_ms": bound1[0], "bound_by": bound1[1], "library_ms": None},
        {"name": "fused_rng_numer", "route": "cuda", "source": src,
         "replaces": "autorally_tpu/ops/rollout_kernel.py:1346",
         "launches": total_launches["fused_rng_numer"],
         "max_abs_err": err_p2, "ms": ms2, "plain_ms": plain2,
         "bound_ms": bound2[0], "bound_by": bound2[1], "library_ms": None},
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
    entries and the field solves' latencies."""
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

    def agreement(tag, name, kc, kx, pc, px, n):
        """Costs within COST_RTOL/COST_ATOL and equal crash flags: in
        every rollout in the nominal case, in all but 1 % elsewhere (a
        field value within rounding of the boundary can latch on one side
        only).  Returns the max cost error over rollouts with equal
        flags."""
        same = kx == px
        near = torch.isclose(kc, pc, rtol=COST_RTOL, atol=COST_ATOL)
        n_differ = int((~near | ~same).sum().item())
        n_crash = int((~same).sum().item())
        err = (kc - pc)[same].abs().max().item()
        limit = 0 if name == "nominal" else n // 100
        print(f"[{tag}] {name}: max|cost err| {err:.3e} over rollouts with "
              f"equal crash flags (cost range {pc.min().item():.4g}.."
              f"{pc.max().item():.4g}), crash {int(px.sum().item())}/{n}, "
              f"crash mismatches {n_crash}, {n_differ} rollouts differ "
              f"(limit {limit})")
        check(torch.isfinite(kc).all().item(), f"{tag} {name}: non-finite")
        check(n_differ <= limit, f"{tag} {name}: {n_differ} rollouts differ "
              f"from the plain version, limit {limit}")
        if name == "random_field":
            check(0 < px.sum().item() < n, f"{tag} random_field: crash "
                  "flags do not differ between rollouts")
        return err

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
    del eps

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

    # -- phase 13: the field path closed-loop --------------------------------
    cap = MPPISolver(host.model, host.cost, cfg.replace(
        num_rollouts=KC, kernel_rng=True), device=dev)
    check(not host._use_kernel_rng(field) and cap._use_kernel_rng(field),
          "field solvers: wrong mode")
    counters = {"fused_rollout_cost": (rk.fused_rollout_cost, "launches"),
                "fused_rng_costs field": (rk.fused_rng_costs,
                                          "field_launches"),
                "fused_rng_costs exact": (rk.fused_rng_costs, "launches"),
                "fused_rng_numer": (rk.fused_rng_numer, "launches"),
                "dynamics_chain": (rk.dynamics_chain, "launches"),
                "fused_exact_rollout_cost": (rk.fused_exact_rollout_cost,
                                             "launches")}
    runs = {"host-noise": (host, FIELD_TICKS, {
                "fused_rollout_cost": 1, "dynamics_chain": 1}),
            "capacity": (cap, FIELD_CAP_TICKS, {
                "fused_rng_costs field": 1, "fused_rng_numer": 1,
                "dynamics_chain": 1})}
    latency, launches = {}, {}
    for label, (s, ticks, per_solve) in runs.items():
        for fn, attr in counters.values():
            setattr(fn, attr, 0)
        with PlainCalls(rk) as plain:
            out = drive_oval.drive(s, params, cost_params, field, ticks,
                                   log=lambda m: print(f"[field path] {m}"))
        got = {n: getattr(fn, attr) for n, (fn, attr) in counters.items()}
        st, stats = out["solve_ms"], out["stats"]
        latency[label] = (float(np.percentile(st, 50)),
                          float(np.percentile(st, 99)))
        print(f"[field path] {label} K={s.cfg.num_rollouts} {ticks} ticks: "
              f"solve latency p50 {latency[label][0]:.3f} ms p99 "
              f"{latency[label][1]:.3f} ms (slide + solve + control "
              f"readback, host clock; {card}); ess {stats.ess.item():.1f}, "
              f"crash% {stats.crash_frac.item() * 100:.1f}; launches {got}; "
              f"plain-version calls {plain.calls}")
        check(np.isfinite(out["controls"]).all(), f"field {label}: "
              "non-finite controls")
        want = {n: per_solve.get(n, 0) * (ticks + 1) for n in counters}
        check(got == want, f"field {label}: launches {got}, expected {want}")
        check(not any(plain.calls.values()), f"field {label}: a plain "
              f"version ran on the card: {plain.calls}")
        launches[label] = got

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
    bound_3 = bound(bytes_3, ops_3)
    print(f"[timing] kernel 3 fused_rollout_cost K={KF} T={T_}: "
          f"{ms_3:.4f} ms, plain {plain_3:.3f} ms, bound {bound_3[0]:.4f} ms "
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
        bound_f = bound(bytes_f, ops_f)
        times[sname] = (ms_f, plain_f, bound_f)
        print(f"[timing] pass 1 field fused_rng_costs {sname} K={KC} "
              f"T={T_}: {ms_f:.4f} ms, plain {plain_f:.3f} ms, bound "
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
    ms_f, plain_f, bound_f = times["gaussian"]
    kernels = [
        {"name": "fused_rollout_cost", "route": "cuda", "source": src,
         "replaces": "autorally_tpu/ops/rollout_kernel.py:606",
         "launches": launches["host-noise"]["fused_rollout_cost"],
         "max_abs_err": err_3, "ms": ms_3, "plain_ms": plain_3,
         "bound_ms": bound_3[0], "bound_by": bound_3[1], "library_ms": None},
        {"name": "fused_rng_costs_field", "route": "cuda", "source": src,
         "replaces": "autorally_tpu/ops/rollout_kernel.py:1221",
         "launches": launches["capacity"]["fused_rng_costs field"],
         "max_abs_err": err_p1, "ms": ms_f, "plain_ms": plain_f,
         "bound_ms": bound_f[0], "bound_by": bound_f[1], "library_ms": None},
    ]
    return kernels, latency


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
        check(len(report) == 6, f"ptxas reported {len(report)} kernels, "
              "expected 6")
        check(all(spill == 0 for _, _, spill in report), "a kernel spills")
    print(f"[build] total {build_s:.1f}s ({card})")

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
    err_a = 0.0
    for name, (ccfg, s0, cmap) in cases.items():
        kc, ku, kx = rk.fused_exact_rollout_cost(
            model, params, ccfg, cost_params, cmap, s0, U, eps)
        pc, pu, px = rk.fused_rollout_cost_plain(
            model, params, ccfg, cost_params, cmap, s0, U, eps)
        note = ""
        if name == "random_map":
            near = torch.isclose(kc, pc, rtol=COST_RTOL, atol=COST_ATOL)
            n_differ = int((~near).sum().item())
            note = (f"; {n_differ} rollouts differ from the plain version's "
                    f"own trajectories, held against the plain cost along "
                    f"kernel B's")
            check(n_differ <= MAX_RANDOM_MAP_DIFFER, f"A random_map: "
                  f"{n_differ} rollouts differ from the plain version, more "
                  f"than {MAX_RANDOM_MAP_DIFFER}")
            kb, _ = rk.dynamics_chain(model, params, ccfg, s0, U, eps)
            pc, px = rk.trajectory_cost_plain(model, params, ccfg,
                                              cost_params, cmap, U, eps, kb)
            check(0 < px.sum().item() < K, "A random_map: crash flags do "
                  "not differ between rollouts")
        torch.cuda.synchronize()
        e_cost = (kc - pc).abs().max().item()
        e_u = (ku - pu).abs().max().item()
        n_crash_diff = int((kx != px).sum().item())
        print(f"[kernel A] {name}: max|cost err| {e_cost:.3e} "
              f"(cost range {pc.min().item():.4g}..{pc.max().item():.4g}), "
              f"max|u_seq err| {e_u:.3e}, crash {int(px.sum().item())}/{K} "
              f"rollouts, crash mismatches {n_crash_diff}{note}")
        check(torch.isfinite(kc).all().item(), f"A {name}: non-finite costs")
        check(torch.allclose(kc, pc, rtol=COST_RTOL, atol=COST_ATOL),
              f"A {name}: costs differ beyond rtol {COST_RTOL} atol "
              f"{COST_ATOL}")
        check(n_crash_diff == 0, f"A {name}: crash flags differ")
        check(torch.equal(ku, pu), f"A {name}: u_seq differs")
        err_a = max(err_a, e_cost)

    # -- phase 3: kernel B against its plain version -------------------------
    err_b = 0.0
    for name, (ccfg, s0, _) in cases.items():
        ks, ku = rk.dynamics_chain(model, params, ccfg, s0, U, eps)
        ps, pu = rk.dynamics_chain_plain(model, params, ccfg, s0, U, eps)
        torch.cuda.synchronize()
        same_nan = torch.equal(torch.isnan(ks), torch.isnan(ps))
        fin = torch.isfinite(ps)
        e_s = (ks[fin] - ps[fin]).abs().max().item() if fin.any() else 0.0
        print(f"[kernel B] {name}: max|state err| {e_s:.3e}, "
              f"max|u_seq err| {(ku - pu).abs().max().item():.3e}")
        check(same_nan, f"B {name}: NaN pattern differs")
        check(torch.allclose(ks, ps, rtol=STATE_RTOL, atol=STATE_ATOL,
                             equal_nan=True), f"B {name}: states differ")
        check(torch.equal(ku, pu), f"B {name}: u_seq differs")
        err_b = max(err_b, e_s)
    ks, _ = rk.nominal_trajectory(model, params, cfg, start, U)
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

    rk.fused_exact_rollout_cost.launches = 0
    rk.dynamics_chain.launches = 0
    out = drive_oval.drive(solver, params, cost_params, costmap, TICKS,
                           log=lambda m: print(f"[main path] {m}"))
    launches = {"fused_exact_rollout_cost": rk.fused_exact_rollout_cost.launches,
                "dynamics_chain": rk.dynamics_chain.launches}
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

    launch_b, _ = rk.prepare_dynamics_chain(model, params, cfg, start, U, eps1)
    ms_b = cuda_ms(launch_b, 100)
    plain_b = cuda_ms(lambda: rk.dynamics_chain_plain(
        model, params, cfg, start, U, eps1), 10)
    bytes_b = 4 * (T * 2 + 7 * T + 2 * T + T * 2 + n_w + 7 + 4)
    bound_b, by_b = bound(bytes_b, flops_step * T)
    print(f"[timing] A fused_exact_rollout_cost K={K} T={T}: {ms_a:.4f} ms, "
          f"plain {plain_a:.3f} ms, bound {bound_a:.5f} ms ({by_a}) ({card})")
    print(f"[timing] B dynamics_chain K=1 T={T}: {ms_b:.4f} ms, plain "
          f"{plain_b:.3f} ms, bound {bound_b:.7f} ms ({by_b}) ({card})")

    # -- phase 6: where a tick's time goes ---------------------------------
    profile_ticks(drive_oval, solver, params, cost_params, costmap, card)

    # -- phases 7-10: the kernel-RNG capacity mode ---------------------------
    cap_kernels, cap_latency = capacity_phases(
        drive_oval, solver, params, cost_params, costmap, cases, U, start,
        (cpu_solver, cpu_params, None, cpu_map), card)

    # -- phases 11-14: the neural-field costmap path -------------------------
    field_kernels, field_latency = field_phases(
        drive_oval, model, params, cost_params, costmap, U, start,
        edge_start, nan_start, slow_start, card)

    src = "autorally_tpu_torch/csrc/rollout_kernels.cu"
    kernels = [
        {"name": "fused_exact_rollout_cost", "route": "cuda", "source": src,
         "replaces": "autorally_tpu/ops/rollout_kernel.py:1013",
         "launches": launches["fused_exact_rollout_cost"],
         "max_abs_err": err_a, "ms": ms_a, "plain_ms": plain_a,
         "bound_ms": bound_a, "bound_by": by_a, "library_ms": None},
        {"name": "dynamics_chain", "route": "cuda", "source": src,
         "replaces": "autorally_tpu/ops/rollout_kernel.py:389",
         "launches": launches["dynamics_chain"],
         "max_abs_err": err_b, "ms": ms_b, "plain_ms": plain_b,
         "bound_ms": bound_b, "bound_by": by_b, "library_ms": None},
    ] + cap_kernels + field_kernels
    print(json.dumps({"kernels": kernels, "card": card,
                      "solve_ms_p50_p99": results["latency"],
                      "capacity_solve_ms_p50_p99": cap_latency,
                      "field_solve_ms_p50_p99": field_latency}))
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
