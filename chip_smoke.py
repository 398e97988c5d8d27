#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``autorally_tpu_torch``) on one GPU.

Drives the port's main path — BASELINE config #1 (``path_integral_nn``):
the 6-32-32-4 tanh MLP at full width with seeded Glorot weights, K=1920
rollouts, T=100, gaussian exploration, the exact 560 x 800 oval costmap —
and checks every CUDA kernel of that path against its plain PyTorch
version.  Phases (any failure exits non-zero):

1. build the kernels from ``autorally_tpu_torch/csrc/rollout_kernels.cu``
   (one nvcc);
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
   device's idle share.

Prints the card's name and power limit, one ``{"kernels": [...]}`` line,
and as its last line ``{"ok": true, "device": {...}}``.  Needs one CUDA
GPU; exits non-zero without one, or without the package beside it.

Usage::

    python3 chip_smoke.py
"""

import json
import os
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


def bound(nbytes: float, flops: float):
    t_b = nbytes / PEAK_BYTES_PER_S * 1e3
    t_f = flops / PEAK_FP32_FLOP_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


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
                  ticks: int = PROFILE_TICKS) -> None:
    """Device time by kernel over ``ticks`` ticks of the main path
    (torch.profiler, CUPTI) and the device's busy share of their wall
    time, profiler overhead included."""
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
        print(f"[profile] device time not measured: the profiler recorded "
              f"no device events ({card})")
        return
    busy = sum(r[0] for r in rows)
    print(f"[profile] {ticks} ticks (+1 first solve): wall {wall_ms:.3f} ms, "
          f"device busy {busy:.3f} ms ({100 * busy / wall_ms:.1f}%, idle "
          f"{100 - 100 * busy / wall_ms:.1f}%) ({card})")
    for ms, n, key in sorted(rows, reverse=True)[:8]:
        print(f"[profile]   {ms / (ticks + 1):8.4f} ms/tick  x{n:<5d} "
              f"{key[:90]}")


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
        pc, pu, px = rk.fused_exact_rollout_cost_plain(
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
            pc, px = rk.exact_cost_plain(model, params, ccfg, cost_params,
                                         cmap, U, eps, kb)
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
    plain_a = cuda_ms(lambda: rk.fused_exact_rollout_cost_plain(
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
    ]
    print(json.dumps({"kernels": kernels, "card": card,
                      "solve_ms_p50_p99": results["latency"]}))
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
