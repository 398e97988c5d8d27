"""Per-stage device-time breakdown of one MPPI replan (port of
``autorally_tpu/tools/solve_breakdown.py``).

A replan is one chain of kernel launches and PyTorch operations; this
tool times each stage on its own to show where the time of a solve goes:
the noise draw, the rollout and cost kernel, the softmax and weighted
update, Savitzky-Golay, the nominal trajectory and the slide (the
capacity mode: pass 1, the softmax, pass 2 and the division).  Each stage
runs ``--n`` times a batch, best of ``--batches``, timed with CUDA events
on the card and with the host clock on the CPU (``--cpu``).  The stage
sum exceeds the whole solve (``FULL_SOLVE``), whose stages overlap their
launches; the value is the ratio between stages.

Every launch pays a host-side floor, which swamps stages of a few
microseconds, so the tool also times a trivial operation under the same
protocol (``dispatch_floor_ms``) and reports the stages less that floor
(``stages_corrected_ms``).

Usage::

    python -m autorally_tpu_torch.tools.solve_breakdown [--rollouts 1920]
        [--timesteps 100] [--bf] [--kernel-rng] [--neural-costmap]
        [--obstacles N] [--cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def _timer(device):
    """``timeit(f, *args, n, batches)``: best-of-batches ms per call of
    ``f``, CUDA events on a card, the host clock on the CPU."""
    import torch

    def timeit(f, *args, n=20, batches=5):
        f(*args)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        best = float("inf")
        for _ in range(batches):
            if device.type == "cuda":
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                for _ in range(n):
                    f(*args)
                e1.record()
                e1.synchronize()
                ms = e0.elapsed_time(e1) / n
            else:
                t0 = time.perf_counter()
                for _ in range(n):
                    f(*args)
                ms = (time.perf_counter() - t0) * 1e3 / n
            best = min(best, ms)
        return best

    return timeit


def run_breakdown(rollouts: int = 1920, timesteps: int = 100,
                  bf: bool = False, neural_costmap: bool = False,
                  kernel_rng: bool = False, obstacles: int = 0,
                  device=None, n: int = 20, batches: int = 5) -> dict:
    """The stage times of one replan on ``device`` (``cuda`` unless given)
    in ``drive_oval``'s configuration; returns the result dict."""
    import numpy as np
    import torch

    from autorally_tpu_torch import drive_oval
    from autorally_tpu_torch.config import MPPIConfig, resolve_device
    from autorally_tpu_torch.ops import rollout_kernel as rk
    from autorally_tpu_torch.solver.mppi import savitzky_golay

    dev = resolve_device(device)
    cfg = MPPIConfig(num_rollouts=rollouts, num_timesteps=timesteps,
                     kernel_rng=kernel_rng)
    # live circles down the track edge, in the inflation band of many
    # rollouts without crashing the swarm (the JAX tool's)
    circles = ([(25.0 + 2.5, 5.0 + 6.0 * i, 0.5) for i in range(obstacles)]
               if obstacles else None)
    solver, params, cp, cm, _ = drive_oval.build(
        cfg=cfg, device=dev, model="bf" if bf else "nn",
        neural_costmap=neural_costmap, obstacles=circles,
        fit_kwargs={"epochs": 1500} if neural_costmap else None)
    cs = solver.init_state()
    state = torch.tensor(drive_oval.START, dtype=torch.float32, device=dev)
    T, K, C = cfg.num_timesteps, cfg.num_rollouts, solver.model.CONTROL_DIM
    timeit = _timer(dev)
    kw = dict(n=n, batches=batches)
    sub = np.array([0, 0], np.uint32)
    rows = {}

    def softmax_w(total):
        return torch.exp(-cfg.gamma * (total - torch.min(total)))

    capacity = solver._use_kernel_rng(cm)
    if capacity:
        # the production solve runs the two kernel-RNG passes: time ITS
        # stages, not the host-noise path it never executes
        key = solver._device_key(sub)
        obs_kw = solver._obstacle_kwargs(cp)

        def pass1(s, U, k):
            return rk.fused_rng_costs(solver.model, params, cfg, cp, cm, s,
                                      U, k, l1_cost=solver.cost.l1_cost,
                                      **obs_kw)

        rows["rng_pass1_costs"] = timeit(pass1, state, cs.U, key, **kw)
        total, _, ctx = pass1(state, cs.U, key)
        rows["rng_softmax"] = timeit(softmax_w, total, **kw)
        w = softmax_w(total)

        def pass2(w):
            return (rk.fused_rng_numer(ctx, w) / torch.sum(w)).T

        rows["rng_pass2_update"] = timeit(pass2, w, **kw)
        U_new = pass2(w)
    else:
        def noise(s):
            return solver._sample_noise(solver._noise_generator(s),
                                        (T, K, C))

        rows["noise_sample"] = timeit(noise, sub, **kw)
        eps = noise(sub)

        def rollouts_fn(s, U, e):
            return solver.rollout_costs(params, cp, cm, s, U, e)

        rows["rollout_costs"] = timeit(rollouts_fn, state, cs.U, eps, **kw)
        total, u_seq, _ = rollouts_fn(state, cs.U, eps)

        def update(total, u_seq):
            w = softmax_w(total)
            return torch.einsum("k,ctk->tc", w, u_seq) / torch.sum(w)

        rows["weight_update"] = timeit(update, total, u_seq, **kw)
        U_new = update(total, u_seq)

    rows["savitzky_golay"] = timeit(savitzky_golay, U_new, cs.control_hist,
                                    **kw)
    rows["nominal_traj"] = timeit(
        lambda s, U: solver.nominal_trajectory(params, s, U), state, U_new,
        **kw)
    rows["slide"] = timeit(solver._slide, cs, 1, **kw)
    # the production replan: every stage above, the key split included
    rows["FULL_SOLVE"] = timeit(
        lambda s, c: solver._solve(params, cp, cm, s, c), state, cs, **kw)
    # per-launch floor: a trivial operation under the same protocol
    tiny = torch.zeros((8, 128), dtype=torch.float32, device=dev)
    floor = timeit(lambda x: x + 1.0, tiny, **kw)

    corrected = {k: max(v - floor, 0.0) for k, v in rows.items()}
    stage_sum = sum(v for k, v in rows.items() if k != "FULL_SOLVE")
    csum = sum(v for k, v in corrected.items() if k != "FULL_SOLVE")
    return {
        "backend": dev.type,
        "device_kind": (torch.cuda.get_device_name(dev)
                        if dev.type == "cuda" else "cpu"),
        "K": K, "T": T,
        "model": "bf" if bf else "nn",
        "pallas": bool(solver.kernel_form),
        "kernel_rng": bool(capacity),
        "dispatch_floor_ms": round(floor, 4),
        "stages_ms": {k: round(v, 4) for k, v in rows.items()},
        "stages_corrected_ms": {k: round(v, 4)
                                for k, v in corrected.items()},
        "stage_sum_ms": round(stage_sum, 4),
        "corrected_sum_ms": round(csum, 4),
        "fusion_gain": round(stage_sum / rows["FULL_SOLVE"], 2),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--rollouts", type=int, default=1920)
    ap.add_argument("--timesteps", type=int, default=100)
    ap.add_argument("--bf", action="store_true")
    ap.add_argument("--neural-costmap", action="store_true")
    ap.add_argument("--kernel-rng", action="store_true")
    ap.add_argument("--obstacles", type=int, default=0, metavar="N",
                    help="compose ObstacleCost with N live circles (the "
                         "in-kernel obstacle-term A/B: compare FULL_SOLVE "
                         "against a run without this flag)")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--n", type=int, default=20)
    ap.add_argument("--batches", type=int, default=5)
    args = ap.parse_args(argv)

    from autorally_tpu_torch.io.compile_cache import enable_persistent_cache

    enable_persistent_cache()
    out = run_breakdown(args.rollouts, args.timesteps, bf=args.bf,
                        neural_costmap=args.neural_costmap,
                        kernel_rng=args.kernel_rng,
                        obstacles=args.obstacles,
                        device="cpu" if args.cpu else None, n=args.n,
                        batches=args.batches)
    print(json.dumps(out))
    rows, corrected = out["stages_ms"], out["stages_corrected_ms"]
    csum, floor = out["corrected_sum_ms"], out["dispatch_floor_ms"]
    width = max(len(k) for k in rows)
    print(f"{'(dispatch floor)':<{width}}  {floor:9.3f} ms", file=sys.stderr)
    for k, v in sorted(rows.items(), key=lambda kv: -corrected[kv[0]]):
        c = corrected[k]
        frac = c / csum * 100 if (k != "FULL_SOLVE" and csum > 0) else 0
        bar = "#" * int(frac / 2)
        tag = (f"-floor {c:7.3f} ms  {frac:5.1f}% {bar}"
               if k != "FULL_SOLVE" else f"-floor {c:7.3f} ms  (one program)")
        print(f"{k:<{width}}  {v:9.3f} ms  {tag}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
