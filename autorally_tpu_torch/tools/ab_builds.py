"""Time the MLP kernels without obstacles of two checkouts of the port on
one GPU, in one call.

The kernels are kernel A (``fused_exact_rollout_cost``) at K=1920, kernel B
(``dynamics_chain``) at K=1 (the nominal trajectory) and exact pass 1
(``fused_rng_costs``, gaussian) at K=262144, all at T=100 on the main
path's seeded configuration (``drive_oval.build``).  Each checkout
builds its own kernels from its own source and runs in its own process, in
the order other, this, this, other, so that a drift of the card over the
call falls on both alike.  Each process prints the CUDA-event medians and a
digest of the outputs (costs, crash flags, states, u_seq); equal digests
show bit-equal results.  The summary gives each checkout's mean of its two
runs and the ratio of this checkout to the other.

Usage (``DIR``: another checkout's root, e.g. ``git archive`` of a parent
commit unpacked under ``autorally_tpu_torch/_build/``)::

    python -m autorally_tpu_torch.tools.ab_builds --other DIR [--rounds 5]
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import statistics
import subprocess
import sys

THIS_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
K_A, K_P1, T = 1920, 262144, 100
KEY = (0x2545F491, 0x9E3779B9)


def time_checkout(root: str, rounds: int) -> dict:
    """Build and time the kernels of the checkout at ``root`` (imported from
    there); the APIs used are those of every slice of the port."""
    sys.path.insert(0, root)
    import torch
    import autorally_tpu_torch
    from autorally_tpu_torch import drive_oval
    from autorally_tpu_torch.ops import rollout_kernel as rk

    pkg = os.path.dirname(os.path.abspath(autorally_tpu_torch.__file__))
    if os.path.dirname(pkg) != os.path.abspath(root):
        raise RuntimeError(f"imported {pkg}, not the checkout at {root}")
    dev = torch.device("cuda", 0)
    solver, params, cost_params, costmap, _ = drive_oval.build(
        rollouts=K_A, device=dev)
    model, cfg = solver.model, solver.cfg
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    eps = torch.randn((T, K_A, 2), generator=gen, device=dev)
    U = torch.tensor([0.0, 0.3], device=dev).repeat(T, 1)
    start = torch.tensor(drive_oval.START, dtype=torch.float32, device=dev)
    key = torch.tensor(KEY, dtype=torch.int64, device=dev)
    launch_a, out_a = rk.prepare_fused_exact_rollout_cost(
        model, params, cfg, cost_params, costmap, start, U, eps)
    launch_b, out_b = rk.prepare_dynamics_chain(
        model, params, cfg, start, U, torch.zeros((T, 1, 2), device=dev))
    launch_p, out_p, _ = rk.prepare_fused_rng_costs(
        model, params, cfg.replace(num_rollouts=K_P1, kernel_rng=True),
        cost_params, costmap, start, U, key)

    def events(fn, reps):
        times = []
        for _ in range(reps):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            fn()
            e1.record()
            e1.synchronize()
            times.append(e0.elapsed_time(e1))
        return times

    launches = {"kernel_a_ms": (launch_a, 40), "kernel_b_ms": (launch_b, 40),
                "pass1_ms": (launch_p, 10)}
    for fn, _ in launches.values():            # build, load, warm up
        events(fn, 3)
    ms = {name: [] for name in launches}
    for _ in range(rounds):                    # interleaved rounds
        for name, (fn, reps) in launches.items():
            ms[name] += events(fn, reps)
    digest = hashlib.sha256()
    for t in (*out_a, *out_b, *out_p):
        digest.update(t.cpu().numpy().tobytes())
    return {"root": os.path.abspath(root),
            **{name: statistics.median(v) for name, v in ms.items()},
            "digest": digest.hexdigest()[:16]}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", help="the other checkout's root")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--time", help=argparse.SUPPRESS)  # one process's run
    args = ap.parse_args()
    if args.time:
        print(json.dumps(time_checkout(args.time, args.rounds)))
        return 0
    if not args.other:
        ap.error("--other DIR is required")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    roots = {"other": os.path.abspath(args.other), "this": THIS_ROOT}
    runs = {"other": [], "this": []}
    for label in ("other", "this", "this", "other"):
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--time",
             roots[label], "--rounds", str(args.rounds)],
            capture_output=True, text=True, cwd=roots[label])
        if out.returncode != 0:
            print(out.stdout + out.stderr, file=sys.stderr)
            return out.returncode
        res = json.loads(out.stdout.strip().splitlines()[-1])
        runs[label].append(res)
        print(f"[ab] {label}: kernel A K={K_A} {res['kernel_a_ms']:.4f} ms, "
              f"kernel B K=1 {res['kernel_b_ms']:.4f} ms, exact pass 1 "
              f"K={K_P1} {res['pass1_ms']:.4f} ms, digest {res['digest']} "
              f"({res['root']})")
    mean = {lb: {k: statistics.mean(r[k] for r in rs)
                 for k in ("kernel_a_ms", "kernel_b_ms", "pass1_ms")}
            for lb, rs in runs.items()}
    same = len({r["digest"] for rs in runs.values() for r in rs}) == 1
    summary = {"card": card, "mean": mean, "bit_equal": same,
               "this_over_other": {k: mean["this"][k] / mean["other"][k]
                                   for k in mean["this"]}}
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
