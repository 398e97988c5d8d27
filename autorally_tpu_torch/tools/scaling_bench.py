"""Multi-rank scaling benchmark: weak/strong rollout-sharding efficiency
(port of ``autorally_tpu/tools/scaling_bench.py``).

Measures the efficiency curve of the sharded solver
(``parallel/sharded.py``) over rank counts:

- **weak scaling**: K_local rollouts *per rank* (ideal efficiency = flat
  solves/s as ranks grow);
- **strong scaling**: K_total rollouts *split across* ranks (ideal =
  solves/s growing linearly).

``--devices`` counts ranks (``parallel/launch.py``: one process a rank).
On a machine with a card for each rank they run NCCL; ranks that share a
card run gloo, and each row says how many ranks share a card
(``ranks_per_device``): such a row measures the collectives' and the
sharing's cost, not multi-card scaling.  ``--virtual N`` runs up to N CPU
ranks over gloo, which checks the shape of the sharded program (the
collectives, the per-shard streams, no hidden serialisation); CPU timings
oversubscribe host cores and are no forecast for a card.

The 1-rank row uses the solver's inline body (no collectives), so
efficiency is measured against the best single-rank implementation;
``--one-dev collectives`` keeps the collectives at one rank too.  Each row
times chained dependent replans (best of ``--batches`` batches of ``--n``
solves, a sync at each batch's end) on ``drive_oval``'s configuration
(the seeded MLP on the 560 x 800 oval, T=100 by default); a rank count's
rows come from one launch of its ranks, the slowest rank's time.

Prints one JSON line; ``--out`` also writes it to a file.

Usage::

    python -m autorally_tpu_torch.tools.scaling_bench --devices 1,2 \\
        --mode both --k-local 1920
    python -m autorally_tpu_torch.tools.scaling_bench --virtual 4 \\
        --devices 1,2,4 --mode weak --k-local 256 --timesteps 32
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time


def _timed_solves(solver, params, cost_params, costmap, state, n=8,
                  batches=4):
    """Best-of-batches seconds per chained dependent replan."""
    import torch

    def sync():
        if solver.device.type == "cuda":
            torch.cuda.synchronize(solver.device)

    cs, _ = solver._solve(params, cost_params, costmap, state,
                          solver.init_state())
    sync()
    best = float("inf")
    for _ in range(batches):
        t0 = time.perf_counter()
        for _ in range(n):
            cs, _ = solver._solve(params, cost_params, costmap, state, cs)
        sync()
        best = min(best, (time.perf_counter() - t0) / n)
    return best


def _rank_timing(device, spec: dict) -> dict:
    """One rank of a rank count's rows: seconds per replan at each K of
    ``spec["Ks"]``."""
    import torch

    from autorally_tpu_torch import drive_oval
    from autorally_tpu_torch.config import MPPIConfig
    from autorally_tpu_torch.io.compile_cache import enable_persistent_cache
    from autorally_tpu_torch.parallel.mesh import rollout_mesh
    from autorally_tpu_torch.parallel.sharded import ShardedMPPISolver

    if spec["cache_dir"]:
        enable_persistent_cache(spec["cache_dir"])
    mesh = rollout_mesh()
    state = torch.tensor(drive_oval.START, dtype=torch.float32,
                         device=device)
    out = {}
    for K in spec["Ks"]:
        cfg = MPPIConfig(num_rollouts=K, num_timesteps=spec["T"])
        base, params, cp, cm, _ = drive_oval.build(cfg=cfg, device=device)
        solver = ShardedMPPISolver(base.model, base.cost, cfg, mesh=mesh,
                                   force_collectives=spec["force"],
                                   device=device)
        out[K] = _timed_solves(solver, params, cp, cm, state, spec["n"],
                               spec["batches"])
    return out


def run_scaling(device_counts, mode: str = "weak", k_local: int = 1920,
                k_total: int = 15360, num_timesteps: int = 100,
                n: int = 8, batches: int = 4, one_dev: str = "inline",
                virtual: int = 0, cache_dir: str = None) -> dict:
    """Measure solves/s across rank counts.  ``virtual``: run CPU ranks
    (at most that many) over gloo; else CUDA ranks, NCCL where each has a
    card of its own and gloo where they share one.  ``cache_dir``: the
    ranks' build cache (None: the checkout's build directory).  Returns
    the result dict."""
    import torch

    from autorally_tpu_torch.parallel import launch

    if virtual:
        device, present, name = "cpu", virtual, "cpu"
        counts = [c for c in device_counts if c <= virtual]
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("scaling_bench needs a CUDA GPU; --virtual N "
                               "runs CPU ranks")
        from autorally_tpu_torch.ops import _build

        _build.load()                 # built once, before any rank starts
        device, present = "cuda", torch.cuda.device_count()
        name = torch.cuda.get_device_name(0)
        counts = list(device_counts)
    if not counts:
        raise ValueError(f"no usable rank counts from {device_counts}; "
                         f"{present} virtual devices")
    modes = ("weak", "strong") if mode == "both" else (mode,)
    out = {
        "platform": "cpu" if virtual else "gpu",
        "device_kind": name,
        "devices_present": present,
        "num_timesteps": num_timesteps,
        "virtual": bool(virtual),
        "one_dev": one_dev,
    }
    rows = {m: [] for m in modes}
    for c in counts:
        Ks = {m: k_local * c if m == "weak" else k_total for m in modes}
        Ks = {m: K for m, K in Ks.items() if K % c == 0}
        if not Ks:
            continue
        be = "gloo" if virtual or c > present else "nccl"
        spec = dict(Ks=sorted(set(Ks.values())), T=num_timesteps, n=n,
                    batches=batches, force=one_dev == "collectives",
                    cache_dir=cache_dir)
        res = launch.run(_rank_timing, c, (spec,), backend=be,
                         device=device, timeout=1800)
        for m, K in Ks.items():
            sec = max(r[K] for r in res)
            rows[m].append({"devices": c, "K": K,
                            "solves_per_sec": round(1.0 / sec, 2),
                            "rollouts_per_sec": round(K / sec),
                            "ranks_per_device": (1 if virtual else
                                                 math.ceil(c / present)),
                            "backend": be})
    for m in modes:
        base = rows[m][0]
        for r in rows[m]:
            if m == "weak":
                # ideal: flat solves/s while K grows with the ranks
                r["efficiency"] = round(
                    r["solves_per_sec"] / base["solves_per_sec"], 3)
            else:
                # ideal: solves/s grows linearly with the ranks
                r["efficiency"] = round(
                    r["solves_per_sec"]
                    / (base["solves_per_sec"] * r["devices"]
                       / base["devices"]), 3)
        out[m] = rows[m]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--devices", default="1,2,4,8",
                    help="comma-separated rank counts to measure")
    ap.add_argument("--mode", choices=("weak", "strong", "both"),
                    default="weak")
    ap.add_argument("--k-local", type=int, default=1920,
                    help="rollouts per rank (weak scaling)")
    ap.add_argument("--k-total", type=int, default=15360,
                    help="total rollouts (strong scaling)")
    ap.add_argument("--timesteps", type=int, default=100)
    ap.add_argument("--n", type=int, default=8, help="solves per batch")
    ap.add_argument("--batches", type=int, default=4)
    ap.add_argument("--virtual", type=int, default=0,
                    help="run up to N CPU ranks over gloo (shape "
                         "validation without a card)")
    ap.add_argument("--one-dev", choices=("inline", "collectives"),
                    default="inline",
                    help="1-rank row: 'inline' = the best single-rank path "
                         "(product efficiency), 'collectives' = keep the "
                         "collectives (structural diagnostic)")
    ap.add_argument("--out", default=None, help="also write JSON here")
    args = ap.parse_args(argv)

    from autorally_tpu_torch.io.compile_cache import enable_persistent_cache

    cache_dir = enable_persistent_cache()
    counts = sorted({int(c) for c in args.devices.split(",")})
    res = run_scaling(counts, mode=args.mode, k_local=args.k_local,
                      k_total=args.k_total, num_timesteps=args.timesteps,
                      n=args.n, batches=args.batches, one_dev=args.one_dev,
                      virtual=args.virtual, cache_dir=cache_dir)
    line = json.dumps(res)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
