"""Multi-card scaling forecast with a validated communication model.

BASELINE.md targets >=85% multi-host scaling efficiency.  The forecast is
a MODEL built from measured parts:

1. **Device compute**, measured on one card (kernel 1, the exact fused
   rollout, MLP 6-32-32-4 at T=100): ``t_dev(K) = a + b*K`` — ``a`` is
   the sequential horizon-chain floor, ``b`` the per-rollout throughput.
   Defaults from an NVIDIA H100 80GB HBM3 at a 700.00 W power limit (as
   ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
   gives them; ``chip_smoke.py`` phase 5): K=1920 -> 0.1932 ms, K=8192
   -> 0.3292 ms, K=262144 -> 3.9414 ms; override with
   ``--ladder K=ms,...``.
2. **Collectives**: one sharded iteration (``parallel/sharded.py``,
   ``_combine``) joins the shards with two all-reduces over
   ``Mesh.all_reduce``: a MIN of one float (the baseline) and a SUM of
   4 + T*C floats (eta, sum w^2, the costs' sum, the crash count and the
   (T, C) = (100, 2) numerator) — 820 B an iteration.  Cost model
   ``t_coll(n) = L(n) + bytes * 2(n-1)/(n*BW)`` (ring all-reduce), with
   the latency term L(n) = l0 * ceil(log2(n)).
3. **Validation**: the bytes term is checked against a real multi-process
   transport by :func:`probe_rank`, run on CPU ranks through
   ``parallel/launch.run`` with gloo: each iteration runs the sharded
   iteration's two all-reduces and an injected extra SUM whose payload is
   swept from 4 B to 4 MB; the measured slope is the transport's
   effective all-reduce bandwidth and the smallest pad's intercept its
   latency floor.  The tool reports predicted-against-measured times an
   iteration for the probe's own fitted parameters: if the model's form
   fits gloo over TCP, the same form with the GPU fabrics' constants is
   a defensible forecast.

Fabric assumptions (stated from NVIDIA's published H100 and ConnectX-7
sheets, not measured): NVLink 4 inside a node ~2 us a hop, 450 GB/s a
direction a card; InfiniBand NDR between nodes ~5 us, 50 GB/s a port.

Prints one JSON document; ``--table`` adds a human-readable summary.
Run: ``python -m autorally_tpu_torch.tools.scaling_forecast [--skip-probe]``.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time

# measured device ladder: kernel 1, MLP 6-32-32-4, T=100, on an NVIDIA
# H100 80GB HBM3 at 700.00 W (chip_smoke.py phase 5)
DEFAULT_LADDER = {1920: 0.1932, 8192: 0.3292, 262144: 3.9414}

# per-iteration collective payload (parallel/sharded.py, _combine): the
# MIN of one float, then the SUM of eta, sum w^2, the costs' sum, the
# crash count and the (T, C) numerator, f32
PAYLOAD_BYTES = (1 + 4 + 100 * 2) * 4

# stated assumptions, not measured
FABRICS = {
    "nvlink": {"l0_us": 2.0, "bw_gbps": 450.0},
    "infiniband": {"l0_us": 5.0, "bw_gbps": 50.0},
}

# the injected payload's sizes (float32 elements): 4 B to 4 MB
PROBE_PADS = (1, 2048, 16384, 131072, 1048576)


def fit_ladder(ladder: dict) -> tuple:
    """Least-squares t_dev(K) = a + b*K (ms)."""
    import numpy as np

    ks = np.array(sorted(ladder), dtype=float)
    ts = np.array([ladder[int(k)] for k in ks])
    A = np.stack([np.ones_like(ks), ks], axis=1)
    (a, b), *_ = np.linalg.lstsq(A, ts, rcond=None)
    return max(float(a), 0.0), float(b)


def t_coll_ms(n: int, fabric: dict, bytes_=PAYLOAD_BYTES) -> float:
    lat_ms = fabric["l0_us"] * math.ceil(math.log2(max(n, 2))) / 1000.0
    bw_ms = (bytes_ * 2 * (n - 1) / n) / (fabric["bw_gbps"] * 1e9) * 1e3
    return lat_ms + bw_ms


def forecast(K: int, a: float, b: float, fabric: dict, ns) -> list:
    """Strong-scaling efficiency for global K over n workers."""
    t1 = a + b * K
    rows = []
    for n in ns:
        tn = a + b * K / n + t_coll_ms(n, fabric)
        rows.append({"n": n, "t_n_ms": round(tn, 4),
                     "solves_per_sec": round(1000.0 / tn, 1),
                     "speedup": round(t1 / tn, 2),
                     "efficiency": round(t1 / (n * tn), 4)})
    return rows


def probe_rank(device, iters: int) -> dict:
    """One rank of the probe: for each injected pad, the best of three
    timed chains of ``iters`` iterations, each the sharded iteration's
    MIN of one float and SUM of 4 + T*C floats and the pad's SUM (always
    present, one element at the baseline point, so that the sweep varies
    only bytes, never the number of collectives).  -> {payload bytes: s
    an iteration}."""
    import torch
    import torch.distributed as dist

    T, C = 100, 2

    def chain(c, p):
        for _ in range(iters):
            b = c[:1].clone()
            dist.all_reduce(b, op=dist.ReduceOp.MIN)           # baseline
            s = torch.cat([torch.stack([c.sum(), (c * c).sum(), c.sum(),
                                        c[0]]), c])
            dist.all_reduce(s, op=dist.ReduceOp.SUM)           # eta .. numer
            dist.all_reduce(p, op=dist.ReduceOp.SUM)           # injected pad
            p.mul_(0.5)
            c = s[4:] * 0.5 + (b[0] + s[0] + s[1]) * 1e-9 + p[0] * 1e-9
        return c

    results = {}
    for pad in PROBE_PADS:
        c0 = torch.ones(T * C, dtype=torch.float32, device=device)
        chain(c0, torch.ones(pad, dtype=torch.float32, device=device))
        best = float("inf")
        for _ in range(3):
            p0 = torch.ones(pad, dtype=torch.float32, device=device)
            dist.barrier()
            t0 = time.perf_counter()
            chain(c0, p0)
            best = min(best, (time.perf_counter() - t0) / iters)
        results[str(pad * 4)] = best                           # bytes -> s
    return {"rank": dist.get_rank(), "nproc": dist.get_world_size(),
            "iters": iters, "per_iter_s": results}


def run_probe(nproc: int = 2, iters: int = 300, timeout: float = 480.0
              ) -> dict:
    """Run :func:`probe_rank` on ``nproc`` gloo CPU ranks; -> rank 0's
    timings."""
    from autorally_tpu_torch.parallel import launch

    return launch.run(probe_rank, nproc, (iters,), backend="gloo",
                      device="cpu", timeout=timeout)[0]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--Ks", default="1920,65536,262144",
                    help="global rollout counts to forecast (the "
                         "reference point, config #4, config #5)")
    ap.add_argument("--ladder", default=None,
                    help="override device ladder, e.g. 1920=0.19,8192=0.33")
    ap.add_argument("--ns", default="2,4,8,16,32")
    ap.add_argument("--skip-probe", action="store_true",
                    help="forecast only (no 2-rank gloo validation run)")
    ap.add_argument("--iters", type=int, default=300)
    ap.add_argument("--table", action="store_true")
    args = ap.parse_args(argv)

    ladder = DEFAULT_LADDER
    if args.ladder:
        ladder = {int(k): float(v) for k, v in
                  (kv.split("=") for kv in args.ladder.split(","))}
    a, b = fit_ladder(ladder)
    ns = [int(n) for n in args.ns.split(",")]

    doc = {
        "artifact": "scaling_forecast",
        "payload_bytes": PAYLOAD_BYTES,
        "ladder_ms": {str(k): v for k, v in sorted(ladder.items())},
        "fit": {"chain_floor_ms": round(a, 4),
                "ms_per_rollout": b},
        "assumptions": FABRICS,
        "forecast": {},
    }
    for K in (int(k) for k in args.Ks.split(",")):
        per_k = {}
        for name, fab in FABRICS.items():
            rows = forecast(K, a, b, fab, ns)
            per_k[name] = rows
            ok = [r["n"] for r in rows if r["efficiency"] >= 0.85]
            per_k[f"{name}_max_n_at_85pct"] = max(ok, default=0)
        doc["forecast"][f"K{K}"] = per_k

    if not args.skip_probe:
        probe = run_probe(iters=args.iters)
        per_iter = {int(k): v for k, v in probe["per_iter_s"].items()}
        xs = sorted(per_iter)
        import numpy as np

        A = np.stack([np.ones(len(xs)), np.array(xs, float)], axis=1)
        (lat_s, inv_bw), *_ = np.linalg.lstsq(
            A, np.array([per_iter[x] for x in xs]), rcond=None)
        bw_gbps = (2 * (2 - 1) / 2) / (inv_bw * 1e9) if inv_bw > 0 else None
        measured = {str(x): round(per_iter[x] * 1e6, 2) for x in xs}
        gloo = {"l0_us": max(lat_s, 0.0) * 1e6,
                "bw_gbps": bw_gbps if bw_gbps else 1.0}
        # the latency + bytes/BW model, fitted to the sweep, evaluated
        # back at each payload: the residual is how linear the transport's
        # response is.  bytes_=x only: the fitted intercept already holds
        # the iteration's own 820 B (the probe sweeps the injected pad).
        predicted = {str(x): round(
            (t_coll_ms(2, gloo, bytes_=x)) * 1e3, 2) for x in xs}
        doc["validation"] = {
            "transport": "gloo/TCP-loopback, 2 processes",
            "measured_per_iter_us": measured,
            "fitted_latency_us": round(float(lat_s) * 1e6, 2),
            "fitted_allreduce_bw_gbps":
                round(bw_gbps, 3) if bw_gbps else None,
            "model_predicted_per_iter_us": predicted,
            "max_shape_rel_err": round(max(
                abs(predicted[s] - measured[s]) / max(measured[s], 1e-9)
                for s in map(str, xs)), 3) if xs else 0.0,
        }

    print(json.dumps(doc))
    if args.table:
        print(f"\nfit: t_dev(K) = {a:.4f} ms + {b*1e3:.4f} us/rollout; "
              f"payload {PAYLOAD_BYTES} B/iter", file=sys.stderr)
        for kname, per_k in doc["forecast"].items():
            for name in FABRICS:
                print(f"-- {kname} {name} --", file=sys.stderr)
                for r in per_k[name]:
                    print(f"  n={r['n']:>3}  t={r['t_n_ms']:7.3f} ms  "
                          f"{r['solves_per_sec']:8.1f}/s  "
                          f"eff={r['efficiency']:.3f}", file=sys.stderr)
    return doc


if __name__ == "__main__":
    main()
