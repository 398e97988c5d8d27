"""Time the MLP kernels without obstacles of two checkouts of the port on
one GPU, in one call.

The kernels are kernel A (``fused_exact_rollout_cost``) at K=1920, kernel B
(``dynamics_chain``) at K=1 (the nominal trajectory), exact pass 1
(``fused_rng_costs``, gaussian) at K=262144, kernel 3
(``fused_rollout_cost``) at K=65536 and pass 1's field mode (gaussian) at
K=262144, all at T=100 on the main path's seeded configuration
(``drive_oval.build``); the field is ``seeded_field``, the same numpy
weights in both checkouts and no fit.  Each checkout builds its own kernels
from its own source and runs in its own process, in the order other, this,
this, other, so that a drift of the card over the call falls on both
alike; each process times the exact-map kernels first, then the field
kernels.  Each prints the CUDA-event medians and a digest of the exact-map
kernels' outputs (costs, crash flags, states, u_seq); equal digests show
bit-equal results.  The SASS of the kernels that a field change should not
touch (``EXACT_MAP_KERNELS``, every instance) is compared between the two
builds' libraries (``cuobjdump -sass``), function by function.  The field
kernels' costs and crash flags
are saved under ``autorally_tpu_torch/_build/ab/`` and compared between
the builds by the largest cost difference and the crash flags that differ
(their summation order may change between designs).  The summary gives
each checkout's mean of its two runs and the ratio of this checkout to the
other.

Usage (``DIR``: another checkout's root, e.g. ``git archive`` of a parent
commit unpacked under ``autorally_tpu_torch/_build/``)::

    python -m autorally_tpu_torch.tools.ab_builds --other DIR [--rounds 5]
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import re
import statistics
import subprocess
import sys

THIS_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
K_A, K_3, K_P1, T = 1920, 65536, 262144, 100
KEY = (0x2545F491, 0x9E3779B9)
TIMES = ("kernel_a_ms", "kernel_b_ms", "pass1_ms", "kernel3_ms",
         "field_pass1_ms")
EXACT_MAP_KERNELS = ("fused_exact_kernel", "dynamics_chain_kernel",
                     "fused_rng_kernel", "weighted_update_kernel")


def seeded_field(costmap, device, seed: int = 7):
    """A field of the CUDA kernels' spec (34-64-64-1, F = 8) on
    ``costmap``'s transform: He-normal weights and small biases from a
    numpy seed, the output scaled (in float64 numpy on a 101 x 101 grid of
    the map) to a standard deviation of 0.25 about 0.35, so that part of it
    lies over the 0.65 crash boundary."""
    import numpy as np
    from autorally_tpu_torch.costs import NeuralCostmap

    rs = np.random.default_rng(seed)
    layers, n_freqs = (34, 64, 64, 1), 8
    W = [np.sqrt(2.0 / a) * rs.standard_normal((a, b))
         for a, b in zip(layers[:-1], layers[1:])]
    B = [0.1 * rs.standard_normal(b) for b in layers[1:]]
    freqs = (2.0 ** np.arange(n_freqs)) * np.pi
    g = np.linspace(0.0, 1.0, 101)
    u, v = (c.reshape(-1, 1) for c in np.meshgrid(g, g))
    h = np.concatenate([u, v, np.sin(u * freqs), np.sin(v * freqs),
                        np.cos(u * freqs), np.cos(v * freqs)], axis=1)
    for i, (w, b) in enumerate(zip(W, B)):
        h = h @ w + b
        h = np.maximum(h, 0.0) if i < len(W) - 1 else h
    scale = 0.25 / h.std()
    W[-1], B[-1] = W[-1] * scale, (B[-1] - h.mean()) * scale + 0.35
    return NeuralCostmap.build(W, B, freqs, costmap.r_c1.cpu(),
                               costmap.r_c2.cpu(), costmap.trs.cpu(),
                               device=device)


def time_checkout(root: str, rounds: int, out: str) -> dict:
    """Build and time the kernels of the checkout at ``root`` (imported from
    there), saving the field kernels' outputs to ``out`` (.npz); the APIs
    used are those of every slice of the port since the field's."""
    sys.path.insert(0, root)
    import torch
    import autorally_tpu_torch
    from autorally_tpu_torch import drive_oval
    from autorally_tpu_torch.ops import _build
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
    cap = cfg.replace(num_rollouts=K_P1, kernel_rng=True)
    launch_p, out_p, _ = rk.prepare_fused_rng_costs(
        model, params, cap, cost_params, costmap, start, U, key)
    field = seeded_field(costmap, dev)
    eps3 = torch.randn((T, K_3, 2), generator=gen, device=dev)
    launch_3, out_3 = rk.prepare_fused_rollout_cost(
        model, params, cfg, cost_params, field, start, U, eps3)
    launch_f, out_f, _ = rk.prepare_fused_rng_costs(
        model, params, cap, cost_params, field, start, U, key)

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

    # the exact-map kernels first, then the field kernels, each group in
    # interleaved rounds, so that the field kernels' load (which differs
    # between builds) does not fall between the exact-map kernels' runs
    groups = ({"kernel_a_ms": (launch_a, 40), "kernel_b_ms": (launch_b, 40),
               "pass1_ms": (launch_p, 10)},
              {"kernel3_ms": (launch_3, 5), "field_pass1_ms": (launch_f, 3)})
    ms = {}
    for launches in groups:
        for fn, _ in launches.values():        # build, load, warm up
            events(fn, 3)
        ms.update({name: [] for name in launches})
        for _ in range(rounds):                # interleaved rounds
            for name, (fn, reps) in launches.items():
                ms[name] += events(fn, reps)
    digest = hashlib.sha256()
    for t in (*out_a, *out_b, *out_p):
        digest.update(t.cpu().numpy().tobytes())
    import numpy as np
    np.savez(out, costs3=out_3[0].cpu().numpy(), crash3=out_3[2].cpu().numpy(),
             costsf=out_f[0].cpu().numpy(), crashf=out_f[1].cpu().numpy())
    return {"root": os.path.abspath(root),
            **{name: statistics.median(v) for name, v in ms.items()},
            "digest": digest.hexdigest()[:16],
            "library": str(_build.library_path())}


def exact_map_sass(library: str, dump: str) -> dict:
    """The SASS of each instance of ``EXACT_MAP_KERNELS`` in the built
    ``library``, by short name (e.g. ``fused_rng_kernel<MlpDeriv>``); the
    whole ``cuobjdump -sass`` output is written to ``dump``.  The kernels
    live in an anonymous namespace, whose mangled name differs between
    builds, so it is cut from the names and the code."""
    from autorally_tpu_torch.ops import _build

    objdump = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    out = subprocess.run([objdump, "-sass", library], capture_output=True,
                         text=True, check=True, timeout=300).stdout
    with open(dump, "w") as f:
        f.write(out)
    names = "|".join(EXACT_MAP_KERNELS)
    sass = {}
    for fn in re.split(r"\n\s*Function : ", out)[1:]:
        head, body = fn.split("\n", 1)
        m = re.search(rf"\d({names})(?:I.*?(Mlp|Bf)Deriv)?", head)
        if m:
            sass[m.group(1) + (f"<{m.group(2)}>" if m.group(2) else "")] = (
                re.sub(r"_GLOBAL__N__\w+", "", body))
    if len(sass) != 7:              # 3 kernels in 2 instances, and pass 2
        raise RuntimeError(f"{library}: found the SASS of {sorted(sass)}, "
                           "not of the 7 exact-map kernel instances")
    return sass


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", help="the other checkout's root")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--time", help=argparse.SUPPRESS)  # one process's run
    ap.add_argument("--out", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.time:
        print(json.dumps(time_checkout(args.time, args.rounds, args.out)))
        return 0
    if not args.other:
        ap.error("--other DIR is required")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    roots = {"other": os.path.abspath(args.other), "this": THIS_ROOT}
    out_dir = os.path.join(THIS_ROOT, "autorally_tpu_torch", "_build", "ab")
    os.makedirs(out_dir, exist_ok=True)
    runs = {"other": [], "this": []}
    for i, label in enumerate(("other", "this", "this", "other")):
        npz = os.path.join(out_dir, f"{i}_{label}.npz")
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--time",
             roots[label], "--rounds", str(args.rounds), "--out", npz],
            capture_output=True, text=True, cwd=roots[label])
        if out.returncode != 0:
            print(out.stdout + out.stderr, file=sys.stderr)
            return out.returncode
        res = json.loads(out.stdout.strip().splitlines()[-1])
        res["npz"] = npz
        runs[label].append(res)
        print(f"[ab] {label}: kernel A K={K_A} {res['kernel_a_ms']:.4f} ms, "
              f"kernel B K=1 {res['kernel_b_ms']:.4f} ms, exact pass 1 "
              f"K={K_P1} {res['pass1_ms']:.4f} ms, kernel 3 K={K_3} "
              f"{res['kernel3_ms']:.4f} ms, field pass 1 K={K_P1} "
              f"{res['field_pass1_ms']:.4f} ms, digest {res['digest']} "
              f"({res['root']})")
    mean = {lb: {k: statistics.mean(r[k] for r in rs) for k in TIMES}
            for lb, rs in runs.items()}
    same = len({r["digest"] for rs in runs.values() for r in rs}) == 1
    import numpy as np
    this, other = (np.load(runs[lb][0]["npz"]) for lb in ("this", "other"))
    field = {}
    for name, c, x in (("kernel3", "costs3", "crash3"),
                       ("field_pass1", "costsf", "crashf")):
        field[name] = {
            "max_abs_cost_diff": float(np.abs(this[c] - other[c]).max()),
            "crash_this": int(this[x].sum()),
            "crash_other": int(other[x].sum()),
            "crash_flags_differ": int((this[x] != other[x]).sum()),
            "rollouts": int(this[x].size)}
    sass = {lb: exact_map_sass(runs[lb][0]["library"],
                               os.path.join(out_dir, f"{lb}.sass"))
            for lb in ("this", "other")}
    sass_equal = {name: sass["this"].get(name) == sass["other"].get(name)
                  for name in sorted(set(sass["this"]) | set(sass["other"]))}
    summary = {"card": card, "mean": mean, "bit_equal": same,
               "exact_map_sass_equal": sass_equal, "field_outputs": field,
               "this_over_other": {k: mean["this"][k] / mean["other"][k]
                                   for k in mean["this"]}}
    print(f"[ab] exact-map kernels' SASS equal to the other build's: "
          f"{sass_equal}")
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
