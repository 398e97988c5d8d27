"""Time kernels 1 and 2 and both passes of the capacity mode of two
checkouts of the port on one GPU, in one call, and hold their outputs bit
for bit.

The forms (``exact_forms``) are kernel 1 (``fused_exact_rollout_cost``) at
K=1920, with 16 circle slots at K=1920, the BF kernel 1 at K=2560 on
random noise and on the inputs of the last tick of a 50-tick BF closed
loop (``bf_closed_loop_tick``), exact pass 1 (``fused_rng_costs``) at
K=262144 with gaussian and OU noise, its form with 16 slots, its BF form
gaussian, OU and with 16 slots, and kernel 1 at K=262144; (``chain_forms``) kernel 2
(``dynamics_chain``), MLP and BF, at the nominal trajectory's K=1 and at
K=1920 and K=2560; and (``update_forms``) pass 2 (``fused_rng_numer``'s
kernel) at K=262144 on three weight vectors: the softmax weights of pass
1's costs from the start (nominal), those of the last tick of a
capacity-mode drive (closed loop) and all ones (dense), each with its
share of warps whose 32 weights are all 0; all at T=100 on the main
path's seeded configuration (``drive_oval.build``), each in the geometry
its checkout's launcher picks.  Each checkout builds its own kernels from
its own source and runs in its own process, in the order other, this,
this, other, so that a drift of the card over the call falls on both
alike.  Each prints the CUDA-event medians and a digest of each form's
outputs; equal digests show bit-equal results.  The SASS of the kernels
named in ``UNTOUCHED_KERNELS`` (every kernel of the library but BF exact
pass 1, which ``fused_rng_bf_kernel`` now runs, the quotient check and
the lane forms, the instances with ``kLanes`` set) is compared between
the two builds' libraries (``cuobjdump -sass``), function by function;
``--changed`` names instances whose SASS this checkout changes on purpose
(e.g. ``fused_exact_kernel<Mlp>``): theirs is compared and reported, and
only the others must be equal.  The summary gives each checkout's mean of its two runs and the
ratio of this checkout to the other.  Run against an identical copy of
this checkout (A/A), it measures the order's own bias.

Usage (``DIR``: another checkout's root, e.g. ``git archive`` of a parent
commit unpacked under ``autorally_tpu_torch/_build/``)::

    python -m autorally_tpu_torch.tools.ab_builds --other DIR [--rounds 5]
        [--changed NAME,NAME,...]
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import os
import re
import statistics
import subprocess
import sys

THIS_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
K_A, K_BF, K_P1, T = 1920, 2560, 262144, 100
KEY = (0x2545F491, 0x9E3779B9)
N_SLOTS = 16
CIRCLES = [[30.0, 5.0, 0.5], [29.5, 8.0, 0.5]]
# kernels whose SASS must equal the other build's: kernel 1 in one rollout
# a thread (MLP, BF) and in its lane groups (8, 16, 32), exact pass 1 (the
# MLP's) and kernel 2 in one rollout a thread and a rollout a warp (MLP,
# BF each), kernel 3 and field pass 1 (MLP, BF each), pass 2; BF exact pass
# 1 (REDESIGNED: fused_rng_kernel<BfDeriv> in a build that has it) is not
UNTOUCHED_KERNELS = ("fused_exact_kernel", "fused_exact_group_kernel",
                     "fused_rng_kernel", "dynamics_chain_kernel",
                     "dynamics_chain_warp_kernel", "fused_field_kernel",
                     "fused_rng_field_kernel", "weighted_update_kernel")
REDESIGNED = ("fused_rng_kernel<Bf>",)
N_UNTOUCHED = 15
# pass 2's forms: K, the capacity-mode ticks whose last weights are the
# closed loop's, CUDA-event repetitions a round; the BF path's ticks whose
# last inputs of kernel 1 are timed
K_P2, CLOSED_LOOP_TICKS, P2_REPS = 262144, 20, 20
BF_TICKS = 50


def seeded_field(costmap, device, seed: int = 7, fspec=(8, 64, 64)):
    """A field of the spec ``fspec`` (F and the hidden widths; the default
    library's 34-64-64-1, F = 8, by default) on ``costmap``'s transform:
    He-normal weights and small biases from a numpy seed, the output
    scaled (in float64 numpy on a 101 x 101 grid of the map) to a standard
    deviation of 0.25 about 0.35, so that part of it lies over the 0.65
    crash boundary."""
    import numpy as np
    from autorally_tpu_torch.costs import NeuralCostmap

    rs = np.random.default_rng(seed)
    n_freqs = fspec[0]
    layers = (2 + 4 * n_freqs,) + tuple(fspec[1:]) + (1,)
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


def exact_forms(dev) -> dict:
    """name -> (K, whether the model is the MLP, ``prepare()`` returning
    (launch, outputs)) for each form of kernel 1 and exact pass 1 that is
    timed; the APIs used are those of every slice of the port since the
    obstacle terms'."""
    import torch
    from autorally_tpu_torch import drive_oval
    from autorally_tpu_torch.costs import make_obstacles
    from autorally_tpu_torch.ops import rollout_kernel as rk

    solver, params, cost_params, costmap, _ = drive_oval.build(
        rollouts=K_A, device=dev)
    bf, bparams, _, _, _ = drive_oval.build(model="bf", rollouts=K_BF,
                                            device=dev)
    model, cfg, bmodel, bcfg = solver.model, solver.cfg, bf.model, bf.cfg
    U = torch.tensor([0.0, 0.3], device=dev).repeat(T, 1)
    start = torch.tensor(drive_oval.START, dtype=torch.float32, device=dev)
    key = torch.tensor(KEY, dtype=torch.int64, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    eps = torch.randn((T, K_A, 2), generator=gen, device=dev)
    beps = torch.randn((T, K_BF, 2), generator=gen, device=dev)
    big = torch.randn((T, K_P1, 2), generator=gen, device=dev)
    okw = dict(obstacles=make_obstacles(CIRCLES, N_SLOTS, device=dev),
               obstacle_coeff=drive_oval.OBSTACLE_COEFF,
               inflation=drive_oval.OBSTACLE_INFLATION)
    cap = cfg.replace(num_rollouts=K_P1, kernel_rng=True)
    ou = cap.replace(noise_sampler="ou", noise_param=0.15)
    bcap = bcfg.replace(num_rollouts=K_P1, kernel_rng=True)
    exact = rk.prepare_fused_exact_rollout_cost

    def pass1(m, p, c, **kw):
        return lambda: rk.prepare_fused_rng_costs(
            m, p, c, cost_params, costmap, start, U, key, **kw)[:2]

    # the BF path's inputs of kernel 1 at the last tick of a closed loop
    tick = bf_closed_loop_tick(bf, bparams, cost_params, costmap)

    return {
        "kernel1_K1920": (K_A, True, lambda: exact(
            model, params, cfg, cost_params, costmap, start, U, eps)),
        "kernel1_16slots_K1920": (K_A, True, lambda: exact(
            model, params, cfg, cost_params, costmap, start, U, eps, **okw)),
        "kernel1_bf_K2560": (K_BF, False, lambda: exact(
            bmodel, bparams, bcfg, cost_params, costmap, start, U, beps)),
        "kernel1_bf_closed_loop_K2560": (K_BF, False, lambda: exact(
            *tick[0], **tick[1])),
        "pass1_gaussian_K262144": (K_P1, True, pass1(model, params, cap)),
        "pass1_ou_K262144": (K_P1, True, pass1(model, params, ou)),
        "pass1_bf_K262144": (K_P1, False, pass1(bmodel, bparams, bcap)),
        "pass1_bf_ou_K262144": (K_P1, False, pass1(
            bmodel, bparams, bcap.replace(noise_sampler="ou",
                                          noise_param=0.15))),
        "pass1_bf_16slots_K262144": (K_P1, False, pass1(bmodel, bparams,
                                                         bcap, **okw)),
        "pass1_16slots_K262144": (K_P1, True, pass1(model, params, cap,
                                                     **okw)),
        "kernel1_K262144": (K_P1, True, lambda: exact(
            model, params, cap.replace(kernel_rng=False), cost_params,
            costmap, start, U, big)),
    }


@contextlib.contextmanager
def last_call(module, name: str):
    """Wraps ``module.<name>`` while the block runs and yields a dict whose
    "args" holds the (args, kwargs) of the last call; raises RuntimeError
    at the block's end if nothing called it (a caller that does not reach
    it through the module attribute)."""
    fn, got = getattr(module, name), {}

    def wrapped(*args, **kw):
        got["args"] = (args, kw)
        return fn(*args, **kw)

    setattr(module, name, wrapped)
    try:
        yield got
    finally:
        setattr(module, name, fn)
    if "args" not in got:
        raise RuntimeError(f"{module.__name__}.{name} was not called")


def bf_closed_loop_tick(solver, params, cost_params, costmap,
                        ticks: int = BF_TICKS):
    """The arguments (args, kwargs) of the BF path's last kernel-1 call in a
    ``ticks``-tick closed loop of ``solver`` from the start (its state, U
    and eps at K=2560): the traffic the BF path sends kernel 1."""
    from autorally_tpu_torch import drive_oval
    from autorally_tpu_torch.ops import rollout_kernel as rk

    with last_call(rk, "fused_exact_rollout_cost") as last:
        drive_oval.drive(solver, params, cost_params, costmap, ticks,
                         log=lambda m: None)
    return last["args"]


def chain_forms(dev) -> dict:
    """name -> (K, whether the model is the MLP, ``prepare()``) for kernel 2
    (``prepare_dynamics_chain``), MLP and BF, at the nominal trajectory's
    K=1 (zero noise) and at the fine-map checks' K (1920, 2560), each in
    the geometry its checkout's launcher picks."""
    import torch
    from autorally_tpu_torch import drive_oval
    from autorally_tpu_torch.ops import rollout_kernel as rk

    solver, params, _, _, _ = drive_oval.build(rollouts=K_A, device=dev)
    bf, bparams, _, _, _ = drive_oval.build(model="bf", rollouts=K_BF,
                                            device=dev)
    U = torch.tensor([0.0, 0.3], device=dev).repeat(T, 1)
    start = torch.tensor(drive_oval.START, dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(8)
    forms = {}
    for label, (s, p, mlp) in (("", (solver, params, True)),
                               ("_bf", (bf, bparams, False))):
        for K in (1, K_A if mlp else K_BF):
            eps = (torch.zeros((T, 1, 2), device=dev) if K == 1 else
                   torch.randn((T, K, 2), generator=gen, device=dev))
            forms[f"kernel2{label}_K{K}"] = (
                K, mlp, lambda s=s, p=p, eps=eps: rk.prepare_dynamics_chain(
                    s.model, p, s.cfg, start, U, eps))
    return forms


def zero_warp_share(w) -> float:
    """The share of pass 2's warps (32 rollouts each, the last padded with
    zeros) whose weights are all 0."""
    import torch

    n = -(-w.numel() // 32)
    pad = torch.zeros(n * 32, dtype=w.dtype, device=w.device)
    pad[:w.numel()] = w
    return float((pad.reshape(n, 32) == 0).all(dim=1).float().mean())


def update_forms(dev) -> dict:
    """name -> (K, whether the model is the MLP, ``prepare()``, the share
    of all-zero warps) for pass 2 (``prepare_fused_rng_numer``) at K=262144,
    gaussian, on the nominal weights (pass 1's costs from the start), the
    closed loop's (the last tick of a ``CLOSED_LOOP_TICKS``-tick capacity
    drive from the start) and dense ones (all 1)."""
    import torch
    from autorally_tpu_torch import drive_oval
    from autorally_tpu_torch.config import effective_gamma
    from autorally_tpu_torch.ops import rollout_kernel as rk
    from autorally_tpu_torch.solver.mppi import MPPISolver

    solver, params, cost_params, costmap, _ = drive_oval.build(
        rollouts=K_A, device=dev)
    cap = solver.cfg.replace(num_rollouts=K_P2, kernel_rng=True)
    U = torch.tensor([0.0, 0.3], device=dev).repeat(T, 1)
    start = torch.tensor(drive_oval.START, dtype=torch.float32, device=dev)
    key = torch.tensor(KEY, dtype=torch.int64, device=dev)
    costs, _, ctx = rk.fused_rng_costs(solver.model, params, cap,
                                       cost_params, costmap, start, U, key)
    nominal = torch.exp(-effective_gamma(cap, cost_params)
                        * (costs - costs.min()))
    with last_call(rk, "fused_rng_numer") as last:
        drive_oval.drive(MPPISolver(solver.model, solver.cost, cap,
                                    device=dev), params, cost_params,
                         costmap, CLOSED_LOOP_TICKS, log=lambda m: None)
    weights = {"nominal": (ctx, nominal), "closed_loop": last["args"][0],
               "dense": (ctx, torch.ones_like(nominal))}
    return {f"pass2_{name}_K{K_P2}": (
        K_P2, True, lambda c=c, w=w: rk.prepare_fused_rng_numer(c, w),
        zero_warp_share(w)) for name, (c, w) in weights.items()}


def events(fn, reps: int) -> list:
    import torch

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


def time_checkout(root: str, rounds: int) -> dict:
    """Build and time the forms of the checkout at ``root`` (imported from
    there); each form's median time and the digest of its outputs."""
    sys.path.insert(0, root)
    import torch
    import autorally_tpu_torch
    from autorally_tpu_torch.ops import _build

    pkg = os.path.dirname(os.path.abspath(autorally_tpu_torch.__file__))
    if os.path.dirname(pkg) != os.path.abspath(root):
        raise RuntimeError(f"imported {pkg}, not the checkout at {root}")
    dev = torch.device("cuda", 0)
    launches, shares = {}, {}
    for name, (K, _, prepare) in {**exact_forms(dev),
                                  **chain_forms(dev)}.items():
        launch, out = prepare()
        launches[name] = (launch, out, 40 if K < K_P1 else 4)
    for name, (K, _, prepare, share) in update_forms(dev).items():
        launch, partials = prepare()
        launches[name] = (launch, (partials,), P2_REPS)
        shares[name] = share
    for launch, _, _ in launches.values():     # build, load, warm up
        events(launch, 2)
    ms = {name: [] for name in launches}
    for _ in range(rounds):                    # interleaved rounds
        for name, (launch, _, reps) in launches.items():
            ms[name] += events(launch, reps)
    digests = {}
    for name, (_, out, _) in launches.items():
        h = hashlib.sha256()
        for t in out:
            h.update(t.cpu().numpy().tobytes())
        digests[name] = h.hexdigest()[:16]
    return {"root": os.path.abspath(root),
            "ms": {name: statistics.median(v) for name, v in ms.items()},
            "digests": digests, "zero_warp_share": shares,
            "library": str(_build.library_path())}


def untouched_sass(library: str, dump: str) -> dict:
    """The SASS of each instance of ``UNTOUCHED_KERNELS`` in the built
    ``library`` but those of ``REDESIGNED``, by short name (e.g.
    ``fused_field_kernel<MlpDeriv>``, ``fused_exact_group_kernel<8>``); the
    whole ``cuobjdump -sass`` output is written to ``dump``.  The kernels
    live in an anonymous namespace, whose mangled name differs between
    builds, so it is cut from the names and the code, and runs of spaces
    are one space."""
    from autorally_tpu_torch.ops import _build

    objdump = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    out = subprocess.run([objdump, "-sass", library], capture_output=True,
                         text=True, check=True, timeout=300).stdout
    with open(dump, "w") as f:
        f.write(out)
    names = "|".join(UNTOUCHED_KERNELS)
    sass = {}
    for fn in re.split(r"\n\s*Function : ", out)[1:]:
        head, body = fn.split("\n", 1)
        m = re.search(rf"\d({names})(?:ILi(\d+)E|I.*?(Mlp|Bf)Deriv)?"
                      r"E?(I?Lb1E)?", head)
        if m:
            arg = m.group(2) or m.group(3)
            name = m.group(1) + (f"<{arg}>" if arg else "")
            if name in REDESIGNED or m.group(4):     # a lane form
                continue
            body = re.sub(r"_GLOBAL__N__\w+", "", body)
            # cuobjdump pads each line to the module's widest instruction,
            # which other kernels set: compare the lines' words; the last
            # function of the dump is followed by a line of dots
            sass[name] = "\n".join(
                " ".join(line.split()) for line in body.splitlines()
                if line.strip(". \t"))
    if len(sass) != N_UNTOUCHED:
        raise RuntimeError(f"{library}: found the SASS of {sorted(sass)}, "
                           f"not of the {N_UNTOUCHED} kernels compared")
    return sass


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", help="the other checkout's root")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--changed", default="",
                    help="comma-separated instances whose SASS may differ")
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
    out_dir = os.path.join(THIS_ROOT, "autorally_tpu_torch", "_build", "ab")
    os.makedirs(out_dir, exist_ok=True)
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
        print(f"[ab] {label} ({res['root']}): " + ", ".join(
            f"{n} {t:.4f} ms" for n, t in res["ms"].items()))
    names = list(runs["this"][0]["ms"])
    mean = {lb: {n: statistics.mean(r["ms"][n] for r in rs) for n in names}
            for lb, rs in runs.items()}
    bit_equal = {n: len({r["digests"][n] for rs in runs.values()
                         for r in rs}) == 1 for n in names}
    sass = {lb: untouched_sass(runs[lb][0]["library"],
                               os.path.join(out_dir, f"{lb}.sass"))
            for lb in ("this", "other")}
    same = {name: sass["this"].get(name) == sass["other"].get(name)
            for name in sorted(set(sass["this"]) | set(sass["other"]))}
    changed = [n for n in args.changed.split(",") if n]
    unknown = sorted(set(changed) - set(same))
    if unknown:
        print(f"[ab] --changed names no compared instance: {unknown}",
              file=sys.stderr)
        return 2
    summary = {"card": card, "mean": mean, "bit_equal": bit_equal,
               "untouched_sass_equal": same, "changed": changed,
               "this_over_other": {n: mean["this"][n] / mean["other"][n]
                                   for n in names}}
    shares = runs["this"][0]["zero_warp_share"]
    summary["zero_warp_share"] = shares
    for n in names:
        share = (f", all-zero warps {100 * shares[n]:.2f} %" if n in shares
                 else "")
        print(f"[ab] {n}: this {mean['this'][n]:.4f} ms, other "
              f"{mean['other'][n]:.4f} ms, ratio "
              f"{summary['this_over_other'][n]:.3f}, outputs bit equal "
              f"{bit_equal[n]}{share} ({card})")
    print(f"[ab] untouched kernels' SASS equal to the other build's: "
          f"{same}; changed on purpose: {changed}")
    for name, equal in same.items():
        if not equal:
            a, b = (sass[lb].get(name, "").splitlines()
                    for lb in ("this", "other"))
            diff = [(x, y) for x, y in zip(a, b) if x != y]
            print(f"[ab] {name}: {len(a)} against {len(b)} lines, "
                  f"{len(diff)} differ; first: {diff[:2]}")
    print(json.dumps(summary))
    return 0 if all(bit_equal.values()) and all(
        equal for name, equal in same.items() if name not in changed) else 1


if __name__ == "__main__":
    sys.exit(main())
