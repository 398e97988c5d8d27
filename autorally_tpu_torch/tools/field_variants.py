"""What bounds the field kernels: time variants of the CUDA source that each
take one part of the work away.

Each variant is the kernel source with one edit, built by nvcc (all at once)
into ``autorally_tpu_torch/_build/variants/`` and timed through the port's
own wrappers: kernel 3 (``fused_rollout_cost``) at K=65536 and pass 1's
field mode (``fused_rng_costs``, gaussian) at K=262144, T=100, on the main
path's seeded configuration and ``ab_builds.seeded_field``.  The variants'
results are wrong by design; only their times mean something.

- ``base``: the source as it is;
- ``1xtf32``: one TF32 product per term instead of 3xTF32's three;
- ``no_mma``: no tensor-core product at all (one fp32 multiply-add keeps
  the operands live);
- ``fast_sincos``: the features' sincosf replaced by the __sincosf
  intrinsic;
- ``no_b_loads``: the B fragments made from registers instead of read from
  shared memory;
- ``one_block_per_sm``: 16 KB more shared memory a block, so that one block
  (4 warps) an SM fits instead of two.

The variants run in turns, two rounds, in one process.  Then ``base`` and
``1xtf32`` are held against the plain versions by ``chip_smoke.agreement``
in ``chip_smoke.py``'s nominal field case (the fitted field of
``drive_oval.build(neural_costmap=True)``, kernel 3 at K=65536 and pass 1
gaussian at K=262144): that comparison must pass the kernel as built and
fail one that drops to a single TF32 product.  Usage, from the root of the
repository (``chip_smoke.py`` is imported from there)::

    python -m autorally_tpu_torch.tools.field_variants
"""

from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import sys

K_3, K_P1, T = 65536, 262144, 100
KEY = (0x2545F491, 0x9E3779B9)
HELD = ("base", "1xtf32")          # held against the plain versions

# (variant, [(text in the source, its replacement), ...])
_LOAD1 = "const float4 b = l1[(ks * kNTiles1 + nt) * 32 + lane];"
_LOAD2 = "const float4 b = l2[(ks * kNTiles2 + nt) * 32 + lane];"
_FAKE_B = ("const float4 b = make_float4(__int_as_float(lane + nt), "
           "__int_as_float(ks), __int_as_float(lane), __int_as_float(nt));")
_MMA3 = """  mma_tf32(d, al, h0, h1);
  mma_tf32(d, ah, __float_as_uint(b.z), __float_as_uint(b.w));
  mma_tf32(d, ah, h0, h1);"""
_SMEM = ("  return (size_t)(Deriv::kNumWeights + kFieldPack + kFieldWarps * "
         "kTileFloats")
VARIANTS = {
    "base": [],
    "1xtf32": [(_MMA3, "  mma_tf32(d, ah, h0, h1);")],
    "no_mma": [(_MMA3, "  d[0] += __uint_as_float(ah[0]) * b.x;")],
    "fast_sincos": [("sincosf(__fmul_rn(u, freqs[n]), &su, &cu);",
                     "__sincosf(__fmul_rn(u, freqs[n]), &su, &cu);"),
                    ("sincosf(__fmul_rn(v, freqs[n]), &sv, &cv);",
                     "__sincosf(__fmul_rn(v, freqs[n]), &sv, &cv);")],
    "no_b_loads": [(_LOAD1, _FAKE_B), (_LOAD2, _FAKE_B)],
    "one_block_per_sm": [(_SMEM, _SMEM + " + 16384")],
}


def build_variants(out_dir, variants=None) -> dict:
    """Build every variant's library (``variants``: name -> [(text, its
    replacement), ...], ``VARIANTS`` by default) at once; returns name ->
    path.  Each one's compiler output (ptxas -v) is kept beside it, in
    ``<name>.log``."""
    from autorally_tpu_torch.ops import _build

    src = _build.SOURCE.read_text()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, edits in (VARIANTS if variants is None else variants).items():
        text = src
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"variant {name}: the source has no "
                                   f"{old!r}")
            text = text.replace(old, new)
        cu, so = out_dir / f"{name}.cu", out_dir / f"{name}.so"
        cu.write_text(text)
        procs[name] = (so, subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        so.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")
    return {name: so for name, (so, _) in procs.items()}


def use_library(path) -> None:
    """Make the wrappers launch the kernels of the library at ``path``."""
    from autorally_tpu_torch.ops import _build
    from autorally_tpu_torch.ops import rollout_kernel as rk

    lib = ctypes.CDLL(str(path))
    for fn, argtypes in _build.SIGNATURES.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    lib.build = None
    _build._lib = lib
    rk._kernel_lib.cache_clear()


def main() -> int:
    import torch
    from autorally_tpu_torch import drive_oval
    from autorally_tpu_torch.ops import _build
    from autorally_tpu_torch.ops import rollout_kernel as rk
    from autorally_tpu_torch.tools.ab_builds import seeded_field

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    libs = build_variants(_build.BUILD_DIR / "variants")
    dev = torch.device("cuda", 0)
    solver, params, cost_params, costmap, _ = drive_oval.build(
        rollouts=K_3, device=dev)
    model, cfg = solver.model, solver.cfg
    field = seeded_field(costmap, dev)
    U = torch.tensor([0.0, 0.3], device=dev).repeat(T, 1)
    start = torch.tensor(drive_oval.START, dtype=torch.float32, device=dev)
    key = torch.tensor(KEY, dtype=torch.int64, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    eps = torch.randn((T, K_3, 2), generator=gen, device=dev)
    cap = cfg.replace(num_rollouts=K_P1, kernel_rng=True)

    def events(fn, reps):
        for _ in range(2):
            fn()
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

    ms = {name: {"kernel3_ms": [], "field_pass1_ms": []} for name in libs}
    for _ in range(2):
        for name, so in libs.items():
            use_library(so)
            launch_3, _ = rk.prepare_fused_rollout_cost(
                model, params, cfg, cost_params, field, start, U, eps)
            launch_f, _, _ = rk.prepare_fused_rng_costs(
                model, params, cap, cost_params, field, start, U, key)
            ms[name]["kernel3_ms"] += events(launch_3, 10)
            ms[name]["field_pass1_ms"] += events(launch_f, 5)
    result = {name: {k: statistics.median(v) for k, v in m.items()}
              for name, m in ms.items()}
    for name, r in result.items():
        print(f"[variants] {name}: kernel 3 K={K_3} {r['kernel3_ms']:.4f} "
              f"ms, field pass 1 K={K_P1} {r['field_pass1_ms']:.4f} ms "
              f"({card})")
    held = hold_against_plain(libs, dev, start, U, key)
    print(json.dumps({"card": card, "variants": result, "held": held}))
    # the check must pass the kernels as built and fail the 1xTF32 ones
    ok = (all(r["held"] for r in held["base"].values())
          and not any(r["held"] for r in held["1xtf32"].values()))
    return 0 if ok else 1


def hold_against_plain(libs, dev, start, U, key) -> dict:
    """``chip_smoke.agreement`` of the ``HELD`` variants' kernel 3 and
    field pass 1 with their plain versions in chip_smoke's nominal field
    case: {variant: {kernel: {"held", "max_abs_err", "failure"}}}."""
    import torch
    import chip_smoke
    from autorally_tpu_torch import drive_oval
    from autorally_tpu_torch.ops import rollout_kernel as rk

    solver, params, cost_params, field, _ = drive_oval.build(
        rollouts=K_3, device=dev, neural_costmap=True)
    model, cfg = solver.model, solver.cfg
    cap = cfg.replace(num_rollouts=K_P1, kernel_rng=True)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    eps = torch.randn((T, K_3, 2), generator=gen, device=dev)
    plain = {
        "kernel3": rk.fused_rollout_cost_plain(
            model, params, cfg, cost_params, field, start, U, eps)[::2],
        "field_pass1": rk.fused_rng_costs_plain(
            model, params, cap, cost_params, field, start, U, key)[:2]}
    held = {}
    for name in HELD:
        use_library(libs[name])
        ran = {"kernel3": rk.fused_rollout_cost(
                   model, params, cfg, cost_params, field, start, U,
                   eps)[::2],
               "field_pass1": rk.fused_rng_costs(
                   model, params, cap, cost_params, field, start, U,
                   key)[:2]}
        torch.cuda.synchronize()
        held[name] = {}
        for kernel, (kc, kx) in ran.items():
            pc, px = plain[kernel]
            r = {"held": True, "max_abs_err": None, "failure": None}
            try:
                r["max_abs_err"] = chip_smoke.agreement(
                    f"variants {name} {kernel} K={kc.numel()}", "nominal",
                    kc, kx, pc, px, kc.numel())
            except chip_smoke.PhaseFailed as e:
                r["held"], r["failure"] = False, str(e)
            held[name][kernel] = r
    return held


if __name__ == "__main__":
    sys.exit(main())
