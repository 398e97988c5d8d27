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
fail one that drops to a single TF32 product.

With ``--spec`` (an MLP layer spec, e.g. ``6-64-64-64-64-4``) it times the
field block of that spec's library instead (``SPEC_BLOCK_VARIANTS``):
blocks of 256 threads, one an SM (8 warps; csrc kSpecFieldBlock as built),
against blocks of 128 (4 warps: a wide spec's weights leave room for no
second block), kernel 3 and field pass 1 (gaussian) at each K of
``SPEC_KS``, seeded weights, in turns, two rounds; the two builds' outputs
must be equal bit for bit.  With ``--field`` (a field spec, F and the
hidden widths, e.g. ``F6-48-48``) it does the same on a seeded field of
that spec, in the library of that field beside the MLP spec (the default
one without ``--spec``, whose field block of 128 threads is timed against
256: ``FIELD_BLOCK_VARIANTS``).  Usage, from the root of the repository
(``chip_smoke.py`` is imported from there)::

    python -m autorally_tpu_torch.tools.field_variants \
        [--spec 6-64-64-64-64-4] [--field F6-48-48]
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
_LOAD1 = "const float4 b = at<float4>(4 * ((ks * NT + nt) * 32 + lane));"
_LOAD2 = ("const float4 b =\n            at<float4>(FS::frag_offset(L) + "
          "4 * ((ks * NT + nt) * 32 + lane));")
_FAKE_B = ("const float4 b = make_float4(__int_as_float(lane + nt), "
           "__int_as_float(ks), __int_as_float(lane), __int_as_float(nt));")
_MMA3 = """  mma_tf32(d, al, h0, h1);
  mma_tf32(d, ah, __float_as_uint(b.z), __float_as_uint(b.w));
  mma_tf32(d, ah, h0, h1);"""
_SMEM = ("  return (size_t)(field_weight_floats<Deriv>() + kFieldStagedPack\n"
         "                  + kFieldWarps * kTileFloats")
VARIANTS = {
    "base": [],
    "1xtf32": [(_MMA3, "  mma_tf32(d, ah, h0, h1);")],
    "no_mma": [(_MMA3, "  d[0] += __uint_as_float(ah[0]) * b.x;")],
    "fast_sincos": [("sincosf(__fmul_rn(u, freq), &su, &cu);",
                     "__sincosf(__fmul_rn(u, freq), &su, &cu);"),
                    ("sincosf(__fmul_rn(v, freq), &sv, &cv);",
                     "__sincosf(__fmul_rn(v, freq), &sv, &cv);")],
    "no_b_loads": [(_LOAD1, _FAKE_B), (_LOAD2, _FAKE_B)],
    "one_block_per_sm": [(_SMEM, _SMEM + " + 16384")],
}
# a spec library's field block (``--spec``)
SPEC_BLOCK_VARIANTS = {
    "spec_block_256": [],
    "spec_block_128": [("constexpr int kSpecFieldBlock = 256;",
                        "constexpr int kSpecFieldBlock = 128;")],
}
# the default MLP spec's field block (``--field`` without ``--spec``)
FIELD_BLOCK_VARIANTS = {
    "field_block_128": [],
    "field_block_256": [("constexpr int kFieldBlock = 128;\n"
                         "constexpr int kFieldMinBlocks = 2;",
                         "constexpr int kFieldBlock = 256;\n"
                         "constexpr int kFieldMinBlocks = 1;")],
}
SPEC_KS = (8192, 65536)


def parse_field(label: str) -> tuple:
    """A field spec from its label: ``F6-48-48`` -> (6, 48, 48)."""
    if not label.startswith("F"):
        raise ValueError(f"a field label starts with F, got {label!r}")
    return tuple(int(n) for n in label[1:].split("-"))


def build_variants(out_dir, variants=None, layers=None, field=None,
                   bf16: bool = False) -> dict:
    """Build every variant's library (``variants``: name -> [(text, its
    replacement), ...], ``VARIANTS`` by default; of the library of the MLP
    spec ``layers`` and the field spec ``field`` when given, of bf16
    operands when ``bf16``) at once; returns name -> path.  Each one's
    compiler output (ptxas -v) is kept beside it, in ``<name>.log``."""
    from autorally_tpu_torch.ops import _build

    src = _build.SOURCE.read_text()
    out_dir.mkdir(parents=True, exist_ok=True)
    flags = _build.NVCC_FLAGS
    defines = _build.spec_defines(layers, field, bf16=bf16)
    if defines:
        header = out_dir / "spec.h"
        header.write_text(defines)
        flags += ("-include", str(header))
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
            [_build.nvcc_path(), *flags, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        so.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")
    return {name: so for name, (so, _) in procs.items()}


def use_library(path, layers=None, field=None, bf16: bool = False) -> None:
    """Make the wrappers launch the kernels of the library at ``path`` (the
    library of the MLP spec ``layers`` and the field spec ``field`` when
    given, of bf16 operands when ``bf16``)."""
    from autorally_tpu_torch.ops import _build
    from autorally_tpu_torch.ops import rollout_kernel as rk

    lib = ctypes.CDLL(str(path))
    for fn in _build.functions(layers, field, bf16=bf16):
        getattr(lib, fn).argtypes = _build.SIGNATURES[fn]
        getattr(lib, fn).restype = ctypes.c_int
    lib.build = None
    key = (_build._spec(layers), _build._field(field), bf16)
    if key == (None, None, False):
        _build._lib = lib
    else:
        _build._spec_libs[key] = lib
    rk._kernel_lib.cache_clear()


def events(fn, reps):
    """CUDA-event times (ms) of ``reps`` runs of ``fn`` after two warm-up
    runs."""
    import torch

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


def spec_blocks(layers, card, field=None) -> dict:
    """Kernel 3 and field pass 1 (gaussian) of the library of the MLP spec
    ``layers`` and the field spec ``field`` (None: the default field) in
    each field block of ``SPEC_BLOCK_VARIANTS`` (``FIELD_BLOCK_VARIANTS``
    for the default MLP spec): seeded weights (``init_params(0)``) on
    ``ab_builds.seeded_field`` of the field's spec, each K of ``SPEC_KS``,
    T=100, in turns, two rounds; each variant's field instances
    (registers, blocks an SM) and whether its outputs equal the first
    variant's bit for bit.  Returns {variant: {form: median ms}}."""
    import torch
    from autorally_tpu_torch import drive_oval
    from autorally_tpu_torch.config import CostParams, MPPIConfig
    from autorally_tpu_torch.models import NeuralNetDynamics
    from autorally_tpu_torch.ops import _build
    from autorally_tpu_torch.ops import rollout_kernel as rk
    from autorally_tpu_torch.tools.ab_builds import seeded_field

    default = tuple(layers) == rk.KERNEL_LAYERS
    libs = build_variants(_build.BUILD_DIR / "variants_spec",
                          FIELD_BLOCK_VARIANTS if default
                          else SPEC_BLOCK_VARIANTS, layers, field)
    blocks = {name: int(name.rsplit("_", 1)[1]) for name in libs}
    block_name = "FIELD_BLOCK" if default else "SPEC_FIELD_BLOCK"
    fspec = rk.FIELD_KERNEL_SPEC if field is None else tuple(field)
    dev = torch.device("cuda", 0)
    cp = CostParams(desired_speed=6.0)
    field = seeded_field(drive_oval.oval_costmap(dev), dev, fspec=fspec)
    cfg = MPPIConfig(num_timesteps=T, hz=50)
    model = NeuralNetDynamics(cfg.dt, layers=layers,
                              control_ranges=cfg.control_ranges, device=dev)
    params = model.init_params(0)
    U = torch.tensor([0.0, 0.3], device=dev).repeat(T, 1)
    start = torch.tensor(drive_oval.START, dtype=torch.float32, device=dev)
    key = torch.tensor(KEY, dtype=torch.int64, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    eps = {k: torch.randn((T, k, 2), generator=gen, device=dev)
           for k in SPEC_KS}
    ms, outs = {name: {} for name in libs}, {}
    built_block = getattr(rk, block_name)
    try:
        for rnd in range(2):
            for name, so in libs.items():
                setattr(rk, block_name, blocks[name])
                use_library(so, layers, fspec)
                if rnd == 0:
                    for rng in (False, True):
                        info = rk.field_kernel_info(rng, False, T,
                                                    layers=layers,
                                                    field=fspec)
                        print(f"[spec blocks] {name} "
                              f"{'field pass 1' if rng else 'kernel 3'}: "
                              f"{info['registers']} registers, "
                              f"{info['local_bytes']} bytes of local memory,"
                              f" {info['blocks_per_sm']} blocks of "
                              f"{blocks[name]} an SM ({card})")
                for k in SPEC_KS:
                    c = cfg.replace(num_rollouts=k)
                    launch_3, out_3 = rk.prepare_fused_rollout_cost(
                        model, params, c, cp, field, start, U, eps[k])
                    launch_f, out_f, _ = rk.prepare_fused_rng_costs(
                        model, params, c.replace(kernel_rng=True), cp, field,
                        start, U, key)
                    for form, launch in ((f"kernel3_K{k}", launch_3),
                                         (f"field_pass1_K{k}", launch_f)):
                        ms[name].setdefault(form, []).extend(
                            events(launch, 10 if k == SPEC_KS[0] else 5))
                    if rnd == 0:
                        outs[name, k] = (out_3, out_f)
    finally:
        setattr(rk, block_name, built_block)
    first = next(iter(libs))
    for name in libs:
        same = all(torch.equal(a, b) for k in SPEC_KS
                   for pair_a, pair_b in zip(outs[name, k], outs[first, k])
                   for a, b in zip(pair_a, pair_b))
        print(f"[spec blocks] {name}: outputs bit equal to {first}'s: "
              f"{same}")
        if not same:
            raise RuntimeError(f"{name}'s outputs differ from {first}'s")
    result = {name: {form: statistics.median(v) for form, v in m.items()}
              for name, m in ms.items()}
    for name, r in result.items():
        print(f"[spec blocks] {name} ({'-'.join(map(str, layers))}, "
              f"{_build.field_label(fspec)}, T={T}):"
              + ", ".join(f" {form} {v:.4f} ms" for form, v in r.items())
              + f" ({card})")
    return result


def main(argv=None) -> int:
    import argparse

    import torch
    from autorally_tpu_torch import drive_oval
    from autorally_tpu_torch.ops import _build
    from autorally_tpu_torch.ops import rollout_kernel as rk
    from autorally_tpu_torch.tools.ab_builds import seeded_field

    ap = argparse.ArgumentParser()
    ap.add_argument("--spec", help="time the field block of this MLP "
                    "spec's library instead, e.g. 6-64-64-64-64-4")
    ap.add_argument("--field", help="time the field block of the library "
                    "of this field spec instead, e.g. F6-48-48")
    args = ap.parse_args(argv)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    if args.spec or args.field:
        layers = (tuple(int(n) for n in args.spec.split("-")) if args.spec
                  else rk.KERNEL_LAYERS)
        field = parse_field(args.field) if args.field else None
        print(json.dumps({"card": card, "spec_blocks": spec_blocks(
            layers, card, field)}))
        return 0
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
