"""What bounds kernels 1 and 2 and exact pass 1, and which launch geometry
is the fastest at each K: time variants of the CUDA source, then every
geometry the kernels are built for.

Each source variant is the kernel source with one edit, built by nvcc (all
at once) into
``autorally_tpu_torch/_build/exact_variants/`` and timed through the
port's own wrappers in the geometry the launcher picks: kernel 1
(``fused_exact_rollout_cost``) at K=1920 and exact pass 1
(``fused_rng_costs``, gaussian) at K=262144, T=100, on the main path's
seeded configuration (``drive_oval.build``).  The variants' results are
wrong by design, but for ``const_operand``, which only moves the weights;
only their times mean something.

- ``base``: the source as it is;
- ``no_tanh``: the MLP's tanhf taken away (the identity), in every form;
- ``no_cost``: the cost step taken away (no lookups, atanf or latches);
- ``const_weights``: the MLP's weights a constant of their index, folded
  into the instructions, instead of read from shared memory;
- ``const_operand``: exact pass 1's MLP weights in the constant bank,
  copied there from the packed weights before each launch, read by a
  derivative type that indexes the ``__constant__`` array at compile-time
  indices, with no compiler barrier a step;
- ``no_gather``: the costmap lookups without their load (the texel index
  arithmetic stays);
- ``blocks_8``, ``blocks_10``: one rollout a thread with 8 or 10 blocks of
  64 an SM asked of the compiler (``__launch_bounds__``), at most 128 or
  102 registers instead of 168, for more warps in flight;
- BF exact pass 1's designs (the base, ``fused_rng_bf_kernel``, has both
  the constant quotients and the branch-free stream a step ahead):
  ``bf_parent``, the parent's kernel (``fused_rng_kernel<BfDeriv>``);
  ``bf_quotients``, the constant quotients only; ``bf_ahead``, the stream
  a step ahead only; ``bf_stream_ieee``, the base with the stream's IEEE
  quotient, root and quadrant switch (their branches); ``bf_blocks_8``,
  ``bf_blocks_10``, ``bf_blocks_11``, ``bf_blocks_12``,
  ``bf_blocks_16``: the base at least 8, 10, 11, 12 or 16 blocks of 64 an
  SM (at most 128, 96, 88, 80 or 64 registers).  These are exact: their
  BF pass-1 outputs must equal the base's bit for bit.  ``bf_no_guard``
  takes div_const in every step (no IEEE fallback under the factor
  floor), which is not exact: it shows the guard's cost and the loop's
  SASS without the fallback's divisions.

Each variant's SASS of exact pass 1 (``fused_rng_kernel<MlpDeriv>``) is
counted by opcode (``pass1_sass``): how the weights are read.  BF exact
pass 1 is timed at K=262144, gaussian and OU, in every variant, and the
kernel that its launcher runs is described by its registers and spills
(ptxas) and a step of its stream loop (``bf_pass1_sass``:
``sass_chain.loop_mix``, with ``FCHK``, ``MUFU.RCP``, ``BSSY`` and
``BSYNC``).  Kernel 2
(``chain_sweep``) is timed at each K of ``CHAIN_K``, the MLP and the BF
model, in each of its geometries (``rk.CHAIN_GEOMETRIES``) with the base
library, its states and u_seq held bit for bit against one rollout a
thread: what places ``rk.chain_geometry``'s choice.

Then (unless ``--no-geometries``), with the ``base`` library, every
geometry kernel 1 is built for (``rk.GEOMETRIES``: lane group G, block) is
forced on each form of ``ab_builds.exact_forms`` (kernel 1 at K=1920 with
and without 16 circle slots, the BF kernel 1 at K=2560, kernel 1 at
K=262144; the BF form takes G = 1 only, and K=262144 no lane groups;
exact pass 1's four forms at K=262144 run their one geometry, one rollout
a thread), timed, and its outputs (costs, crash flags, u_seq) held bit for
bit against one rollout a thread.  Last, kernel 1 is timed at the K of
``CROSSOVER_K`` in one rollout a thread and each lane group, to place the
launcher's choice.  Exits non-zero when a geometry's outputs differ.
Usage, from the root of the repository::

    python -m autorally_tpu_torch.tools.exact_variants [--variants a,b]
        [--no-geometries]
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import statistics
import subprocess
import sys

K_A, K_P1 = 1920, 262144
CROSSOVER_K = (256, 960, 1920, 4224, 8448, 16896, 33792, 67584)
# kernel 2's K: the nominal trajectory's 1, the fine-map checks' 1920 and
# 2560, and around one wave of the warp form (16 rollouts an SM, 2112)
CHAIN_K = (1, 33, 132, 528, 1056, 1920, 2112, 2560, 4224, 8448)

_STAND_IN = ("__device__ __forceinline__ float stand_in(int i) {\n"
             "  return 0.01f * (float)((i * 7) & 31) - 0.15f;\n}\n\n")
_SI4 = "make_float4(stand_in({0}), stand_in({0} + 1), stand_in({0} + 2), " \
       "stand_in({0} + 3))"
_RNG_LAUNCH = ("  const cudaError_t err = rng_opt_in<MlpDeriv, kLanes>(device);\n"
               "  if (err != cudaSuccess) return err;\n"
               "  fused_rng_kernel<MlpDeriv, kLanes><<<")
_COPY = ("  if (!s.bf)\n"
         "    cudaMemcpyToSymbolAsync(c_w, weights, kNumMlpWeights * 4, 0,\n"
         "                            cudaMemcpyDeviceToDevice, st);\n")
_MLP_BF_ANCHOR = "// BfDeriv: theta^T phi, the 25 car basis functions"
_PASS1_CALL = ("rollout_cost<false, Deriv>(s, cs, s0, rngs, USource{U_s, U, "
               "Tu < s.T},")
_STEP_TOP = ("    weights_barrier();\n    float u0, u1, du0, du1;\n"
             "    perturb(s, U_s, noise(t), t, zero_rollout, pure_noise, u0, "
             "u1, du0, du1);\n    if (kStoreU && active) {")
_CONST_W = "__constant__ float c_w[kNumMlpWeights];\n\n"
_BF_BOUNDS = "__launch_bounds__(kBlock, kBfPass1Blocks)"
BF_FORMS = {"pass1_bf_K262144": "gaussian", "pass1_bf_ou_K262144": "ou"}


def _const_deriv(name, w):
    """The source of a derivative type ``name``: MlpDeriv's layers (the
    library's spec, ``Spec``) with each weight read as the C++ expression
    ``w`` of a compile-time index (``{i}``), and ``PassDerivOf`` mapping
    MlpDeriv to it in exact pass 1."""
    return f"""struct {name} {{
  static constexpr int kNumWeights = kNumMlpWeights;

  template <int L>
  static __device__ __forceinline__ void layer(const float* x, float* y) {{
    constexpr int n = Spec::width(L), m = Spec::width(L + 1);
    constexpr int off = mlp_offset<Spec>(L), boff = off + m * n;
#pragma unroll
    for (int j = 0; j < m; ++j) {{
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < n; ++i)
        acc = fmaf({w.format(i='off + j * n + i')}, x[i], acc);
      if constexpr (L + 1 < Spec::kLayers)
        y[j] = tanhf(acc + {w.format(i='boff + j')});
      else
        y[j] = acc + {w.format(i='boff + j')};
    }}
  }}

  template <int L>
  static __device__ __forceinline__ void layers(const float* x,
                                                float out[kOut]) {{
    if constexpr (L + 1 == Spec::kLayers) {{
      layer<L>(x, out);
    }} else {{
      float h[Spec::width(L + 1)];
      layer<L>(x, h);
      layers<L + 1>(h, out);
    }}
  }}

  static __device__ __forceinline__ void eval(const float* __restrict__ w,
                                              const float d[kOut], float u0,
                                              float u1, float out[kOut]) {{
    const float in[kIn] = {{d[0], d[1], d[2], d[3], u0, u1}};
    layers<0>(in, out);
  }}
}};

template <class D> struct PassDerivOf {{ using type = D; }};
template <> struct PassDerivOf<MlpDeriv> {{ using type = {name}; }};

"""


# exact pass 1's MLP instance on MlpConstDeriv, without the step's compiler
# barrier, the weights copied to c_w before each launch
_CONST_OPERAND = [
    (_MLP_BF_ANCHOR,
     _CONST_W + _const_deriv("MlpConstDeriv", "c_w[{i}]") + _MLP_BF_ANCHOR),
    (_PASS1_CALL, "rollout_cost<false, typename PassDerivOf<Deriv>::type>("
     "s, cs, s0, rngs, USource{U_s, U, Tu < s.T},"),
    (_STEP_TOP, _STEP_TOP.replace(
        "    weights_barrier();",
        "    if constexpr (!std::is_same_v<Deriv, typename PassDerivOf<"
        "MlpDeriv>::type>)\n      weights_barrier();")),
    (_RNG_LAUNCH, _COPY + _RNG_LAUNCH)]
VARIANTS = {
    "base": [],
    "no_tanh": [
        ("y[j] = mm_operand(tanhf(acc + b[j]));",
         "y[j] = mm_operand(acc + b[j]);"),
        ("h[u] = mm_operand(tanhf(acc + b.z));",
         "h[u] = mm_operand(acc + b.z);"),
        ("y[u] = mm_operand(tanhf(acc[u] + W[(lane + G * u) * stride + n]));",
         "y[u] = mm_operand(acc[u] + W[(lane + G * u) * stride + n]);")],
    "no_cost": [("if (t > 0) {", "if (false) {")],
    "const_weights": [
        ("template <class S, bool kSplit = false>\nstruct MlpDerivOf {",
         _STAND_IN + "template <class S, bool kSplit = false>\n"
         "struct MlpDerivOf {"),
        ("acc = fmaf(W[j * n + i], x[i], acc);",
         "acc = fmaf(stand_in(off + j * n + i), x[i], acc);"),
        ("const float4 a = r[0], b = r[1];",
         f"const float4 a = {_SI4.format('u')}, b = {_SI4.format('u + 4')};"),
        ("wq[u] = reinterpret_cast<const float4*>(W + (lane + G * u)\n"
         "                                                * stride)[q];",
         f"wq[u] = {_SI4.format('off + q + u')};"),
        ("const float4 wq = r[q];",
         f"const float4 wq = {_SI4.format('off + q')};")],
    "const_operand": _CONST_OPERAND,
    "no_gather": [
        ("return __ldg(ch0 + (size_t)(int)fy * c.W + (int)fx);",
         "return (fx + fy) * 1e-9f;")],
    **{f"blocks_{n}": [
        (f"__launch_bounds__(kBlock, 1)\n{kernel}(",
         f"__launch_bounds__(kBlock, {n})\n{kernel}(")
        for kernel in ("fused_exact_kernel", "fused_rng_kernel")]
       for n in (8, 10)},
    "bf_parent": [("fused_rng_bf_kernel<kLanes><<<",
                   "fused_rng_kernel<BfDeriv, kLanes><<<")],
    "bf_quotients": [("auto noise = stream_noise_ahead(r, key, k, s.T);",
                      "auto noise = stream_noise(r, key, k);")],
    "bf_ahead": [("rollout_cost<false, BfConstDivDeriv>(",
                  "rollout_cost<false, BfDeriv>(")],
    "bf_stream_ieee": [("w = stream_normals<true>(", "w = stream_normals(")],
    "bf_no_guard": [("bf_phi<IeeeQuotient>(", "bf_phi<ConstQuotient>(")],
    **{f"bf_blocks_{n}": [(_BF_BOUNDS, f"__launch_bounds__(kBlock, {n})")]
       for n in (8, 10, 11, 12, 16)},
}


def pass1_sass(library) -> dict:
    """Opcode counts in the SASS of ``fused_rng_kernel<MlpDeriv>`` in the
    built ``library`` (``cuobjdump -sass``): instructions, shared-memory and
    constant-bank loads, FFMA, and FFMA with a constant-bank operand."""
    from autorally_tpu_torch.ops import _build

    objdump = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    out = subprocess.run([objdump, "-sass", str(library)],
                         capture_output=True, text=True, check=True,
                         timeout=300).stdout
    for fn in re.split(r"\n\s*Function : ", out)[1:]:
        head, body = fn.split("\n", 1)
        if not re.search(r"\dfused_rng_kernelI\w*?MlpDerivELb0E", head):
            continue
        ins = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                         r"([A-Z][A-Z0-9_]*)[\w.]*\s*([^;]*);", body)
        count = {"instructions": len(ins)}
        for op in ("LDS", "LDC", "ULDC", "FFMA", "MUFU"):
            count[op] = sum(o == op for o, _ in ins)
        count["FFMA c[]"] = sum(o == "FFMA" and "c[" in a for o, a in ins)
        return count
    raise RuntimeError(f"{library}: no fused_rng_kernel<MlpDeriv>")


def bf_pass1_sass(name, library) -> dict:
    """BF exact pass 1 as variant ``name`` builds it (the kernel that its
    launcher runs): its registers and spill bytes (the variant's ptxas
    log) and a step of its stream loop (``sass_chain.loop_mix``)."""
    from autorally_tpu_torch.ops import _build
    from autorally_tpu_torch.tools import sass_chain

    kernel = (r"\dfused_rng_kernelI\w*?BfDerivELb0E" if name == "bf_parent"
              else r"\dfused_rng_bf_kernelILb0E")
    log = library.with_suffix(".log").read_text()
    regs = spill = None
    for entry in re.split(r"Compiling entry function", log)[1:]:
        if re.search(kernel, entry.split("\n", 1)[0]):
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", entry)
            spill = int(m.group(1)) + int(m.group(2)) if m else None
            m = re.search(r"Used (\d+) registers", entry)
            regs = int(m.group(1)) if m else None
    objdump = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    sass = subprocess.run([objdump, "-sass", str(library)],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    return {"registers": regs, "spill_bytes": spill,
            "loop": sass_chain.loop_mix(sass_chain.instructions(sass,
                                                                kernel))}


@contextlib.contextmanager
def forced_geometry(group: int, block: int):
    """Makes every launch of kernel 1 take the geometry (G, block), one of
    ``rk.GEOMETRIES``, while active."""
    from autorally_tpu_torch.ops import rollout_kernel as rk

    saved = rk.exact_geometry
    rk.exact_geometry = lambda K, n_sms, bf=False, layers=None: (
        rk._geometry(K, group, block))
    try:
        yield
    finally:
        rk.exact_geometry = saved


def events(fn, reps: int) -> float:
    """Median CUDA-event time of ``fn`` in ms after two warm-up runs."""
    from autorally_tpu_torch.tools import ab_builds

    ab_builds.events(fn, 2)
    return statistics.median(ab_builds.events(fn, reps))


def main() -> int:
    import argparse

    import torch
    from autorally_tpu_torch.ops import _build
    from autorally_tpu_torch.ops import rollout_kernel as rk
    from autorally_tpu_torch.tools.ab_builds import exact_forms
    from autorally_tpu_torch.tools.field_variants import (build_variants,
                                                          use_library)

    ap = argparse.ArgumentParser()
    ap.add_argument("--variants", default=",".join(VARIANTS),
                    help="comma-separated names of VARIANTS to build, "
                    "base among them")
    ap.add_argument("--no-geometries", action="store_true",
                    help="skip kernel 1's geometries and crossover sweep")
    args = ap.parse_args()
    names = args.variants.split(",")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    libs = build_variants(_build.BUILD_DIR / "exact_variants",
                          {n: VARIANTS[n] for n in names})
    dev = torch.device("cuda", 0)
    timed = exact_forms(dev)

    # the source variants, in the launcher's geometry, two rounds in turns
    forms = (("kernel1_K1920", 40), ("pass1_gaussian_K262144", 5),
             *((f, 5) for f in BF_FORMS))
    ms = {name: {f: [] for f, _ in forms} for name in libs}
    bf_out = {}
    for _ in range(2):
        for name, so in libs.items():
            use_library(so)
            for form, reps in forms:
                launch, out = timed[form][2]()
                ms[name][form].append(events(launch, reps))
                if form in BF_FORMS:
                    torch.cuda.synchronize()
                    bf_out[name, form] = [t.clone() for t in out]
                del launch, out
    variants = {name: {f: statistics.mean(v) for f, v in m.items()}
                for name, m in ms.items()}
    sass = {name: pass1_sass(so) for name, so in libs.items()}
    for name, r in variants.items():
        print(f"[exact variants] {name}: kernel 1 K={K_A} "
              f"{r['kernel1_K1920']:.4f} ms, exact pass 1 K={K_P1} "
              f"{r['pass1_gaussian_K262144']:.4f} ms ({card}); pass 1 SASS "
              f"{sass[name]}")
    # BF exact pass 1's designs: exact, so bit equal to the base's
    ok, bf_sass = True, {}
    for name, so in libs.items():
        if not (name == "base" or name.startswith("bf_")):
            continue
        bf_sass[name] = bf_pass1_sass(name, so)
        same = all(torch.equal(a, b) for f in BF_FORMS for a, b in zip(
            bf_out[name, f], bf_out["base", f]))
        ok &= same or name == "bf_no_guard"
        variants[name]["bf_bit_equal_to_base"] = same
        print(f"[exact variants] {name}: BF exact pass 1 K={K_P1} "
              + ", ".join(f"{label} {variants[name][f]:.4f} ms"
                          for f, label in BF_FORMS.items())
              + f"; bit equal to the base: {same}; {bf_sass[name]} "
              f"({card})")

    chain, same = chain_sweep(libs["base"], dev, card)
    ok &= same
    geometries, crossover = {}, {}
    if not args.no_geometries:
        use_library(libs["base"])
        geometries, same = geometry_holds(timed, card)
        ok &= same
        crossover = crossover_sweep(dev, card)
    print(json.dumps({"card": card, "variants": variants, "pass1_sass": sass,
                      "bf_pass1": bf_sass,
                      "chain": chain, "geometries": geometries,
                      "crossover": crossover, "bit_equal": ok}))
    return 0 if ok else 1


def geometry_holds(timed, card):
    """Every geometry of kernel 1 forced on each form of ``timed``, timed
    and held bit for bit against one rollout a thread: ({form: {label:
    {ms, bit_equal, launcher}}}, whether all are bit equal)."""
    import torch
    from autorally_tpu_torch.ops import rollout_kernel as rk

    geometries, ok = {}, True
    for form, (K, mlp, prepare) in timed.items():
        with forced_geometry(*rk.GEOMETRIES[0]):
            launch, ref = prepare()
            launch()
            ref = [t.clone() for t in ref]
        geometries[form] = {}
        for geom in rk.GEOMETRIES:
            if geom[0] > 1 and (not mlp or K == K_P1):
                continue              # BF: G = 1; no groups at 262144
            with forced_geometry(*geom):
                launch, out = prepare()
            reps = 40 if K < K_P1 else 5
            t = events(launch, reps)
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in zip(out, ref))
            ok &= same
            label = "G%d block %d" % geom
            geometries[form][label] = {"ms": t, "bit_equal": same,
                                       "launcher": False}
            print(f"[exact geometry] {form} {label}: {t:.4f} ms, bit equal "
                  f"to G=1: {same} ({card})")
            del launch, out
        picked = timed[form][2]()[0].geometry
        label = "G%d block %d" % picked[:2]
        if label in geometries[form]:
            geometries[form][label]["launcher"] = True
        print(f"[exact geometry] {form}: the launcher picks {label}")
    return geometries, ok


@contextlib.contextmanager
def forced_chain_geometry(group: int, block: int):
    """Makes every launch of kernel 2 take the geometry (G, block), one of
    ``rk.CHAIN_GEOMETRIES``, while active."""
    from autorally_tpu_torch.ops import rollout_kernel as rk

    saved = rk.chain_geometry
    rk.chain_geometry = lambda K, n_sms, bf=False, layers=None: (
        rk._geometry(K, group, block))
    try:
        yield
    finally:
        rk.chain_geometry = saved


def chain_sweep(library, dev, card):
    """Kernel 2 (the MLP and the BF model, seeded weights) at each K of
    ``CHAIN_K`` in each geometry of ``rk.CHAIN_GEOMETRIES`` with
    ``library``: the time of each, and its states and u_seq held bit for
    bit against one rollout a thread.  Returns ({model: {K: {label: ms}}},
    whether all are bit equal)."""
    import torch
    from autorally_tpu_torch import drive_oval
    from autorally_tpu_torch.ops import rollout_kernel as rk
    from autorally_tpu_torch.tools.field_variants import use_library

    mlp, mparams, _, _, _ = drive_oval.build(rollouts=K_A, device=dev)
    bf, bparams, _, _, _ = drive_oval.build(model="bf", rollouts=K_A,
                                            device=dev)
    models = {"mlp": (mlp, mparams), "bf": (bf, bparams)}
    U = torch.tensor([0.0, 0.3], device=dev).repeat(100, 1)
    start = torch.tensor(drive_oval.START, dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    eps = {K: torch.randn((100, K, 2), generator=gen, device=dev)
           for K in CHAIN_K}
    use_library(library)
    out, ok = {}, True
    for mname, (solver, params) in models.items():
        out[mname] = {}
        for K in CHAIN_K:
            out[mname][K], ref = {}, None
            for geom in rk.CHAIN_GEOMETRIES:         # one a thread first
                with forced_chain_geometry(*geom):
                    launch, res = rk.prepare_dynamics_chain(
                        solver.model, params, solver.cfg, start, U, eps[K])
                t = events(launch, 100 if K < 8192 else 20)
                torch.cuda.synchronize()
                ref = ref or [r.clone() for r in res]
                same = all(torch.equal(a, b) for a, b in zip(res, ref))
                ok &= same
                label = "G%d block %d" % geom
                out[mname][K][label] = t
                print(f"[chain] {mname} K={K} {label}: {t:.4f} ms, bit "
                      f"equal to one rollout a thread: {same} ({card})")
                del launch, res
    return out, ok


def crossover_sweep(dev, card) -> dict:
    """Kernel 1 (the MLP on the exact map) at each K of ``CROSSOVER_K`` in
    one rollout a thread and in each lane group: {K: {label: ms}}."""
    import torch
    from autorally_tpu_torch import drive_oval
    from autorally_tpu_torch.ops import rollout_kernel as rk

    solver, params, cost_params, costmap, _ = drive_oval.build(
        rollouts=K_A, device=dev)
    U = torch.tensor([0.0, 0.3], device=dev).repeat(100, 1)
    start = torch.tensor(drive_oval.START, dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    out = {}
    for K in CROSSOVER_K:
        cfg = solver.cfg.replace(num_rollouts=K)
        eps = torch.randn((100, K, 2), generator=gen, device=dev)
        out[K] = {}
        for geom in rk.GEOMETRIES:
            with forced_geometry(*geom):
                launch, _ = rk.prepare_fused_exact_rollout_cost(
                    solver.model, params, cfg, cost_params, costmap, start,
                    U, eps)
            out[K]["G%d block %d" % geom] = events(launch, 20)
        best = min(out[K], key=out[K].get)
        print(f"[exact crossover] kernel 1 K={K}: " + ", ".join(
            f"{g} {t:.4f} ms" for g, t in out[K].items())
            + f"; fastest {best} ({card})")
    return out


if __name__ == "__main__":
    sys.exit(main())
