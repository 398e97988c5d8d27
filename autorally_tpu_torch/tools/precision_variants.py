"""Whether ``chip_smoke.py`` phase 31's rule can fail a partly wrong
``matmul_precision="default"`` instance: build the default library of bf16
operands with one deliberate fault each and hold each build against the
plain versions as phase 31 holds it.

Each variant is the kernel source with one edit, built by nvcc (all at once,
``field_variants.build_variants``) into
``autorally_tpu_torch/_build/precision_variants/``:

- ``base``: the source as it is;
- ``kernel3_concat``: kernel 3 runs the concatenated ``MlpDeriv`` (the
  controls and W0's control columns rounded) instead of
  ``MlpSplitDeriv``;
- ``rounded_biases``: the thread forms round every bias with the W
  entries;
- ``unrounded_group_weights``: the lane groups' and the warp chain's W
  entries stay float32 (``round_group_weights`` does nothing);
- ``unrounded_hidden``: the thread forms' hidden activations stay float32.

Each build runs five cases on the main path's seeded configuration (T=100;
the biases seeded as phase 31 seeds them, ``chip_smoke.with_biases``):
kernel 1 at K=1920 in lane groups of 8 and one rollout a thread, kernel 2
in a warp a rollout at K=1920, kernel 3 at K=8192 on
``ab_builds.seeded_field`` and exact pass 1 (gaussian) at K=65536.  In each
case it reads ``chip_smoke.agreement`` (phase 11's rule, all but 1 % of
the rollouts; kernel 2's states as phase 31 holds them) and
``chip_smoke.closer_reading`` (the CPU tests' rule: the kernel PREC_CLOSER
times closer to its "default" plain version than to the "highest" one)
against the float32 library's instance.  ``base`` must meet both rules in
every case; each other variant must fail one in at least one case.
Usage, from the root of the repository (``chip_smoke.py`` is imported from
there)::

    python -m autorally_tpu_torch.tools.precision_variants
"""

from __future__ import annotations

import json
import subprocess
import sys

T, K, K_3, K_P1 = 100, 1920, 8192, 65536
KEY = (0x2545F491, 0x9E3779B9)

VARIANTS = {
    "base": [],
    "kernel3_concat": [("  using type = MlpSplitDeriv;",
                        "  using type = MlpDeriv;")],
    "rounded_biases": [("      if (i < off + m * n + m) return false;",
                        "      if (i < off + m * n + m) return true;")],
    "unrounded_group_weights": [
        ("    if (!group_is_bias<Spec>(n)) w_s[n] = mm_operand(w_s[n]);",
         "    if (false) w_s[n] = mm_operand(w_s[n]);")],
    "unrounded_hidden": [("        y[j] = mm_operand(tanhf(acc + b[j]));",
                          "        y[j] = tanhf(acc + b[j]);")],
}


def cases(dev) -> dict:
    """name -> (run(precision) -> (values, crash flags or None),
    plain(precision) -> the same, rollouts): the five cases."""
    import torch

    import chip_smoke
    from autorally_tpu_torch import drive_oval
    from autorally_tpu_torch.ops import rollout_kernel as rk
    from autorally_tpu_torch.tools.ab_builds import seeded_field
    from autorally_tpu_torch.tools.exact_variants import (
        forced_chain_geometry, forced_geometry)

    solver, params, cp, costmap, _ = drive_oval.build(rollouts=K, device=dev)
    model, cfg = solver.model, solver.cfg
    params = chip_smoke.with_biases(params, 31)
    field = seeded_field(costmap, dev)
    U = torch.tensor([0.0, 0.3], device=dev).repeat(T, 1)
    start = torch.tensor(drive_oval.START, dtype=torch.float32, device=dev)
    slow = start.clone()
    slow[4] = 1.0
    key = torch.tensor(KEY, dtype=torch.int64, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(31)
    eps = torch.randn((T, K, 2), generator=gen, device=dev)
    eps_3 = torch.randn((T, K_3, 2), generator=gen, device=dev)
    cap = cfg.replace(num_rollouts=K_P1, kernel_rng=True)
    m = (model, params)

    def fused(fn, surface, e, force=None):
        def run(p):
            if force is None:
                out = fn(*m, cfg, cp, surface, start, U, e, precision=p)
            else:
                with forced_geometry(*force):
                    out = fn(*m, cfg, cp, surface, start, U, e, precision=p)
            return out[0], out[2]
        return run, lambda p: rk.fused_rollout_cost_plain(
            *m, cfg, cp, surface, start, U, e, precision=p)[::2]

    def chain(p):
        with forced_chain_geometry(32, rk.CHAIN_WARP_BLOCK):
            return rk.dynamics_chain(*m, cfg, slow, U, eps,
                                     precision=p)[0], None

    return {
        "kernel 1 G8": (*fused(rk.fused_exact_rollout_cost, costmap, eps,
                               (8, rk.GROUP_BLOCK)), K),
        "kernel 1 G1": (*fused(rk.fused_exact_rollout_cost, costmap, eps,
                               (1, rk.EXACT_BLOCK)), K),
        "kernel 2 warp": (chain, lambda p: (rk.dynamics_chain_plain(
            *m, cfg, slow, U, eps, precision=p)[0], None), K),
        "kernel 3": (*fused(rk.fused_rollout_cost, field, eps_3), K_3),
        "pass 1": (lambda p: rk.fused_rng_costs(
            *m, cap, cp, costmap, start, U, key, precision=p)[:2],
            lambda p: rk.fused_rng_costs_plain(
                *m, cap, cp, costmap, start, U, key, precision=p)[:2],
            K_P1)}


def hold(name, run, plain_d, plain_h, n) -> dict:
    """Phase 31's two rules for one case of the build in use."""
    import torch

    import chip_smoke

    (k, kx), (k32, _) = run("default"), run("highest")
    (p, px), (p32, _) = plain_d, plain_h
    torch.cuda.synchronize()
    if kx is None:                           # kernel 2's states
        keep = torch.isclose(k, p, rtol=chip_smoke.STATE_RTOL,
                             atol=chip_smoke.STATE_ATOL,
                             equal_nan=True).all(dim=0).all(dim=0)
    else:
        keep = chip_smoke.agreeing(k, kx, p, px)
    r = chip_smoke.closer_reading(k, p, k32, p32, keep)
    r["phase11"] = True
    try:
        if kx is None:
            chip_smoke.check(int((~keep).sum().item()) <= n // 100,
                             f"{name}: states differ")
        else:
            chip_smoke.agreement(f"precision variants {name}", "nominal", k,
                                 kx, p, px, n, limit=n // 100)
    except chip_smoke.PhaseFailed:
        r["phase11"] = False
    r["caught"] = not r["phase11"] or (r["resolved"] and not r["held"])
    return r


def main() -> int:
    import torch

    from autorally_tpu_torch.ops import _build
    from autorally_tpu_torch.tools.field_variants import (build_variants,
                                                          use_library)

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    _build.load()                            # the float32 instances
    libs = build_variants(_build.BUILD_DIR / "precision_variants",
                          VARIANTS, bf16=True)
    dev = torch.device("cuda", 0)
    held = cases(dev)
    plains = {name: (plain("default"), plain("highest"))
              for name, (_, plain, _) in held.items()}
    out = {}
    for variant, so in libs.items():
        use_library(so, bf16=True)
        out[variant] = {}
        for name, (run, _, n) in held.items():
            r = out[variant][name] = hold(name, run, *plains[name], n)
            print(f"[precision variants] {variant} {name}: phase 11's rule "
                  f"{'met' if r['phase11'] else 'FAILED'}; mean|'default' - "
                  f"plain 'default'| {r['near']:.3e}, mean|'default' - "
                  f"plain 'highest'| {r['far']:.3e}, plain 'default' - "
                  f"plain 'highest' {r['plain_moved']:.3e}, float32 noise "
                  f"{r['fp32_noise']:.3e}: {'caught' if r['caught'] else 'passed'} "
                  f"({card})")
    print(json.dumps({"card": card, "held": out}))
    ok = (not any(r["caught"] for r in out["base"].values())
          and all(any(r["caught"] for r in rs.values())
                  for v, rs in out.items() if v != "base"))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
