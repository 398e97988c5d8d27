"""A latency floor for a kernel's time loop, counted from its SASS.

Kernel 2 at K = 1 is one rollout's chain of T dependent steps: no
throughput bound says anything about it.  ``loop_chain`` reads a kernel's
SASS (``cuobjdump -sass``), takes its time loop (the backward branch of the
widest span), and follows the registers through one pass of the loop body
in program order, each instruction ready a fixed latency after the last of
its source registers (``LATENCY``: assumed latencies, since NVIDIA does not
publish Hopper's: FFMA 4 clocks, MUFU 20, shuffles 25, shared loads 23);
the registers live into the loop are ready at 0.  Given the store
instructions of one step (``stores``), it counts the loop body's ``STG``
and refuses a body that holds another number of them: a loop that ptxas
unrolled would make T times its chain more than the floor.  The step's longest dependent chain is the latest
ready time of a register that the loop body redefines and reads before it
does (carried into the next step).  Code behind a forward branch (a slow
path, an if) is left out, and issue limits and stalls are ignored, so
that ``T`` times the chain is a floor for a dependent chain at these
latencies, not a roofline and not a measurement.

``loop_mix`` counts the instructions of a step of a kernel whose time loop
replays the capacity mode's noise stream (the loop whose body holds the
most Threefry rotations, ``SHF.L.W``, 20 a step), by the pipe that issues
them: every instruction takes one of a scheduler's issue slots, the integer
ones (``INT_OPS``) one of the SM's 64 INT32 lanes a thread; and a step's
``FCHK``, ``MUFU.RCP``, ``BSSY`` and ``BSYNC`` (``COUNTED_OPS``), the marks
of IEEE divisions and of branches that end basic blocks.

Usage, on a ``cuobjdump -sass`` dump::

    python -m autorally_tpu_torch.tools.sass_chain DUMP KERNEL_REGEX [STORES]
"""

from __future__ import annotations

import re
import sys

# latency in clocks by opcode (the part before the first dot); anything
# else 4, the fixed-latency ALU pipes
LATENCY = {"MUFU": 20, "SHFL": 25, "LDS": 23, "LDSM": 23, "LDG": 200,
           "LD": 200, "LDL": 200, "LDC": 8, "ULDC": 8, "S2R": 20, "S2UR": 20,
           "CS2R": 4, "I2F": 6, "F2I": 6, "F2F": 6, "I2FP": 4, "F2FP": 4,
           "DADD": 8, "DMUL": 8, "DFMA": 8, "POPC": 6, "FLO": 6, "BREV": 6,
           "REDUX": 20, "VOTE": 4}
# opcodes with no destination register
NO_DEST = ("ST", "STS", "STG", "STL", "BRA", "EXIT", "BAR", "NOP", "RED",
           "BSSY", "BSYNC", "WARPSYNC", "YIELD", "CALL", "RET", "MEMBAR",
           "DEPBAR", "ERRBAR", "CCTL", "BPT", "JMP", "BREAK", "SYNCS")

# opcodes of the INT32 pipe (integer add, logic, shift, compare, select;
# IMAD and IMUL issue to the FMA pipe and are not counted)
INT_OPS = ("IADD3", "IADD", "IADD32I", "VIADD", "VIADDMNMX", "IABS",
           "IMNMX", "ISETP", "ISCADD", "LOP3", "LOP", "LOP32I", "SHF", "SHL",
           "SHR", "LEA", "PRMT", "SEL", "BMSK", "BREV", "FLO", "POPC")
ROTATIONS_A_STEP = 20                # Threefry-2x32-20: one SHF.L.W a round
# opcodes that loop_mix counts a step (an opcode with its leading
# modifiers): the IEEE division's slow-path check and reciprocal, and the
# reconvergence marks of a branch that may diverge
COUNTED_OPS = ("FCHK", "MUFU.RCP", "BSSY", "BSYNC")

_LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P[T0-9]+\s+)?"
                   r"([A-Z][A-Z0-9_]*)((?:\.[\w]+)*)\s*([^;]*);")
_REG = re.compile(r"\b(U?R\d+|U?P\d+)(\.64|\.128)?")


def instructions(sass: str, kernel: str) -> list:
    """The instructions of the first function of ``sass`` whose name
    matches the regex ``kernel``: (address, guard, opcode, modifiers,
    operands)."""
    for fn in re.split(r"\n\s*Function : ", sass)[1:]:
        head, body = fn.split("\n", 1)
        if re.search(kernel, head):
            return [(int(m.group(1), 16), (m.group(2) or "").strip(),
                     m.group(3), m.group(4), m.group(5))
                    for m in _LINE.finditer(body)]
    raise ValueError(f"no function matching {kernel!r}")


def _regs(text: str, wide: int = 1) -> list:
    """Registers named in ``text``, a vector (``R4.64``, or ``wide``) as
    its consecutive registers; RZ, PT and URZ are not registers."""
    out = []
    for name, vec in _REG.findall(text):
        n = {".64": 2, ".128": 4}.get(vec, wide)
        prefix, num = re.match(r"(U?[RP])(\d+)", name).groups()
        out += [f"{prefix}{int(num) + i}" for i in range(n)]
    return out


def _dests_sources(op: str, mods: str, operands: str):
    parts = [p.strip() for p in operands.split(",")] if operands else []
    wide = 4 if ".128" in mods else 2 if ".64" in mods or ".WIDE" in mods \
        else 1
    if op in NO_DEST or op.startswith("ST") or not parts:
        return [], _regs(operands)
    n_dest = 1
    if op in ("FSETP", "ISETP", "DSETP", "HSETP2", "SHFL") or (
            op in ("IADD3", "LEA", "IMAD") and ".X" not in mods
            and len(parts) > 4 and parts[1].startswith("P")):
        n_dest = 2                       # a predicate and a register
    dests = []
    for p in parts[:n_dest]:
        dests += _regs(p, wide if p.startswith("R") else 1)
    return dests, _regs(",".join(parts[n_dest:]))


def loop_chain(ins: list, stores: int | None = None) -> dict:
    """The longest dependent chain of one pass of the time loop of ``ins``
    (``instructions``): {"cycles", "chain" (instructions on it),
    "in_order" (clocks until the last instruction of the pass can issue,
    when instructions also issue in program order), "body" (instructions
    in the pass), "skipped" (behind forward branches), "stores" (``STG``
    in the pass, skipped code included)}.  Raises ValueError when
    ``stores`` is given and the pass holds another number of ``STG``."""
    loops = _loops(ins)
    if not loops:
        raise ValueError("no backward branch")
    _, lo, hi = max(loops)
    n_stg = sum(op == "STG" for _, _, op, _, _ in ins[lo:hi + 1])
    if stores is not None and n_stg != stores:
        raise ValueError(f"the loop body holds {n_stg} STG, not the "
                         f"{stores} of one step")
    skip = set()
    for i in range(lo, hi):
        a, guard, op, mods, operands = ins[i]
        m = re.search(r"0x([0-9a-f]+)", operands)
        if op == "BRA" and m and int(m.group(1), 16) > a:
            end = int(m.group(1), 16)
            skip.update(j for j in range(i + 1, hi) if ins[j][0] < end)
    ready, depth, written, read_first = {}, {}, set(), set()
    issue = 0
    for i in range(lo, hi + 1):
        if i in skip:
            continue
        a, guard, op, mods, operands = ins[i]
        dests, srcs = _dests_sources(op, mods, operands)
        srcs += _regs(guard)
        for r in srcs:
            if r not in written:
                read_first.add(r)
        t = max((ready.get(r, 0) for r in srcs), default=0)
        d = max((depth.get(r, 0) for r in srcs), default=0)
        issue = max(issue, t)
        for r in dests:
            ready[r] = t + LATENCY.get(op, 4)
            depth[r] = d + 1
            written.add(r)
    carried = [r for r in written & read_first if r in ready]
    crit = max(carried, key=lambda r: ready[r])
    return {"cycles": ready[crit], "chain": depth[crit], "in_order": issue,
            "body": hi - lo + 1 - len(skip), "skipped": len(skip),
            "stores": n_stg}


def _loops(ins: list) -> list:
    """(span in bytes, first index, last index) of each backward branch."""
    addr = [a for a, *_ in ins]
    loops = []
    for i, (a, guard, op, mods, operands) in enumerate(ins):
        m = re.search(r"0x([0-9a-f]+)", operands)
        if op == "BRA" and m and int(m.group(1), 16) < a:
            loops.append((a - int(m.group(1), 16), addr.index(
                int(m.group(1), 16)), i))
    return loops


def loop_mix(ins: list) -> dict:
    """Instructions a step of the stream's time loop of ``ins``
    (``instructions``): the loop whose body holds the most ``SHF.L.W`` (the
    smallest such), its steps a pass (those rotations over
    ``ROTATIONS_A_STEP``), and a step's instructions and integer ones
    (``INT_OPS``), all of them and those not behind a forward branch (which
    every step issues), and each of ``COUNTED_OPS`` in the whole body:
    {"steps", "instructions", "int", "instructions_always", "int_always",
    "ops"}."""
    def rotations(lo, hi):
        return sum(op == "SHF" and ".L.W" in mods
                   for _, _, op, mods, _ in ins[lo:hi + 1])

    loops = [(rotations(lo, hi), -span, lo, hi)
             for span, lo, hi in _loops(ins)]
    if not loops or max(loops)[0] < ROTATIONS_A_STEP:
        raise ValueError("no loop holds a step of the stream")
    n_rot, _, lo, hi = max(loops)
    if n_rot % ROTATIONS_A_STEP:
        raise ValueError(f"the loop holds {n_rot} rotations, not whole "
                         "steps of the stream")
    skip = set()
    for i in range(lo, hi):
        a, _, op, _, operands = ins[i]
        m = re.search(r"0x([0-9a-f]+)", operands)
        if op == "BRA" and m and int(m.group(1), 16) > a:
            end = int(m.group(1), 16)
            skip.update(j for j in range(i + 1, hi) if ins[j][0] < end)
    steps = n_rot // ROTATIONS_A_STEP
    body = range(lo, hi + 1)
    is_int = [ins[i][2] in INT_OPS for i in body]
    always = [i not in skip for i in body]
    return {"steps": steps,
            "instructions": len(body) / steps,
            "int": sum(is_int) / steps,
            "instructions_always": sum(always) / steps,
            "int_always": sum(a and b for a, b in zip(always, is_int))
            / steps,
            "ops": {name: sum((ins[i][2] + ins[i][3]).startswith(name)
                              for i in body) / steps
                    for name in COUNTED_OPS}}


def pipe_bounds(mix: dict, K: int, T: int, num_sms: int, clock_mhz: float,
                branched: bool = False) -> dict:
    """Two floors, in ms, for K rollouts of T steps of a kernel whose step
    ``loop_mix`` counted: its integer instructions on 64 INT32 lanes an SM,
    and all its instructions at four warp instructions a clock an SM (one
    for each scheduler), both at ``clock_mhz``.  They count the
    instructions outside forward branches, which every step issues, or
    with ``branched`` the whole loop body, for a loop whose forward
    branches every rollout of the run takes (pass 2's test of the rollouts
    past K)."""
    clocks_ms = num_sms * clock_mhz * 1e3
    n_int, n_all = ((mix["int"], mix["instructions"]) if branched
                    else (mix["int_always"], mix["instructions_always"]))
    return {"int_ms": n_int * K * T / (64 * clocks_ms),
            "issue_ms": n_all * (K / 32) * T / (4 * clocks_ms)}


def main() -> int:
    dump, kernel = sys.argv[1], sys.argv[2]
    stores = int(sys.argv[3]) if len(sys.argv) > 3 else None
    with open(dump) as f:
        print(loop_chain(instructions(f.read(), kernel), stores))
    return 0


if __name__ == "__main__":
    sys.exit(main())
