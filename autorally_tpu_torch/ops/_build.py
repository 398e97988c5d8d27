"""Build and load the port's CUDA kernels.

``autorally_tpu_torch/csrc/rollout_kernels.cu`` exposes a plain C
interface.  At first use it is compiled by ``nvcc`` for ``sm_90a`` into a
shared library under ``autorally_tpu_torch/_build/`` (listed in
``.gitignore``), or the persistent cache directory that
``io/compile_cache.enable_persistent_cache`` sets, named by a hash of the
source and the flags, and loaded with ``ctypes``.  The default library
holds every kernel, its MLP instances for the 6-32-32-4 spec
(``DEFAULT_LAYERS``); an MLP of another layer spec gets a library of its
own at first use, built from the same source with the spec's hidden widths
as a define (in a header that nvcc includes first: nvcc splits a ``-D``
value at its commas), which holds the MLP's instances of kernels 1-4
(kernel 1 in its geometries, kernel 2, kernel 3 and both modes of pass 1;
not the BF model's, nor pass 2, which the default library runs for every
spec) (``load(layers)``), as the JAX kernels compile per spec.  A neural
field of another spec than 34-64-64-1 with 8 frequencies (``DEFAULT_FIELD``)
gets a library of its own for each MLP spec it runs beside
(``load(layers, field)``), built with the field's spec as a define too,
which holds only the field kernels (kernel 3 and pass 1's field mode, the
BF model's instances beside the default MLP spec), as the JAX kernels
compile per field spec.  ``matmul_precision="default"`` (bf16 operands in
the dynamics' products) takes a library of its own for each of these
(``load(layers, field, bf16=True)``), built with ``ARTT_BF16_OPERANDS``
defined too, which holds the same instances but pass 2 and the quotient
check, which evaluate no model.  Every library holds the lane form (a
stacked ``CostParams`` in one launch) of each kernel instance it holds.
The library of an MLP with more weights than the default spec's, whose
unrolled MLP takes ``ptxas`` minutes a kernel, is compiled in ``PARTS``
objects at once (``-DARTT_PART``: each holds one family of kernels in its
solo or its lane form), linked into one library (``parts``).  A process
runs at most ``NVCC_JOBS`` ``nvcc`` at once.
The check and the build run under an
exclusive lock on a file beside the library, so that processes that start
together (the ranks of a sharded solve) run ``nvcc`` once and the others
load its library.  Nothing is built when the module is imported, so the
CPU tests import it on machines without ``nvcc``.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Optional, Sequence

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "rollout_kernels.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# The MLP spec of the default library (csrc ARTT_MLP_HIDDEN's default).
DEFAULT_LAYERS = (6, 32, 32, 4)
# The field spec of the default and the MLP spec libraries, F and the hidden
# widths (csrc ARTT_FIELD_SPEC's default): 34-64-64-1.
DEFAULT_FIELD = (8, 64, 64)
# The objects a library compiled in parts is compiled in (csrc ARTT_PART).
PARTS = 8
# How many nvcc processes this process runs at once (libraries and parts
# alike): all but two of the cores it may run on, so that builds that run
# beside other work leave it cores.
NVCC_JOBS = max(1, len(os.sched_getaffinity(0)) - 2)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C signatures of the library: every pointer and the stream as c_void_p,
# every int as c_int, every float as c_float; every function returns an int.
SIGNATURES = {
    "artt_num_weights": [],
    "artt_num_bf_weights": [],
    "artt_field_pack_floats": [],
    "artt_field_block": [],
    "artt_max_field_t": [],
    "artt_max_field_lanes_t": [],
    "artt_field_global": [],
    "artt_max_obstacles": [],
    "artt_num_float_scalars": [],
    "artt_num_int_scalars": [],
    "artt_update_block": [],
    "artt_exact_block": [],
    "artt_group_block": [],
    "artt_chain_warp_block": [],
    "artt_max_t": [],
    # fsc, isc, lane group, block, device, then device pointers + stream
    "artt_fused_exact_rollout_cost": [_P, _P, _I, _I, _I] + [_P] * 11,
    "artt_fused_field_rollout_cost": [_P, _P, _I] + [_P] * 11,
    "artt_dynamics_chain": [_P, _P, _I, _I, _I] + [_P] * 8,
    # fsc, isc, k_offset, ou_a, ou_b, device, then device pointers + stream
    "artt_fused_rng_costs": [_P, _P, _I, _F, _F, _I] + [_P] * 10,
    "artt_fused_rng_field_costs": [_P, _P, _I, _F, _F, _I] + [_P] * 10,
    "artt_weighted_update": [_P, _P, _I, _F, _F, _I] + [_P] * 5,
    # rng, bf, T, n_obs, device, out (4 ints)
    "artt_field_kernel_info": [_I] * 5 + [_P],
    # rng, bf, lane group, block, T, n_obs, device, out (4 ints)
    "artt_exact_kernel_info": [_I] * 7 + [_P],
    # out (int64 host array or null); device, counts (device), stream
    "artt_const_divisors": [_P],
    "artt_div_const_check": [_I, _P, _P],
    # out (int host array or null); no arguments
    "artt_mlp_layers": [_P],
    "artt_field_spec": [_P],
    "artt_lane_groups": [],
    # bf, lane group, block, T, device, out (4 ints)
    "artt_chain_kernel_info": [_I] * 5 + [_P],
    "artt_bf16_operands": [],
    # fsc, isc, lane scalars (device), lanes, lane group, block, device,
    # then device pointers + stream
    "artt_fused_exact_lanes": [_P, _P, _P, _I, _I, _I, _I] + [_P] * 11,
    # fsc, isc, lane scalars (device), lanes, device, then device pointers
    # + stream
    "artt_fused_field_lanes": [_P, _P, _P, _I, _I] + [_P] * 11,
    # fsc, isc, lanes, lane group, block, device, then device pointers +
    # stream
    "artt_dynamics_chain_lanes": [_P, _P, _I, _I, _I, _I] + [_P] * 8,
    # fsc, isc, lane scalars (device), lanes, k_offset, ou_a, ou_b, device,
    # then device pointers + stream
    "artt_fused_rng_costs_lanes": [_P, _P, _P, _I, _I, _F, _F, _I] + [_P] * 10,
    "artt_fused_rng_field_costs_lanes": ([_P, _P, _P, _I, _I, _F, _F, _I]
                                         + [_P] * 10),
    # fsc, isc, lanes, k_offset, ou_a, ou_b, device, then device pointers +
    # stream
    "artt_weighted_update_lanes": [_P, _P, _I, _I, _F, _F, _I] + [_P] * 5,
    # kernel (1-5), field mode (kernel 4), bf, lane group, block, T, n_obs,
    # device, out (4 ints)
    "artt_lanes_kernel_info": [_I] * 8 + [_P],
}
# What only the float32 library of the default specs holds: pass 2 and the
# quotient check, which evaluate no model.
FP32_ONLY_FUNCTIONS = ("artt_weighted_update", "artt_weighted_update_lanes",
                       "artt_update_block", "artt_const_divisors",
                       "artt_div_const_check")
# What a library of another field holds (-DARTT_FIELD_LIBRARY): the field
# kernels, their lane forms and the queries of their layouts and instances.
FIELD_FUNCTIONS = (
    "artt_num_weights", "artt_max_obstacles", "artt_num_float_scalars",
    "artt_num_int_scalars", "artt_mlp_layers", "artt_field_spec",
    "artt_field_pack_floats", "artt_field_block", "artt_max_field_t",
    "artt_max_field_lanes_t", "artt_field_global",
    "artt_fused_field_rollout_cost",
    "artt_fused_rng_field_costs", "artt_fused_field_lanes",
    "artt_fused_rng_field_costs_lanes", "artt_field_kernel_info",
    "artt_lanes_kernel_info", "artt_bf16_operands")
# What a library of another MLP spec holds (-DARTT_SPEC_LIBRARY): the MLP's
# kernels 1-4, their lane forms and the queries of their layouts and
# instances.
SPEC_FUNCTIONS = FIELD_FUNCTIONS + (
    "artt_exact_block", "artt_group_block", "artt_chain_warp_block",
    "artt_max_t", "artt_lane_groups", "artt_fused_exact_rollout_cost",
    "artt_dynamics_chain", "artt_fused_rng_costs", "artt_exact_kernel_info",
    "artt_chain_kernel_info", "artt_fused_exact_lanes",
    "artt_dynamics_chain_lanes", "artt_fused_rng_costs_lanes")

_lib = None                   # the default library
_spec_libs = {}               # (layers, field, bf16) -> that library
_load_lock = threading.Lock()
# NVCC_JOBS slots, taken in the order asked for (a Condition wakes the
# longest waiter first)
_nvcc_slots = threading.BoundedSemaphore(NVCC_JOBS)


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    found = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return found


def _spec(layers: Optional[Sequence[int]]) -> Optional[tuple]:
    """The spec a library is built for: None for the default library."""
    if layers is None or tuple(layers) == DEFAULT_LAYERS:
        return None
    layers = tuple(int(n) for n in layers)
    if len(layers) < 3 or min(layers) < 1:
        raise ValueError(f"an MLP spec with at least one hidden layer, got "
                         f"{layers}")
    return layers


def _field(field: Optional[Sequence[int]]) -> Optional[tuple]:
    """The field spec (F, hidden widths...) a library is built for: None
    for ``DEFAULT_FIELD``."""
    if field is None or tuple(field) == DEFAULT_FIELD:
        return None
    field = tuple(int(n) for n in field)
    if not field or min(field) < 1:
        raise ValueError(f"a field spec (F, hidden widths...) with F >= 1, "
                         f"got {field}")
    return field


def num_weights(layers: Sequence[int]) -> int:
    """The weights and biases of an MLP of the spec ``layers``."""
    return sum(a * b + b for a, b in zip(layers[:-1], layers[1:]))


def parts(layers: Optional[Sequence[int]] = None,
          field: Optional[Sequence[int]] = None,
          bf16: bool = False) -> int:
    """How many objects the library of ``layers`` and ``field`` is
    compiled in: ``PARTS`` for the library of an MLP spec with more weights
    than ``DEFAULT_LAYERS`` (of either precision), else one."""
    spec = _spec(layers)
    if spec is None or _field(field) is not None:
        return 1
    return PARTS if num_weights(spec) > num_weights(DEFAULT_LAYERS) else 1


def field_label(field: Sequence[int]) -> str:
    """A field spec's label, F and the hidden widths: ``F6-48-48``."""
    return "F" + "-".join(str(n) for n in field)


def spec_defines(layers: Optional[Sequence[int]] = None,
                 field: Optional[Sequence[int]] = None,
                 bf16: bool = False) -> str:
    """The defines of the library of ``layers`` and ``field``, of bf16
    operands when ``bf16``: none for the default library (None or
    ``DEFAULT_LAYERS``, None or ``DEFAULT_FIELD``, float32)."""
    spec, fspec = _spec(layers), _field(field)
    out = "#define ARTT_BF16_OPERANDS\n" if bf16 else ""
    if spec is not None:
        hidden = ", ".join(str(n) for n in spec[1:-1])
        out += f"#define ARTT_MLP_HIDDEN {hidden}\n#define ARTT_SPEC_LIBRARY\n"
    if fspec is not None:
        out += (f"#define ARTT_FIELD_SPEC {', '.join(map(str, fspec))}\n"
                "#define ARTT_FIELD_LIBRARY\n")
    return out


def library_path(layers: Optional[Sequence[int]] = None,
                 field: Optional[Sequence[int]] = None,
                 bf16: bool = False) -> Path:
    """Where the library of ``layers`` and ``field`` (of bf16 operands when
    ``bf16``) is built, named by a hash of the source, the flags, the
    defines and the number of parts."""
    n = parts(layers, field, bf16)
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()
                            + spec_defines(layers, field, bf16).encode()
                            + (f"parts {n}".encode() if n > 1 else b"")
                            ).hexdigest()
    spec, fspec = _spec(layers), _field(field)
    name = SOURCE.stem + ("" if spec is None else
                          "_mlp" + "-".join(str(n) for n in spec))
    if fspec is not None:
        name += "_field" + field_label(fspec)
    if bf16:
        name += "_bf16"
    return BUILD_DIR / f"{name}_{digest[:16]}.so"


@contextlib.contextmanager
def file_lock(path: Path):
    """An exclusive ``flock`` on ``path`` (created if missing) for the
    ``with`` block; the kernel releases it if the process dies."""
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "a") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def set_build_dir(path) -> None:
    """Build and load the library in ``path`` from now on; raises if this
    process already loaded it from another directory."""
    global BUILD_DIR
    path = Path(path).resolve()
    for lib in [_lib, *_spec_libs.values()]:
        if lib is not None and Path(lib._name).parent != path:
            raise RuntimeError(f"the kernel library is already loaded from "
                               f"{Path(lib._name).parent}, not {path}")
    BUILD_DIR = path


def _run(cmd: list, log: Path) -> tuple:
    """Runs ``cmd`` in one of the ``NVCC_JOBS`` slots, its output to the
    file ``log``; returns (exit code, seconds it ran)."""
    with _nvcc_slots, open(log, "w") as f:
        t0 = time.perf_counter()
        code = subprocess.run(cmd, stdout=f, stderr=subprocess.STDOUT
                              ).returncode
        return code, time.perf_counter() - t0


def _compile(out: Path, defines: str, n_parts: int = 1) -> tuple:
    """Compile the source with ``defines`` (a header included first) into
    ``out`` (atomically: a reader sees no library or the whole one), in
    ``n_parts`` objects compiled at once (as ``NVCC_JOBS`` allows) and
    then linked when it is over one; returns (seconds, compiler output:
    the parts' in order, each after a line of its seconds)."""
    nvcc = nvcc_path()
    flags = NVCC_FLAGS
    with tempfile.TemporaryDirectory(dir=out.parent) as work:
        if defines:
            header = Path(work) / "spec.h"
            header.write_text(defines)
            flags += ("-include", str(header))
        tmp = str(Path(work) / out.name)
        t0 = time.perf_counter()
        if n_parts == 1:
            steps = [[[nvcc, *flags, "-o", tmp, str(SOURCE)]]]
        else:
            objs = [str(Path(work) / f"part{p}.o") for p in range(n_parts)]
            part_flags = tuple(f for f in flags if f != "-shared")
            steps = [[[nvcc, *part_flags, f"-DARTT_PART={p}", "-c", "-o", obj,
                       str(SOURCE)] for p, obj in enumerate(objs)],
                     [[nvcc, "-shared", "-o", tmp, *objs]]]
        log = ""
        for i, step in enumerate(steps):
            logs = [Path(work) / f"step{i}_{j}.log" for j in range(len(step))]
            with ThreadPoolExecutor(len(step)) as pool:
                runs = list(pool.map(_run, step, logs))
            for j, (path, (_, seconds)) in enumerate(zip(logs, runs)):
                if n_parts > 1:
                    log += (f"part {j}: nvcc {seconds:.1f}s\n" if i == 0
                            else f"link: nvcc {seconds:.1f}s\n")
                log += path.read_text()
            if any(code for code, _ in runs):
                raise RuntimeError(f"nvcc failed for {SOURCE.name}:\n{log}")
        os.replace(tmp, out)
    return time.perf_counter() - t0, log


def functions(layers: Optional[Sequence[int]] = None,
              field: Optional[Sequence[int]] = None,
              bf16: bool = False) -> Sequence[str]:
    """The C functions the library of ``layers`` and ``field`` (of bf16
    operands when ``bf16``) holds."""
    if _field(field) is not None:
        return FIELD_FUNCTIONS
    if _spec(layers) is not None:
        return SPEC_FUNCTIONS
    return tuple(fn for fn in SIGNATURES
                 if not (bf16 and fn in FP32_ONLY_FUNCTIONS))


def load(layers: Optional[Sequence[int]] = None,
         field: Optional[Sequence[int]] = None,
         bf16: bool = False) -> ctypes.CDLL:
    """The kernel library of the MLP spec ``layers`` and the field spec
    ``field`` (the default library for None or ``DEFAULT_LAYERS`` and None
    or ``DEFAULT_FIELD``), of bf16 operands in the dynamics' products when
    ``bf16`` (``matmul_precision="default"``; else float32), compiled
    first when its ``.so`` is missing
    (raises with the compiler's output if that fails).  The library's
    ``build`` attribute is ``(seconds, compiler output)`` of a compile made
    by this process, else None.  Threads may load different specs at once
    (each ``nvcc`` runs in its own process)."""
    global _lib
    key = (_spec(layers), _field(field), bool(bf16))
    lib = _lib if key == (None, None, False) else _spec_libs.get(key)
    if lib is not None:
        return lib
    out = library_path(*key)
    build = None
    with file_lock(out.with_suffix(".lock")):
        if not out.exists():
            build = _compile(out, spec_defines(*key), parts(*key))
    lib = ctypes.CDLL(str(out))
    for fn in functions(*key):
        getattr(lib, fn).argtypes = SIGNATURES[fn]
        getattr(lib, fn).restype = ctypes.c_int
    lib.build = build
    with _load_lock:
        if key == (None, None, False):
            _lib = lib
        else:
            _spec_libs[key] = lib
    return lib
