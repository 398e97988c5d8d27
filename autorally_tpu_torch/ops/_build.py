"""Build and load the port's CUDA kernels.

``autorally_tpu_torch/csrc/rollout_kernels.cu`` exposes a plain C
interface.  At first use it is compiled by ``nvcc`` for ``sm_90a`` into a
shared library under ``autorally_tpu_torch/_build/`` (listed in
``.gitignore``), or the persistent cache directory that
``io/compile_cache.enable_persistent_cache`` sets, named by a hash of the
source and the flags, and loaded with ``ctypes``.  The check and the
build run under an exclusive lock on a file beside the library, so that
processes that start together (the ranks of a sharded solve) run ``nvcc``
once and the others load its library.  Nothing is built when the module
is imported, so the CPU tests import it on machines without ``nvcc``.
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
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "rollout_kernels.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C signatures of the library: every pointer and the stream as c_void_p,
# every int as c_int, every float as c_float; every function returns an int.
SIGNATURES = {
    "artt_num_weights": [],
    "artt_num_bf_weights": [],
    "artt_field_pack_floats": [],
    "artt_field_block": [],
    "artt_max_field_t": [],
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
}

_lib = None


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    found = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return found


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{SOURCE.stem}_{digest[:16]}.so"


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
    if _lib is not None and Path(_lib._name).parent != path:
        raise RuntimeError(f"the kernel library is already loaded from "
                           f"{Path(_lib._name).parent}, not {path}")
    BUILD_DIR = path


def _compile(out: Path) -> tuple:
    """Compile the source into ``out`` (atomically: a reader sees no
    library or the whole one); returns (seconds, compiler output)."""
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    t0 = time.perf_counter()
    proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(SOURCE)],
                          capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {SOURCE.name}:\n{log}")
    os.replace(tmp, out)
    return time.perf_counter() - t0, log


def load() -> ctypes.CDLL:
    """The kernel library, compiled first when its ``.so`` is missing
    (raises with the compiler's output if that fails).  The library's
    ``build`` attribute is ``(seconds, compiler output)`` of a compile made
    by this process, else None."""
    global _lib
    if _lib is not None:
        return _lib
    out = library_path()
    build = None
    with file_lock(out.with_suffix(".lock")):
        if not out.exists():
            build = _compile(out)
    lib = ctypes.CDLL(str(out))
    for fn, argtypes in SIGNATURES.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    lib.build = build
    _lib = lib
    return lib
