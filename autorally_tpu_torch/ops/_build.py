"""Build and load the port's CUDA kernels.

``autorally_tpu_torch/csrc/rollout_kernels.cu`` exposes a plain C
interface.  At first use it is compiled by ``nvcc`` for ``sm_90a`` into a
shared library under ``autorally_tpu_torch/_build/`` (listed in
``.gitignore``), named by a hash of the source and the flags, and loaded
with ``ctypes``.  Nothing is built when the module is imported, so the CPU
tests import it on machines without ``nvcc``.
"""

from __future__ import annotations

import ctypes
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
    "artt_num_field_weights": [],
    "artt_max_obstacles": [],
    "artt_num_float_scalars": [],
    "artt_num_int_scalars": [],
    "artt_update_block": [],
    "artt_fused_exact_rollout_cost": [_P, _P, _I] + [_P] * 11,
    "artt_fused_field_rollout_cost": [_P, _P, _I] + [_P] * 11,
    "artt_dynamics_chain": [_P, _P, _I] + [_P] * 8,
    # fsc, isc, k_offset, ou_a, ou_b, device, then device pointers + stream
    "artt_fused_rng_costs": [_P, _P, _I, _F, _F, _I] + [_P] * 10,
    "artt_fused_rng_field_costs": [_P, _P, _I, _F, _F, _I] + [_P] * 10,
    "artt_weighted_update": [_P, _P, _I, _F, _F, _I] + [_P] * 5,
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
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        t0 = time.perf_counter()
        proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", tmp,
                               str(SOURCE)], capture_output=True, text=True)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed for {SOURCE.name}:\n{log}")
        os.replace(tmp, out)                  # the library appears atomically
        build = (time.perf_counter() - t0, log)
    lib = ctypes.CDLL(str(out))
    for fn, argtypes in SIGNATURES.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    lib.build = build
    _lib = lib
    return lib
