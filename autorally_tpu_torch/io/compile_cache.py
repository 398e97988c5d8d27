"""Persistent build cache for the port's compiled libraries (the port's
``autorally_tpu/io/compile_cache.py``).

The JAX package caches XLA compilations; the port compiles two libraries
at first use instead: the CUDA kernels (``ops/_build.py``, one ``nvcc``
run) and the native runtime (``runtime/native.py``, one ``g++`` run).  By
default both build into ``autorally_tpu_torch/_build/`` of the checkout.
A persistent directory shared across checkouts and runs makes every
later run of a tool start without a compile.  Each library is named by a
hash of its source and flags, and built under a file lock, so that
processes that start together (the ranks of a sharded solve) compile it
once.

Not enabled at import time: library users keep the checkout's build
directory.  The tools (``tools/solve_breakdown.py``,
``tools/scaling_bench.py``) opt in by calling
:func:`enable_persistent_cache` before their first build.
"""

from __future__ import annotations

import os

DEFAULT_CACHE_DIR = os.path.join(
    os.path.expanduser("~"), ".cache", "autorally_tpu", "cuda_build")


def enable_persistent_cache(cache_dir: str | None = None) -> str:
    """Build and load the kernel library and the native runtime library in
    ``cache_dir``, else ``$AUTORALLY_TPU_CACHE_DIR``, else
    :data:`DEFAULT_CACHE_DIR`.  Safe to call more than once; raises if this
    process already loaded either library from another directory.  Returns
    the directory in use."""
    from autorally_tpu_torch.ops import _build
    from autorally_tpu_torch.runtime import native

    path = os.path.realpath(cache_dir or os.environ.get(
        "AUTORALLY_TPU_CACHE_DIR", DEFAULT_CACHE_DIR))
    os.makedirs(path, exist_ok=True)
    _build.set_build_dir(path)
    native.set_build_dir(path)
    return path
