"""The port's persistent build cache (``autorally_tpu_torch/io/compile_cache.py``)
and the build lock of ``ops/_build.py`` and ``runtime/native.py``.

- the directory: the argument, ``$AUTORALLY_TPU_CACHE_DIR``, the default;
- a second call is fine, a call after a library was loaded from another
  directory raises;
- the lock: two processes that start together load the kernel library
  from a fresh cache directory with ``nvcc`` a stand-in script (it sleeps,
  counts its calls and builds a library that holds every entry point of
  the kernel library, each returning 0), and the compiler runs once; the
  same for the native runtime with ``CXX`` a stand-in that counts its
  calls and runs ``g++``."""

import os
import stat
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from autorally_tpu_torch.io import compile_cache
from autorally_tpu_torch.ops import _build
from autorally_tpu_torch.runtime import native

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture
def fresh(monkeypatch):
    """Build directories and loaded libraries restored after the test."""
    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", native.BUILD_DIR)
    monkeypatch.setattr(native, "SO_PATH", native.SO_PATH)
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.delenv("AUTORALLY_TPU_CACHE_DIR", raising=False)
    return monkeypatch


class _Loaded:
    def __init__(self, name):
        self._name = str(name)


def test_cache_directory_argument_environment_default(fresh, tmp_path):
    assert compile_cache.DEFAULT_CACHE_DIR == os.path.join(
        os.path.expanduser("~"), ".cache", "autorally_tpu", "cuda_build")
    tmp_path = tmp_path.resolve()
    got = compile_cache.enable_persistent_cache(str(tmp_path / "arg"))
    assert got == str(tmp_path / "arg") and os.path.isdir(got)
    assert _build.BUILD_DIR == Path(got)
    assert _build.library_path().parent == Path(got)
    assert native.BUILD_DIR == Path(got)
    assert native.SO_PATH.parent == Path(got)
    assert native.SO_PATH.name.startswith("libartpu_rt_")
    fresh.setenv("AUTORALLY_TPU_CACHE_DIR", str(tmp_path / "env"))
    assert compile_cache.enable_persistent_cache() == str(tmp_path / "env")
    fresh.delenv("AUTORALLY_TPU_CACHE_DIR")
    fresh.setattr(compile_cache, "DEFAULT_CACHE_DIR", str(tmp_path / "dflt"))
    assert compile_cache.enable_persistent_cache() == str(tmp_path / "dflt")
    assert _build.BUILD_DIR == tmp_path / "dflt"


def test_enabling_twice_is_fine_another_directory_is_refused(fresh,
                                                             tmp_path):
    tmp_path = tmp_path.resolve()
    here = compile_cache.enable_persistent_cache(str(tmp_path))
    assert compile_cache.enable_persistent_cache(str(tmp_path)) == here
    fresh.setattr(_build, "_lib", _Loaded(_build.library_path()))
    fresh.setattr(native, "_LIB", _Loaded(native.SO_PATH))
    assert compile_cache.enable_persistent_cache(str(tmp_path)) == here
    with pytest.raises(RuntimeError, match="kernel library is already "
                                           "loaded from"):
        compile_cache.enable_persistent_cache(str(tmp_path / "other"))
    fresh.setattr(_build, "_lib", None)
    with pytest.raises(RuntimeError, match="native library is already "
                                           "loaded from"):
        compile_cache.enable_persistent_cache(str(tmp_path / "other"))


def _standin(path: Path, body: str) -> str:
    path.write_text(f"#!{sys.executable}\n" + textwrap.dedent(body))
    path.chmod(path.stat().st_mode | stat.S_IEXEC)
    return str(path)


def _load_together(tmp_path, loader: str, env=None) -> list:
    """Two processes that enable the cache in ``tmp_path / 'cache'`` and
    run ``loader`` at once; returns their outputs."""
    code = ("import sys\n"
            "from autorally_tpu_torch.io.compile_cache import "
            "enable_persistent_cache\n"
            "from autorally_tpu_torch.ops import _build\n"
            "from autorally_tpu_torch.runtime import native\n"
            f"_build.nvcc_path = lambda: {str(tmp_path / 'nvcc')!r}\n"
            f"enable_persistent_cache({str(tmp_path / 'cache')!r})\n"
            + loader)
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=REPO,
                              env={**os.environ, **(env or {})},
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for _ in range(2)]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=120)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
        assert p.returncode == 0, out
        outs.append(out)
    return outs


def test_processes_that_start_together_run_nvcc_once(tmp_path):
    tmp_path = tmp_path.resolve()
    calls = tmp_path / "calls"
    names = list(_build.SIGNATURES)
    _standin(tmp_path / "nvcc", f"""
        import subprocess, sys, time
        with open({str(calls)!r}, "a") as f:
            f.write("nvcc\\n")
        time.sleep(1.0)
        out = sys.argv[sys.argv.index("-o") + 1]
        src = out + ".c"
        with open(src, "w") as f:
            for n in {names!r}:
                f.write("int %s(void) {{ return 0; }}\\n" % n)
        subprocess.run(["cc", "-shared", "-fPIC", "-o", out, src],
                       check=True)
        """)
    outs = _load_together(
        tmp_path, "lib = _build.load()\n"
                  "print('BUILT' if lib.build else 'LOADED', lib._name)\n")
    assert calls.read_text().count("nvcc") == 1
    assert sorted(o.split()[0] for o in outs) == ["BUILT", "LOADED"]
    so = Path(outs[0].split()[1])
    assert so.parent == tmp_path / "cache" and so.exists()
    assert so.name == _build.library_path().name
    assert {o.split()[1] for o in outs} == {str(so)}


def test_processes_that_start_together_run_gxx_once(tmp_path):
    tmp_path = tmp_path.resolve()
    calls = tmp_path / "calls"
    cxx = _standin(tmp_path / "cxx", f"""
        import os, sys, time
        with open({str(calls)!r}, "a") as f:
            f.write("g++\\n")
        time.sleep(1.0)
        os.execvp("g++", ["g++"] + sys.argv[1:])
        """)
    outs = _load_together(
        tmp_path, "print(native.load()._name)\n", env={"CXX": cxx})
    assert calls.read_text().count("g++") == 1
    paths = {Path(o.split()[-1]) for o in outs}
    assert len(paths) == 1
    so = paths.pop()
    assert so.parent == tmp_path / "cache" and so.exists()
    assert so.name.startswith("libartpu_rt_")
