"""The build of a wide MLP spec's library in parts (``ops/_build.py``
``parts`` and ``_compile``; ``csrc/rollout_kernels.cu`` ``ARTT_PART``).

- which libraries are compiled in parts: an MLP spec with more weights
  than the default spec's, of either precision, and no other field;
- ``_compile`` starts one ``nvcc -c`` a part at once (a stand-in script
  that records its arguments and times) and links their objects into one
  library; at most as many ``nvcc`` run at once as there are slots;
- the preprocessed source of each part defines a disjoint set of the C
  functions, whose union is what the whole library defines (``g++ -E``
  with empty CUDA headers)."""

import collections
import re
import shutil
import stat
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from autorally_tpu_torch.ops import _build

WIDE = (6, 64, 64, 64, 64, 4)


@pytest.mark.parametrize("layers, field, bf16, want", [
    (WIDE, None, False, _build.PARTS),
    (WIDE, None, True, _build.PARTS),
    (WIDE, (6, 48, 48), False, 1),
    ((6, 24, 4), None, False, 1),
    ((6, 32, 32, 4), None, False, 1),
    (None, None, True, 1),
    (None, (6, 48, 48), False, 1),
])
def test_wide_spec_libraries_build_in_parts(layers, field, bf16, want):
    assert _build.parts(layers, field, bf16) == want


def _standin(path: Path, log: Path) -> None:
    """An ``nvcc`` that records its arguments and its start and end times
    in ``log``, sleeps, and builds with ``cc``: for ``-c`` an object that
    defines ``part_<ARTT_PART>``, for ``-shared`` a library of the objects
    it is given."""
    path.write_text(f"#!{sys.executable}\n" + textwrap.dedent(f"""
        import subprocess, sys, time
        t0 = time.time()
        args = sys.argv[1:]
        out = args[args.index("-o") + 1]
        time.sleep(0.5)
        if "-c" in args:
            part = [a for a in args if a.startswith("-DARTT_PART=")][0]
            src = out + ".c"
            with open(src, "w") as f:
                f.write("int part_%s(void) {{ return %s; }}\\n"
                        % ((part.split("=")[1],) * 2))
            subprocess.run(["cc", "-c", "-fPIC", "-o", out, src], check=True)
        else:
            objs = [a for a in args if a.endswith(".o")]
            subprocess.run(["cc", "-shared", "-o", out, *objs], check=True)
        with open({str(log)!r}, "a") as f:
            f.write("%r %r %r\\n" % (t0, time.time(), args))
        """))
    path.chmod(path.stat().st_mode | stat.S_IEXEC)


def _compile_logged(tmp_path, monkeypatch, slots: int):
    """``_compile`` of the wide spec's library in parts with ``slots``
    nvcc slots and the stand-in nvcc: (library path, seconds, output,
    each call's arguments, each call's (start, end))."""
    import threading

    log = tmp_path / "calls"
    _standin(tmp_path / "nvcc", log)
    monkeypatch.setattr(_build, "nvcc_path", lambda: str(tmp_path / "nvcc"))
    monkeypatch.setattr(_build, "_nvcc_slots",
                        threading.BoundedSemaphore(slots))
    out = tmp_path / "lib.so"
    seconds, text = _build._compile(out, _build.spec_defines(WIDE),
                                    _build.PARTS)
    lines = log.read_text().splitlines()
    calls = [eval(line.split(" ", 2)[2]) for line in lines]
    times = [tuple(map(float, line.split(" ", 2)[:2])) for line in lines]
    return out, seconds, text, calls, times


@pytest.mark.skipif(shutil.which("cc") is None, reason="no C compiler")
def test_parts_compile_at_once_and_link_into_one_library(tmp_path,
                                                         monkeypatch):
    import ctypes

    out, seconds, text, calls, times = _compile_logged(
        tmp_path, monkeypatch, _build.PARTS)
    compiles = [c for c in calls if "-c" in c]
    links = [c for c in calls if "-shared" in c]
    assert len(compiles) == _build.PARTS and len(links) == 1
    assert sorted(next(a for a in c if a.startswith("-DARTT_PART="))
                  for c in compiles) == [f"-DARTT_PART={p}"
                                         for p in range(_build.PARTS)]
    for c in compiles:
        # the library's flags but -shared, the spec's header included first
        assert c[:c.index("-include")] == [f for f in _build.NVCC_FLAGS
                                           if f != "-shared"]
        assert c[-1] == str(_build.SOURCE)
    # every part started before any ended; the link after them all
    part_times = [t for t, c in zip(times, calls) if "-c" in c]
    assert max(t0 for t0, _ in part_times) < min(t1 for _, t1 in part_times)
    link_t0 = next(t for t, c in zip(times, calls) if "-shared" in c)[0]
    assert link_t0 >= max(t1 for _, t1 in part_times)
    assert seconds > 0 and isinstance(text, str)
    lib = ctypes.CDLL(str(out))
    assert [getattr(lib, f"part_{p}")() for p in range(_build.PARTS)] == \
        list(range(_build.PARTS))


@pytest.mark.skipif(shutil.which("cc") is None, reason="no C compiler")
def test_the_slots_bound_the_nvcc_processes_at_once(tmp_path, monkeypatch):
    import ctypes

    out, _, _, calls, times = _compile_logged(tmp_path, monkeypatch, 2)
    assert len(calls) == _build.PARTS + 1
    # at each start, at most 2 calls run (itself included)
    for t0, _ in times:
        assert sum(1 for s, e in times if s <= t0 < e) <= 2
    ctypes.CDLL(str(out)).part_7()


@pytest.mark.skipif(shutil.which("cc") is None, reason="no C compiler")
def test_a_failed_part_fails_the_build_with_its_output(tmp_path,
                                                       monkeypatch):
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(f"#!{sys.executable}\n" + textwrap.dedent("""
        import sys
        if "-DARTT_PART=3" in sys.argv:
            print("error: part 3 does not compile")
            sys.exit(2)
        open(sys.argv[sys.argv.index("-o") + 1], "w").close()
        """))
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(_build, "nvcc_path", lambda: str(nvcc))
    out = tmp_path / "lib.so"
    with pytest.raises(RuntimeError, match="part 3 does not compile"):
        _build._compile(out, _build.spec_defines(WIDE), _build.PARTS)
    assert not out.exists()


def _defined(tmp_path: Path, *defines: str) -> list:
    """The C functions that the source defines with ``defines``, from its
    preprocessed text (the CUDA headers empty)."""
    inc = tmp_path / "inc"
    inc.mkdir(exist_ok=True)
    for name in ("cuda_runtime.h", "cuda_bf16.h"):
        (inc / name).write_text("")
    out = subprocess.run(["g++", "-E", "-P", "-x", "c++", f"-I{inc}",
                          *defines, str(_build.SOURCE)],
                         capture_output=True, text=True)
    text = out.stdout
    tail = text[text.index('extern "C" {'):]
    return re.findall(r"\bint (artt_\w+)\([^;{]*\)\s*\{", tail)


@pytest.mark.skipif(shutil.which("g++") is None, reason="no g++")
@pytest.mark.parametrize("bf16", [False, True])
def test_each_part_defines_its_functions_once(tmp_path, bf16):
    spec = ["-DARTT_SPEC_LIBRARY"] + (["-DARTT_BF16_OPERANDS"] if bf16
                                      else [])
    whole = _defined(tmp_path, *spec)
    parts = [_defined(tmp_path, *spec, f"-DARTT_PART={p}")
             for p in range(_build.PARTS)]
    counts = collections.Counter(fn for part in parts for fn in part)
    assert all(n == 1 for n in counts.values()), counts
    assert sorted(counts) == sorted(whole)
    assert set(_build.SPEC_FUNCTIONS) <= set(whole)
    # each part holds its family's instance query; part 0 every query
    for p, part in enumerate(parts):
        assert f"artt_part_info_{p}" in part
    assert {"artt_exact_kernel_info", "artt_chain_kernel_info",
            "artt_field_kernel_info", "artt_lanes_kernel_info",
            "artt_num_weights"} <= set(parts[0])
    assert set(parts[1]) == {"artt_part_info_1", "artt_fused_exact_lanes"}
    assert set(parts[7]) == {"artt_part_info_7", "artt_fused_field_lanes",
                             "artt_fused_rng_field_costs_lanes"}
    # the default library, in one object, holds every entry point
    assert set(_build.SIGNATURES) <= set(_defined(tmp_path))
