"""Build the port's CUDA sources at first use and load them with ctypes.

Every `lol_tpu_torch/csrc/*.cu` is compiled by its own `nvcc` for
`sm_90a`, all started together, and the objects are linked into one
shared library with a plain C interface, under
`lol_tpu_torch/_build/<hash of the sources>/`, so an edit to any source
builds anew and an unchanged tree reuses the library.  Nothing here runs
at import time: the CPU test suite imports every module without nvcc.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _sources() -> list[Path]:
    return sorted(list(CSRC.glob("*.cu")) + list(CSRC.glob("*.cuh")))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path() -> Path:
    """Where the library for the current sources lives (built or not)."""
    h = hashlib.sha256()
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_ROOT / h.hexdigest()[:16] / "liblol_kernels.so"


def build() -> Path:
    """Compile the sources unless the library for them exists; returns its
    path.  The compilers' log (with `-Xptxas -v`'s register and shared
    memory report per kernel) is kept beside the library as build.log.
    Safe under concurrency: processes that build the same sources take
    turns on an advisory lock beside the library (released when its holder
    exits, however it exits), and the later ones find it built."""
    return locked_build(library_path(), _compile)


def locked_build(lib: Path, compile_fn) -> Path:
    """lib, made by compile_fn(lib) unless it exists, under the advisory
    lock `build.lock` beside it: concurrent processes take turns, and the
    later ones find it built.  compile_fn writes lib atomically."""
    if lib.exists():
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    with open(lib.parent / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not lib.exists():
            compile_fn(lib)
    return lib


def _compile(lib: Path) -> None:
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=lib.parent) as tmp:
        cu = [s for s in _sources() if s.suffix == ".cu"]
        objs = [f"{tmp}/{src.stem}.o" for src in cu]
        jobs = []
        for src, obj in zip(cu, objs):
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
            jobs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                               stderr=subprocess.STDOUT, text=True)))
        steps = [(cmd, proc.communicate()[0], proc.returncode) for cmd, proc in jobs]
        if all(rc == 0 for _, _, rc in steps):
            cmd = [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", f"{tmp}/lib.so", *objs]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            steps.append((cmd, proc.stdout + proc.stderr, proc.returncode))
        log = "".join(" ".join(cmd) + "\n" + out for cmd, out, _ in steps)
        (lib.parent / "build.log").write_text(log)
        if any(rc != 0 for _, _, rc in steps):
            raise RuntimeError(f"nvcc failed:\n{log}")
        # atomic: a concurrent process never sees a partial file
        os.replace(f"{tmp}/lib.so", lib)


_LIB: list[ctypes.CDLL] = []


def load() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    if not _LIB:
        lib = ctypes.CDLL(str(build()))
        lib.lol_cuda_error_string.argtypes = [ctypes.c_int]
        lib.lol_cuda_error_string.restype = ctypes.c_char_p
        _LIB.append(lib)
    return _LIB[0]


def ptxas_report(log: str) -> dict[str, dict[str, int]]:
    """Each kernel's resources from a build log (`-Xptxas -v`), by mangled
    name: registers, and the bytes of its stack frame and of its spill
    stores and loads."""
    out: dict[str, dict[str, int]] = {}
    name = None
    for line in log.splitlines():
        head = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)", line)
        if head:
            name = head.group(1)
            out.setdefault(name, {})
            continue
        frame = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                          r"(\d+) bytes spill loads", line)
        if frame and name:
            out[name].update(zip(("stack", "spill_stores", "spill_loads"),
                                 map(int, frame.groups())))
        regs = re.search(r"Used (\d+) registers", line)
        if regs and name:
            out[name]["registers"] = int(regs.group(1))
    return out


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if err != 0:
        msg = load().lol_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
