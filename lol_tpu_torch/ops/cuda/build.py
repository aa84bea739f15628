"""Build the port's CUDA sources at first use and load them with ctypes.

Every `lol_tpu_torch/csrc/*.cu` is compiled by `nvcc` for `sm_90a` into
one shared library with a plain C interface, under
`lol_tpu_torch/_build/<hash of the sources>/`, so an edit to any source
builds anew and an unchanged tree reuses the library.  Nothing here runs
at import time: the CPU test suite imports every module without nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


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
    path.  The compiler's log (with `-Xptxas -v`'s register and shared
    memory report) is kept beside the library as build.log."""
    lib = library_path()
    if lib.exists():
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    cu = [str(s) for s in _sources() if s.suffix == ".cu"]
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=lib.parent)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *cu]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    (lib.parent / "build.log").write_text(
        " ".join(cmd) + "\n" + proc.stdout + proc.stderr
    )
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, lib)  # atomic: a concurrent process never sees a partial file
    return lib


_LIB: list[ctypes.CDLL] = []


def load() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    if not _LIB:
        lib = ctypes.CDLL(str(build()))
        lib.lol_cuda_error_string.argtypes = [ctypes.c_int]
        lib.lol_cuda_error_string.restype = ctypes.c_char_p
        _LIB.append(lib)
    return _LIB[0]


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if err != 0:
        msg = load().lol_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
