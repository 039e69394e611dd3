"""Build and load the hand-written CUDA kernels in ``dpilqr_tpu_torch/csrc``.

The ``.cu`` sources compile with ``nvcc`` for ``sm_90a`` (Hopper) into one
shared library with a plain C interface, loaded through ``ctypes``.  The
build runs on first use, never at import, into
``dpilqr_tpu_torch/_build/<hash>/`` keyed by a hash of the sources and the
compiler flags, so an edited kernel rebuilds and an unchanged one loads.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from functools import cache
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
LIB_NAME = "libdpilqr_kernels.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
# Argument lists of the C entry points (pointers, then ints, then stream).
_SIGNATURES = {
    "dpilqr_backward_batched": [_P] * 11 + [_I] * 5 + [_P],
    "dpilqr_forward_batched": [_P] * 20 + [_I] * 6 + [_P],
}


def sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def find_nvcc() -> str:
    for cand in (
        os.environ.get("CUDA_HOME") and os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"),
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build(verbose: bool = False) -> tuple[Path, float]:
    """Compile the kernels if needed; returns ``(library path, seconds)``."""
    out_dir = BUILD_DIR / source_hash()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib, 0.0
    out_dir.mkdir(parents=True, exist_ok=True)
    cu = [str(s) for s in sources() if s.suffix == ".cu"]
    t0 = time.perf_counter()
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    cmd = [find_nvcc(), *NVCC_FLAGS, "-I", str(CSRC_DIR), "-o", tmp, *cu]
    if verbose:
        cmd.insert(1, "-Xptxas=-v")
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}"
        )
    if verbose and proc.stderr:
        print(proc.stderr)
    os.replace(tmp, lib)
    return lib, time.perf_counter() - t0


@cache
def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built on first call."""
    lib_path, _ = build()
    lib = ctypes.CDLL(str(lib_path))
    for base, argtypes in _SIGNATURES.items():
        for suffix in ("f32", "f64"):
            fn = getattr(lib, f"{base}_{suffix}")
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib
