"""ctypes wrapper for the native host dynamics kernel (``bbdyn.cpp``).

Counterpart of ``dpilqr_tpu/native/host.py``, over the port's own copy of
``bbdyn.cpp`` (byte-identical to the JAX package's).  The shared library
builds with g++ on first use, never at import, into
``dpilqr_tpu_torch/_build/host/<hash>/`` keyed by a hash of the source and
the flags, and exposes batched ``f`` / ``step`` / ``linearize`` on the padded
block layout ``(n, nx_p)``, float64 numpy in and out.  ``available()`` says
whether the library could be built and loaded; callers that can do without
it (``api.f`` / ``integrate`` / ``linearize``, the experiment script's plant)
take the port's torch models where it is False.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent / "bbdyn.cpp"
_BUILD_DIR = Path(__file__).resolve().parent.parent / "_build" / "host"
# -ffp-contract=off: no FMA contraction, so the library rounds as the torch
# float64 models do (Quad12D is chaotic at high spin rates and amplifies
# last-bit differences).
_FLAGS = ("-O3", "-ffp-contract=off", "-shared", "-fPIC")

_lib = None
_build_error: str | None = None


def _library_path() -> Path:
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    h.update(_SRC.read_bytes())
    return _BUILD_DIR / h.hexdigest()[:16] / "libbbdyn.so"


def _build(out: Path) -> bool:
    """Compile ``bbdyn.cpp`` into ``out`` (written whole or not at all)."""
    global _build_error
    cxx = shutil.which("g++")
    if cxx is None:
        _build_error = "g++ not found"
        return False
    out.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        so = os.path.join(tmp, out.name)
        proc = subprocess.run([cxx, *_FLAGS, "-o", so, str(_SRC)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            _build_error = proc.stderr
            return False
        os.replace(so, out)
    return True


def _load():
    global _lib
    if _lib is not None:
        return _lib
    path = _library_path()
    if not path.exists() and not _build(path):
        return None
    lib = ctypes.CDLL(str(path))
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    c = ctypes.c_int
    lib.bbdyn_f.argtypes = [i32p, c, c, c, f64p, f64p, f64p]
    lib.bbdyn_f.restype = c
    lib.bbdyn_step.argtypes = [i32p, c, c, c, f64p, f64p, ctypes.c_double, f64p]
    lib.bbdyn_step.restype = c
    lib.bbdyn_linearize.argtypes = [
        i32p, c, c, c, f64p, f64p, ctypes.c_double, f64p, f64p,
    ]
    lib.bbdyn_linearize.restype = c
    _lib = lib
    return lib


def available() -> bool:
    """Whether the library builds (on first call) and loads."""
    return _load() is not None


def build_error() -> str | None:
    """The compiler's message of a failed build, else None."""
    return _build_error


def _prep(model_ids, x, u):
    models = np.ascontiguousarray(model_ids, dtype=np.int32)
    x = np.ascontiguousarray(x, dtype=np.float64)
    u = np.ascontiguousarray(u, dtype=np.float64)
    if x.ndim != 2 or u.ndim != 2 or models.shape != (x.shape[0],) \
            or u.shape[0] != x.shape[0]:
        raise ValueError(
            f"expected model_ids (n,), x (n, nx_p), u (n, nu_p); got "
            f"{models.shape}, {x.shape}, {u.shape}")
    return models, x, u, x.shape[0], x.shape[1], u.shape[1]


def _lib_or_raise():
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native host library unavailable: {_build_error}")
    return lib


def f(model_ids, x, u):
    """Batched continuous dynamics: (n, nx_p), (n, nu_p) -> (n, nx_p)."""
    lib = _lib_or_raise()
    models, x, u, n, nx_p, nu_p = _prep(model_ids, x, u)
    out = np.empty_like(x)
    if lib.bbdyn_f(models, n, nx_p, nu_p, x, u, out) != 0:
        raise ValueError("bbdyn_f: bad model id")
    return out


def step(model_ids, x, u, dt):
    """Batched RK4 step over dt (per-model substeps)."""
    lib = _lib_or_raise()
    models, x, u, n, nx_p, nu_p = _prep(model_ids, x, u)
    out = np.empty_like(x)
    if lib.bbdyn_step(models, n, nx_p, nu_p, x, u, float(dt), out) != 0:
        raise ValueError("bbdyn_step: bad model id")
    return out


def linearize(model_ids, x, u, dt):
    """Batched Euler-discretized Jacobians: -> (n, nx_p, nx_p), (n, nx_p, nu_p)."""
    lib = _lib_or_raise()
    models, x, u, n, nx_p, nu_p = _prep(model_ids, x, u)
    A = np.empty((n, nx_p, nx_p))
    B = np.empty((n, nx_p, nu_p))
    if lib.bbdyn_linearize(models, n, nx_p, nu_p, x, u, float(dt), A, B) != 0:
        raise ValueError("bbdyn_linearize: bad model id")
    return A, B
