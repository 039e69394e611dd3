"""Build, load and launch the hand-written CUDA kernels in ``dpilqr_tpu_torch/csrc``.

The ``.cu`` sources compile with ``nvcc`` for ``sm_90a`` (Hopper), one
``nvcc`` per source started together, and link into one shared library with
a plain C interface, loaded through ``ctypes``.  The build runs on first
use, never at import, into ``dpilqr_tpu_torch/_build/<hash>/`` keyed by a
hash of the sources and the compiler flags, so an edited kernel rebuilds
and an unchanged one loads.

Fleets of custom models (``ops.codegen``) run on a second library: the
five kernels that integrate or differentiate a fleet (K1 to K5) compiled
once more with ``-DDPILQR_CUSTOM_MODELS`` and the generated header on the
include path, into ``_build/custom/<hash of sources, flags and header>/``.
``require_kernel_models`` routes a fleet to its library (or refuses it);
the probes hold no model and always come from the default one.

Where a kernel places its working set (its shared-memory plan) is defined
once, in ``csrc/plan.h``: the kernels plan every launch with it, and
``host_build`` compiles the same header with g++ into a small library,
``csrc/plan.cpp``'s, from which ``riccati_plan`` and ``forward_plan``
read every plan the wrappers size a workspace or refuse a width with, on
the card and on the CPU alike.  ``host_build`` also builds the CPU tests'
host libraries of ``csrc/``.

``launch`` is the one way a wrapper calls a kernel: it raises on a failed
launch and counts the launch in ``launch_counts`` (and, from a custom
library, in ``custom_launch_counts``; the plain-torch twins never count).
Inside a ``timed_launches()`` block it also brackets each kernel with CUDA
events, so a caller can read the kernel's own time apart from its
wrapper's torch preparation.  ``bind`` resolves a launch once (entry point
and arguments, tensors as pointers) for a caller that repeats it on fixed
buffers: ``run`` launches it as ``launch`` does, ``call`` launches it
alone (inside a CUDA graph's capture), and ``count`` adds a graph's
replayed launches to the counts.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time
from functools import cache
from pathlib import Path
from typing import NamedTuple

import torch

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
LIB_NAME = "libdpilqr_kernels.so"
# The generated header's name in a custom library's build directory (the
# name csrc/dynamics.cuh includes).
HEADER_NAME = "dpilqr_custom_models.cuh"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
# Dynamic shared memory a block may use on the card the kernels compile for
# (sm_90a's opt-in: 227 KB): the limit every plan is made under.
SMEM_LIMIT = 232_448
# DPILQR_NVCC_FLAGS adds compiler flags (and so keys another build), e.g.
# -DDPILQR_PHASE_CLOCKS for scripts/riccati_phase_clocks.py.
COMPILE_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                 *os.environ.get("DPILQR_NVCC_FLAGS", "").split())

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_D = ctypes.c_double
# Argument lists of the C entry points (pointers, then sizes and scalars,
# then stream).
_SIGNATURES = {
    "accept_batched": [_P] * 14 + [_I] * 6 + [_D] * 4 + [_I] * 3 + [_P],
    "backward_batched": [_P] * 17 + [_I] * 5 + [_P],
    "backward_batched_wide": [_P] * 18 + [_L] + [_I] * 5 + [_P],
    "backward_sweep": [_P] * 17 + [_L] + [_I] * 4 + [_P],
    "forward_batched": [_P] * 23 + [_I] * 8 + [_P],
    "forward_sweep": [_P] * 21 + [_I] * 7 + [_P],
    "probe_fma": [_P] * 2 + [_L, _I] + [_F] * 8 + [_P],
    "probe_hbm": [_P] * 2 + [_I, _L] + [_P],
    "probe_sin": [_P] * 2 + [_L, _I] + [_P],
}
# Entry-point suffixes of each kernel: the dtypes it is compiled for.
_DTYPES = {
    "accept_batched": ("f32", "f64"),
    "backward_batched": ("f32", "f64"),
    "backward_batched_wide": ("f32", "f64"),
    "backward_sweep": ("f32", "f64"),
    "forward_batched": ("f32", "f64"),
    "forward_sweep": ("f32", "f64"),
    "probe_fma": ("f32",),
    "probe_hbm": ("f32",),
    "probe_sin": ("f32",),
}

# The sources (and so the kernels) of a custom-model library: those whose
# kernels run a fleet's right-hand sides.
CUSTOM_KERNELS = ("backward_batched", "backward_batched_wide", "backward_sweep",
                  "forward_batched", "forward_sweep")

# Launches of each kernel since the last reset, and of those the launches
# from a custom-model library.
launch_counts = dict.fromkeys(_SIGNATURES, 0)
custom_launch_counts = dict.fromkeys(CUSTOM_KERNELS, 0)
# Launches of the backward kernels (K1, K3, K5) by the placement tier of
# their working set (``riccati_plan``: 0-2, and 3 for K3's cluster tier),
# keyed ``(kernel, tier)``; a graph's replays count as its launches do.
tier_counts: dict[tuple[str, int], int] = {}


def reset_launch_counts():
    for counts in (launch_counts, custom_launch_counts):
        for k in counts:
            counts[k] = 0
    tier_counts.clear()


# While a ``timed_launches()`` block is open: its list of
# ``(kernel, start event, end event, sizes)``, the sizes being the launch's
# integer arguments as the wrapper passed them; None otherwise.
_timed = None


@contextlib.contextmanager
def timed_launches():
    """Bracket every kernel launched inside the block with CUDA events.

    Yields the list the launches append ``(kernel, start, end, sizes)`` to;
    after a ``torch.cuda.synchronize()`` ``launch_ms`` turns it into times.
    The events surround the C entry point alone, not the wrapper's checks,
    allocations or torch preparation."""
    global _timed
    record, previous = [], _timed
    _timed = record
    try:
        yield record
    finally:
        _timed = previous


def launch_ms(record, kernel: str) -> list[float]:
    """Milliseconds of each launch of ``kernel`` in a ``timed_launches()``
    record (synchronizes first)."""
    torch.cuda.synchronize()
    return [s.elapsed_time(e) for k, s, e, _ in record if k == kernel]


def sources() -> list[Path]:
    return (sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))
            + sorted(CSRC_DIR.glob("*.h")))


def find_nvcc() -> str:
    for cand in (
        os.environ.get("CUDA_HOME") and os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"),
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def source_hash(header: str | None = None) -> str:
    """Hash of the sources and flags, and of a custom library's header."""
    h = hashlib.sha256(" ".join(COMPILE_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    if header is not None:
        h.update(b"\0custom\0" + header.encode())
    return h.hexdigest()[:16]


def build_dir(header: str | None = None) -> Path:
    """Where the default library (``header`` None) or the custom library of
    a generated header is built."""
    if header is None:
        return BUILD_DIR / source_hash()
    return BUILD_DIR / "custom" / source_hash(header)


def _check(returncode: int, what: str, out: str, err: str):
    if returncode != 0:
        raise RuntimeError(f"nvcc failed on {what} ({returncode}):\n{out}\n{err}")


def build(verbose: bool = False, header: str | None = None) -> tuple[Path, float]:
    """Compile the kernels if needed; returns ``(library path, seconds)``.

    With ``header`` (a header ``ops.codegen`` generated) the custom-model
    library: ``CUSTOM_KERNELS``' sources with ``-DDPILQR_CUSTOM_MODELS`` and
    the header on the include path.  With ``verbose`` nvcc reports each
    kernel's registers and spills (``-Xptxas=-v``), kept beside the library
    as ``<source>.log`` (``ptxas_report`` reads it)."""
    out_dir = build_dir(header)
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib, 0.0
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    extra = ["-Xptxas=-v"] if verbose else []
    srcs = [s for s in sources() if s.suffix == ".cu"]
    if header is not None:
        srcs = [s for s in srcs if s.stem in CUSTOM_KERNELS]
        tmp_header = out_dir / f".{HEADER_NAME}.{os.getpid()}"
        tmp_header.write_text(header)
        os.replace(tmp_header, out_dir / HEADER_NAME)
        extra += ["-DDPILQR_CUSTOM_MODELS", "-I", str(out_dir)]
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        procs = []
        for src in srcs:
            obj = Path(tmp) / f"{src.stem}.o"
            cmd = [nvcc, *COMPILE_FLAGS, *extra, "-I", str(CSRC_DIR), "-c",
                   "-o", str(obj), str(src)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        for src, _, proc in procs:
            out, err = proc.communicate()
            _check(proc.returncode, src.name, out, err)
            if verbose:
                (out_dir / f"{src.stem}.log").write_text(err)
        so = Path(tmp) / LIB_NAME
        link = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", "-o", str(so),
             *(str(obj) for _, obj, _ in procs)],
            capture_output=True, text=True,
        )
        _check(link.returncode, "link", link.stdout, link.stderr)
        os.replace(so, lib)
    return lib, time.perf_counter() - t0


def ptxas_report(lib: Path, source: str, kernel: str) -> dict[str, tuple[int, int, int]]:
    """``{entry: (registers, spill-store bytes, spill-load bytes)}`` of the
    entry functions of ``kernel`` (a substring of their mangled names) in
    the ``-Xptxas=-v`` report of ``source`` (a stem) kept beside the
    library ``lib`` by ``build(verbose=True)``."""
    out, name, spill = {}, None, (0, 0)
    for line in (lib.parent / f"{source}.log").read_text().splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name, spill = (m.group(1) if kernel in m.group(1) else None), (0, 0)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name] = (int(m.group(1)), *spill)
            name = None
    return out


@cache
def load_library(header: str | None = None) -> ctypes.CDLL:
    """The kernels' shared library, built on first call: the default one,
    or with ``header`` the custom-model library of that generated header."""
    lib_path, _ = build(header=header)
    lib = ctypes.CDLL(str(lib_path))
    for base in _SIGNATURES if header is None else CUSTOM_KERNELS:
        for suffix in _DTYPES[base]:
            fn = getattr(lib, f"dpilqr_{base}_{suffix}")
            fn.argtypes = _SIGNATURES[base]
            fn.restype = ctypes.c_int
    return lib


def host_build(source: Path, flags, name: str, header: str | None = None) -> Path:
    """Compile ``source`` with g++ and ``flags`` into the shared library
    ``name`` in ``_build/host/<hash>/``, unless it is there; returns its
    path.  The hash covers the source, the flags, ``header`` (a header
    ``ops.codegen`` generated, written as ``HEADER_NAME`` on the include
    path before ``csrc/``) and every file in ``csrc/``, so that an edit of
    any header the source includes rebuilds it; the library is replaced
    whole or not at all."""
    h = hashlib.sha256(" ".join(flags).encode())
    for path in (source, *sorted(p for p in CSRC_DIR.iterdir() if p.is_file())):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    if header is not None:
        h.update(b"\0custom\0" + header.encode())
    out = BUILD_DIR / "host" / h.hexdigest()[:16] / name
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError(f"g++ not found: {source.name} needs a host C++ compiler")
    out.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        include = ["-I", str(CSRC_DIR)]
        if header is not None:
            (Path(tmp) / HEADER_NAME).write_text(header)
            include = ["-I", tmp, *include]
        so = Path(tmp) / name
        proc = subprocess.run([cxx, *flags, "-shared", "-fPIC", *include, "-o", str(so),
                               str(source)], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed on {source.name} ({proc.returncode}):\n"
                               f"{proc.stderr}")
        os.replace(so, out)
    return out


@cache
def plan_library() -> ctypes.CDLL:
    """``csrc/plan.cpp``'s library (the plan of ``csrc/plan.h``), built on
    first call."""
    lib = ctypes.CDLL(str(host_build(CSRC_DIR / "plan.cpp", ("-std=c++17", "-O2"),
                                     "libdpilqr_plan.so")))
    lib.dpilqr_riccati_plan.argtypes = ([_I] * 5 + [_L] + [ctypes.POINTER(_L)] * 2
                                        + [ctypes.POINTER(_I)])
    lib.dpilqr_riccati_plan.restype = ctypes.c_int
    lib.dpilqr_forward_plan.argtypes = [_I] * 7 + [_L, ctypes.POINTER(_I)]
    lib.dpilqr_forward_plan.restype = ctypes.c_longlong
    return lib


def dtype_suffix(dtype) -> str:
    if dtype == torch.float32:
        return "f32"
    if dtype == torch.float64:
        return "f64"
    raise ValueError(f"kernels take float32 or float64, got {dtype}")


def require_kernel_models(fleet) -> str | None:
    """The library that runs ``fleet``'s models in the kernels that
    integrate or differentiate them (K1 to K5), as ``launch`` takes it:
    None for the default library (the nine built-ins, compiled into
    ``csrc/dynamics.cuh``), else the header ``ops.codegen`` generates for
    the fleet's custom models, which keys their library.  Pure Python: it
    builds nothing.  Raises ``NotImplementedError``, naming the reason, for
    a model that is not kernel-ready (``codegen.not_kernel_ready``): such a
    model runs on the CPU, never in a plain version on the card."""
    custom = [s for s in fleet.unique_specs if not s.builtin]
    if not custom:
        return None
    from . import codegen

    for spec in custom:
        reason = codegen.not_kernel_ready(spec)
        if reason:
            raise NotImplementedError(
                f"model {spec.name!r} (id {spec.model_id}) cannot run in the "
                f"CUDA kernels: {reason}; solve it with device=\"cpu\"")
    return codegen.generate_header(fleet.unique_specs)


def require_cuda(name: str, t):
    """Raise unless ``t`` lies on a CUDA device: a wrapper never runs a
    kernel's twin in its place."""
    if not t.is_cuda:
        raise ValueError(f"{name} needs CUDA tensors")


def check_tensors(name: str, tensors: dict, shapes: dict, dtype, device,
                  ints=(), layouts=None, bools=()):
    """Raise unless every tensor has its shape, lies on ``device``, has
    ``dtype`` (int32 for the keys in ``ints``, bool for those in ``bools``)
    and is contiguous in memory: as it stands or, for a key in ``layouts``,
    after the permutation given there (a tensor handed out as a permuted
    view of the kernel's layout)."""
    for key, t in tensors.items():
        want = torch.int32 if key in ints else torch.bool if key in bools else dtype
        if tuple(t.shape) != shapes[key]:
            raise ValueError(f"{name}: {key} has shape {tuple(t.shape)}, "
                             f"expected {shapes[key]}")
        if t.device != device:
            raise ValueError(f"{name}: {key} is on {t.device}, expected {device}")
        if t.dtype != want:
            raise ValueError(f"{name}: {key} has dtype {t.dtype}, expected {want}")
        perm = (layouts or {}).get(key)
        if not (t if perm is None else t.permute(perm)).is_contiguous():
            raise ValueError(
                f"{name}: {key} must be contiguous"
                + ("" if perm is None else f" in memory order {perm}"))


class RiccatiPlan(NamedTuple):
    """Where a backward kernel places one problem's working set: the tier
    (0 all in shared memory, 1 the three nxf^2 matrices in a device-memory
    workspace, 2 the gain blocks and the input buffers too, 3 all of it in
    the shared memory of a cluster of CTAs), the shared-memory bytes of a
    CTA, the workspace values of one problem and the CTAs a problem (1
    below tier 3)."""

    tier: int
    smem: int
    work: int
    cluster: int = 1


@cache
def cluster_max() -> int:
    """K3's largest cluster of CTAs (``CLUSTER_MAX`` in csrc/plan.h), the
    ``max_cluster`` of its ``riccati_plan``."""
    return _I.in_dll(plan_library(), "dpilqr_cluster_max").value


@cache
def riccati_plan(K: int, nx: int, nu: int, itemsize: int, max_cluster: int = 1,
                 limit: int = SMEM_LIMIT) -> RiccatiPlan:
    """Where a backward kernel (K1, K3, K5) places one problem of ``K``
    slots under ``limit`` bytes of shared memory a block: csrc/plan.h's
    ``computed_plan``, or with ``max_cluster`` > 1 K3's ``wide_plan``, which
    may put it on a cluster of CTAs.  Raises a ``ValueError`` where not even
    the vectors fit."""
    smem, work, cluster = _L(), _L(), _I()
    tier = plan_library().dpilqr_riccati_plan(
        K, nx, nu, itemsize, max_cluster, limit, ctypes.byref(smem), ctypes.byref(work),
        ctypes.byref(cluster))
    if tier < 0:
        raise ValueError(
            f"backward kernels: riccati_plan finds no tier for a problem with "
            f"K*nx={K * nx}, K*nu={K * nu}: its vectors alone take "
            f"{smem.value} bytes of shared memory, over the {limit} a block "
            "may use")
    return RiccatiPlan(tier, smem.value, work.value, cluster.value)


class ForwardPlan(NamedTuple):
    """Where the forward kernels (K2, K4) place one problem's columns:
    ``chunks`` CTAs of ``warps`` warps (alphas) each; with gains ``buffers``
    (2 or 1) buffers of a tile of ``rows`` gain rows and of a step's rows;
    ``nbytes`` of dynamic shared memory a CTA."""

    chunks: int
    warps: int
    buffers: int
    rows: int
    nbytes: int

    def placement(self, nuf: int) -> str:
        """"stages" (a step's whole gain block a buffer), "tiles" or
        "columns" (no gains)."""
        return "columns" if not self.rows else "stages" if self.rows >= nuf else "tiles"


@cache
def forward_plan(K: int, nx: int, nu: int, n_alpha: int, itemsize: int,
                 gains: bool = True, max_rows: int = 0,
                 limit: int = SMEM_LIMIT) -> ForwardPlan:
    """Where the forward kernels (K2, K4) place one problem of ``K`` slots
    under ``limit`` bytes of shared memory a block: csrc/plan.h's
    ``column_launch``; ``max_rows`` > 0 forces tiles of at most that many
    gain rows.  Raises a ``ValueError`` where not even one warp's column
    (beside a 4-row tile of gains) fits."""
    plan = (_I * 4)()
    nbytes = plan_library().dpilqr_forward_plan(K, nx, nu, n_alpha, int(gains), itemsize,
                                                max_rows, limit, plan)
    if nbytes < 0:
        raise ValueError(
            f"forward kernels: their plan (column_launch) places no CTA for a problem "
            f"with K*nx={K * nx}, K*nu={K * nu}: one warp's column"
            + (" beside a 4-row tile of its gain block" if gains else "")
            + f" takes {-nbytes} bytes of shared memory, over the {limit} a block "
            "may use")
    return ForwardPlan(*plan, nbytes)


def ptr(t):
    return ctypes.c_void_p(t.data_ptr()) if t is not None else None


class Bound(NamedTuple):
    """A kernel launch resolved once: the C entry point and its arguments
    (tensors as pointers), the launch's integer arguments as
    ``timed_launches`` records them, and the tensors themselves, held so
    that no pointer outlives its memory (a graph replays them)."""

    kernel: str
    library: str | None
    fn: object
    args: tuple
    sizes: tuple
    tensors: tuple
    tier: int | None = None


def bind(kernel: str, dtype, *args, library: str | None = None,
         tier: int | None = None) -> Bound:
    """Resolve ``dpilqr_<kernel>_<f32|f64>(*args, stream)``: ``library`` is
    what ``require_kernel_models`` returned (None: the default library);
    ``tier``, a backward kernel's placement tier, for ``tier_counts``."""
    suffix = dtype_suffix(dtype)
    if suffix not in _DTYPES[kernel]:
        raise ValueError(f"{kernel} takes {_DTYPES[kernel]}, got {dtype}")
    if library is not None and kernel not in CUSTOM_KERNELS:
        raise ValueError(f"{kernel} holds no model: it has no custom-model build")
    fn = getattr(load_library(library), f"dpilqr_{kernel}_{suffix}")
    return Bound(kernel, library, fn,
                 tuple(ptr(a) if isinstance(a, torch.Tensor) else a for a in args),
                 tuple(a for a in args if isinstance(a, int)),
                 tuple(a for a in args if isinstance(a, torch.Tensor)), tier)


def call(b: Bound, stream):
    """Launch ``b`` on ``stream`` (a ``torch.cuda.Stream``), uncounted and
    untimed: the one step of a graph's capture; raises on a failed launch."""
    err = b.fn(*b.args, ctypes.c_void_p(stream.cuda_stream))
    if err != 0:
        raise RuntimeError(f"{b.kernel} kernel failed: cudaError {err}")


def count(b: Bound):
    """Add one launch of ``b`` to the counts (a graph's replay of it)."""
    launch_counts[b.kernel] += 1
    if b.library is not None:
        custom_launch_counts[b.kernel] += 1
    if b.tier is not None:
        tier_counts[b.kernel, b.tier] = tier_counts.get((b.kernel, b.tier), 0) + 1


def run(b: Bound, device):
    """Launch ``b`` on the current stream of ``device``: counted, and timed
    inside a ``timed_launches()`` block."""
    stream = torch.cuda.current_stream(device)
    if _timed is not None:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record(stream)
    call(b, stream)
    if _timed is not None:
        end.record(stream)
        _timed.append((b.kernel, start, end, b.sizes))
    count(b)


def timing() -> bool:
    """Whether a ``timed_launches()`` block is open."""
    return _timed is not None


def launch(kernel: str, dtype, device, *args, library: str | None = None,
           tier: int | None = None):
    """Call ``dpilqr_<kernel>_<f32|f64>(*args, stream)`` on the current
    stream of ``device``; tensors among ``args`` pass as pointers.
    ``library``: what ``require_kernel_models`` returned (None: the default
    library); ``tier`` as ``bind``'s."""
    run(bind(kernel, dtype, *args, library=library, tier=tier), device)
