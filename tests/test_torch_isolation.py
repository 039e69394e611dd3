"""The PyTorch port stands alone: it never imports JAX or the JAX package,
and importing it (kernel wrappers, facade and host utilities included)
builds nothing, needs no CUDA toolchain and pulls in neither sympy nor the
plotting libraries -- the kernels, the plan library and the native host
library compile on first use, sympy and matplotlib load where they are
used."""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "dpilqr_tpu_torch"

_PROBE = """
import sys
import dpilqr_tpu_torch
import dpilqr_tpu_torch.api
import dpilqr_tpu_torch.native.host as host
import dpilqr_tpu_torch.ops.batched
import dpilqr_tpu_torch.ops.codegen
import dpilqr_tpu_torch.ops.cuda_build as cb
import dpilqr_tpu_torch.ops.ilqr
import dpilqr_tpu_torch.ops.pscan
import dpilqr_tpu_torch.ops.sweeps
import dpilqr_tpu_torch.parallel.deadline
import dpilqr_tpu_torch.parallel.mesh
import dpilqr_tpu_torch.parallel.rhc
import dpilqr_tpu_torch.utils.checkpoint
import dpilqr_tpu_torch.utils.metrics
import dpilqr_tpu_torch.utils.profiling
import dpilqr_tpu_torch.utils.rate
import dpilqr_tpu_torch.utils.sol
import dpilqr_tpu_torch.utils.viz
import bench_torch
import chip_smoke
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "dpilqr_tpu", "sympy", "matplotlib",
                                       "networkx"))
assert not leaked, leaked
assert cb.load_library.cache_info().currsize == 0
assert cb.plan_library.cache_info().currsize == 0
assert host._lib is None and host._build_error is None  # no g++ run
print("ok")
"""


def test_import_leaves_jax_out_and_needs_no_nvcc(tmp_path):
    env = dict(os.environ)
    # No CUDA toolchain reachable: the import must not look for one.
    env["PATH"] = str(Path(sys.executable).parent)
    env["CUDA_HOME"] = str(tmp_path / "no_cuda")
    env["PYTHONPATH"] = str(REPO)
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


# The port's programs outside the package: its bench, its smoke and its
# scripts (the bench's two CLIs among them).
PROGRAMS = (REPO / "bench_torch.py", REPO / "chip_smoke.py",
            *sorted((REPO / "scripts").glob("torch_*.py")))


def test_sources_import_no_jax():
    pat = re.compile(r"^\s*(import|from) (jax|dpilqr_tpu)\b")
    offenders = [
        f"{p.relative_to(REPO)}:{i}"
        for p in (*sorted(PKG.rglob("*.py")), *PROGRAMS)
        for i, line in enumerate(p.read_text().splitlines(), 1)
        if pat.match(line)
    ]
    assert not offenders, offenders
    names = {p.name for p in PROGRAMS}
    assert {"torch_bench_rhc.py", "torch_bench_warmstart.py"} <= names


KERNEL_SOURCES = {
    # No Pallas kernel: the accept step XLA fuses into the batched iteration.
    "accept_batched.cu": "dpilqr_tpu/ops/pallas_batched.py :: batched_iteration",
    "backward_batched.cu": "dpilqr_tpu/ops/pallas_batched.py :: backward_pass_batched",
    "forward_batched.cu": "dpilqr_tpu/ops/pallas_batched.py :: forward_pass_batched",
    "backward_batched_wide.cu":
        "dpilqr_tpu/ops/pallas_batched_wide.py :: backward_pass_batched_wide",
    "backward_sweep.cu": "dpilqr_tpu/ops/pallas_sweeps.py :: backward_pass_pallas",
    "forward_sweep.cu": "dpilqr_tpu/ops/pallas_sweeps.py :: forward_pass_pallas",
    "probe_fma.cu": "dpilqr_tpu/utils/sol.py :: measure_vpu_peak_gflops",
    "probe_hbm.cu": "dpilqr_tpu/utils/sol.py :: measure_hbm_stream_gbps",
    "probe_sin.cu": "dpilqr_tpu/utils/sol.py :: measure_vpu_transcendental_ops",
}


# The headers the sources share, and which source must include which.
KERNEL_HEADERS = {
    "computed_inputs.cuh": ("backward_batched.cu", "backward_batched_wide.cu",
                            "backward_sweep.cu", "derivatives_host.cpp"),
    "derivatives.cuh": ("computed_inputs.cuh",),
    "dynamics.cuh": ("rollout.cuh", "derivatives.cuh"),
    "launch.cuh": ("riccati.cuh", "rollout.cuh", "accept_batched.cu"),
    # The shared-memory plan: the kernels' headers, and plan.cpp, its host
    # build's exports.
    "plan.h": ("launch.cuh", "riccati.cuh", "computed_inputs.cuh", "riccati_cluster.cuh",
               "rollout.cuh", "plan.cpp"),
    "riccati.cuh": ("backward_batched.cu", "backward_batched_wide.cu", "backward_sweep.cu"),
    "riccati_cluster.cuh": ("backward_batched_wide.cu",),
    "rollout.cuh": ("forward_batched.cu", "forward_sweep.cu"),
}


@pytest.mark.parametrize("header", sorted(KERNEL_HEADERS))
def test_kernel_headers_are_listed_hashed_and_included(header):
    """Every header under csrc is one the table names (a new one must be
    added here), is part of the build's source hash, and is included by the
    files that share it; no source includes a header that is not there,
    but for the one a custom-model build generates (``ops.codegen``)."""
    import dpilqr_tpu_torch.ops.cuda_build as cb

    csrc = PKG / "csrc"
    assert {p.name for p in (*csrc.glob("*.cuh"), *csrc.glob("*.h"))} == set(KERNEL_HEADERS)
    assert csrc / header in cb.sources()
    for user in KERNEL_HEADERS[header]:
        assert f'#include "{header}"' in (csrc / user).read_text(), (user, header)
    for src in (*cb.sources(), *csrc.glob("*.cpp")):
        for inc in re.findall(r'#include "([^"]+)"', src.read_text()):
            assert (csrc / inc).exists() or inc == cb.HEADER_NAME, (src.name, inc)


@pytest.mark.parametrize("name", sorted(KERNEL_SOURCES))
def test_kernel_sources_name_the_tpu_kernel_they_replace(name):
    text = (PKG / "csrc" / name).read_text()
    # The header comment as one line of words.
    head = " ".join(line.lstrip("/").strip() for line in text[:3000].splitlines())
    assert KERNEL_SOURCES[name] in head
    assert "What bounds it on the H100" in head
    assert "__global__" in text and 'extern "C"' in text


def test_every_kernel_source_is_built_and_bound():
    """Each .cu source has its C entry points (one per dtype the kernel
    names) in the build's signature table, so the library loads every
    kernel; every entry point the table names is defined in its source."""
    import dpilqr_tpu_torch.ops.cuda_build as cb

    names = {p.name for p in (PKG / "csrc").glob("*.cu")}
    assert names == set(KERNEL_SOURCES) == {f"{k}.cu" for k in cb._SIGNATURES}
    assert set(cb.launch_counts) == set(cb._SIGNATURES) == set(cb._DTYPES)
    for base, suffixes in cb._DTYPES.items():
        text = (PKG / "csrc" / f"{base}.cu").read_text()
        defined = set(re.findall(rf"dpilqr_{base}_(f\d\d)\b", text))
        assert defined == set(suffixes), (base, defined)
