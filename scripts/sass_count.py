#!/usr/bin/env python3
"""Count the instructions of the ceiling probe K8's sine loop in its SASS.

K8 (``csrc/probe_sin.cu``) times the accurate ``sinf``; the one-instruction
bound its accounting gives it (``utils/sol.py`` ``published_bound``: one
FP32 issue slot a sine) is far below what that routine can reach.  This
script builds the kernels (``ops/cuda_build.py``), disassembles
``probe_sin_kernel`` with ``cuobjdump -sass``, takes the loop over
iterations (the backward branch that spans the most instructions: 16 sines
an iteration, unrolled) and, within it, the path the probe's arguments take:
each sine's large-argument reduction is a block that a predicated branch
jumps over to its BSYNC, and those blocks are left out.  It prints the
instructions of the loop and of that path, the path's count per sine, and
the least time of the timed probe (``sol.PROBE_SHAPE``, ``sol.SIN_ITERS``)
if every instruction on it took one FP32 issue slot at the published rate
(67 TFLOP/s = 33.5 T slots/s): ``sol.SIN_LOOP_SASS`` holds that count.
The SASS of the function goes to the file ``--out`` names (default
``probe_sin.sass``).  Needs the CUDA toolkit (run on the card's machine,
from the repository root):

    python3 scripts/sass_count.py [--out probe_sin.sass]
"""

import argparse
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, os.getcwd())

from dpilqr_tpu_torch.ops import cuda_build  # noqa: E402
from dpilqr_tpu_torch.utils import sol  # noqa: E402

SINES_PER_ITERATION = 16
_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_BRA = re.compile(r"\bBRA\b.*?(0x[0-9a-f]+)")


def cuobjdump() -> str:
    nvcc = Path(cuda_build.find_nvcc())
    for cand in (nvcc.parent / "cuobjdump", shutil.which("cuobjdump")):
        if cand and Path(cand).exists():
            return str(cand)
    raise RuntimeError("cuobjdump not found beside nvcc or on PATH")


def function_sass(lib: Path, name: str) -> list[str]:
    """The SASS lines of the kernel whose mangled name contains ``name``."""
    out = subprocess.run([cuobjdump(), "-sass", str(lib)], capture_output=True,
                         text=True, check=True).stdout
    lines, inside = [], False
    for line in out.splitlines():
        if "Function :" in line:
            inside = name in line
            continue
        if inside:
            lines.append(line)
    if not lines:
        raise RuntimeError(f"no function named like {name!r} in {lib}")
    return lines


def loop_body(lines: list[str]) -> list[tuple[int, str]]:
    """The instructions between the target and the source of the backward
    branch that spans the most instructions."""
    insns = [(int(m.group(1), 16), m.group(2)) for m in map(_INSN.search, lines) if m]
    best = []
    for addr, text in insns:
        b = _BRA.search(text)
        if b and int(b.group(1), 16) < addr:
            body = [i for i in insns if int(b.group(1), 16) <= i[0] <= addr]
            best = body if len(body) > len(best) else best
    if not best:
        raise RuntimeError("no backward branch: the loop was not found")
    return best


def taken_path(body: list[tuple[int, str]]) -> list[tuple[int, str]]:
    """``body`` less the blocks a predicated branch jumps over to a BSYNC
    (the reductions of arguments past sinf's fast range)."""
    at = dict(body)
    skip = set()
    for addr, text in body:
        b = _BRA.search(text)
        if b and text.startswith("@"):
            target = int(b.group(1), 16)
            if target > addr and at.get(target, "").startswith("BSYNC"):
                skip.update(a for a, _ in body if addr < a < target)
    return [i for i in body if i[0] not in skip]


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default="probe_sin.sass")
    out = Path(parser.parse_args().out)
    lib, _ = cuda_build.build()
    lines = function_sass(lib, "probe_sin_kernel")
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text("\n".join(lines) + "\n")
    loop = loop_body(lines)
    body = taken_path(loop)
    n = len(body)
    per_sine = n / SINES_PER_ITERATION
    elements = sol.PROBE_SHAPE[0] * sol.PROBE_SHAPE[1]
    slots = elements * sol.SIN_ITERS * n
    bound_ms = slots / (sol.PUBLISHED_FP32_FLOPS / 2) * 1e3
    ops = {}
    for _, text in body:
        op = text.split()[0] if not text.startswith("@") else text.split()[1]
        ops[op.split(".")[0]] = ops.get(op.split(".")[0], 0) + 1
    print(f"probe_sin loop: {len(loop)} instructions; the path the probe's arguments "
          f"take: {n} instructions, {per_sine} a sine; by opcode "
          f"{dict(sorted(ops.items(), key=lambda kv: -kv[1]))}")
    print(f"bound of the timed probe at one FP32 issue slot an instruction: "
          f"{bound_ms:.5f} ms ({slots} slots)")


if __name__ == "__main__":
    main()
