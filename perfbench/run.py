"""Run one benchmark cell once and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell (``workloads`` in ``BENCHMARK.json`` at the root of the checkout)
names a configuration and a traffic mix; the harness builds the problem,
warms up the shapes the cell uses (that and everything before it is
``setup_s``), runs the mix for ``--seconds`` seconds on the card, reads the
peak device memory, then judges a seed-drawn sample of what the window
produced against the plain reference in ``reference/`` (``harness/check.py``).
With ``--trace 0`` the result carries the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, read by ``metrics/<name>.py`` from the
window and from one ``torch.profiler`` session over its first units.

The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``check``: every number compared beside its
limit); the last lines of standard error repeat the numbers compared.
Without a CUDA device (or with fewer than the cell asks for) it exits 2 and
prints no result; ``--rehearse`` runs the cell at the configuration's
rehearsal sizes on the CPU instead, for the benchmark's own tests.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# Caches at fixed paths inside the checkout (the program builds its kernels
# into dpilqr_tpu_torch/_build/ there itself).
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = str(ROOT / ".perfbench_cache" / sub)
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "dpilqr_tpu")
RESERVE_BYTES = 1 << 30


def parse_args(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--rehearse", action="store_true",
                    help="run at the rehearsal sizes on the CPU (the benchmark's tests)")
    return ap.parse_args(argv)


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


class NoDevice(RuntimeError):
    pass


def graph_cache() -> dict:
    """The program's cache of captured iterations (its own counter), for the
    log: a capture inside the window shows as a change here."""
    from dpilqr_tpu_torch.ops.batched import graph_cache_info

    info = graph_cache_info()
    return {k: info[k] for k in ("entries", "captured")}


def run_cell(args, root: Path = ROOT) -> dict:
    """The cell's run; returns the result object."""
    import torch

    from perfbench.harness import check, spec
    from perfbench.harness.problem import Problem
    from perfbench.harness.trace import Slice
    from perfbench.harness.window import Run

    cell = spec.find_cell(args.workload, root)
    if args.rehearse:
        device = torch.device("cpu")
    else:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            raise NoDevice(f"{args.workload} needs {cell.chips} CUDA device(s); torch finds "
                           f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    problem = Problem(cell.config, device, rehearse=args.rehearse)
    kind = spec.kind_module(cell).make(problem, cell.traffic, args.seed, args.rehearse)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    run = Run(kind=cell.traffic["kind"], problem=problem, traffic=cell.traffic)
    kind.warm_up()
    if device.type == "cuda":
        # Grow the caching allocator's pool once, as a long-running process
        # has, so that no cudaMalloc stalls the window's start (the check's
        # sample holds some solves' tensors alive).
        torch.empty(RESERVE_BYTES, dtype=torch.uint8, device=device).untyped_storage()
    sync()
    run.setup_s = time.perf_counter() - T_START
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    graphs0 = graph_cache()
    kind.window(run, args.seconds, Slice(device) if args.trace else None)
    sync()
    graphs1 = graph_cache()
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    bad = forbidden_modules()
    if bad:
        raise RuntimeError(f"modules of JAX or the JAX package were loaded: {bad}")
    verdict = check.judge(problem, kind.items, kind.plans, getattr(kind, "step_size", 1))
    run.plan_costs = verdict.plan_costs
    limits = cell.config["check"]["limits"]
    metrics, missing = {}, []
    for m in (cell.per_layer if args.trace else cell.end_to_end):
        value = spec.metric_reader(cell, m["name"]).read(run)
        if value is None:
            missing.append(m["name"])
            continue
        metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu",
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    out = {"correct": verdict.correct(limits), "attempted": run.attempted,
           "failed": run.failed, "metrics": metrics, "device": dev}
    if args.trace and run.trace is not None:
        dev["busy_s"] = run.trace.busy_us / 1e6
        dev["window_s"] = run.trace.window_us / 1e6
        out["breakdown"] = run.trace.breakdown()
    if missing:
        out["missing_metrics"] = missing
    print(f"perfbench: window {run.window_s:.3f} s, {run.units} units, {run.attempted} "
          f"attempted; iteration graphs before/after the window {graphs0} / {graphs1}",
          file=sys.stderr)
    out["check"] = {name: {"value": v, "limit": lim} for name, v, lim in verdict.lines(limits)}
    # The subproblem solves judged: at least one (a lower limit).
    out["check"]["lanes_judged"] = {"value": verdict.lanes, "min": 1}
    return out


def main(argv=None) -> int:
    args = parse_args(argv)
    try:
        out = run_cell(args)
    except NoDevice as e:
        print(f"perfbench: {e}", file=sys.stderr)
        return 2
    lines = [f"check {k} {v['value']!r} " + (f"limit {v['limit']!r}" if "limit" in v
                                                else f"min {v['min']!r}")
             for k, v in out["check"].items()]
    sys.stderr.write("\n".join(lines) + "\n")
    sys.stderr.flush()
    print(json.dumps(out))
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
