"""Find a cell's pieces by name: ``BENCHMARK.json`` at the root of the
checkout, the configuration's file it names, ``traffic/<mix>.json``, the
generator of the mix's ``kind`` in ``kinds/<kind>.py`` and every metric's
reader in ``metrics/<metric>.py``.  A new configuration, mix, kind or metric
is a new file; nothing here names one."""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent.parent


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list  # this cell's end-to-end metric entries
    per_layer: list  # this cell's per-layer metric entries
    root: Path  # the checkout whose BENCHMARK.json names the cell

    @property
    def bench_dir(self) -> Path:
        return self.root / "perfbench"


def load_module(path: Path, name: str):
    if not path.exists():
        raise FileNotFoundError(f"no module at {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _reports(entry: dict, cell: str, reported: set) -> bool:
    """Whether ``cell`` reports a metric: it is listed under the metric's
    ``workloads``, or the metric lists none and the cell reports the
    end-to-end metric it moves (every cell, for an end-to-end metric)."""
    if "workloads" in entry:
        return cell in entry["workloads"]
    return entry["moves"] in reported if "moves" in entry else True


def find_cell(name: str, root: Path = ROOT) -> Cell:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    traffic = json.loads((root / "perfbench" / "traffic" / f"{w['traffic']}.json").read_text())
    e2e = [m for m in bench["end_to_end"] if _reports(m, name, set())]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _reports(m, name, reported)]
    return Cell(name=name, chips=int(w["chips"]), config=config, traffic=traffic,
                end_to_end=e2e, per_layer=per_layer, root=root)


def kind_module(cell: Cell):
    kind = cell.traffic["kind"]
    return load_module(cell.bench_dir / "kinds" / f"{kind}.py", f"perfbench_kind_{kind}")


def metric_reader(cell: Cell, name: str):
    return load_module(cell.bench_dir / "metrics" / f"{name}.py",
                       "perfbench_metric_" + name.replace(".", "_").replace("-", "_"))
