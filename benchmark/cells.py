"""Everything of a cell, found by name: its entry in BENCHMARK.json, its
configuration (`configs/<config>.json`), its traffic mix
(`traffic/<traffic>.json`), the kind of request the mix names
(`kinds/<kind>.py`), and the metrics the cell reports, each a file of its
own (`e2e/<name>.py`, `metrics/<name>.py`; see `metric_file`).  A later
change adds a configuration, a mix or a metric as new files and entries."""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType

ROOT = Path(__file__).resolve().parents[1]


def load_module(path: Path) -> ModuleType:
    """The Python file at path as a module (metric names hold dots)."""
    name = "_".join(path.with_suffix("").parts[-2:]).replace(".", "_")
    spec = importlib.util.spec_from_file_location("benchmark_" + name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_file(folder: Path, name: str) -> Path:
    """folder/<name>.py; for a metric split by the end-to-end metric it
    moves (`device_idle_pct.step`, `device_idle_pct.ntt`), where the split
    has no file of its own, the file of the quantity before the last dot
    (`device_idle_pct.py`)."""
    parts = name.split(".")
    for i in range(len(parts), 1, -1):
        path = folder / (".".join(parts[:i]) + ".py")
        if path.exists():
            return path
    return folder / f"{parts[0]}.py"


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: dict, cell: str, e2e_names: set[str]) -> bool:
    """Whether a metric of BENCHMARK.json is read in this cell: its
    `workloads` name the cell, or it has none and (per-layer) the
    metric it moves is read there."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in e2e_names


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    kind: ModuleType
    e2e: dict  # name -> (unit, module)
    per_layer: dict  # name -> (unit, module)


def cell(name: str, root: Path = ROOT) -> Cell:
    """The cell `name` of root/BENCHMARK.json, its files under
    root/benchmark."""
    bench = read_json(root / "BENCHMARK.json")
    here = root / "benchmark"
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cfg = next(c for c in bench["configs"] if c["name"] == entry["config"])
    mix = read_json(here / "traffic" / f"{entry['traffic']}.json")
    e2e = {m["name"]: (m["unit"], load_module(metric_file(here / "e2e", m["name"])))
           for m in bench["end_to_end"] if _reports(m, name, set())}
    per_layer = {m["name"]: (m["unit"], load_module(metric_file(here / "metrics", m["name"])))
                 for m in bench["per_layer"] if _reports(m, name, set(e2e))}
    return Cell(name, entry["chips"], read_json(root / cfg["file"]), mix,
                load_module(here / "kinds" / f"{mix['kind']}.py"), e2e, per_layer)
