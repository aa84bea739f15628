"""Helpers of the benchmark's tests: a copy of the benchmark with its
cells cut to a size a CPU test holds, and runs of it on the CPU."""

from __future__ import annotations

import json
import shutil
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from benchmark import cells, run  # noqa: E402
from benchmark.reference import ring as ref_ring  # noqa: E402

TINY_M = {"bgv_m32768": 64, "bgv_m18432": 72}  # same kind of ring: 2-power, 2^a 3^2
TINY_BATCH = 8


def primes(m: int, count: int = 3) -> list[int]:
    """The largest 30-bit primes = 1 mod m."""
    out, q = [], (1 << 30) - 1 - ((1 << 30) - 2) % m
    while len(out) < count:
        if ref_ring.factorize(q) == [(q, 1)]:
            out.append(q)
        q -= m
    return out


def copy_benchmark(dest: Path) -> Path:
    """A checkout of BENCHMARK.json and benchmark/ under dest."""
    shutil.copytree(ROOT / "benchmark", dest / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    shutil.copy(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    return dest


def tiny_root(dest: Path, batch: int = TINY_BATCH) -> Path:
    """copy_benchmark with every configuration at its tiny ring and every
    mix at `batch`."""
    root = copy_benchmark(dest)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        f = root / c["file"]
        cfg = json.loads(f.read_text())
        cfg["m"] = TINY_M[c["name"]]
        cfg["qs"] = primes(cfg["m"])
        f.write_text(json.dumps(cfg))
    for f in (root / "benchmark" / "traffic").glob("*.json"):
        mix = json.loads(f.read_text())
        mix["batch"] = batch
        f.write_text(json.dumps(mix))
    return root


def run_cpu(root: Path, cell: str, seed: int = 2 ** 31 + 7, seconds: float = 0.3,
            trace: bool = False, system: str = "program") -> dict:
    """One run of a cell of the copy at root, on the CPU: the harness
    without its look for a card."""
    return run.run(cells.cell(cell, root), seed, seconds, trace, torch.device("cpu"),
                   system=system, t_start=time.perf_counter())
