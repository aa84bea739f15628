"""BENCHMARK.json's form (its keys, names, units, bounds and sizes), and
every file of a cell found by its name, in this checkout and in a copy
that a later change extends with new files only."""

from __future__ import annotations

import hashlib
import json
import re

import pytest

from bench_tiny import ROOT, copy_benchmark, primes

from benchmark import cells

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def _line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_keys_names_and_bounds():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["paths"]) <= 16 and all(PATH.match(p) for p in BENCH["paths"])
    assert len(BENCH["command"]) <= 32 and all(_line(w) for w in BENCH["command"])
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith(tuple(p + "/" for p in BENCH["paths"]))
        assert len(c["reduced"]) <= 16
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert all(NAME.match(w[k]) for k in ("name", "config", "traffic"))
        assert w["chips"] in (1, 4) and _line(w["why"])
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                                                     "higher")
        assert set(m["workloads"]) <= set(CELLS) if "workloads" in m else True
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert _line(m["layer"]) and m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    for group in (BENCH["configs"], BENCH["workloads"], metrics):
        assert len({x["name"] for x in group}) == len(group)
    assert len({(w["config"], w["traffic"]) for w in BENCH["workloads"]}) == len(CELLS)
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(CELLS) // 4)
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_loads_by_name(name):
    """Its configuration, mix, kind and metric files; setup_s, another
    end-to-end metric and a per-layer metric, each moving one it reports."""
    c = cells.cell(name)
    assert "setup_s" in c.e2e and len(c.e2e) >= 2 and c.per_layer
    for unit, mod in c.e2e.values():
        assert callable(mod.value)
    moves = {m["name"]: m["moves"] for m in BENCH["per_layer"]}
    for metric, (unit, mod) in c.per_layer.items():
        assert callable(mod.read) and moves[metric] in c.e2e
    assert hasattr(c.kind, "Kind") and {"kind", "batch", "inflight", "pool"} <= set(c.mix)


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_configs_state_their_ring(cfg):
    """A configuration's file is its entry's, with the published chain:
    the three largest 30-bit primes = 1 mod m."""
    data = json.loads((ROOT / cfg["file"]).read_text())
    assert data["name"] == cfg["name"] and data["source"] == cfg["source"]
    assert data["reduced"] == cfg["reduced"] == []
    assert data["qs"] == primes(data["m"])
    assert data["gadget"] == "rns" and data["encoding"] == "lsd"


def _digest(root) -> dict:
    return {p.relative_to(root).as_posix(): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "benchmark").rglob("*")) if p.is_file()}


def test_new_files_are_found_without_editing_any(tmp_path):
    """A later change adds a configuration, a mix, a per-layer metric and a
    cell as files and entries; every file already there stays as it is."""
    root = copy_benchmark(tmp_path)
    before = _digest(root)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cfg = json.loads((root / "benchmark/configs/bgv_m32768.json").read_text())
    cfg.update(name="bgv_m8192", m=8192, n=4096, qs=primes(8192, 2))
    (root / "benchmark/configs/bgv_m8192.json").write_text(json.dumps(cfg))
    mix = json.loads((root / "benchmark/traffic/ntt_b4096.json").read_text())
    mix["batch"] = 16384
    (root / "benchmark/traffic/ntt_b16384.json").write_text(json.dumps(mix))
    (root / "benchmark/metrics/device_busy_ms.py").write_text(
        "def read(tr):\n    return tr.busy_us() / 1e3 if tr.device else None\n")
    bench["configs"].append({"name": "bgv_m8192", "source": "x", "why": "x", "reduced": [],
                             "file": "benchmark/configs/bgv_m8192.json"})
    bench["workloads"].append({"name": "ntt.m8192", "config": "bgv_m8192",
                               "traffic": "ntt_b16384", "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "device_busy_ms", "unit": "ms", "better": "lower",
                               "source": "device_trace", "layer": "device",
                               "moves": "ntt_per_s", "workloads": ["ntt.m8192"]})
    next(m for m in bench["end_to_end"] if m["name"] == "ntt_per_s")["workloads"].append(
        "ntt.m8192")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    c = cells.cell("ntt.m8192", root)
    assert c.config["m"] == 8192 and c.mix["batch"] == 16384
    assert "device_busy_ms" in c.per_layer and "ntt_per_s" in c.e2e
    after = _digest(root)
    assert all(after[k] == v for k, v in before.items())


def test_a_split_metric_reads_its_quantitys_file(tmp_path):
    """device_idle_pct.step and .ntt share metrics/device_idle_pct.py; a
    split given a file of its own later reads that one."""
    metrics = copy_benchmark(tmp_path) / "benchmark" / "metrics"
    for name in ("device_idle_pct.step", "device_idle_pct.ntt"):
        assert cells.metric_file(metrics, name) == metrics / "device_idle_pct.py"
    (metrics / "device_idle_pct.ntt.py").write_text("def read(tr):\n    return None\n")
    assert cells.metric_file(metrics, "device_idle_pct.ntt") == metrics / "device_idle_pct.ntt.py"
    assert cells.metric_file(metrics, "launches_per_batch") == metrics / "launches_per_batch.py"
