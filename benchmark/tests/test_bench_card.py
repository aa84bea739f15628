"""The harness on the card, at tiny rings: sound runs are correct, the
control is not, and the command in a directory that holds only
BENCHMARK.json and the benchmark exits non-zero and prints nothing.

Marked `cuda`: every test takes the `cuda` fixture, which skips without a
CUDA device.  On a machine with an H100 and nvcc, from the repository's
root: `python -m pytest benchmark/tests -q -m cuda`.
"""

from __future__ import annotations

import subprocess
import sys
import time

import pytest
import torch

from bench_tiny import copy_benchmark, tiny_root

from benchmark import cells, run

pytestmark = pytest.mark.cuda
CELLS = ("bgv_step.m32768", "bgv_step.m18432", "ntt.m32768")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the program's kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("system", ["program", "control"])
def test_runs_on_the_card(cuda, tmp_path, cell, system):
    root = tiny_root(tmp_path, batch=64)
    for trace in (False, True):
        res = run.run(cells.cell(cell, root), 2 ** 31 + 3, 0.5, trace, cuda, system=system,
                      t_start=time.perf_counter())
        assert res["correct"] == (system == "program")
        if trace and system == "program":
            assert res["busy_s"] > 0 and "launches_per_batch" in res["metrics"]


def test_without_the_program_the_command_fails(cuda, tmp_path):
    root = copy_benchmark(tmp_path)
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", CELLS[2],
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=root,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode != 0 and out.stdout == ""
