"""Runs of the harness on the CPU, at tiny rings of both kinds: a sound
run is correct; the control (the reference in float64 in the program's
place) and each fault a cell can have, planted under the timed path, come
out not correct; without a card the command exits non-zero and prints
nothing.  The fault a cell on four chips could have, the exchange between
chips left out, has no cell here: every cell runs on one chip."""

from __future__ import annotations

import os
import subprocess
import sys

import pytest
import torch

from bench_tiny import ROOT, run_cpu, tiny_root

from lol_tpu_torch import she_batched
from lol_tpu_torch.ops.cuda import ntt_kernel

CELLS = ("bgv_step.m32768", "bgv_step.m18432", "ntt.m32768")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("tiny"))


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_a_sound_run_is_correct(root, cell, trace):
    res = run_cpu(root, cell, trace=trace)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] > 0
    assert res["checks"] == {"words_wrong": {"value": 0, "limit": 0},
                             "answers_unchecked": {"value": 0, "limit": 0}}
    if trace:  # the CPU has no device trace: every reader finds nothing to read
        assert res["metrics"] == {} and res["busy_s"] == 0
    else:
        assert set(res["metrics"]) >= {"setup_s", "batch_ms_p95"}


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(root, cell):
    res = run_cpu(root, cell, system="control")
    assert not res["correct"] and res["checks"]["words_wrong"]["value"] > 0


def _step_fault(fault):
    forward = she_batched.BGVStep.forward

    def broken(self, c0, c1, d0, d1):
        if fault == "unchanged":  # the state handed back as it came
            return c0[:-1], c1[:-1]
        B = c0.shape[-1]
        if fault == "half":  # half of the batch left out
            half = forward(self, *(t[..., :B // 2].contiguous() for t in (c0, c1, d0, d1)))
            return tuple(torch.cat([h, torch.zeros_like(h)], dim=-1) for h in half)
        out = forward(self, c0, c1, d0, d1)  # one word of the answer altered
        out[0][0, 0, 0] = (out[0][0, 0, 0] + 1) % self.bb.qs[0]
        return out
    return broken


def _ntt_fault(fault):
    ntt_cm = ntt_kernel.ntt_cm

    def broken(x, plan, inverse=False, **kw):
        if fault == "unchanged":
            return x.clone()
        B = x.shape[1]
        if fault == "half":
            y = ntt_cm(x[:, :B // 2].contiguous(), plan, inverse, **kw)
            return torch.cat([y, torch.zeros_like(y)], dim=1)
        y = ntt_cm(x, plan, inverse, **kw)
        y[0, 0] = (y[0, 0] + 1) % plan.q
        return y
    return broken


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_a_planted_fault_is_not_correct(root, cell, fault, monkeypatch):
    if cell.startswith("bgv_step"):
        monkeypatch.setattr(she_batched.BGVStep, "forward", _step_fault(fault))
    else:
        monkeypatch.setattr(ntt_kernel, "ntt_cm", _ntt_fault(fault))
    res = run_cpu(root, cell)
    assert not res["correct"] and res["failed"] > 0
    assert res["checks"]["words_wrong"]["value"] > 0


def test_without_a_card_the_command_exits_non_zero():
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", CELLS[0],
                          "--seed", str(2 ** 31 + 1), "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
    assert "needs 1 CUDA device" in out.stderr
