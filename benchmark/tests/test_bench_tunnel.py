"""The ring-tunnel cell `tunnel.m32768` at its tiny ring (m = 64 -> 32,
E = S): a sound run is correct, traced and untraced; the control and each
fault planted in `Tunnel.forward` are not; the reference's hint is a
real one (a message encrypted under s_R, tunnelled and decrypted under
s_S gives L(message) mod p); and the tunnel's metrics read the
program's spans from hand-made Traces.  On the card (`-m cuda`), the
sound and the control runs at batch 64."""

from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from bench_tiny import ROOT, primes, run_cpu, tiny_root

from benchmark import cells, roofline, run, spans, tracing
from benchmark.cells import load_module, metric_file
from benchmark.reference import ring as ref_ring, tunnel as ref_tunnel
from lol_tpu_torch import linear, prng, she, she_batched
from lol_tpu_torch.she_batched import BatchedBGV

CELL = "tunnel.m32768"
METRICS = ROOT / "benchmark" / "metrics"


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("tiny"))


@pytest.mark.parametrize("trace", [False, True])
def test_a_sound_run_is_correct(root, trace):
    res = run_cpu(root, CELL, trace=trace)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] > 0
    assert res["checks"] == {"words_wrong": {"value": 0, "limit": 0},
                             "answers_unchecked": {"value": 0, "limit": 0}}
    if trace:  # the CPU has no device trace: every reader finds nothing to read
        assert res["metrics"] == {} and res["busy_s"] == 0
    else:
        assert set(res["metrics"]) == {"ct_per_s", "batch_ms_p95", "setup_s"}


def test_the_control_is_not_correct(root):
    res = run_cpu(root, CELL, system="control")
    assert not res["correct"] and res["checks"]["words_wrong"]["value"] > 0


def _fault(fault):
    forward = she_batched.Tunnel.forward

    def broken(self, c0, c1):
        if fault == "unchanged":  # the input handed back as it came
            return c0, c1
        B = c0.shape[-1]
        if fault == "half":  # half of the batch left out
            half = forward(self, *(t[..., :B // 2].contiguous() for t in (c0, c1)))
            return tuple(torch.cat([h, torch.zeros_like(h)], dim=-1) for h in half)
        out = forward(self, c0, c1)  # one word of the answer altered
        out[1][0, 0, 0] = (out[1][0, 0, 0] + 1) % self.bb.qs[0]
        return out
    return broken


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_a_planted_fault_is_not_correct(root, fault, monkeypatch):
    monkeypatch.setattr(she_batched.Tunnel, "forward", _fault(fault))
    res = run_cpu(root, CELL)
    assert not res["correct"] and res["failed"] > 0
    assert res["checks"]["words_wrong"]["value"] > 0


@pytest.mark.parametrize("ys_kind", ["descent", "random"])
def test_the_reference_hint_decrypts_to_the_map(ys_kind):
    m_r, m_s, p, B = 64, 32, 257, 4
    qs = tuple(primes(m_r))
    ring_r, ring_s = ref_ring.Ring(m_r, qs, "cpu"), ref_ring.Ring(m_s, qs, "cpu")
    g = torch.Generator().manual_seed(3)
    ys = torch.zeros((2, ring_s.n), dtype=torch.int64)
    if ys_kind == "descent":
        ys[0, 0] = 1
    else:
        ys = torch.randint(-2, 3, (2, ring_s.n), generator=g)
    lmap = ref_tunnel.Map(m_s, ring_r, ring_s, ys)
    s_r = torch.randint(-1, 2, (ring_r.n,), generator=g)
    s_s = torch.randint(-1, 2, (ring_s.n,), generator=g)
    a = torch.stack([torch.randint(0, q, (2, 3, ring_s.n), generator=g) for q in qs], dim=2)
    e = torch.normal(0.0, 2.0 ** 0.5, (2, 3, ring_s.n), generator=g).round().long()
    h0, h1 = ref_tunnel.tunnel_hint(lmap, p, s_r, s_s, a, e)
    pr, ps = (she.SHEParams(m=m, p=p, qs=qs, var=2.0) for m in (m_r, m_s))
    msgs = torch.randint(0, p, (ring_r.n, B), generator=g)
    c0, c1 = BatchedBGV(pr, "cpu").build_encrypt(she.SK(pr, s_r, 2.0))(msgs, prng.PRNGKey(9))
    out = ref_tunnel.tunnel(lmap, c0, c1, h0, h1)
    got = BatchedBGV(ps, "cpu").build_decrypt(she.SK(ps, s_s, 2.0))(*out)
    lin = linear.linear_pow(ps.ctx, pr.ctx, ps.ctx, list(ys.numpy()))
    for b in range(B):
        np.testing.assert_array_equal(got[:, b].numpy(),
                                      linear.eval_lin_ints(lin, msgs[:, b].numpy(), p))


# one tunnel call on the host (us on the trace's clock): id, name, parent, start, end, counters
T0 = 1_700_000_000_000_000  # the trace's zero on the records' clock, us
SPANS = [
    (1, "tunnel", None, 20, 100, {}),
    (2, "tunnel.intt", 1, 21, 30, {}),
    (3, "tunnel.forward", 1, 31, 50, {}),
    (4, "tunnel.inner", 1, 51, 60, {"glue_io_bytes": 1000}),
    (5, "tunnel.forward", 1, 61, 70, {}),
    (6, "tunnel.inner", 1, 71, 99, {"glue_io_bytes": 3000}),
]
HOST = [("cudaStreamQuery", 10.0, 12.0),  # the anchor's
        ("cudaLaunchKernel", 22.0, 23.0), ("cudaLaunchKernelExC", 25.0, 26.0),
        ("cudaLaunchKernelExC", 35.0, 36.0), ("cudaLaunchKernel", 45.0, 46.0),
        ("cudaLaunchKernel", 55.0, 56.0), ("cudaLaunchKernelExC", 65.0, 66.0),
        ("cudaLaunchKernel", 75.0, 76.0), ("cudaMemcpyAsync", 80.0, 81.0),
        ("cudaLaunchKernel", 110.0, 111.0)]
DEVICE = [("inv", 24.0, 30.0), ("inv", 30.0, 36.0), ("fwd", 37.0, 40.0), ("cat", 47.0, 48.0),
          ("mul", 57.0, 61.0), ("fwd", 67.0, 70.0), ("rem", 77.0, 82.0),
          ("Memcpy DtoD (Device -> Device)", 83.0, 85.0), ("loose", 112.0, 113.0)]
ANCHOR = ((T0 + 9) * 1000, (T0 + 13) * 1000)  # ns, around [10, 12]
WORK = [("ntt_inv_gs", 16384, 1024)] * 6 + [("ntt_fwd", 8192, 1024)] * 24


def _records():
    return [SimpleNamespace(name=n, id=i, parent=p, start_ns=(T0 + s) * 1000,
                            end_ns=(T0 + e) * 1000, counters=dict(c))
            for i, n, p, s, e, c in SPANS]


@pytest.fixture
def program(monkeypatch):
    """The program's records stood in for, as in test_bench_spans."""
    state = SimpleNamespace(taken=(_records(), ANCHOR, 0))

    def taken():
        out = state.taken
        if out is not None:
            state.taken = ([], None, 0)
        return out

    monkeypatch.setattr(spans, "program_records", taken)
    monkeypatch.setattr(spans, "_last", [None, None])
    return state


BOUND_US = 1e3 * sum(roofline.bound(*roofline.work(*w))[0] for w in WORK)
EXPECTED = {  # two batches
    "tunnel_intt_ms_per_batch": 12e-3 / 2, "tunnel_forward_ms_per_batch": 7e-3 / 2,
    "tunnel_inner_ms_per_batch": 11e-3 / 2, "tunnel_ntt_roofline": 100 * BOUND_US / 19,
    "glue_io_bytes_per_batch": 2000}


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_each_tunnel_metric_reads_the_program(name, program):
    read = load_module(metric_file(METRICS, name)).read
    tr = lambda: tracing.Trace(list(DEVICE), list(HOST), 2, list(WORK))  # noqa: E731
    assert read(tr()) == pytest.approx(EXPECTED[name])
    assert spans.attribution(spans._last[0]).outside("tunnel") == 1  # the kernel at 110
    assert read(tr()) is None  # the records went with the first Trace
    program.taken = None  # a program without the span module
    assert read(tr()) is None
    program.taken = ([r for r in _records() if r.name == "tunnel"], ANCHOR, 0)
    assert read(tr()) is None


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the program's kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("system", ["program", "control"])
def test_runs_on_the_card(cuda, tmp_path, system):
    root = tiny_root(tmp_path, batch=64)
    for trace in (False, True):
        res = run.run(cells.cell(CELL, root), 2 ** 31 + 5, 0.5, trace, cuda, system=system,
                      t_start=time.perf_counter())
        assert res["correct"] == (system == "program")
        if trace and system == "program":
            assert res["busy_s"] > 0 and "launches_per_batch" in res["metrics"]
    if system == "program":  # the spans in a fresh process, as test_bench_spans reads them
        out = subprocess.run([sys.executable, "-c",
                              f"import test_bench_tunnel as t; t.on_the_card({str(root)!r})"],
                             cwd=Path(__file__).parent, capture_output=True, text=True,
                             timeout=900)
        print(out.stdout)
        assert out.returncode == 0, out.stderr[-4000:]


def on_the_card(root: str) -> None:
    """One traced run of the tiny cell: every device operation lies under
    a `tunnel` span, each tunnel metric reads, and the glue bytes are the
    formula.  In a process that ran other profiles before, the profiler
    was seen to drop the device records of the session's first launches,
    which no pairing by order can place."""
    res = run.run(cells.cell(CELL, Path(root)), 2 ** 31 + 5, 0.5, True,
                  torch.device("cuda", 0), t_start=time.perf_counter())
    a = spans._last[1]
    assert res["correct"] and a is not None and a.outside("tunnel") == 0
    assert set(EXPECTED) <= set(res["metrics"])
    # (d (1 + nrns) + 2) int32 stacks of (nrns, n_s = 16, 64)
    assert res["metrics"]["glue_io_bytes_per_batch"]["value"] == 10 * 3 * 16 * 64 * 4
    print({k: v["value"] for k, v in res["metrics"].items()})
