"""The program's spans laid over a traced run (`spans.py`) and the
metrics that read them, on hand-made Traces and records; on the card,
the order pairing against the profiler's own correlation ids."""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from bench_tiny import ROOT

from benchmark import spans, tracing
from benchmark.cells import load_module, metric_file

METRICS = ROOT / "benchmark" / "metrics"
T0 = 1_700_000_000_000_000  # the trace's zero on the records' clock, us

# two requests on the host (us on the trace's clock): id, name, parent, start, end, counters
SPANS = [
    (1, "bgv.step", None, 20, 100, {}),
    (2, "bgv.ct_mul", 1, 22, 40, {}),
    (3, "bgv.ks.intt", 1, 41, 45, {}),
    (4, "bgv.ks.digits", 1, 46, 49, {}),
    (5, "bgv.ks.inner", 1, 50, 90, {"glue_io_bytes": 1000}),
    (6, "crt.odd", 5, 60, 70, {}),
    (7, "bgv.step", None, 120, 200, {}),
    (8, "bgv.ks.inner", 7, 130, 190, {"glue_io_bytes": 3000}),
    (9, "bgv.rescale", 7, 192, 198, {"glue_io_bytes": 500}),
]
# launch calls and their device operations (start, duration)
HOST = [("cudaStreamQuery", 10.0, 12.0),  # the anchor's
        ("cudaLaunchKernel", 25.0, 26.0), ("cudaLaunchKernelExC", 55.0, 56.0),
        ("cudaLaunchKernel", 65.0, 66.0), ("cudaMemcpyAsync", 80.0, 81.0),
        ("cudaLaunchKernel", 110.0, 111.0), ("cuLaunchKernel", 140.0, 141.0),
        ("cudaMemsetAsync", 150.0, 151.0), ("cudaEventRecordWithFlags", 151.5, 152.0),
        ("cudaEventSynchronize", 152.0, 160.0)]
DEVICE = [("ct_mul", 30.0, 33.0), ("inner", 60.0, 64.0), ("odd", 70.0, 75.0),
          ("Memcpy DtoD (Device -> Device)", 85.0, 87.0), ("loose", 115.0, 121.0),
          ("inner", 145.0, 152.0), ("Memset (Device)", 155.0, 156.0)]
ANCHOR = ((T0 + 9) * 1000, (T0 + 13) * 1000)  # ns, around [10, 12]: zero in [T0 - 1, T0 + 1]


def records(shift_us: float = 0.0):
    return [SimpleNamespace(name=n, id=i, parent=p,
                            start_ns=T0 * 1000 + round((s + shift_us) * 1000),
                            end_ns=T0 * 1000 + round((e + shift_us) * 1000), counters=dict(c))
            for i, n, p, s, e, c in SPANS]


def trace(device=DEVICE, host=HOST, batches=2):
    return tracing.Trace(list(device), list(host), batches)


@pytest.fixture
def program(monkeypatch):
    """The program's records stood in for: set `.taken` to (records,
    anchor, dropped), or None for a program without the span module."""
    state = SimpleNamespace(taken=(records(), ANCHOR, 0), calls=0)

    def taken():
        state.calls += 1
        out = state.taken
        if out is not None:
            state.taken = ([], None, 0)  # the program's list emptied
        return out

    monkeypatch.setattr(spans, "program_records", taken)
    monkeypatch.setattr(spans, "_last", [None, None])
    return state


def test_the_anchor_sets_the_offset():
    zero = ((T0 - 1) * 1000, (T0 + 1) * 1000)
    assert spans.trace_zero(HOST, ANCHOR) == zero
    a = spans.attribute(trace(), records(), ANCHOR)
    assert a.zero_ns == zero
    assert [(s.start_us, s.end_us) for s in a.spans.values()] == [(s, e) for _, _, _, s, e, _
                                                                  in SPANS]
    # the anchor is the first cudaStreamQuery, wherever the list has it
    late = HOST[1:] + [("cudaStreamQuery", 300.0, 301.0), HOST[0]]
    assert spans.trace_zero(late, ANCHOR) == zero
    assert spans.trace_zero(HOST, None) is None and spans.trace_zero(HOST[1:], ANCHOR) is None
    # a call longer than the anchor's bracket: the clocks disagree
    assert spans.trace_zero([("cudaStreamQuery", 8.0, 16.0)], ANCHOR) is None


def test_order_pairing_by_kind():
    pairs = spans.pair(DEVICE, HOST)
    got = sorted((op[1], call[0], call[1]) for op, call in pairs)
    assert got == [(30.0, "cudaLaunchKernel", 25.0), (60.0, "cudaLaunchKernelExC", 55.0),
                   (70.0, "cudaLaunchKernel", 65.0), (85.0, "cudaMemcpyAsync", 80.0),
                   (115.0, "cudaLaunchKernel", 110.0), (145.0, "cuLaunchKernel", 140.0),
                   (155.0, "cudaMemsetAsync", 150.0)]


@pytest.mark.parametrize("drop", ["cudaLaunchKernelExC", "cudaMemcpyAsync", "cudaMemsetAsync"])
def test_a_count_mismatch_gives_none(drop, program):
    host = [h for h in HOST if h[0] != drop]
    assert spans.pair(DEVICE, host) is None
    assert spans.attribute(trace(host=host), records(), ANCHOR) is None
    assert load_module(metric_file(METRICS, "ct_mul_ms_per_batch")).read(trace(host=host)) is None


def test_nested_inclusive_sums():
    a = spans.attribute(trace(), records(), ANCHOR)
    assert a.device_us("bgv.ct_mul") == 3
    assert a.device_us("crt.odd") == 5
    assert a.device_us("bgv.ks.inner") == (4 + 5 + 2) + (7 + 1)  # crt.odd's kernel included
    assert a.device_us("bgv.step") == 3 + 4 + 5 + 2 + 7 + 1  # each op once
    assert a.device_us("bgv.ks.intt") == 0 and a.outside() == 1  # the kernel at 110
    assert a.counter("glue_io_bytes") == 4500


def test_a_small_clock_error_moves_nothing():
    """Records 3 us late against the anchor: every launch keeps its span."""
    a = spans.attribute(trace(), records(shift_us=3.0), ((T0 + 12) * 1000, (T0 + 16) * 1000))
    assert a.device_us("bgv.ks.inner") == 19 and a.outside() == 1


def test_the_spans_device_ranges_are_not_operations():
    """A profile that records the host adds each span's own device-side
    range (a user annotation, named as the span); they pair with no call."""
    device = DEVICE + [("bgv.step", 30.0, 87.0), ("bgv.ks.inner", 60.0, 87.0)]
    a = spans.attribute(trace(device=device), records(), ANCHOR)
    assert a is not None and a.device_us("bgv.step") == 22


def test_issue_idle_against_a_hand_count(program):
    tr = trace()
    # busy [30,33] [60,64] [70,75] [85,87] [115,121] [145,152] [155,156], span 126 us;
    # the gaps inside bgv.step [20,100] or [120,200]: 27 + 6 + 10 + 13 (of 28) + 24 + 3
    assert spans.issue_idle_pct(tr) == pytest.approx(100 * 83 / 126)
    read = load_module(metric_file(METRICS, "issue_idle_pct.step")).read
    assert read(tr) == pytest.approx(100 * 83 / 126)


def test_gaps_by_span(program):
    got = spans.gaps_by_span(trace(), top=4)
    assert [name for name, _ in got] == ["no span", "bgv.ks.digits", "bgv.ks.inner",
                                         "bgv.ks.inner"]  # each named at its middle
    assert [s for _, s in got] == pytest.approx([28e-6, 27e-6, 24e-6, 10e-6])


EXPECTED = {"ct_mul_ms_per_batch": 3e-3 / 2, "intt_ms_per_batch": 0.0,
            "digits_ms_per_batch": 0.0, "inner_product_ms_per_batch": 19e-3 / 2,
            "rescale_ms_per_batch": 0.0, "odd_axis_ms_per_batch": 5e-3 / 2,
            "glue_io_bytes_per_batch": 2250, "issue_idle_pct.step": 100 * 83 / 126}


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_each_metric_reads_the_program(name, program):
    read = load_module(metric_file(METRICS, name)).read
    tr = trace()
    assert read(tr) == pytest.approx(EXPECTED[name])
    assert read(tr) == pytest.approx(EXPECTED[name]) and program.calls == 1  # taken once a Trace
    assert read(trace()) is None  # the records went with the first Trace
    assert read(trace(device=[])) is None
    program.taken = (records(), ANCHOR, 1)  # a span past the program's cap
    assert read(trace()) is None
    program.taken = None  # a program without the span module
    assert read(trace()) is None
    program.taken = ([r for r in records() if r.name == "bgv.step"], ANCHOR, 0)
    assert (read(trace()) is None) == (name not in ("issue_idle_pct.step",))


def test_the_program_records_are_taken_and_emptied():
    from torch.profiler import ProfilerActivity, profile

    from lol_tpu_torch import trace as program_trace

    program_trace.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        with program_trace.span("bgv.step"):
            pass
    recs, anchor, dropped = spans.program_records()
    assert [r.name for r in recs] == ["bgv.step"] and dropped == 0
    assert program_trace.records() == []


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the program's kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [32768, 18432])
def test_order_pairing_is_the_profilers_on_the_card(cuda, m):
    """One step (B = 16) profiled in a fresh process, as the benchmark
    profiles a cell's traced batches (`on_the_card`).  In a process that
    ran other profiles and windows before, the profiler was seen to drop
    the device record of the session's first launch, which no pairing by
    order can place."""
    out = subprocess.run([sys.executable, "-c", f"import test_bench_spans as t; t.on_the_card({m})"],
                         cwd=Path(__file__).parent, capture_output=True, text=True, timeout=900)
    print(out.stdout)
    assert out.returncode == 0, out.stderr[-4000:]


def on_the_card(m: int) -> None:
    """Under a profile of the host and the device: the order pairing gives
    each device operation the launch call of its own correlation id; the
    anchor's bounds hold the profile's own zero; and each span's device
    time equals what the profile's record_function ranges of the same
    spans hold by correlation id."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from lol_tpu_torch import numtheory as nt, prng, sampling, she, trace as program_trace
    from lol_tpu_torch.she_batched import BatchedBGV

    dev = torch.device("cuda", 0)
    params = she.SHEParams(m=m, p=257 if m == 32768 else 7,
                           qs=tuple(nt.ntt_primes(m, 30, 3)), var=2.0)
    g = prng.KeyChain(1)
    bb = BatchedBGV(params, dev)
    fn = bb.build_step(bb.gen_ks_quad_hint(she.gen_sk(params, g(), dev), g()))
    cts = [sampling.uniform_residues(params.qs, (params.ctx.n, 16), g(), dev) for _ in range(4)]
    fn(*cts)
    torch.cuda.synchronize()
    program_trace.clear()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        fn(*cts)
        fn(*cts)
        torch.cuda.synchronize()
    recs, anchor = program_trace.records(), program_trace.anchor()
    evs = prof.events()
    row = lambda e: (e.name, float(e.time_range.start), float(e.time_range.end))  # noqa: E731
    ops = [e for e in evs if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    calls = [e for e in evs if e.device_type == DeviceType.CPU
             and e.name.startswith(("cudaLaunch", "cuLaunch", "cudaMemcpy", "cudaMemset"))]
    ids = {row(e): e.id for e in ops + calls}
    pairs = spans.pair([row(e) for e in ops], [row(e) for e in calls])
    lone = [(e.name, e.id, e.time_range.start) for e in calls
            if e.id not in {o.id for o in ops}]
    assert pairs is not None and len(pairs) == len(ops) > 0, (len(ops), len(calls), lone)
    assert all(ids[op] == ids[call] for op, call in pairs)

    a = spans.attribute(tracing.from_profiler(prof, 2, []), recs, anchor)
    assert a is not None and a.outside() == 0 and len(a.owners) == len(ops)
    lo, hi = a.zero_ns
    assert lo <= prof.profiler.kineto_results.trace_start_ns() <= hi
    ranges = [e for e in evs if e.device_type == DeviceType.CPU and e.is_user_annotation]
    launch = {e.id: e.time_range.start for e in calls}
    truth: dict[str, float] = {}
    for e in ops:
        for name in {r.name for r in ranges if r.time_range.start <= launch[e.id]
                     <= r.time_range.end}:
            truth[name] = truth.get(name, 0.0) + e.time_range.end - e.time_range.start
    mine = {name: a.device_us(name) for name in a.names()}
    print(f"m = {m}: {len(ops)} device ops paired; anchor bounds {(hi - lo) / 1e3:.3f} us; "
          f"device us by span {mine}")
    assert mine == pytest.approx(truth)
