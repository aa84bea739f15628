"""The per-layer readers and the end-to-end metrics on hand-made inputs,
and the frozen roofline against the program's numbers at commit 652d80f."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from bench_tiny import ROOT

from benchmark import roofline, tracing
from benchmark.cells import load_module, metric_file

METRICS = ROOT / "benchmark" / "metrics"
E2E = ROOT / "benchmark" / "e2e"

# two batches: torch glue, a hand-written kernel, a copy, overlapping kernels
DEVICE = [
    ("void at::native::vectorized_elementwise_kernel<4, Mul>", 10.0, 20.0),
    ("ntt_fwd_pass<14>", 15.0, 40.0),  # overlaps the one before
    ("Memcpy DtoD (Device -> Device)", 50.0, 55.0),
    ("void at::native::(anonymous namespace)::CatArrayBatchedCopy", 60.0, 70.0),
    ("ct_mul", 90.0, 100.0),
]
HOST = [("aten::mul", 0.0, 12.0), ("cudaEventSynchronize", 38.0, 95.0),
        ("aten::cat", 56.0, 58.0)]


def trace(device=DEVICE, host=HOST, batches=2, work=()):
    return tracing.Trace(list(device), list(host), batches, list(work))


def read(name, tr):
    return load_module(metric_file(METRICS, name)).read(tr)


def test_union_and_idle_share():
    tr = trace()
    assert tr.busy() == [(10.0, 40.0), (50.0, 55.0), (60.0, 70.0), (90.0, 100.0)]
    assert tr.busy_us() == 55.0 and tr.span_us() == 90.0  # the first device op to the last
    for name in ("device_idle_pct.step", "device_idle_pct.ntt"):
        assert read(name, tr) == pytest.approx(100 * (1 - 55 / 90))
        assert read(name, trace(device=[])) is None


def test_torch_ops_counts_at_native_and_copies_only():
    # 10 (Mul) + 5 (Memcpy) + 10 (Cat) us over 2 batches
    assert read("torch_ops_ms_per_batch", trace()) == pytest.approx(12.5e-3)
    assert read("torch_ops_ms_per_batch", trace(device=[])) is None


def test_launches_count_kernels_not_copies():
    assert read("launches_per_batch", trace()) == 2.0  # 4 kernels, 2 batches
    assert read("launches_per_batch", trace(device=DEVICE[2:3])) is None


def test_ntt_roofline_from_the_requested_work():
    n, B = 16384, 4096
    work = [("ntt_fwd", n, B)] * 3 + [("ntt_inv_gs", n, B)] * 3
    bound_ms = 6 * roofline.bound(*roofline.work("ntt_fwd", n, B))[0]
    dev = [("k", 0.0, bound_ms * 1e3 * 2)]  # twice the bound
    assert read("ntt_roofline", trace(device=dev, work=work)) == pytest.approx(50.0)
    assert read("ntt_roofline", trace(device=dev)) is None
    assert read("ntt_roofline", trace(device=[], work=work)) is None


def test_breakdown_names_ops_and_gaps():
    b = tracing.breakdown(trace())
    assert b["device_ops"][0] == ["ntt_fwd_pass<14>", pytest.approx(25e-6)]
    assert len(b["device_ops"]) == 5
    # gaps: 70-90 (sync in flight), 40-50 (sync), 55-60 (aten::cat, innermost)
    assert b["idle_gaps"] == [["cudaEventSynchronize", pytest.approx(20e-6)],
                              ["cudaEventSynchronize", pytest.approx(10e-6)],
                              ["aten::cat", pytest.approx(5e-6)]]


def test_end_to_end_metrics():
    w = SimpleNamespace(setup_s=9.5, seconds=2.0, items=4096,
                        latencies_ms=[float(x) for x in range(1, 101)])
    assert load_module(E2E / "ct_per_s.py").value(w) == 2048.0
    assert load_module(E2E / "ntt_per_s.py").value(w) == 2048.0
    assert load_module(E2E / "setup_s.py").value(w) == 9.5
    assert load_module(E2E / "batch_ms_p95.py").value(w) == 95.0  # nearest rank
    w.latencies_ms = [3.0, 1.0, 2.0]
    assert load_module(E2E / "batch_ms_p95.py").value(w) == 3.0


# lol_tpu_torch/bench/roofline.py's work() and bound() at commit 652d80f
FROZEN = {
    (16384, 4096): ((4227858432, 536870912), (0.25275592286501375, "operations")),
    (16384, 1024): ((1056964608, 134217728), (0.06318898071625344, "operations")),
    (4096, 16384): ((3623878656, 536870912), (0.2166479338842975, "operations")),
    (1, 8): ((0, 64), (1.9104477611940296e-08, "bytes")),
}


@pytest.mark.parametrize("op", ["ntt_fwd", "ntt_inv_gs"])
@pytest.mark.parametrize("n, B", list(FROZEN))
def test_frozen_roofline_holds_the_counts_of_652d80f(op, n, B):
    work, bound = FROZEN[n, B]
    assert roofline.work(op, n, B) == work
    assert roofline.bound(*roofline.work(op, n, B)) == bound


def test_frozen_peaks_and_unknown_ops():
    assert roofline.HBM_BYTES_PER_S == 3.35e12
    assert roofline.U32_OPS_PER_S == 16727040000000.0
    with pytest.raises(ValueError):
        roofline.work("ct_mul", 16384, 1024)
