"""The port's spans and glue byte counter (`lol_tpu_torch.trace`).

Off (no profiler recording) a span site costs one read of the profiler's
flag and records nothing; under `torch.profiler` a BGV step at m = 64
(2-power) and at m = 72 (2^3 3^2, one odd axis) records the span tree
the benchmark's readers expect, with the exact glue byte count, and
computes the same words as without it; so does the ring tunnel
m = 64 -> 32.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from lol_tpu_torch import linear, numtheory as nt, prng, sampling, she, trace
from lol_tpu_torch.ops import general as gen
from lol_tpu_torch.she_batched import BatchedBGV

torch.set_num_threads(2)

NRNS, B = 3, 4
RINGS = {64: 17, 72: 5}  # m -> p
STEP_SPANS = {"bgv.step": 1, "bgv.ct_mul": 1, "bgv.ks.intt": 1, "bgv.ks.digits": NRNS,
              "bgv.ks.inner": 1, "bgv.rescale": 2}
# the odd-axis transforms of a step: the inverse of e2 (nrns), each digit's
# forward transforms (nrns - 1 a digit), each rescale's inverse and forwards
ODD_PER_STEP = NRNS + NRNS * (NRNS - 1) + 2 * NRNS


@pytest.fixture(scope="module", params=sorted(RINGS), ids=lambda m: f"m{m}")
def step(request):
    m = request.param
    params = she.SHEParams(m=m, p=RINGS[m], qs=tuple(nt.ntt_primes(m, 30, NRNS)), var=2.0)
    g = prng.KeyChain(m)
    bb = BatchedBGV(params, "cpu")
    fn = bb.build_step(bb.gen_ks_quad_hint(she.gen_sk(params, g(), "cpu"), g()))
    cts = [sampling.uniform_residues(params.qs, (params.ctx.n, B), g(), "cpu")
           for _ in range(4)]
    return m, fn, cts


def traced(fn, cts):
    trace.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn(*cts)
    return out, trace.records(), prof


class Flag:
    """Stands in for torch.autograd.profiler: counts reads of the flag."""

    def __init__(self):
        self.reads = 0

    @property
    def _is_profiler_enabled(self):
        self.reads += 1
        return False


def test_off_a_site_is_one_flag_read_and_records_nothing(step, monkeypatch):
    m, fn, cts = step
    trace.clear()
    flag = Flag()
    monkeypatch.setattr(trace, "_profiler", flag)
    monkeypatch.setattr(trace, "_Span", None)  # never built while off
    assert trace.span("bgv.step") is trace.OFF and trace.span("x") is trace.OFF
    assert trace.count("glue_io_bytes", cts[0]) is None and trace.tag("int64") is None
    flag.reads = 0
    fn(*cts)
    odd = ODD_PER_STEP if m == 72 else 0
    spans = sum(STEP_SPANS.values()) + odd
    counts = 2 + 2  # the inner product's in and out, each rescale's one
    tags = odd + 1 + 2  # matvec_mod's route tag, ks_inner_cm's, each rescale_out's
    assert flag.reads == spans + counts + tags
    assert trace.records() == [] and trace.anchor() is None and trace.dropped() == 0


def test_the_step_records_its_span_tree(step):
    m, fn, cts = step
    _, recs, _ = traced(fn, cts)
    names = [r.name for r in recs]
    want = dict(STEP_SPANS, **({"crt.odd": ODD_PER_STEP} if m == 72 else {}))
    assert {n: names.count(n) for n in set(names)} == want
    root = recs[0]
    assert root.name == "bgv.step" and root.parent is None and root.request == root.id
    by_id = {r.id: r for r in recs}
    assert len(by_id) == len(recs)
    for r in recs:
        assert r.request == root.id and r.start_ns <= r.end_ns
        if r is root:
            continue
        parent = by_id[r.parent]
        assert parent.start_ns <= r.start_ns and r.end_ns <= parent.end_ns
        if r.name == "crt.odd":
            assert parent.name in ("bgv.ks.intt", "bgv.ks.digits", "bgv.rescale")
            assert r.tag == "int64"  # phi = 6, below the int8-limb route's axis
        else:
            assert parent is root
            # the CPU's route of ks_inner_cm and rescale_out
            assert r.tag == ("int64" if r.name in ("bgv.ks.inner", "bgv.rescale") else None)
    assert trace.anchor() is None  # no card in use: no anchor event


def test_two_steps_have_two_requests(step):
    m, fn, cts = step
    trace.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        fn(*cts)
        fn(*cts)
    recs = trace.records()
    roots = [r for r in recs if r.parent is None]
    assert [r.name for r in roots] == ["bgv.step"] * 2
    assert {r.request for r in recs} == {r.id for r in roots}
    assert sum(r.request == roots[0].id for r in recs) == len(recs) // 2


def test_glue_io_bytes_is_the_formula_from_shapes(step):
    m, fn, cts = step
    _, recs, _ = traced(fn, cts)
    N = NRNS * cts[0].shape[1] * B  # words of one (nrns, n, B) stack
    inner = [r.counters["glue_io_bytes"] for r in recs if r.name == "bgv.ks.inner"]
    # one call over every digit: int32 e0 / e1 from ct_mul and the NRNS digit
    # stacks in, int32 (e0, e1) out
    assert inner == [(4 + 4 + 4 * NRNS + 4 + 4) * N]
    resc = [r.counters["glue_io_bytes"] for r in recs if r.name == "bgv.rescale"]
    assert resc == [4 * N + 4 * N * (NRNS - 1) // NRNS] * 2  # int32 comp in, int32 out
    assert sum(inner) + sum(resc) == 28 * N + 2 * (4 * N + 8 * N // 3)
    assert all(not r.counters for r in recs if r.name not in ("bgv.ks.inner", "bgv.rescale"))


def test_outputs_are_the_same_with_the_profiler_on(step):
    _, fn, cts = step
    want = fn(*cts)
    got, recs, _ = traced(fn, cts)
    assert recs and all(torch.equal(a, b) for a, b in zip(want, got))


def test_the_profile_shows_the_spans(step):
    m, fn, cts = step
    _, recs, prof = traced(fn, cts)
    shown = {e.name for e in prof.events()}
    assert {r.name for r in recs} <= shown
    assert ("crt.odd" in shown) == (m == 72)


def test_count_outside_a_span_and_past_the_cap(monkeypatch):
    trace.clear()
    monkeypatch.setattr(trace, "CAP", 2)
    x = torch.zeros(3, 5, dtype=torch.int64)
    with profile(activities=[ProfilerActivity.CPU]):
        trace.count("glue_io_bytes", x)  # no span open: nowhere to add it
        with trace.span("a") as a:
            trace.count("glue_io_bytes", x, 7)
            trace.tag("modmat_s8")
            trace.tag("int64")  # the first route named stays
            with trace.span("b") as b:
                with trace.span("c") as c:
                    trace.count("glue_io_bytes", x)
    assert [r.name for r in trace.records()] == ["a", "b"] and trace.dropped() == 1
    assert a.counters == {"glue_io_bytes": 127} and a.tag == "modmat_s8"
    assert c.parent == b.id and b.parent == a.id and c.counters == {"glue_io_bytes": 120}
    trace.clear()
    assert trace.records() == [] and trace.dropped() == 0


def test_the_odd_axis_route_is_the_one_that_ran():
    plan = gen.general_plan(72, nt.ntt_primes(72, 30, 1)[0])
    x = torch.randint(0, plan.q, (24, 2), dtype=torch.int32)
    trace.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        gen.crt_cm(plan, x)
        with trace.span("forced"):
            gen.matvec_mod(plan.axes[1].M, x.view(4, 6, 2), plan.q, axis=1, use_mxu=True)
    assert [(r.name, r.tag) for r in trace.records()] == [("crt.odd", "int64"),
                                                          ("forced", "modmat_s8")]


# the ring tunnel m = 64 -> 32, E = S (d = 2 relative basis elements)
M_R, M_T = 64, 32
D = 2
TUNNEL_SPANS = {"tunnel": 1, "tunnel.intt": 1, "tunnel.forward": D * (1 + NRNS),
                "tunnel.inner": D * (1 + NRNS)}


@pytest.fixture(scope="module")
def tunnel():
    qs = tuple(nt.ntt_primes(M_R, 30, NRNS))
    pr, ps = (she.SHEParams(m=m, p=257, qs=qs, var=2.0) for m in (M_R, M_T))
    g = prng.KeyChain(M_R + 1)
    ys = [np.eye(1, M_T // 2, dtype=np.int64)[0], np.zeros(M_T // 2, dtype=np.int64)]
    lin = linear.linear_pow(ps.ctx, pr.ctx, ps.ctx, ys)
    bb = BatchedBGV(pr, "cpu")
    th = bb.gen_tunnel_hint(lin, she.gen_sk(ps, g(), "cpu"), she.gen_sk(pr, g(), "cpu"), g())
    cts = [sampling.uniform_residues(qs, (pr.ctx.n, B), g(), "cpu") for _ in range(2)]
    return bb.build_tunnel(th), cts


def test_the_tunnel_records_its_span_tree(tunnel):
    fn, cts = tunnel
    _, recs, _ = traced(fn, cts)
    names = [r.name for r in recs]
    assert {n: names.count(n) for n in set(names)} == TUNNEL_SPANS
    root = recs[0]
    assert root.name == "tunnel" and root.parent is None and root.request == root.id
    assert names[1:3] == ["tunnel.intt", "tunnel.forward"]
    assert names[3:] == ["tunnel.inner", "tunnel.forward"] * (D * (1 + NRNS) - 1) + [
        "tunnel.inner"]  # combine's order: each stack, then the products that consume it
    for r in recs[1:]:
        assert r.parent == root.id and r.request == root.id
        assert root.start_ns <= r.start_ns <= r.end_ns <= root.end_ns


def test_the_tunnel_glue_io_bytes_is_the_formula_from_shapes(tunnel):
    fn, cts = tunnel
    _, recs, _ = traced(fn, cts)
    S = NRNS * (M_T // 2) * B * 4  # bytes of one int32 (nrns, n_s, B) stack over S
    inner = [r.counters["glue_io_bytes"] for r in recs if r.name == "tunnel.inner"]
    # each transformed stack in once; the last also (e0, e1) out
    assert inner == [S] * (D * (1 + NRNS) - 1) + [3 * S]
    assert sum(inner) == (D * (1 + NRNS) + 2) * S
    assert all(not r.counters for r in recs if r.name != "tunnel.inner")


def test_the_tunnel_off_records_nothing_and_computes_the_same(tunnel, monkeypatch):
    fn, cts = tunnel
    got, recs, _ = traced(fn, cts)
    trace.clear()
    flag = Flag()
    monkeypatch.setattr(trace, "_profiler", flag)
    monkeypatch.setattr(trace, "_Span", None)
    want = fn(*cts)
    spans = sum(TUNNEL_SPANS.values())
    counts = D * (1 + NRNS) + 1  # each stack consumed, and the output
    assert flag.reads == spans + counts
    assert trace.records() == [] and trace.anchor() is None and trace.dropped() == 0
    assert recs and all(torch.equal(a, b) for a, b in zip(want, got))
