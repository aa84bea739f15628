"""The program's own spans (`lol_tpu_torch.trace`) against the traced
run's device operations.

On the card the traced run records the device's activity and the CUDA
runtime calls (`tracing.Trace`), not the host's ops, so the program's
`record_function` ranges never reach the Trace.  The program keeps its
spans as records in memory instead, on the host's unix-ns clock, and
`attribute` lays them over the Trace:

1. the offset between the clocks: the records' anchor (`time.time_ns()`
   just before and just after one cudaStreamQuery, the first of the
   traced window) against that call in `tr.host`;
2. the pairing: each device operation with its launch call, by order on
   the one stream: kernels with cudaLaunch* / cuLaunch*, Memcpy* with
   cudaMemcpy*, Memset* with cudaMemset*; None where the counts differ;
3. the attribution: each operation to the innermost span whose host
   interval holds its launch call's start, and so to that span's
   ancestors.

The program's records are taken once for each Trace, and the program's
list emptied, so that a later traced run in the same process anchors
anew.  Where the program has no span module (a commit before it) or
recorded nothing, or the Trace holds no device operation, every reader
here returns None.
"""

from __future__ import annotations

from dataclasses import dataclass

LAUNCHES = {"Memcpy": ("cudaMemcpy",), "Memset": ("cudaMemset",),
            "kernel": ("cudaLaunch", "cuLaunch")}  # a device op's kind: its launch calls
ANCHOR_CALL = "cudaStreamQuery"
STEP = "bgv.step"


@dataclass
class Span:
    name: str
    id: int
    parent: int | None
    start_us: float  # on the trace's clock
    end_us: float
    counters: dict


@dataclass
class Attribution:
    spans: dict[int, Span]
    owners: list[tuple[float, int | None]]  # each device op's duration (us), innermost span
    batches: int
    zero_ns: tuple[int, int]  # the bounds of the trace's zero on the records' clock

    def names(self) -> set[str]:
        return {s.name for s in self.spans.values()}

    def chain(self, sid: int | None):
        while sid is not None:
            yield self.spans[sid]
            sid = self.spans[sid].parent

    def device_us(self, name: str) -> float:
        """Device time of the operations launched inside spans `name`,
        nested spans included, each operation once."""
        return sum(us for us, sid in self.owners
                   if any(s.name == name for s in self.chain(sid)))

    def outside(self, root: str = STEP) -> int:
        """Device operations launched outside every span `root`."""
        return sum(1 for _, sid in self.owners if not any(s.name == root
                                                          for s in self.chain(sid)))

    def counter(self, name: str) -> int:
        return sum(s.counters.get(name, 0) for s in self.spans.values())

    def intervals(self, name: str) -> list[tuple[float, float]]:
        return sorted((s.start_us, s.end_us) for s in self.spans.values() if s.name == name)


def trace_zero(host, anchor) -> tuple[int, int] | None:
    """The bounds of the trace's zero on the records' clock (ns): the
    first cudaStreamQuery call [s, e] lies inside the anchor's
    [before, after], so zero lies in [before - s, after - e]."""
    calls = [h for h in host if h[0] == ANCHOR_CALL]
    if anchor is None or not calls:
        return None
    _, s, e = min(calls, key=lambda h: h[1])
    lo, hi = anchor[0] - round(s * 1e3), anchor[1] - round(e * 1e3)
    return (lo, hi) if lo <= hi else None  # else the clocks disagree


def op_kind(name: str) -> str:
    return name[:6] if name.startswith(("Memcpy", "Memset")) else "kernel"


def pair(device, host) -> list[tuple[tuple, tuple]] | None:
    """(device op, launch call) pairs, each kind in order of start; None
    where a kind's counts differ."""
    out = []
    for kind, calls_of in LAUNCHES.items():
        ops = sorted((d for d in device if op_kind(d[0]) == kind), key=lambda d: d[1])
        calls = sorted((h for h in host if h[0].startswith(calls_of)), key=lambda h: h[1])
        if len(ops) != len(calls):
            return None
        out += zip(ops, calls)
    return out


def innermost(spans: list[Span], times: list[float]) -> list[int | None]:
    """For each time (ascending), the innermost span open at it: spans
    nest, so a sweep with a stack of the open ones."""
    order = sorted(spans, key=lambda s: (s.start_us, -s.end_us))
    out, stack, i = [], [], 0
    for t in times:
        while i < len(order) and order[i].start_us <= t:
            while stack and stack[-1].end_us < order[i].start_us:
                stack.pop()
            stack.append(order[i])
            i += 1
        while stack and stack[-1].end_us < t:
            stack.pop()
        out.append(stack[-1].id if stack else None)
    return out


def attribute(tr, records, anchor) -> Attribution | None:
    """Lay the program's records (objects with name, id, parent,
    start_ns, end_ns, counters) over tr."""
    zero = trace_zero(tr.host, anchor)
    if not records or zero is None or not tr.device or not tr.batches:
        return None
    z = sum(zero) // 2  # whole ns: unix ns do not fit a float's mantissa
    spans = {r.id: Span(r.name, r.id, r.parent, (r.start_ns - z) / 1e3,
                        (r.end_ns - z) / 1e3, dict(r.counters)) for r in records}
    names = {s.name for s in spans.values()}
    # a profile that records the host adds each span's device-side range
    pairs = pair([d for d in tr.device if d[0] not in names], tr.host)
    if pairs is None:
        return None
    pairs.sort(key=lambda p: p[1][1])
    owners = innermost(list(spans.values()), [call[1] for _, call in pairs])
    return Attribution(spans, [(op[2] - op[1], sid) for (op, _), sid in zip(pairs, owners)],
                       tr.batches, zero)


def program_records():
    """The program's records, anchor and dropped count, the list then
    emptied; None where the program has no span module."""
    try:
        from lol_tpu_torch import trace
    except ImportError:
        return None
    taken = trace.records(), trace.anchor(), trace.dropped()
    trace.clear()
    return taken


_last: list = [None, None]  # the Trace last attributed, and its attribution


def attribution(tr) -> Attribution | None:
    """attribute(tr) on the program's records, once a Trace; None where
    spans were dropped past the program's cap."""
    if _last[0] is not tr:
        taken = program_records()
        got = None
        if taken is not None and not taken[2]:
            got = attribute(tr, taken[0], taken[1])
        _last[:] = [tr, got]
    return _last[1]


def ms_per_batch(tr, name: str) -> float | None:
    """Device ms a batch of the operations launched inside spans `name`."""
    a = attribution(tr)
    if a is None or name not in a.names():
        return None
    return a.device_us(name) / 1e3 / a.batches


def issue_idle_pct(tr, root: str = STEP) -> float | None:
    """The share of the traced span (tr.span_us()) in which the device
    was idle while the host was inside a span `root`, in percent."""
    a = attribution(tr)
    span = tr.span_us()
    if a is None or root not in a.names() or span <= 0:
        return None
    busy = tr.busy()
    host = a.intervals(root)
    idle = 0.0
    for (_, s), (e, _) in zip(busy, busy[1:]):  # each gap (s, e) against each host interval
        idle += sum(max(0.0, min(e, he) - max(s, hs)) for hs, he in host)
    return 100 * idle / span


def gaps_by_span(tr, top: int = 10) -> list[list] | None:
    """The longest idle gaps of the device, longest first, each named by
    the innermost program span open on the host at its middle ("no span"
    where none was); seconds."""
    a = attribution(tr)
    if a is None:
        return None
    busy = tr.busy()
    gaps = sorted(((e - s, s, e) for (_, s), (e, _) in zip(busy, busy[1:])), reverse=True)[:top]
    mids = sorted((s + e) / 2 for _, s, e in gaps)
    owner = dict(zip(mids, innermost(list(a.spans.values()), mids)))
    return [[a.spans[owner[(s + e) / 2]].name if owner[(s + e) / 2] is not None else "no span",
             length * 1e-6] for length, s, e in gaps]
