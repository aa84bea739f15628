"""Spans and byte counters inside the program, on the profiler's clock.

Recording is on exactly while torch's profiler records
(`torch.autograd.profiler._is_profiler_enabled`); there is no other
switch.  Off, `span` returns the one shared no-op `OFF` and `count` and
`tag` return at once: a site costs one attribute read and allocates
nothing.  On, a span

- enters `torch.profiler.record_function(name)`, so a profile that
  records the host shows it natively, its kernels beneath it;
- appends a `Record` to a bounded list in memory (`CAP`; the spans past
  it are counted in `dropped()`): its name, its id, its parent's, its
  request id (the outermost open span's, so every span under one
  `bgv.step` call shares that step's id), its host start and end from
  `time.time_ns()` (the unix-ns clock Kineto stamps events with), the
  counters added inside it (`count`) and its tag (`tag`).

Clock anchor: the first span recorded after the list was emptied
(`clear()`) queries the current CUDA stream, where a card is in use,
and notes `time.time_ns()` just before and just after the call
(`anchor()`).  That call is the first `cudaStreamQuery` of a traced
window, so a reader finds it in the profiler's trace and sets the offset
between the records' clock and the trace's to within the few us the
call takes.  (A CUDA event's record, the first thought, brackets its
runtime call with ~0.1 ms of Python and untraced calls on the H100, too
loose to tell which span a launch belongs to.)

The program's spans, by name (per BGV step at nrns channels):
`bgv.step` (`BGVStep.forward`, 1), `bgv.ct_mul` (1), `bgv.ks.intt` (the
inverse of e2, 1), `bgv.ks.digits` (each digit's forward transforms,
nrns), `bgv.ks.inner` (the hint inner products of every digit, 1, tagged
with its route, "ks_inner" or "int64"), `bgv.rescale`
(`BatchedBGV._rescale_crt`, 2, tagged with its epilogue's route,
"rescale_out" or "int64"), and `crt.odd` (each odd axis of a
general-m `ops.general.crt_cm`, tagged with its route, "modmat_small",
"int64" or "modmat_s8").  Per ring tunnel R -> S (`Tunnel`, d relative basis
elements): `tunnel` (`Tunnel.forward`, 1), `tunnel.intt` (both inverse
transforms over R, 1), `tunnel.forward` (each stack of forward
transforms over S with its gather and embed, d (1 + nrns)) and
`tunnel.inner` (each int64 product with ys_i or a hint, the output's
int32 casts in the last, d (1 + nrns)).  The one counter,
`glue_io_bytes`, is added in `bgv.ks.inner`, `bgv.rescale` and
`tunnel.inner`: the bytes of their tensor arguments and results (the
hints not counted), what a fused kernel at that boundary must move at
least.
"""

from __future__ import annotations

import itertools
import threading
import time
from dataclasses import dataclass, field

import torch
from torch.autograd import profiler as _profiler

CAP = 1 << 16  # records kept until clear(); later spans only counted


@dataclass(slots=True)
class Record:
    name: str
    id: int
    parent: int | None
    request: int
    start_ns: int
    end_ns: int = 0
    counters: dict[str, int] = field(default_factory=dict)
    tag: str | None = None


class _Off:
    """The span of a run that no profiler records: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


OFF = _Off()


class _Recorder:
    """The records of this process, their anchor, and each thread's
    stack of open spans."""

    def __init__(self):
        self.records: list[Record] = []
        self.dropped = 0
        self.anchor: tuple[int, int] | None = None
        self.anchored = False
        self.ids = itertools.count(1)
        self.local = threading.local()

    def stack(self) -> list[Record]:
        st = getattr(self.local, "stack", None)
        if st is None:
            st = self.local.stack = []
        return st

    def take_anchor(self) -> None:
        self.anchored = True
        if torch.cuda.is_initialized():
            stream = torch.cuda.current_stream()
            before = time.time_ns()
            stream.query()
            self.anchor = (before, time.time_ns())


_rec = _Recorder()


class _Span:
    __slots__ = ("record", "fn")

    def __init__(self, name: str):
        st = _rec.stack()
        parent = st[-1] if st else None
        if not _rec.anchored:
            _rec.take_anchor()
        rid = next(_rec.ids)
        self.record = Record(name, rid, parent.id if parent else None,
                             parent.request if parent else rid, 0)
        self.fn = _profiler.record_function(name)

    def __enter__(self):
        r = self.record
        if len(_rec.records) < CAP:
            _rec.records.append(r)
        else:
            _rec.dropped += 1
        _rec.stack().append(r)
        r.start_ns = time.time_ns()
        self.fn.__enter__()
        return r

    def __exit__(self, *exc):
        self.fn.__exit__(*exc)
        self.record.end_ns = time.time_ns()
        _rec.stack().pop()
        return False


def span(name: str):
    """A context manager around one layer's call: `OFF` unless the
    profiler records."""
    if not _profiler._is_profiler_enabled:
        return OFF
    return _Span(name)


def count(name: str, *items) -> None:
    """Add to counter `name` of the innermost open span the bytes of each
    tensor of items (an int counts as itself); nothing when the profiler
    is off or no span is open."""
    if not _profiler._is_profiler_enabled:
        return
    st = _rec.stack()
    if st:
        c = st[-1].counters
        c[name] = c.get(name, 0) + sum(x if isinstance(x, int) else x.nbytes for x in items)


def tag(value: str) -> None:
    """Name the route of the innermost open span, where it has none yet."""
    if not _profiler._is_profiler_enabled:
        return
    st = _rec.stack()
    if st and st[-1].tag is None:
        st[-1].tag = value


def records() -> list[Record]:
    """The spans recorded since the last clear(), in the order they
    opened."""
    return list(_rec.records)


def dropped() -> int:
    """Spans past CAP since the last clear(), not kept."""
    return _rec.dropped


def anchor() -> tuple[int, int] | None:
    """time.time_ns() just before and just after the anchor's
    cudaStreamQuery; None where no card was in use."""
    return _rec.anchor


def clear() -> None:
    """Empty the records; the next recorded span takes a new anchor."""
    _rec.records = []
    _rec.dropped = 0
    _rec.anchor = None
    _rec.anchored = False
