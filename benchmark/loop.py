"""The one traffic generator: a closed loop of batches.

A mix (`traffic/<name>.json`) names its kind of request and its
parameters; every mix runs through `closed_loop`.  The loop keeps
`inflight` batches issued: after issuing batch k it waits on the
completion of the oldest batch still out, so with two in flight on
batch k - 1's.  A batch's latency runs from the host's issue of it to
the host seeing its completion event.  Batch k reads the inputs of pool
slot k mod `pool`, so every batch reads inputs far larger than the L2.
"""

from __future__ import annotations

import random
import time
from collections import deque
from dataclasses import dataclass, field

import torch


class Done:
    """A batch's completion: a CUDA event on the card; on the CPU, where
    every call has finished when it returns, nothing to wait for."""

    def __init__(self, device: torch.device):
        self.event = None
        if device.type == "cuda":
            self.event = torch.cuda.Event()
            self.event.record()

    def wait(self) -> None:
        if self.event is not None:
            self.event.synchronize()


class Sample:
    """A reservoir sample of the answers a run produced, `per_class` of
    each class of batch (a mix's request kinds), drawn from the seed."""

    def __init__(self, seed: int, per_class: int):
        self.rng = random.Random(seed)
        self.per_class = per_class
        self.seen: dict[int, int] = {}
        self.kept: dict[int, list] = {}

    def offer(self, cls: int, k: int, answer) -> None:
        n = self.seen[cls] = self.seen.get(cls, 0) + 1
        kept = self.kept.setdefault(cls, [])
        if len(kept) < self.per_class:
            kept.append((k, answer))
        else:
            j = self.rng.randrange(n)
            if j < self.per_class:
                kept[j] = (k, answer)

    def answers(self) -> list:
        return [a for cls in sorted(self.kept) for a in self.kept[cls]]


@dataclass
class Window:
    seconds: float = 0.0  # first issue to the last completion seen in the window
    issued: int = 0
    completed: int = 0
    latencies_ms: list[float] = field(default_factory=list)
    items: int = 0  # completed batches times the kind's items a batch
    setup_s: float = 0.0


def closed_loop(kind, device, inflight: int, on_answer, seconds: float | None = None,
                batches: int | None = None) -> Window:
    """Run batches 0, 1, ... of `kind` with `inflight` in flight, for
    `seconds` (until the first completion seen at or after it) or for a
    number of `batches`; on_answer(k, answer) gets every batch's answer
    once it is complete, those still out when the window closes too."""
    w = Window()
    out = deque()
    t0 = time.perf_counter()
    while True:
        t = time.perf_counter()
        answer = kind.issue(w.issued)
        out.append((w.issued, t, Done(device), answer))
        w.issued += 1
        if len(out) < inflight and (batches is None or w.issued < batches):
            continue
        k, t, done, answer = out.popleft()
        done.wait()
        now = time.perf_counter()
        w.latencies_ms.append((now - t) * 1e3)
        w.completed += 1
        w.seconds = now - t0
        on_answer(k, answer)
        if (seconds is not None and w.seconds >= seconds) or \
                (batches is not None and w.issued >= batches):
            break
    while out:
        k, _, done, answer = out.popleft()
        done.wait()
        on_answer(k, answer)
    return w
