"""The traced run's events, read from torch.profiler in memory.

`Trace` holds the device operations (kernels, copies, sets) and the host
events (on the card, the CUDA runtime calls) of a fixed number of
batches, each as (name, start_us, end_us) on the profiler's clock, with
the work those batches asked for.

The per-layer readers (`metrics/<name>.py`) take a `Trace` and return a
number, or None where it holds nothing for them to read.
"""

from __future__ import annotations

from dataclasses import dataclass, field

COPY_PREFIXES = ("Memcpy", "Memset")


@dataclass
class Trace:
    device: list[tuple[str, float, float]]
    host: list[tuple[str, float, float]]
    batches: int
    work: list[tuple[str, int, int]] = field(default_factory=list)  # (roofline op, n, B)

    @property
    def kernels(self) -> list[tuple[str, float, float]]:
        return [e for e in self.device if not e[0].startswith(COPY_PREFIXES)]

    def span_us(self) -> float:
        """From the start of the traced batches' first device operation to
        the end of their last."""
        if not self.device:
            return 0.0
        return max(e[2] for e in self.device) - min(e[1] for e in self.device)

    def busy(self) -> list[tuple[float, float]]:
        """The union of the device operations' intervals, in order."""
        return union((s, e) for _, s, e in self.device)

    def busy_us(self) -> float:
        return sum(e - s for s, e in self.busy())


def union(intervals) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def from_profiler(prof, batches: int, work) -> Trace:
    """A Trace from a finished torch.profiler.profile."""
    from torch.autograd import DeviceType

    device, host = [], []
    for e in prof.events():
        row = (e.name, float(e.time_range.start), float(e.time_range.end))
        if e.device_type == DeviceType.CUDA:
            device.append(row)
        elif e.device_type == DeviceType.CPU:
            host.append(row)
    return Trace(device, host, batches, list(work))


NAME_CHARS = 160


def kernel_counts(tr: Trace) -> dict[str, int]:
    """Kernels of the traced batches by name."""
    counts: dict[str, int] = {}
    for name, _, _ in tr.kernels:
        counts[name[:NAME_CHARS]] = counts.get(name[:NAME_CHARS], 0) + 1
    return counts


def breakdown(tr: Trace, top: int = 10) -> dict:
    """The device operations that took most time, by name, and the
    longest idle gaps, each named by the innermost host event in flight at
    its middle (a CUDA runtime call, as the card's trace records them;
    "host code" where the host ran between calls); seconds."""
    by_name: dict[str, float] = {}
    for name, s, e in tr.device:
        by_name[name[:NAME_CHARS]] = by_name.get(name[:NAME_CHARS], 0.0) + (e - s) * 1e-6
    busy = tr.busy()
    gaps = sorted(((b[0] - a[1], a[1], b[0]) for a, b in zip(busy, busy[1:])), reverse=True)
    idle = []
    for length, s, e in gaps[:top]:
        mid = (s + e) / 2
        inflight = [h for h in tr.host if h[1] <= mid <= h[2]]
        name = max(inflight, key=lambda h: h[1])[0] if inflight else "host code"
        idle.append([name[:NAME_CHARS], length * 1e-6])
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": idle}
