"""torch_ops_ms_per_batch: device milliseconds a batch of PyTorch's own
work: kernels in `at::native`, and the copies and sets.  The program's
hand-written kernels are not counted."""

from benchmark.tracing import COPY_PREFIXES


def read(tr):
    if not tr.device or not tr.batches:
        return None
    us = sum(e - s for name, s, e in tr.device
             if "at::native" in name or name.startswith(COPY_PREFIXES))
    return us / 1e3 / tr.batches
