"""glue_io_bytes_per_batch: the program's `glue_io_bytes` counter over
the traced batches, a batch (`spans.py`): the bytes of the tensors the
hint inner products and the rescale take and give back, the least a
fused kernel at those boundaries must move.  Exact: counted from
shapes, the same every run."""

from benchmark import spans


def read(tr):
    a = spans.attribution(tr)
    if a is None or not a.counter("glue_io_bytes"):
        return None
    return a.counter("glue_io_bytes") / a.batches
