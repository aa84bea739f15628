"""launches_per_batch: kernels the device ran for the traced batches
(copies and sets not counted), over the number of batches.  Exact: the
profiler traces whole batches and nothing else."""


def read(tr):
    kernels = tr.kernels
    return len(kernels) / tr.batches if kernels and tr.batches else None
