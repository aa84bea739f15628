"""setup_s: seconds from the harness's first line to the first timed
batch: imports, the CUDA context, the program's kernels built or found
built, the inputs made from the seed, the warm-up batches."""


def value(w) -> float:
    return w.setup_s
