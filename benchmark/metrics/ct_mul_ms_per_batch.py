"""ct_mul_ms_per_batch: device ms a batch of the operations launched
inside the program's `bgv.ct_mul` spans (`spans.py`): the CRT Hadamards
of the ciphertext multiply."""

from benchmark import spans


def read(tr):
    return spans.ms_per_batch(tr, "bgv.ct_mul")
