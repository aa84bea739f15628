"""digits_ms_per_batch: device ms a batch of the operations launched
inside the program's `bgv.ks.digits` spans (`spans.py`): each digit's
re-expansion and forward transforms, and the stack of them."""

from benchmark import spans


def read(tr):
    return spans.ms_per_batch(tr, "bgv.ks.digits")
