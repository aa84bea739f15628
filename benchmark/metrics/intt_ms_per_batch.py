"""intt_ms_per_batch: device ms a batch of the operations launched
inside the program's `bgv.ks.intt` spans (`spans.py`): the key switch's
inverse transform of e2, every channel."""

from benchmark import spans


def read(tr):
    return spans.ms_per_batch(tr, "bgv.ks.intt")
