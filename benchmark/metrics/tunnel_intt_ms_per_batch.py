"""tunnel_intt_ms_per_batch: device ms a batch of the operations launched
inside the program's `tunnel.intt` spans (`spans.py`): the ring tunnel's
inverse transforms of both components over R, every channel."""

from benchmark import spans


def read(tr):
    return spans.ms_per_batch(tr, "tunnel.intt")
