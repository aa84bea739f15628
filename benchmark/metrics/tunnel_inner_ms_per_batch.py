"""tunnel_inner_ms_per_batch: device ms a batch of the operations
launched inside the program's `tunnel.inner` spans (`spans.py`): the
ring tunnel's products with the images ys_i and the hints mod q, their
casts, and the output's casts to int32."""

from benchmark import spans


def read(tr):
    return spans.ms_per_batch(tr, "tunnel.inner")
