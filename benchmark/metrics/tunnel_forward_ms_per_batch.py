"""tunnel_forward_ms_per_batch: device ms a batch of the operations
launched inside the program's `tunnel.forward` spans (`spans.py`): each
relative coefficient's gather and embed into S, its forward transforms
over S (the digit prologue included) and the stack of them."""

from benchmark import spans


def read(tr):
    return spans.ms_per_batch(tr, "tunnel.forward")
