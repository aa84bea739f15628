"""tunnel_ntt_roofline: the least time the H100 could take for the
transforms the traced batches asked for (`roofline.work` / `bound`,
frozen: the inverses over R and the forwards over S a ring tunnel
requests), over the device time of the operations launched inside the
program's `tunnel.intt` and `tunnel.forward` spans (`spans.py`), in
percent.  Those spans also hold the gathers, embeds and stacks around
the transforms."""

from benchmark import roofline, spans

SPANS = ("tunnel.intt", "tunnel.forward")


def read(tr):
    ntt = [w for w in tr.work if w[0].startswith("ntt_")]
    a = spans.attribution(tr)
    if not ntt or a is None or not set(SPANS) <= a.names():
        return None
    dev_us = sum(a.device_us(name) for name in SPANS)
    if not dev_us:
        return None
    bound_ms = sum(roofline.bound(*roofline.work(op, n, B))[0] for op, n, B in ntt)
    return 100 * bound_ms * 1e3 / dev_us
