"""ntt_roofline: the least time the H100 could take for the
transforms the traced batches asked for (`roofline.work` / `bound`,
frozen), over the device time of every operation in those batches, in
percent.  The work is counted from the requests, whatever kernels did
it."""

from benchmark import roofline


def read(tr):
    ntt = [w for w in tr.work if w[0].startswith("ntt_")]
    dev_us = sum(e - s for _, s, e in tr.device)
    if not ntt or not dev_us:
        return None
    bound_ms = sum(roofline.bound(*roofline.work(op, n, B))[0] for op, n, B in ntt)
    return 100 * bound_ms * 1e3 / dev_us
