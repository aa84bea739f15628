"""device_idle_pct: the share of the traced span (the start of the traced
batches' first device operation to the end of their last) in which no
operation ran on the device, in percent."""


def read(tr):
    span = tr.span_us()
    return 100 * (1 - tr.busy_us() / span) if span > 0 else None
