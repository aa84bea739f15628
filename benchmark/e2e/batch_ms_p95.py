"""batch_ms_p95: the 95th percentile (nearest rank) of every batch
completed in the window, issue on the host to the host seeing its
completion event, in milliseconds."""

import math


def value(w) -> float:
    lat = sorted(w.latencies_ms)
    return lat[math.ceil(0.95 * len(lat)) - 1]
