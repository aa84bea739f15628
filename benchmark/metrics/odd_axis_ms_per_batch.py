"""odd_axis_ms_per_batch: device ms a batch of the operations launched
inside the program's `crt.odd` spans (`spans.py`): every odd axis of the
general-m CRT transforms, wherever in the step they run.  None at a
2-power m, which has no odd axis."""

from benchmark import spans


def read(tr):
    return spans.ms_per_batch(tr, "crt.odd")
