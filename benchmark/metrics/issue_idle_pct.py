"""issue_idle_pct: the share of the traced span (the same denominator
as `device_idle_pct`) in which the device was idle while the host was
inside a program span `bgv.step` (`spans.py`), in percent: the idle the
program's own issue causes.  Idle while the host sits in the loop or in
the wait for a batch is the rest of `device_idle_pct`."""

from benchmark import spans


def read(tr):
    return spans.issue_idle_pct(tr)
