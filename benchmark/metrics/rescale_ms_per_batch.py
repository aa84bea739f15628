"""rescale_ms_per_batch: device ms a batch of the operations launched
inside the program's `bgv.rescale` spans (`spans.py`): the exact
drop-last rescale of both components, its transforms included."""

from benchmark import spans


def read(tr):
    return spans.ms_per_batch(tr, "bgv.rescale")
