"""inner_product_ms_per_batch: device ms a batch of the operations
launched inside the program's `bgv.ks.inner` spans (`spans.py`): the key
switch's hint inner products, one span a digit."""

from benchmark import spans


def read(tr):
    return spans.ms_per_batch(tr, "bgv.ks.inner")
