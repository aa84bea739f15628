"""ntt_per_s: ring elements transformed in every modulus of the chain
(forward or inverse, each counted once) in the window, over the window's
seconds (first issue to the last completion seen in it)."""


def value(w) -> float:
    return w.items / w.seconds
