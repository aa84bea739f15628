"""ct_per_s: ciphertext pairs that completed the whole step in the
window, over the window's seconds (first issue to the last completion
seen in it)."""


def value(w) -> float:
    return w.items / w.seconds
