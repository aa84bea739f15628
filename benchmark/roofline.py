"""The benchmark's frozen counts of work and the H100's peaks: what the
cells read, and nothing more.

A copy of the arithmetic of `lol_tpu_torch/bench/roofline.py` for the
negacyclic transforms (`work`, `bound` and the two peaks) as it stands at
commit 652d80f0e2dba092fb96240d08c6b33e6d72c43b, kept here so that a
change to the program cannot move the yardstick.  The counts are
functions of (op, n, B) only, never of the kernels that do the work: a
transform of an (n, B) int32 array (forward, or the GS inverse) is
k n / 2 butterflies a column (k = log2 n) at 9 u32 operations each, the
model the reference package counts with; its bytes are 8 n B, the array
read and written once whatever the number of passes.  A kernel that
needs fewer operations a butterfly than the model counts reads high
against this bound, and above 100% where it beats the model by enough;
correcting the count is then a benchmark change.  A later benchmark
change adds the count of another kernel together with the metric that
reads it.

`bound` is the least time the H100 could take: the larger of the bytes
over the data sheet's 3.35 TB/s and the u32 operations over 132 SMs x 64
IMAD a clock x 1.98 GHz.  That clock is the data sheet's boost clock, an
assumption: no run has sampled the card's clock under this load.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet
U32_OPS_PER_S = 132 * 64 * 1.98e9  # SMs x IMAD per clock per SM x the assumed boost clock


def bound(ops: float, nbytes: float) -> tuple[float, str]:
    """(least ms on the H100, "bytes" or "operations", whichever bounds)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / U32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def work(op: str, n: int, B: int) -> tuple[int, int]:
    """(u32 ops, least bytes moved) of one transform `op` of an (n, B)
    int32 array."""
    if op not in ("ntt_fwd", "ntt_inv_gs"):
        raise ValueError(f"roofline: unknown op {op!r}")
    k = n.bit_length() - 1
    return 9 * (k * n // 2) * B, 8 * n * B
