"""Debug guards for the modular-arithmetic kernels.

Counterpart of `lol_tpu/ops/debug.py` (SURVEY.md §6, "race detection /
sanitizers"): the analog of a memory sanitizer here is a reduction
tripwire.  Every residue must lie in [0, q) after a reduction; a lazy
reduction that leaked shows up as a word in [q, 4q), or as garbage after
a u32 wraparound.  The port holds residues as int32, so a u32 word at or
above 2^31 reads as negative: `assert_reduced` checks the minimum as well
as the maximum.  On a CUDA tensor the check reads two numbers back to the
host, a sync (the reference's check syncs under jit the same way): a
tool for debugging, not for a hot path.
"""

from __future__ import annotations

import torch

from .cuda import ntt_kernel as tk
from .ntt import NTTPlan


class ReductionError(AssertionError):
    pass


def assert_reduced(x: torch.Tensor, q: int, where: str = "") -> torch.Tensor:
    """Check that every element of x lies in [0, q); returns x unchanged."""
    if x.numel() == 0:
        return x
    lo, hi = (int(v) for v in torch.aminmax(x))
    at = f" [{where}]" if where else ""
    if lo < 0:
        word = lo + (1 << 32) if x.dtype == torch.int32 else lo
        raise ReductionError(f"assert_reduced{at}: residue {lo} < 0 (u32 word {word}: a "
                             "wraparound?)")
    if hi >= q:
        raise ReductionError(f"assert_reduced{at}: residue {hi} >= modulus {q} "
                             "(lazy-reduction overflow?)")
    return x


def ntt_cm_checked(x: torch.Tensor, plan: NTTPlan, inverse: bool = False, **kw) -> torch.Tensor:
    """`ops/cuda/ntt_kernel.ntt_cm` between two guards, the debug variant of
    the fused NTT: the input against its modulus (`pre_digit_q` where the
    forward's prologue takes residues mod another prime, else the plan's),
    the output against the plan's.  Every keyword of `ntt_cm` passes
    through, so `alg="dit"` runs route B."""
    n = plan.n
    assert_reduced(x, kw.get("pre_digit_q") or plan.q, where=f"ntt_cm input n={n}")
    y = tk.ntt_cm(x, plan, inverse=inverse, **kw)
    return assert_reduced(y, plan.q, where=f"ntt_cm output n={n}")
