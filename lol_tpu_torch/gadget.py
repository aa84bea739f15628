"""The RNS (CRT) gadget of the key switch.

Counterpart of `RnsGad`'s branch of `lol_tpu/gadget.py`: g_i =
(Q/q_i) * [(Q/q_i)^{-1}]_{q_i}, digit_i(x) = centered [x]_{q_i}.  The
digits themselves are re-expanded inside the forward NTT kernels
(`ops.cuda.ntt_kernel.redigit`), so only the gadget vector lives here.
"""

from __future__ import annotations

import numpy as np

from . import numtheory as nt
from .rns import RnsBasis


def gadget_ints(basis: RnsBasis) -> list[int]:
    """The RNS gadget vector as Python ints mod Q."""
    Q = basis.modulus
    return [(Q // q) * nt.modinv((Q // q) % q, q) % Q for q in basis.qs]


def gadget_rns(basis: RnsBasis) -> np.ndarray:
    """(ell, nrns) uint32: gadget entries in residue form."""
    return np.array(
        [[g % q for q in basis.qs] for g in gadget_ints(basis)], dtype=np.uint32
    )
