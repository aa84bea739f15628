"""Gadgets: the RNS (CRT) gadget of the key switch and the base-b gadget
of the KH-PRF.

Counterpart of `RnsGad`'s and `BaseBGad`'s branches of
`lol_tpu/gadget.py`.  RNS: g_i = (Q/q_i) * [(Q/q_i)^{-1}]_{q_i},
digit_i(x) = centered [x]_{q_i}; the digits themselves are re-expanded
inside the forward NTT kernels (`ops.cuda.ntt_kernel.redigit`), so only
the gadget vector lives here.  Base b (over one modulus q, the PRF's p):
g = [1, b, b^2, ...] with balanced digits of the centered lift, on the
host (set-up, once per PRF input).
"""

from __future__ import annotations

from dataclasses import dataclass

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


@dataclass(frozen=True)
class BaseBGad:
    """gadget = [1, b, b^2, ...] with balanced base-b digits."""

    b: int

    def __post_init__(self):
        if self.b < 2:
            raise ValueError("BaseBGad: b >= 2 required")


def num_digits(spec: BaseBGad, modulus: int) -> int:
    """Digits of the base-b gadget over Z_modulus: the least ell with
    b^ell >= modulus."""
    ell, t = 0, 1
    while t < modulus:
        t *= spec.b
        ell += 1
    return ell


def _signed_digits(v: int, b: int, ell: int) -> list[int]:
    """Balanced base-b digits of integer v: v = sum d_j b^j, d in [-b/2, b/2)."""
    out = []
    for _ in range(ell):
        d = v % b
        if d >= (b + 1) // 2:
            d -= b
        out.append(d)
        v = (v - d) // b
    if v != 0:
        raise ValueError("digit overflow: |v| too large for ell digits")
    return out


def _balanced_digits(spec: BaseBGad, q: int, a) -> tuple[np.ndarray, np.ndarray]:
    """`_signed_digits` of the centered lifts of residues a mod q, all at
    once: the (ell, *a.shape) int64 digits and what is left above them."""
    b, ell = spec.b, num_digits(spec, q)
    x = np.asarray(a, dtype=np.int64) % q
    x = np.where(x >= (q + 1) // 2, x - q, x)
    digs = []
    for _ in range(ell):
        d = x % b
        d = np.where(d >= (b + 1) // 2, d - b, d)
        digs.append(d)
        x = (x - d) // b
    return np.stack(digs), x


def decompose_host(spec: BaseBGad, q: int, a) -> np.ndarray:
    """Host oracle over one modulus q: (..., n) residues -> (ell, ..., n)
    int64 digits in residue form, sum_j digits_j b^j = a (mod q); raises
    where a centered lift needs more than ell digits (as `_signed_digits`)."""
    digs, rest = _balanced_digits(spec, q, a)
    if rest.any():
        raise ValueError("digit overflow: |v| too large for ell digits")
    return digs % q


def decompose(spec: BaseBGad, q: int, a) -> np.ndarray:
    """The KH-PRF's decomposition (`decompose_base_jnp` of the reference,
    which `gadget.decompose` dispatches to over one modulus): the same
    ell balanced digits in residue form, with no overflow check (a digit
    string that overflows still sums to a mod q when b^ell = 0 mod q, as
    for q = 2^k, b = 2)."""
    return _balanced_digits(spec, q, a)[0] % q
