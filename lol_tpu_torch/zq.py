"""Z_q arithmetic: host constants and the plain torch reference forms.

Counterpart of `lol_tpu/zq.py`.  Moduli are primes q < 2^30 held as
Python ints.  Residues cross the port's API as `torch.int32` in [0, q)
(bit-identical to the JAX package's u32, since q < 2^30); the plain
functions here compute in int64, where every product of two residues is
below 2^60 and `(a * b) % q` is exact.

The kernels (`csrc/`) work in u32: the wide product's high word, Shoup's
multiply by a constant with its companion word, and Harvey's lazy form of
it whose result lies in [0, 2q).  `mulhi32`, `mul32_wide`, `mul_mod_shoup`
and `mul_shoup_lazy` are their plain versions: they take u32 words (any
integer tensor, read modulo 2^32) and return int64 holding exactly the u32
words the kernels compute, lazy ranges included.  `np_mul_mod` /
`np_matvec_mod` are the numpy mirrors, `Modulus` / `modulus` the modulus
descriptor.

`q` may be a Python int or an int64 tensor that broadcasts against the
operands (one modulus per RNS channel).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from . import numtheory as nt

MAX_MODULUS_BITS = 30  # q < 2^30: a+b and 4q fit in u32; Barrett mu fits u32
_MASK32 = 0xFFFFFFFF


def _u32(a) -> torch.Tensor:
    return torch.as_tensor(a).long() & _MASK32


def mulhi32(a, b) -> torch.Tensor:
    """The high 32 bits of the 64-bit product of u32 words a and b (int64
    out), assembled from 16-bit halves so that no int64 overflows."""
    a, b = _u32(a), _u32(b)
    a0, a1, b0, b1 = a & 0xFFFF, a >> 16, b & 0xFFFF, b >> 16
    w0 = a0 * b0
    t = a1 * b0 + (w0 >> 16)
    w1 = (t & 0xFFFF) + a0 * b1
    return a1 * b1 + (t >> 16) + (w1 >> 16)


def mul32_wide(a, b) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) words of the 64-bit product of u32 words; lo is the
    wrapping u32 product."""
    a, b = _u32(a), _u32(b)
    lo = (a * (b & 0xFFFF) + ((a * (b >> 16)) << 16)) & _MASK32
    return mulhi32(a, b), lo


def mul_mod_shoup(a, w, w_sh, q) -> torch.Tensor:
    """(a * w) mod q for a u32 word a, a constant w in [0, q) and its Shoup
    companion w_sh = floor(w 2^32 / q): the wrapping a w - mulhi(a, w_sh) q,
    which lies in [0, 2q), then one conditional subtraction."""
    r = mul_shoup_lazy(a, w, _u32(w_sh) >> 16, _u32(w_sh) & 0xFFFF, q)
    return torch.where(r >= q, r - q, r)


def mul_shoup_lazy(a, w, w_sh_hi, w_sh_lo, q) -> torch.Tensor:
    """Harvey's lazy Shoup multiply: a word == a w (mod q) in [0, 2q), the
    companion given as its 16-bit halves (w_sh >> 16, w_sh & 0xFFFF), for
    any u32 word a and w in [0, q)."""
    a = _u32(a)
    hi = mulhi32(a, (_u32(w_sh_hi) << 16) | _u32(w_sh_lo))
    return (a * _u32(w) - hi * q) & _MASK32


def barrett_mu(q: int) -> int:
    """mu = floor(2^(2k) / q) for k = bitlength(q); fits u32 for k <= 30."""
    if not (2 <= q < (1 << MAX_MODULUS_BITS)):
        raise ValueError(f"modulus {q} out of range [2, 2^{MAX_MODULUS_BITS})")
    return (1 << (2 * q.bit_length())) // q


def shoup(w: int, q: int) -> int:
    """Shoup companion word for constant w in [0, q): floor(w * 2^32 / q)."""
    return (int(w) << 32) // q


def shoup_np(w: np.ndarray, q: int) -> np.ndarray:
    """Vectorized Shoup companions (u32) for an array of constants < q."""
    w64 = w.astype(np.int64)
    if w64.size and int(w64.max()) >= q:
        raise ValueError("shoup_np: entries must be < q")
    return ((w64 << 32) // q).astype(np.uint32)


def add_mod(a: torch.Tensor, b: torch.Tensor, q) -> torch.Tensor:
    return (a.long() + b.long()) % q


def sub_mod(a: torch.Tensor, b: torch.Tensor, q) -> torch.Tensor:
    return (a.long() - b.long()) % q


def neg_mod(a: torch.Tensor, q) -> torch.Tensor:
    return (-a.long()) % q


def mul_mod(a: torch.Tensor, b: torch.Tensor, q, mu: int | None = None) -> torch.Tensor:
    """(a * b) mod q for residues a, b in [0, q), q < 2^30 (exact in int64).

    mu: the Barrett constant of the JAX package's `zq.mul_mod`.  None or
    `barrett_mu(q)` gives the exact product; any other u32 mu (q a Python
    int) runs that function's u32 Barrett steps with it and returns the
    same words, whatever they are."""
    if mu is None or mu == barrett_mu(int(q)):
        return (a.long() * b.long()) % q
    mu = int(mu)
    if not 0 <= mu < 1 << 32:
        raise OverflowError(f"mul_mod: mu={mu} out of bounds for u32")
    k = q.bit_length()
    hi, lo = mul32_wide(a, b)
    t = ((hi << (33 - k)) | (lo >> (k - 1))) & _MASK32  # floor(a b / 2^(k-1))
    qhi, qlo = mul32_wide(t, mu)
    quot = ((qhi << (31 - k)) | (qlo >> (k + 1))) & _MASK32
    r = (lo - quot * q) & _MASK32
    r = torch.where(r >= q, r - q, r)
    return torch.where(r >= q, r - q, r)


def reduce_mod(x: torch.Tensor, q) -> torch.Tensor:
    """x mod q for any non-negative x below 2^63."""
    return x.long() % q


# ---------------------------------------------------------------------------
# exact numpy mirrors
# ---------------------------------------------------------------------------


def np_mul_mod(a: np.ndarray, b: np.ndarray, q: int) -> np.ndarray:
    """Exact int64 (a * b) mod q (products below 2^60), u32 out."""
    return (a.astype(np.int64) * b.astype(np.int64) % q).astype(np.uint32)


def np_matvec_mod(A: np.ndarray, x: np.ndarray, q: int) -> np.ndarray:
    """Exact (A @ x) mod q, A split at 15 bits so that no int64 overflows
    (entries in [0, q), rows up to 2^18 long)."""
    A = A.astype(np.int64)
    x = x.astype(np.int64)
    Ah, Al = A >> 15, A & 0x7FFF
    return (((Ah @ x % q) << 15) + Al @ x) % q


# ---------------------------------------------------------------------------
# modulus descriptor
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Modulus:
    """One RNS modulus q with its derived constants."""

    q: int

    def __post_init__(self):
        if not (2 <= self.q < (1 << MAX_MODULUS_BITS)):
            raise ValueError(f"Modulus {self.q} out of [2, 2^{MAX_MODULUS_BITS})")

    @property
    def mu(self) -> int:
        return barrett_mu(self.q)

    @property
    def is_prime(self) -> bool:
        return nt.is_prime(self.q)

    def inv(self, a: int) -> int:
        return nt.modinv(a, self.q)

    def has_crt(self, m: int) -> bool:
        """True iff Z_q has a principal m-th root (q prime, m | q - 1)."""
        return self.is_prime and (self.q - 1) % m == 0

    def root_of_unity(self, m: int) -> int:
        return nt.principal_root_of_unity(m, self.q)

    def __repr__(self):
        return f"Modulus({self.q})"


@lru_cache(maxsize=1024)
def modulus(q: int) -> Modulus:
    return Modulus(q)
