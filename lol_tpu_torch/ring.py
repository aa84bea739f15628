"""Ring contexts: a cyclotomic index with its RNS chain.

Counterpart of `lol_tpu/ring.py`'s `RingContext` for 2-power m only:
R_Q = Z_Q[x]/(x^n + 1), n = m/2, with one negacyclic NTT plan per
modulus.  General m (the JAX package's `ops/general.py`) is not ported
yet and raises NotImplementedError.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

from .ops import ntt
from .rns import RnsBasis, rns_basis


@dataclass(frozen=True)
class RingContext:
    m: int
    basis: RnsBasis

    def __post_init__(self):
        if self.m < 2 or self.m & (self.m - 1):
            raise NotImplementedError(
                f"RingContext: m={self.m}; only 2-power m is ported"
            )

    @property
    def n(self) -> int:
        return self.m // 2

    def ntt_plans(self) -> list[ntt.NTTPlan]:
        return [ntt.ntt_plan(self.n, q) for q in self.basis.qs]


@lru_cache(maxsize=512)
def ring_context(m: int, qs: tuple[int, ...]) -> RingContext:
    return RingContext(m, rns_basis(tuple(qs)))
