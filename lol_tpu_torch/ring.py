"""Ring contexts: a cyclotomic index with its RNS chain.

Counterpart of `lol_tpu/ring.py`'s `RingContext`: R_Q = Z_Q[zeta_m] of
degree n = phi(m).  A 2-power m transforms by one negacyclic NTT plan per
modulus (`ntt_plans`); any m by the tensor-factored plans of
`ops/general.py` (`general_plans`).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

from .factored import Factored, fact
from .ops import general as gen
from .ops import ntt
from .rns import RnsBasis, rns_basis


@dataclass(frozen=True)
class RingContext:
    m: int
    basis: RnsBasis

    @property
    def fm(self) -> Factored:
        return fact(self.m)

    @property
    def n(self) -> int:
        return self.fm.phi

    def ntt_plans(self) -> list[ntt.NTTPlan]:
        if not self.fm.is_pow2():
            raise NotImplementedError("general-m plans: use general_plans()")
        return [ntt.ntt_plan(self.n, q) for q in self.basis.qs]

    def general_plans(self) -> list[gen.GeneralPlan]:
        return [gen.general_plan(self.m, q) for q in self.basis.qs]


@lru_cache(maxsize=512)
def ring_context(m: int, qs: tuple[int, ...]) -> RingContext:
    return RingContext(m, rns_basis(tuple(qs)))
