"""The cyclotomic index m in factored form.

Counterpart of `lol_tpu/factored.py`: one frozen, hashable descriptor per
m, validated at construction, whose prime powers (primes ascending) give
the tensor factorization R_m = (x)_i R_{p_i^{e_i}} that the general-m
transforms of `ops/general.py` walk.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from functools import lru_cache

from . import numtheory as nt


@dataclass(frozen=True, order=True)
class PrimePower:
    """One p^e factor."""

    p: int
    e: int

    def __post_init__(self):
        if not nt.is_prime(self.p):
            raise ValueError(f"PrimePower: p={self.p} is not prime")
        if self.e < 1:
            raise ValueError(f"PrimePower: e={self.e} must be >= 1")

    @property
    def value(self) -> int:
        return self.p ** self.e

    @property
    def phi(self) -> int:
        """The totient of p^e."""
        return (self.p - 1) * self.p ** (self.e - 1)


@dataclass(frozen=True)
class Factored:
    """m with its prime powers `pps`, primes ascending."""

    m: int
    pps: tuple[PrimePower, ...] = field(init=False)

    def __post_init__(self):
        if self.m < 1:
            raise ValueError(f"Factored: m={self.m} must be >= 1")
        object.__setattr__(self, "pps", tuple(PrimePower(p, e) for p, e in nt.factorize(self.m)))

    @property
    def value(self) -> int:
        return self.m

    @property
    def phi(self) -> int:
        return math.prod(pp.phi for pp in self.pps)

    @property
    def mhat(self) -> int:
        """m-hat: m / 2 for even m, else m (the tweak scalar)."""
        return self.m // 2 if self.m % 2 == 0 else self.m

    @property
    def radical(self) -> int:
        return math.prod(pp.p for pp in self.pps)

    @property
    def odd_radical(self) -> int:
        """The product of the odd primes of m (the primes of g)."""
        return math.prod(pp.p for pp in self.pps if pp.p != 2)

    def divides(self, other: "Factored") -> bool:
        return other.m % self.m == 0

    def coprime(self, other: "Factored") -> bool:
        return math.gcd(self.m, other.m) == 1

    def gcd(self, other: "Factored") -> "Factored":
        return Factored(math.gcd(self.m, other.m))

    def lcm(self, other: "Factored") -> "Factored":
        return Factored(math.lcm(self.m, other.m))

    @property
    def phi_shape(self) -> tuple[int, ...]:
        """The coefficient tensor's shape, one axis per prime power: a flat
        length-phi(m) vector is its row-major reshape."""
        return tuple(pp.phi for pp in self.pps) if self.pps else (1,)

    def is_pow2(self) -> bool:
        return self.m == 1 or (len(self.pps) == 1 and self.pps[0].p == 2)

    def __hash__(self):
        return hash(("Factored", self.m))

    def __repr__(self):
        pps = "·".join(f"{pp.p}^{pp.e}" if pp.e > 1 else f"{pp.p}" for pp in self.pps)
        return f"Factored({self.m}={pps or '1'})"


@lru_cache(maxsize=1024)
def fact(m: int) -> Factored:
    """The interned Factored of m."""
    return Factored(m)
