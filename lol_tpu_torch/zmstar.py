"""The unit group (Z/mZ)^*: slot indexing and automorphisms.

Counterpart of `lol_tpu/zmstar.py`: the units mod m, their order in the
CRT slots of the transforms (`ops.general._global_units`), the group's
order and product table, and the slot permutation of the Galois
automorphism sigma_k : zeta -> zeta^k.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np

from .factored import fact
from .ops import general as gen


@lru_cache(maxsize=1024)
def units(m: int) -> tuple[int, ...]:
    """The units of Z/mZ, ascending."""
    if m == 1:
        return (0,)
    return tuple(u for u in range(m) if math.gcd(u, m) == 1)


@lru_cache(maxsize=1024)
def unit_index(m: int) -> dict[int, int]:
    return {u: i for i, u in enumerate(units(m))}


def order(m: int) -> int:
    """|(Z/mZ)^*| = phi(m)."""
    return fact(m).phi


def mul_table(m: int) -> np.ndarray:
    """(phi, phi) int32 table of unit products, by index into `units`."""
    us = np.array(units(m), dtype=np.int64)
    idx = np.zeros(max(m, 1), dtype=np.int32)
    idx[us] = np.arange(len(us), dtype=np.int32)
    return idx[np.outer(us, us) % max(m, 1)]


@lru_cache(maxsize=1024)
def canonical_slot_units(m: int, q: int) -> np.ndarray:
    """The unit of each CRT slot, in the transforms' slot order."""
    out = gen._global_units(gen.general_plan(m, q))
    out.flags.writeable = False  # shared through the cache
    return out


def automorphism_slot_perm(m: int, q: int, k: int) -> np.ndarray:
    """The CRT slot permutation of sigma_k (gcd(k, m) = 1): the slot that
    evaluates at omega^u reads the old slot at omega^(u k)."""
    if math.gcd(k, m) != 1:
        raise ValueError(f"automorphism: k={k} not a unit mod m={m}")
    us = canonical_slot_units(m, q)
    pos = {int(u): i for i, u in enumerate(us)}
    return np.array([pos[int(u) * k % m] for u in us], dtype=np.int64)
