"""Index tables between cyclotomic rings m_sub | m_sup.

Counterpart of the index tables of `lol_tpu/ops/general.py` that ring
tunneling reads (`embed_pow_table`, `rel_coeff_table`,
`rel_pow_basis_positions`, `general.py:606`, `:718`, `:764` there), for
2-power indices only, where the powerful basis is the power basis
x^0, ..., x^(n-1) with n = max(m/2, 1) and the tables reduce to closed
forms: with r = n_sup / n_sub, sub coefficient j sits at sup position
j*r, and relative basis element b_i = x^i gathers the coefficients at
i, i + r, i + 2r, ...  A non-2-power index raises NotImplementedError,
as `ring.RingContext` does.

The general-m machinery of the JAX module (`GeneralPlan`, `crt_cm`,
`l_cm` and the tables over composite indices) lands here when general m
is ported.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np


def _phi(m: int) -> int:
    """Degree of the 2-power cyclotomic ring of index m."""
    if m < 1 or m & (m - 1):
        raise NotImplementedError(f"index tables: m={m}; only 2-power m is ported")
    return max(m // 2, 1)


def _check(m_sub: int, m_sup: int) -> tuple[int, int]:
    n_sub, n_sup = _phi(m_sub), _phi(m_sup)
    if m_sup % m_sub:
        raise ValueError(f"index tables: need m_sub | m_sup, got {m_sub}, {m_sup}")
    return n_sub, n_sup


def _frozen(a: np.ndarray) -> np.ndarray:
    a.flags.writeable = False  # shared by every caller through the cache
    return a


@lru_cache(maxsize=512)
def embed_pow_table(m_sub: int, m_sup: int) -> np.ndarray:
    """(n_sub,) int64: the sup coefficient position of each sub
    coefficient (the embedding's scatter)."""
    n_sub, n_sup = _check(m_sub, m_sup)
    return _frozen(np.arange(n_sub, dtype=np.int64) * (n_sup // n_sub))


@lru_cache(maxsize=512)
def rel_coeff_table(m_sub: int, m_sup: int) -> np.ndarray:
    """(d, n_sub) int64 with T[i, j] = the sup position of coefficient j
    of the relative coefficient a_i: x = sum_i b_i * embed(a_i), d = r."""
    n_sub, n_sup = _check(m_sub, m_sup)
    r = n_sup // n_sub
    return _frozen(np.arange(n_sub, dtype=np.int64)[None, :] * r
                   + np.arange(r, dtype=np.int64)[:, None])


@lru_cache(maxsize=512)
def rel_pow_basis_positions(m_sub: int, m_sup: int) -> np.ndarray:
    """(d,) int64: the exponent of each relative basis monomial b_i
    (T[i, 0])."""
    return _frozen(rel_coeff_table(m_sub, m_sup)[:, 0].copy())
