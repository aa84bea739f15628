"""The complex CRT embedding: the characteristic-0 transform.

Counterpart of `lol_tpu/complexfield.py` (Lol's `Complex` and
`CRTEmbed`): base rings with no m-th roots of unity (Z, Q, R/qZ) embed
into C, where the CRT always exists; the continuous-error paths and
sanity checks use it.  Host numpy complex128, as the reference (which
wants double precision for the challenge bounds), in the exact
transforms' slot order (`ops.general._global_units`), so complex and
mod-q CRT slots correspond one for one.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

from .factored import fact
from .ops import ntt


@lru_cache(maxsize=256)
def _crt_matrix_c(m: int) -> np.ndarray:
    """(n, n) complex CRT matrix, canonical slot x powerful basis."""
    f = fact(m)
    exps = np.zeros(f.phi, dtype=np.int64)
    for flat in range(f.phi):
        idx = np.unravel_index(flat, f.phi_shape)
        exps[flat] = sum(int(j) * (m // pp.value) for j, pp in zip(idx, f.pps)) % m
    w = np.exp(2j * np.pi / max(m, 1))
    return np.array([[w ** ((u * e) % m) for e in exps] for u in _canonical_units_c(m)])


@lru_cache(maxsize=256)
def _canonical_units_c(m: int) -> tuple[int, ...]:
    """The canonical slot order with no modulus: per axis the transforms'
    order (the 2-axis by `crt_output_exponents`, odd axes ascending),
    combined by the CRT."""
    if m == 1:
        return (0,)
    parts = []
    for pp in fact(m).pps:
        pe = pp.value
        if pp.p == 2 and pp.e >= 2:
            us = (ntt.crt_output_exponents(pe // 2) % pe).astype(int)
        elif pp.p == 2:
            us = np.array([1])
        else:
            us = np.array([u for u in range(pe) if u % pp.p != 0])
        mi = m // pe
        parts.append((us % pe) * (mi * pow(mi, -1, pe) % m) % m)
    out = parts[0]
    for v in parts[1:]:
        out = np.add.outer(out, v) % m
    return tuple(int(u) for u in out.reshape(-1))


def crt_embed(x, m: int) -> np.ndarray:
    """Powerful-basis real / integer coefficients -> complex CRT slots."""
    return np.asarray(x, dtype=np.complex128) @ _crt_matrix_c(m).T


def crt_embed_inv(y, m: int) -> np.ndarray:
    """Complex slots -> powerful coefficients (real up to rounding)."""
    return np.linalg.solve(_crt_matrix_c(m), np.asarray(y, dtype=np.complex128).T).T


def round_complex(y) -> np.ndarray:
    """Round a near-real array to integers (Lol roundComplex); raises where
    the imaginary part is not negligible."""
    r = np.asarray(y)
    if np.max(np.abs(r.imag)) >= 1e-6 * max(1.0, float(np.max(np.abs(r)))):
        raise ValueError("round_complex: non-negligible imaginary part")
    return np.rint(r.real).astype(np.int64)
