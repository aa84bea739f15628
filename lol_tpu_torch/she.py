"""BGV parameters, keys, plaintexts, key-switch and tunnel hints.

Counterpart of the pieces of `lol_tpu/she.py` that the batched pipeline
uses (2-power m): c(s) = c0 + c1 s satisfies c(s) = f*m + p*e (mod Q)
under the LSD encoding and c(s) = round(Q/p)*m + e (mod Q) under the MSD
one, with message m in R_p, small error e and a tracked scale factor f
in Z_p^*.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from . import numtheory as nt
from . import sampling
from .linear import Linear
from .ops import ntt as ntt_mod
from .ring import RingContext, ring_context
from .rns import rns_basis


@dataclass(frozen=True)
class SHEParams:
    """Cyclotomic index m (2-power), plaintext modulus p, ciphertext chain
    qs (NTT primes for m), and the error variance."""

    m: int
    p: int
    qs: tuple[int, ...]
    var: float = 9.0

    def __post_init__(self):
        for q in self.qs:
            if math.gcd(self.p, q) != 1:
                raise ValueError(f"p={self.p} not coprime to q={q}")

    @property
    def ctx(self) -> RingContext:
        return ring_context(self.m, self.qs)


@dataclass(frozen=True, eq=False)
class SK:
    """Secret key: small integer coefficients, an (n,) int64 CPU tensor."""

    params: SHEParams
    s_ints: torch.Tensor
    var: float


@dataclass(frozen=True, eq=False)
class KSHint:
    """RNS-gadget key-switch hint in the CRT domain: h0[j] = p e_j + g_j t
    - a_j s and h1[j] = a_j, each an (ell, nrns, n) int32 tensor."""

    params: SHEParams
    h0: torch.Tensor
    h1: torch.Tensor


@dataclass(frozen=True, eq=False)
class TunnelHint:
    """Everything that applies the E-linear map `lin` (R -> S) to a
    ciphertext and moves it to ring S: per relative basis element b_i of
    R/E, a KSHint over S encrypting f(b_i * s_R) under s_S."""

    lin: Linear
    hints: tuple[KSHint, ...]


def gen_sk(params: SHEParams, generator: torch.Generator) -> SK:
    """Sample s as rounded Gaussian coefficients of variance params.var."""
    s = sampling.gaussian_ints((params.ctx.n,), params.var, generator, "cpu")
    return SK(params, s, params.var)


def pt_random(params: SHEParams, generator: torch.Generator,
              batch: tuple[int, ...] = ()) -> torch.Tensor:
    """Uniform plaintext coefficients in [0, p), shape (n, *batch), int32."""
    return torch.randint(0, params.p, (params.ctx.n, *batch),
                         generator=generator, device=generator.device,
                         dtype=torch.int32)


def pt_mul(params: SHEParams, a, b) -> np.ndarray:
    """Plaintext ring product in R_p (exact, host): a numpy negacyclic NTT
    product over an auxiliary chain sized to the integer bound
    n*(p-1)^2, centered-lifted and reduced mod p.  int64 (n,) out."""
    n = params.ctx.n
    p = params.p
    a = np.asarray(a, dtype=np.int64) % p
    b = np.asarray(b, dtype=np.int64) % p
    aux_qs = _aux_chain(2 * n, 2 * n * (p - 1) ** 2)
    res = []
    for q in aux_qs:
        plan = ntt_mod.ntt_plan(n, q)
        fa = ntt_mod.np_ntt_forward(np.mod(a, q).astype(np.uint32)[None], plan)
        fb = ntt_mod.np_ntt_forward(np.mod(b, q).astype(np.uint32)[None], plan)
        prod = fa[0].astype(np.int64) * fb[0].astype(np.int64) % q
        res.append(ntt_mod.np_ntt_inverse(prod[None].astype(np.uint32), plan)[0])
    lifted = rns_basis(aux_qs).lift_centered(np.stack(res))
    return (lifted % p).astype(np.int64)


def _aux_chain(m_mult: int, bound: int) -> tuple[int, ...]:
    """Smallest chain of 29-bit primes = 1 mod m_mult whose product
    exceeds `bound`, so centered lifts of values in [-bound/2, bound/2]
    are exact."""
    k = 1
    while True:
        qs = nt.ntt_primes(m_mult, 29, k)
        if math.prod(qs) > bound:
            return tuple(qs)
        k += 1
