"""RNS modulus chains: residue conversions, channel-wise arithmetic and
the decrypt-side lifts.

Counterpart of `lol_tpu/rns.py`: `RnsBasis.modulus`, the host-exact
`to_rns` / `from_rns` / `lift_centered` (numpy object ints) and the Garner
mixed-radix digits, the canonical representative and the centered lift
reduced mod p (`to_mixed_radix_jnp`/`pos_mod_jnp`/`lift_mod_jnp` there),
here in int64 torch with the residue axis first: (nrns, ...).  The
channel-wise ring arithmetic and the exact drop-last rescale take the
reference's ring-element layout, the residue axis second to last:
(..., nrns, n) int32 residues.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from . import numtheory as nt
from . import zq


@dataclass(frozen=True, init=False)
class RnsBasis:
    """An ordered chain of distinct, pairwise coprime moduli q_i < 2^30.
    Built from `qs` (ints) or, as the reference builds it, from `moduli`
    (`zq.Modulus` descriptors or ints); either way it holds the ints."""

    qs: tuple[int, ...]

    def __init__(self, qs=None, *, moduli=None):
        if (qs is None) == (moduli is None):
            raise TypeError("RnsBasis: give exactly one of qs, moduli")
        object.__setattr__(self, "qs", tuple(int(getattr(q, "q", q))
                                             for q in (qs if moduli is None else moduli)))
        for i, a in enumerate(self.qs):
            if not (2 <= a < (1 << zq.MAX_MODULUS_BITS)):
                raise ValueError(f"RnsBasis: modulus {a} out of [2, 2^30)")
            for b in self.qs[i + 1 :]:
                if math.gcd(a, b) != 1:
                    raise ValueError(f"RnsBasis: moduli {a}, {b} not coprime")

    @property
    def nrns(self) -> int:
        return len(self.qs)

    @property
    def modulus(self) -> int:
        """The full composite modulus Q = prod q_i (Python int)."""
        return math.prod(self.qs)

    def drop_last(self) -> "RnsBasis":
        if self.nrns < 2:
            raise ValueError("RnsBasis.drop_last: need >= 2 moduli")
        return rns_basis(self.qs[:-1])

    def to_rns(self, x) -> np.ndarray:
        """Integers (any shape; int64 or object) -> u32 residues with a
        leading rns axis, (nrns, *x.shape)."""
        xa = np.asarray(x)
        if xa.dtype != object and not np.issubdtype(xa.dtype, np.integer):
            raise TypeError(f"to_rns: integer input needed, got {xa.dtype}")
        if xa.dtype != object:
            xa = xa.astype(np.int64)
        return np.stack([np.mod(xa, q).astype(np.uint32) for q in self.qs]).reshape(
            (self.nrns,) + xa.shape)

    def from_rns(self, r) -> np.ndarray:
        """(nrns, ...) residues -> object ints in [0, Q)."""
        digits = self.to_mixed_radix(torch.from_numpy(np.asarray(r, dtype=np.int64))).numpy()
        x = digits[-1].astype(object)
        for j in range(self.nrns - 2, -1, -1):
            x = x * self.qs[j] + digits[j].astype(object)
        return x

    def qv(self, device) -> torch.Tensor:
        """The moduli as an (nrns, 1) int64 tensor on device, to broadcast
        over (..., nrns, n) residues."""
        return _qv(self.qs, str(torch.device(device)))

    def add(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return zq.add_mod(a, b, self.qv(a.device)).to(torch.int32)

    def sub(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return zq.sub_mod(a, b, self.qv(a.device)).to(torch.int32)

    def neg(self, a: torch.Tensor) -> torch.Tensor:
        return zq.neg_mod(a, self.qv(a.device)).to(torch.int32)

    def mul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return zq.mul_mod(a, b, self.qv(a.device)).to(torch.int32)

    def rescale_drop_last(self, a: torch.Tensor, dec_basis: bool = False) -> torch.Tensor:
        """Exact modulus switch Q -> Q / q_last of (..., nrns, n) residues:
        b_i = (a_i - [a]_last) q_last^-1 mod q_i, [a]_last the centered
        residue mod q_last, so b = round(a / q_last) exactly.  The map is
        the same in every basis: dec_basis changes nothing, as in the JAX
        package."""
        ql = self.qs[-1]
        last = a[..., -1:, :].long()
        centered = torch.where(last >= (ql + 1) // 2, last - ql, last)
        qv = self.drop_last().qv(a.device)
        inv = _qv(tuple(nt.modinv(ql % q, q) for q in self.qs[:-1]), str(a.device))
        return ((a[..., :-1, :].long() - centered) % qv * inv % qv).to(torch.int32)

    def to_mixed_radix(self, r: torch.Tensor) -> torch.Tensor:
        """(nrns, ...) residues -> int64 Garner digits v with
        x = v_0 + q_0 v_1 + q_0 q_1 v_2 + ..., v_i in [0, q_i)."""
        if r.shape[0] != self.nrns:
            raise ValueError(f"to_mixed_radix: {r.shape[0]} channels, basis has {self.nrns}")
        r = r.long()
        digits = [r[0]]
        for i in range(1, self.nrns):
            qi = self.qs[i]
            t = r[i]
            for j in range(i):
                t = (t - digits[j]) % qi
                t = t * nt.modinv(self.qs[j] % qi, qi) % qi
            digits.append(t)
        return torch.stack(digits)

    def _horner_mod(self, v: torch.Tensor, p: int) -> torch.Tensor:
        acc = v[-1] % p
        for j in range(self.nrns - 2, -1, -1):
            acc = (acc * (self.qs[j] % p) + v[j] % p) % p
        return acc

    def pos_mod(self, r: torch.Tensor, p: int) -> torch.Tensor:
        """[x]_p in [0, p) as int64 for the canonical representative x in
        [0, Q) of (nrns, ...) residues: Horner over the Garner digits, with
        no centering (the MSD decrypt's rounding reads it)."""
        return self._horner_mod(self.to_mixed_radix(r), p)

    def lift_mod(self, r: torch.Tensor, p: int) -> torch.Tensor:
        """[lift_centered(r)]_p in [0, p) as int64, for (nrns, ...)
        residues: Horner over the Garner digits gives x mod p; x >= (Q+1)/2
        is a most-significant-first digit compare."""
        v = self.to_mixed_radix(r)
        acc = self._horner_mod(v, p)
        t = (self.modulus + 1) // 2
        tdig = []
        for q in self.qs:
            tdig.append(t % q)
            t //= q
        ge = torch.zeros(acc.shape, dtype=torch.bool, device=acc.device)
        eq = torch.ones(acc.shape, dtype=torch.bool, device=acc.device)
        for i in range(self.nrns - 1, -1, -1):
            ge = ge | (eq & (v[i] > tdig[i]))
            eq = eq & (v[i] == tdig[i])
        ge = ge | eq  # x == T counts as high (lift in [-Q/2, Q/2))
        return torch.where(ge, (acc - self.modulus % p) % p, acc)

    def lift_centered(self, r: np.ndarray) -> np.ndarray:
        """(nrns, ...) residues -> object ints in [-Q/2, Q/2)."""
        x = self.from_rns(r)
        Q = self.modulus
        return np.where(x >= (Q + 1) // 2, x - Q, x)


@lru_cache(maxsize=1024)
def _qv(values: tuple[int, ...], device: str) -> torch.Tensor:
    return torch.tensor(values, dtype=torch.int64, device=device).view(-1, 1)


@lru_cache(maxsize=256)
def rns_basis(qs: tuple[int, ...]) -> RnsBasis:
    return RnsBasis(tuple(qs))
