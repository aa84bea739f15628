"""Plain ring tunneling R -> S over `Ring`s: the E-linear map, the
tunnel hint, and the tunnel the benchmark times, computed from the
definitions in plain int64 torch.

Rings E | R and E | S share one chain of moduli.  Every element is held
as in `ring.py`: a ring element is the row-major flattening of its
tensor-factored powerful-basis coefficients (one axis a prime of m,
ascending), and its CRT residues are `Ring.crt`'s, in the bit-reversed
slot order of the 2-power axis.

The relative powerful basis of R / E.  On the axis of a prime p with
p^e || m_R and p^e' || m_E, R's coefficient k < phi(p^e) is the monomial
zeta^k, and with r = phi(p^e) / phi(p^e') it splits as k = j r + i:
zeta^k = zeta^i (zeta^r)^j, zeta^r generating E's axis (r = p^(e - e')
where e' >= 1; where p does not divide m_E, E's axis has the one
coefficient j = 0 and i runs over the whole axis).  The relative basis
element b_i is the monomial zeta_R^i with i the row-major flattening of
the axes' i, and the relative coefficient a_i in E holds, at E's
position j (row-major over the axes' j), R's coefficient at the
flattening of the axes' j r + i:  x = sum_i b_i a_i.  b_i is R's
coefficient at position (j = 0, i).

The embedding E -> S on the powerful basis: on the axis of a prime p of
m_S with p^s || m_S, E's coefficient j lands at j p^(s - e') (zeta_E =
zeta_S^(m_S / m_E)); a prime of m_S alone keeps E's element at its
coefficient 0.

The map L: R -> S is E-linear and given by the images y_i = L(b_i), each
an element of S by its integer coefficients:

    L(x) = sum_i y_i embed(a_i)                  (CRT over S: a product a slot)

The tunnel hint, for each i and gadget row j, over S, with the RNS
gadget g_j (1 mod q_j, 0 mod every other modulus, as in `bgv.py`):

    h0_ij = p e_ij + g_j L(b_i s_R) - a_ij s_S,   h1_ij = a_ij

with a_ij uniform CRT residues and e_ij a small integer polynomial.
b_i s_R is the product in R (through R's CRT).  The tunnel of a
ciphertext (c0, c1) over R, in CRT residues:

    a_i = the relative coefficients of CRT_R^-1(c), each channel
    c0' = sum_i CRT_S(embed(a0_i)) y_i + sum_{i,j} CRT_S(embed(digit_j(a1_i))) h0_ij
    c1' = sum_{i,j} CRT_S(embed(digit_j(a1_i))) h1_ij

digit_j(a) the channel-j residues of a, centred into (-q_j/2, q_j/2],
then reduced mod each modulus, as in `bgv.step`.  Then c0' + c1' s_S =
L(c0 + c1 s_R) + p (small), since sum_j g_j digit_j(a) = a mod Q.  Every
product goes through the ring's `mul`, so that the control computes in
float64.
"""

from __future__ import annotations

import torch

from .bgv import _centred_mod
from .ring import Ring, factorize


def _phi(p: int, e: int) -> int:
    return (p - 1) * p ** (e - 1) if e else 1


def rel_positions(m_e: int, m_r: int) -> torch.Tensor:
    """(d, n_e) int64: R's coefficient position of E's coefficient j of
    the relative coefficient a_i, at [i, j]."""
    if m_r % m_e:
        raise ValueError(f"{m_e} does not divide {m_r}")
    e_of = dict(factorize(m_e))
    T = torch.zeros(1, 1, dtype=torch.int64)
    for p, e in factorize(m_r):
        phi_r, phi_e = _phi(p, e), _phi(p, e_of.get(p, 0))
        r = phi_r // phi_e
        ax = torch.arange(phi_e)[None, :] * r + torch.arange(r)[:, None]  # (i, j) -> j r + i
        T = (T[:, None, :, None] * phi_r + ax[None, :, None, :]).reshape(
            T.shape[0] * r, T.shape[1] * phi_e)
    return T


def embed_positions(m_e: int, m_s: int) -> torch.Tensor:
    """(n_e,) int64: S's coefficient position of E's coefficient j."""
    if m_s % m_e:
        raise ValueError(f"{m_e} does not divide {m_s}")
    e_of = dict(factorize(m_e))
    flat = torch.zeros(1, dtype=torch.int64)
    for p, s in factorize(m_s):
        e = e_of.get(p, 0)
        idx = torch.arange(_phi(p, e)) * p ** (s - e) if e else torch.zeros(1, dtype=torch.int64)
        flat = (flat[:, None] * _phi(p, s) + idx[None, :]).reshape(-1)
    return flat


class Map:
    """The E-linear map L: R -> S with images ys (d, n_s) (integer
    coefficients over S, on the rings' device) of R / E's relative basis;
    R and S are `Ring`s over one chain, S's `mul` used for every product."""

    def __init__(self, m_e: int, ring_r: Ring, ring_s: Ring, ys: torch.Tensor):
        if ring_r.qs != ring_s.qs:
            raise ValueError("tunnel: R and S over different chains")
        self.r, self.s = ring_r, ring_s
        self.rel = rel_positions(m_e, ring_r.m).to(ys.device)
        self.emb = embed_positions(m_e, ring_s.m).to(ys.device)
        self.d = self.rel.shape[0]
        if tuple(ys.shape) != (self.d, ring_s.n):
            raise ValueError(f"tunnel: need {self.d} images of {ring_s.n} coefficients")
        # ys_crt[k]: (d, n_s, 1) CRT residues of the images mod qs[k]
        self.ys_crt = [ring_s.crt((ys % q).T, k).T[..., None]
                       for k, q in enumerate(ring_s.qs)]

    def parts(self, x: torch.Tensor) -> torch.Tensor:
        """(n_r, B) coefficients over R -> (d, n_s, B): embed(a_i), each
        relative coefficient embedded in S."""
        out = x.new_zeros((self.d, self.s.n, x.shape[1]))
        out[:, self.emb, :] = x[self.rel]
        return out

    def __call__(self, x: torch.Tensor, ch: int) -> torch.Tensor:
        """(n_r, B) coefficients mod qs[ch] over R -> the (n_s, B) CRT
        residues mod qs[ch] of L(x)."""
        q, mul, parts = self.s.qs[ch], self.s.mul, self.parts(x)
        acc = torch.zeros((self.s.n, x.shape[1]), dtype=torch.int64, device=x.device)
        for i in range(self.d):
            acc = (acc + mul(self.s.crt(parts[i], ch), self.ys_crt[ch][i], q)) % q
        return acc


def tunnel_targets(lmap: Map, s_r: torch.Tensor) -> torch.Tensor:
    """(d, nrns, n_s) int64: the CRT residues over S of L(b_i s_R), for s_R
    by its (n_r,) integer coefficients."""
    R, qs = lmap.r, lmap.r.qs
    out = torch.empty((lmap.d, len(qs), lmap.s.n), dtype=torch.int64, device=s_r.device)
    for k, q in enumerate(qs):
        s_crt = R.crt((s_r % q)[:, None], k)
        for i in range(lmap.d):
            mono = torch.zeros((R.n, 1), dtype=torch.int64, device=s_r.device)
            mono[lmap.rel[i, 0]] = 1  # b_i
            bs = R.crt(R.mul(R.crt(mono, k), s_crt, q), k, inverse=True)
            out[i, k] = lmap(bs, k)[:, 0]
    return out


def tunnel_hint(lmap: Map, p: int, s_r: torch.Tensor, s_s: torch.Tensor, a: torch.Tensor,
                e: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(h0, h1), each (d, ell = nrns, nrns, n_s) int32, from the keys'
    integer coefficients s_r (n_r,) and s_s (n_s,), uniform CRT residues
    a (d, ell, nrns, n_s) and small error coefficients e (d, ell, n_s),
    all int64 on one device."""
    S, qs = lmap.s, lmap.s.qs
    t = tunnel_targets(lmap, s_r)
    h0 = torch.empty_like(a)
    for k, q in enumerate(qs):
        s_crt = S.crt((s_s % q)[:, None], k)[:, 0]
        for i in range(lmap.d):
            for j in range(len(qs)):
                pe = S.crt((p * e[i, j] % q)[:, None], k)[:, 0]
                h0[i, j, k] = (pe - S.mul(a[i, j, k], s_crt, q)) % q
                if j == k:  # g_j = 1 mod q_j, 0 mod the others
                    h0[i, j, k] = (h0[i, j, k] + t[i, k]) % q
    return h0.to(torch.int32), a.to(torch.int32)


def tunnel(lmap: Map, c0, c1, h0, h1) -> tuple[torch.Tensor, torch.Tensor]:
    """The tunnel of (nrns, n_r, B) int32 stacks over R: two (nrns, n_s,
    B) int32 stacks over S."""
    R, S, qs = lmap.r, lmap.s, lmap.s.qs
    x0 = [R.crt(c0[k], k, inverse=True) for k in range(len(qs))]
    x1 = [R.crt(c1[k], k, inverse=True) for k in range(len(qs))]
    h0, h1 = h0.long()[..., None], h1.long()[..., None]
    out0, out1 = [], []
    for k, q in enumerate(qs):
        acc0, acc1 = lmap(x0[k], k), 0
        for j, qj in enumerate(qs):
            parts = lmap.parts(_centred_mod(x1[j], qj, q))
            for i in range(lmap.d):
                dij = S.crt(parts[i], k)
                acc0 = (acc0 + S.mul(dij, h0[i, j, k], q)) % q
                acc1 = (acc1 + S.mul(dij, h1[i, j, k], q)) % q
        out0.append(acc0)
        out1.append(acc1)
    return torch.stack(out0).to(torch.int32), torch.stack(out1).to(torch.int32)
