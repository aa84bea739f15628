"""Plain BGV over a `Ring`: the relinearisation hint, and the step the
benchmark times (ciphertext multiply, RNS-gadget key switch, exact
rescale), computed from the definitions in plain int64 torch.

A ciphertext component is an (nrns, n, B) stack of CRT residues, one
ciphertext a column.  With the RNS gadget g_i (the CRT basis element: 1
mod q_i, 0 mod every other q_j), a hint row i encrypts g_i s^2 under s:
h0[i] = p e_i + g_i s^2 - a_i s, h1[i] = a_i.  The step, LSD encoding
(c(s) = f m + p e):

    (e0, e1, e2) = (c0 d0, c0 d1 + c1 d0, c1 d1)        per CRT slot
    x_i = [CRT_i^-1 e2_i] centred into (-q_i/2, q_i/2]  digit i, i < ell
    e0 += sum_i CRT(x_i) h0[i],  e1 += sum_i CRT(x_i) h1[i]
    rescale each of e0, e1 by q_l (the last modulus), exactly:
        v = p^-1 [CRT_l^-1 e_l] mod q_l, centred; delta = p v
        out_j = (e_j - CRT_j(delta)) q_l^-1 mod q_j      for j < l

CRT_i(x_i) is e2_i itself (the transform and its inverse are exact).
"""

from __future__ import annotations

import torch

from .ring import Ring


def _consts(values, device) -> torch.Tensor:
    return torch.tensor(list(values), dtype=torch.int64, device=device).view(-1, 1, 1)


def _centred_mod(x: torch.Tensor, q_src: int, q: int) -> torch.Tensor:
    """Residues mod q_src centred into (-q_src/2, q_src/2], then mod q."""
    return torch.where(x >= (q_src + 1) // 2, x - q_src, x) % q


def relin_hint(ring: Ring, p: int, s: torch.Tensor, a: torch.Tensor,
               e: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(h0, h1), each (ell = nrns, nrns, n) int32, from the secret key's
    coefficients s (n,), uniform residues a (ell, nrns, n) and small error
    coefficients e (ell, n), one integer polynomial a row, all int64 on
    the ring's device."""
    qs, mul = ring.qs, ring.mul
    s_crt = [ring.crt((s % q)[:, None], j)[:, 0] for j, q in enumerate(qs)]
    h0 = torch.empty_like(a)
    for i in range(len(qs)):
        for j, q in enumerate(qs):
            pe = ring.crt((p * e[i] % q)[:, None], j)[:, 0]
            h0[i, j] = (pe - mul(a[i, j], s_crt[j], q)) % q
        h0[i, i] = (h0[i, i] + mul(s_crt[i], s_crt[i], qs[i])) % qs[i]
    return h0.to(torch.int32), a.to(torch.int32)


def _rescale(ring: Ring, p: int, comp: torch.Tensor) -> torch.Tensor:
    qs, mul = ring.qs, ring.mul
    ql, last = qs[-1], len(qs) - 1
    v = mul(ring.crt(comp[last], last, inverse=True), pow(p, -1, ql), ql)
    out = []
    for j, q in enumerate(qs[:-1]):
        delta = mul(_centred_mod(v, ql, q), p % q, q)
        d = (comp[j] - ring.crt(delta, j)) % q
        out.append(mul(d, pow(ql, -1, q), q))
    return torch.stack(out)


def step(ring: Ring, p: int, c0, c1, d0, d1, h0, h1) -> tuple[torch.Tensor, torch.Tensor]:
    """The step on (nrns, n, B) int32 stacks: two (nrns - 1, n, B) int32
    components."""
    qs, mul = ring.qs, ring.mul
    qv = _consts(qs, c0.device)
    c0, c1, d0, d1 = (t.long() for t in (c0, c1, d0, d1))
    e0 = mul(c0, d0, qv)
    e1 = (mul(c0, d1, qv) + mul(c1, d0, qv)) % qv
    e2 = mul(c1, d1, qv)
    h0, h1 = h0.long()[..., None], h1.long()[..., None]
    for i, qi in enumerate(qs):
        xi = ring.crt(e2[i], i, inverse=True)
        for j, q in enumerate(qs):
            dij = e2[i] if j == i else ring.crt(_centred_mod(xi, qi, q), j)
            e0[j] = (e0[j] + mul(dij, h0[i, j], q)) % q
            e1[j] = (e1[j] + mul(dij, h1[i, j], q)) % q
    return tuple(_rescale(ring, p, e).to(torch.int32) for e in (e0, e1))
