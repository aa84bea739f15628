"""Hensel-lifted CRT sets: the plaintext slot idempotents of R_m / p^k R_m.

Counterpart of `lol_tpu/crtset.py` (the port's own copy).  For p coprime
to m, R/pR = prod_i GF(p^d) with one factor per orbit of multiplication
by p on (Z/m)^*; the CRT set {e_i} is the system of orthogonal
idempotents (e_i e_j = delta_ij e_i, sum e_i = 1), lifted from mod p to
mod p^k by the quadratic iteration e <- 3e^2 - 2e^3.
`linear.slot_projection` builds HomomPRF's tower-descent maps from them.

Host-side exact computation (Python ints); sizes are plaintext-ring
sized and nothing here runs on the device.  `crt_set_ints` returns the
idempotents as powerful-basis integer rows, and `crt_set_cyc` as the
ring elements of R_{p^k} that the JAX package's returns.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np

from . import numtheory as nt
from .factored import fact


# ---------------------------------------------------------------------------
# cyclotomic polynomials and power->powerful basis conversion
# ---------------------------------------------------------------------------


@lru_cache(maxsize=512)
def cyclotomic_poly(m: int) -> tuple[int, ...]:
    """Integer coefficients of Phi_m(x), low-to-high."""
    # Phi_m(x) = prod_{d | m} (x^d - 1)^{mu(m/d)}: compute by polynomial
    # division: start from x^m - 1, divide by Phi_d for proper divisors.
    if m == 1:
        return (-1, 1)
    poly = [0] * (m + 1)
    poly[0], poly[m] = -1, 1  # x^m - 1
    for d in range(1, m):
        if m % d == 0:
            poly = _poly_div_exact(poly, list(cyclotomic_poly(d)))
    return tuple(poly)


def _poly_div_exact(num: list[int], den: list[int]) -> list[int]:
    """Exact division of integer polynomials (monic-ish denominator)."""
    num = list(num)
    dn = len(den) - 1
    while den[dn] == 0:
        dn -= 1
    out = [0] * (len(num) - dn)
    for i in range(len(num) - 1 - dn, -1, -1):
        c = num[i + dn] // den[dn]
        out[i] = c
        if c:
            for j in range(dn + 1):
                num[i + j] -= c * den[j]
    assert all(v == 0 for v in num[: dn]), "non-exact cyclotomic division"
    return out


@lru_cache(maxsize=512)
def power_to_powerful(m: int) -> np.ndarray:
    """(n, m) integer matrix T: powerful coeffs of zeta^a = T[:, a].

    The powerful basis uses the axis roots zeta_{p^e} := zeta_m^(m/p^e)
    (the same convention as ops/general.py's exponent map
    exps[t] = sum_i j_i * (m/p_i^{e_i}) mod m), so the per-axis exponent
    of zeta_m^a is b_i = a * [(m/p^e)^{-1}]_{p^e} mod p^e — NOT a mod p^e
    (that would be the CRT-idempotent root convention, a hidden Galois
    twist for multi-prime m with m/p^e != 1 mod p^e).  Each axis factor
    with exponent b >= phi(p^e) reduces via Phi_{p^e}(zeta_{p^e}) = 0:
    zeta^(phi + r) = -sum_{t<p-1} zeta^(t p^(e-1) + r)."""
    f = fact(m)
    n = f.phi
    shape = f.phi_shape
    # per-axis: reduction vectors: for exponent b in [0, p^e): vector over
    # phi(p^e) basis coeffs
    axis_tables = []
    axis_expinv = []
    for pp in f.pps:
        p, e = pp.p, pp.e
        pe, phi = p**e, pp.phi
        tbl = np.zeros((pe, phi), dtype=np.int64)
        for b in range(pe):
            if b < phi:
                tbl[b, b] = 1
            else:
                r = b - phi  # b = phi + r with r < p^(e-1)
                for t in range(p - 1):
                    tbl[b, t * p ** (e - 1) + r] = -1
        axis_tables.append(tbl)
        axis_expinv.append(nt.modinv((m // pe) % pe, pe))
    T = np.zeros((n, m), dtype=np.int64)
    for a in range(m):
        vecs = []
        for pp, tbl, uinv in zip(f.pps, axis_tables, axis_expinv):
            vecs.append(tbl[(a * uinv) % pp.value])
        out = vecs[0]
        for v in vecs[1:]:
            out = np.multiply.outer(out, v)
        T[:, a] = out.reshape(-1)
    return T


# ---------------------------------------------------------------------------
# GF(p)[x] helpers
# ---------------------------------------------------------------------------


def _pmulmod(a, b, mod, p):
    out = [0] * (len(a) + len(b) - 1)
    for i, ai in enumerate(a):
        if ai:
            for j, bj in enumerate(b):
                out[i + j] = (out[i + j] + ai * bj) % p
    return _pmod(out, mod, p)


def _pmod(a, mod, p):
    a = [v % p for v in a]
    dn = len(mod) - 1
    inv_lead = nt.modinv(mod[dn], p)
    for i in range(len(a) - 1, dn - 1, -1):
        c = a[i] * inv_lead % p
        if c:
            for j in range(dn + 1):
                a[i - dn + j] = (a[i - dn + j] - c * mod[j]) % p
    return a[:dn] + [0] * max(0, dn - len(a))


def _pgcdext(a, b, p):
    """Extended gcd in GF(p)[x]: returns (g, s, t) with s a + t b = g."""
    r0, r1 = [v % p for v in a], [v % p for v in b]
    s0, s1 = [1], [0]
    t0, t1 = [0], [1]

    def deg(f):
        d = len(f) - 1
        while d >= 0 and f[d] % p == 0:
            d -= 1
        return d

    def sub_scaled(f, g, c, shift):
        out = list(f) + [0] * max(0, len(g) + shift - len(f))
        for i, gv in enumerate(g):
            out[i + shift] = (out[i + shift] - c * gv) % p
        return out

    while deg(r1) >= 0:
        d0, d1 = deg(r0), deg(r1)
        if d0 < d1:
            r0, r1, s0, s1, t0, t1 = r1, r0, s1, s0, t1, t0
            continue
        c = r0[d0] * nt.modinv(r1[d1], p) % p
        shift = d0 - d1
        r0 = sub_scaled(r0, r1, c, shift)
        s0 = sub_scaled(s0, s1, c, shift)
        t0 = sub_scaled(t0, t1, c, shift)
        if deg(r0) < deg(r1):
            r0, r1, s0, s1, t0, t1 = r1, r0, s1, s0, t1, t0
    return r0, s0, t0


# ---------------------------------------------------------------------------
# factor Phi_m mod p via the p-power orbit structure over GF(p^d)
# ---------------------------------------------------------------------------


@lru_cache(maxsize=256)
def slot_orbits(m: int, p: int) -> tuple[tuple[int, ...], ...]:
    """Orbits of multiplication-by-p on (Z/m)^* (one per plaintext slot)."""
    if math.gcd(p, m) != 1:
        raise ValueError(f"crtset: p={p} must be coprime to m={m}")
    units = [u for u in range(1, m + 1) if math.gcd(u, m) == 1] if m > 1 else [0]
    seen = set()
    orbits = []
    for u in units:
        u %= m
        if u in seen:
            continue
        orb = []
        v = u
        while v not in seen:
            seen.add(v)
            orb.append(v)
            v = v * p % m
        orbits.append(tuple(orb))
    return tuple(orbits)


def slot_degree(m: int, p: int) -> int:
    """d = ord_p in (Z/m)^*: each slot is GF(p^d)."""
    return nt.multiplicative_order(p % m, m) if m > 1 else 1


@lru_cache(maxsize=128)
def _factor_phi_mod_p(m: int, p: int) -> tuple[tuple[int, ...], ...]:
    """Irreducible factors of Phi_m mod p, one per orbit: f_O(x) =
    prod_{u in O} (x - zeta^u) computed in GF(p^d)."""
    from . import gf

    d = slot_degree(m, p)
    orbits = slot_orbits(m, p)
    if d == 1:
        # roots are in GF(p): zeta = element of order m mod p
        # find via a generator of GF(p)^*
        g = nt.primitive_root(p)
        zeta = pow(g, (p - 1) // m, p)
        return tuple(
            tuple(_roots_to_poly([pow(zeta, u, p) for u in orb], p))
            for orb in orbits
        )
    # zeta of order m in GF(p^d): search x + c for a generator-ish element
    order_needed = m
    group = p**d - 1
    assert group % m == 0
    zeta = None
    for trial in range(1, 200):
        cand = gf.GF.of(p, d, [trial % p, 1])  # x + trial
        z = cand.pow(group // m)
        if _gf_order(z, m) == m:
            zeta = z
            break
    assert zeta is not None, "no order-m element found"
    facs = []
    for orb in orbits:
        # f = prod (x - zeta^u): coefficients in GF(p^d), must land in GF(p)
        coeffs = [gf.GF.one(p, d)]
        for u in orb:
            root = zeta.pow(u)
            # multiply (x - root)
            new = [gf.GF.zero(p, d) for _ in range(len(coeffs) + 1)]
            for i, c in enumerate(coeffs):
                new[i + 1] = new[i + 1] + c
                new[i] = new[i] - c * root
            coeffs = new
        flat = []
        for c in coeffs:
            assert all(v == 0 for v in c.cs[1:]), "factor not over GF(p)"
            flat.append(c.cs[0])
        facs.append(tuple(flat))
    return tuple(facs)


def _gf_order(z, bound: int) -> int:
    from . import gf

    one = gf.GF.one(z.p, z.d)
    cur = z
    for k in range(1, bound + 1):
        if cur == one:
            return k
        cur = cur * z
    return -1


def _roots_to_poly(roots: list[int], p: int) -> list[int]:
    coeffs = [1]
    for r in roots:
        new = [0] * (len(coeffs) + 1)
        for i, c in enumerate(coeffs):
            new[i + 1] = (new[i + 1] + c) % p
            new[i] = (new[i] - c * r) % p
        coeffs = new
    return coeffs


# ---------------------------------------------------------------------------
# the CRT set, Hensel-lifted to p^k
# ---------------------------------------------------------------------------


@lru_cache(maxsize=128)
def crt_set_powerful(m: int, p: int, k: int = 1) -> np.ndarray:
    """(num_slots, n) int64: orthogonal idempotents of R_m / p^k R_m in
    the POWERFUL basis (Lol crtSetDec up to the dec-basis change).

    e_i = (Phi/f_i) * [(Phi/f_i)^{-1} mod f_i]  (mod Phi, p), then
    Hensel-lifted: e <- 3e^2 - 2e^3 doubles the precision each step."""
    phi_m = [c % p for c in cyclotomic_poly(m)]
    phi_int = list(cyclotomic_poly(m))
    facs = _factor_phi_mod_p(m, p)
    n = fact(m).phi
    idems = []
    for f in facs:
        # cofactor = Phi / f mod p
        cof = _poly_div_mod_p(phi_m, list(f), p)
        # inverse of cofactor mod f
        g, s, t = _pgcdext(cof, list(f), p)
        dg = max(i for i, v in enumerate(g) if v % p) if any(g) else 0
        assert dg == 0 and g[0] % p != 0, "cofactor not invertible mod f"
        inv = [v * nt.modinv(g[0], p) % p for v in s]
        e = _pmulmod(cof, inv, phi_m, p)
        idems.append(e + [0] * (n - len(e)))
    # Hensel lift mod p^k
    mod_now = p
    es = [[int(v) for v in e] for e in idems]
    while mod_now < p**k:
        mod_now = min(mod_now * mod_now, p**k)
        phim = [c % mod_now for c in phi_int]
        es = [
            _lift_step(e, phim, mod_now) for e in es
        ]
    return np.array([e[:n] for e in es], dtype=np.int64)


def _poly_div_mod_p(num, den, p):
    num = [v % p for v in num]
    den = [v % p for v in den]
    dn = len(den) - 1
    while den[dn] == 0:
        dn -= 1
    inv_lead = nt.modinv(den[dn], p)
    out = [0] * (len(num) - dn)
    for i in range(len(num) - 1 - dn, -1, -1):
        c = num[i + dn] * inv_lead % p
        out[i] = c
        if c:
            for j in range(dn + 1):
                num[i + j] = (num[i + j] - c * den[j]) % p
    return out


def _lift_step(e, phim, mod):
    # e' = 3 e^2 - 2 e^3 mod (Phi, mod)
    e2 = _pmulmod(e, e, phim, mod)
    e3 = _pmulmod(e2, e, phim, mod)
    out = [(3 * a - 2 * b) % mod for a, b in zip(e2, e3)]
    return out


def crt_set_ints(m: int, p: int, k: int = 1) -> np.ndarray:
    """(num_slots, n) int64: the CRT set's powerful-basis coefficients mod
    p^k, the rows that the JAX package's `crt_set_cyc` holds as ring
    elements.  The idempotents of `crt_set_powerful` are power-basis
    polynomials in zeta_m; `power_to_powerful` rebases them for
    multi-prime m."""
    E = crt_set_powerful(m, p, k)
    T = power_to_powerful(m)[:, : E.shape[1]]
    return np.stack([(T @ row) % (p**k) for row in E])


def crt_set_cyc(m: int, p: int, k: int = 1, device="cuda"):
    """The CRT set as `Cyc` elements of R_{p^k} (powerful basis)."""
    from .cyc import Cyc
    from .ring import ring_context

    ctx = ring_context(m, (p**k,))
    return [Cyc.from_ints(ctx, row, device=device) for row in crt_set_ints(m, p, k)]


def num_slots(m: int, p: int) -> int:
    return len(slot_orbits(m, p))


def slot_restriction(m_sub: int, m_sup: int, p: int) -> np.ndarray:
    """For each slot (p-orbit) of R_{m_sup}, the index of the slot of
    R_{m_sub} it lies over (restriction u -> u mod m_sub) — the relative
    slot structure Lol's crtSetDec exposes for tunneling slot tracking."""
    if m_sup % m_sub != 0:
        raise ValueError("slot_restriction: need m_sub | m_sup")
    sup_orbits = slot_orbits(m_sup, p)
    sub_orbits = slot_orbits(m_sub, p)
    where = {}
    for i, orb in enumerate(sub_orbits):
        for u in orb:
            where[u % m_sub] = i
    out = []
    for orb in sup_orbits:
        restr = {u % m_sub for u in orb}
        idx = {where[r] for r in restr}
        assert len(idx) == 1, "restriction not well-defined (bug)"
        out.append(idx.pop())
    return np.array(out, dtype=np.int64)
