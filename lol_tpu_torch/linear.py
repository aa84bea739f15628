"""E-linear maps between cyclotomic rings (`Linear`, `eval_lin`).

Counterpart of `lol_tpu/linear.py`: an E-linear map f : R -> S (E a
common subring, m_E | m_R and m_E | m_S) held by its images ys_i = f(b_i)
of the relative powerful basis of R/E (monomials b_i).  Writing
x = sum_i b_i * embed_R(a_i) with a_i in E (a gather of x's
powerful-basis coefficients by `ops.general.rel_coeff_table`),
f(x) = sum_i ys_i * embed_S(a_i).

The JAX package keeps each ys_i as a ring element mod Q; here ys_i is its
(n_s,) integer powerful-basis coefficient vector over S (numpy int64),
which the tunnel reduces into each channel.  `eval_lin` applies the map
to a `Cyc` of R, as the reference does; `eval_lin_ints` is the host
plaintext map on numpy, the oracle that ring tunneling is checked
against.  `slot_projection` builds the CRT-set tower-descent maps (host
numpy, as the reference).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from . import crtset
from . import numtheory as nt
from .factored import fact
from .ops import general as gen
from .ring import RingContext


@dataclass(frozen=True, eq=False)
class Linear:
    """f : R -> S, E-linear, via the images ys of R/E's relative powerful
    basis, each an (n_s,) int64 coefficient vector over S."""

    e_ctx: RingContext
    r_ctx: RingContext
    s_ctx: RingContext
    ys: tuple[np.ndarray, ...]

    def __post_init__(self):
        for name, ctx in (("R", self.r_ctx), ("S", self.s_ctx)):
            if not self.e_ctx.fm.divides(ctx.fm):
                raise ValueError(f"Linear: E={self.e_ctx.m} must divide {name}={ctx.m}")
        d = self.r_ctx.n // self.e_ctx.n
        if len(self.ys) != d:
            raise ValueError(f"Linear: need {d} basis images, got {len(self.ys)}")
        for y in self.ys:
            if y.shape != (self.s_ctx.n,):
                raise ValueError(f"Linear: image of shape {y.shape}, S has n={self.s_ctx.n}")

    @property
    def d(self) -> int:
        """The number of relative basis elements, n_r / n_e."""
        return len(self.ys)


def linear_pow(e_ctx: RingContext, r_ctx: RingContext, s_ctx: RingContext, ys) -> Linear:
    """The map with images ys of the relative powerful basis monomials:
    integer coefficients over S, or `Cyc`s of S as the reference gives
    them (taken by their centred powerful-basis lifts)."""
    from .cyc import Cyc, Rep

    return Linear(e_ctx, r_ctx, s_ctx, tuple(
        np.array(y.lift_ints(rep=Rep.POW) if isinstance(y, Cyc) else y, dtype=np.int64)
        for y in ys))


def rel_basis_elements(r_ctx: RingContext, e_ctx: RingContext, device="cuda"):
    """The relative powerful basis monomials b_i as elements of R."""
    from .cyc import Cyc

    return Cyc.rel_pow_basis(r_ctx, e_ctx, device)


def eval_lin(lin: Linear, x):
    """Apply the E-linear map to x, a `Cyc` of R (Lol evalLin): the sum of
    ys_i embed_S(a_i) over x's relative coefficients a_i, on x's device."""
    from .cyc import Cyc, Rep

    if x.ctx != lin.r_ctx:
        raise ValueError("eval_lin: x not in the map's source ring")
    acc = Cyc.zero(lin.s_ctx, device=x.device,
                   rep=Rep.CRT if lin.s_ctx.has_crt() else Rep.POW)
    for y, a in zip(lin.ys, x.coeffs(lin.e_ctx, rep=Rep.POW)):
        acc = acc + Cyc.from_ints(lin.s_ctx, y, device=x.device) * a.embed(lin.s_ctx)
    return acc


def eval_lin_ints(lin: Linear, x, p: int) -> np.ndarray:
    """f(x) mod p for x in R given by its (n_r,) integer powerful-basis
    coefficients: the (n_s,) int64 powerful-basis coefficients of the image
    in [0, p), exact (`she.ring_mul_sum` over S).  (At 2-power m the
    powerful and decoding bases coincide; elsewhere `ops.general.l_host`
    converts a decryption's decoding-basis coefficients.)"""
    from .she import ring_mul_sum

    n_r, n_s = lin.r_ctx.n, lin.s_ctx.n
    x = np.asarray(x, dtype=np.int64) % p
    if x.shape != (n_r,):
        raise ValueError(f"eval_lin_ints: x of shape {x.shape}, R has n={n_r}")
    coeff = gen.rel_coeff_table(lin.e_ctx.m, lin.r_ctx.m)
    embed = gen.embed_pow_table(lin.e_ctx.m, lin.s_ctx.m)
    pairs = []
    for y, rows in zip(lin.ys, coeff):
        a = np.zeros(n_s, dtype=np.int64)
        a[embed] = x[rows]
        pairs.append((y, a))
    return ring_mul_sum(pairs, p, lin.s_ctx.m, basis="pow")


# ---------------------------------------------------------------------------
# CRT-set tower-descent maps (the slot maps of HomomPRF's tunnel chain)
# ---------------------------------------------------------------------------


def _powerful_exponents(m: int) -> np.ndarray:
    """exps[t] = the power-basis exponent of the t-th powerful monomial."""
    f = fact(m)
    exps = np.zeros(f.phi, dtype=np.int64)
    for flat in range(f.phi):
        idx = np.unravel_index(flat, f.phi_shape)
        exps[flat] = sum(int(j) * (m // pp.value) for j, pp in zip(idx, f.pps)) % m
    return exps


def _mul_matrix_mod(m: int, u_pow: np.ndarray, pk: int) -> np.ndarray:
    """(n, n) matrix of multiplication by u on the powerful coordinates of
    R_m / pk R_m (u given in powerful coordinates), by power-basis
    polynomial arithmetic mod (Phi_m, pk)."""
    n = fact(m).phi
    exps = _powerful_exponents(m)
    phi_poly = [c % pk for c in crtset.cyclotomic_poly(m)]
    T = crtset.power_to_powerful(m)[:, :n]
    u_power = [0] * m  # u as a power-basis polynomial, each monomial reduced
    for t in range(n):
        u_power[int(exps[t])] = (u_power[int(exps[t])] + int(u_pow[t])) % pk
    u_red = crtset._pmod(u_power, phi_poly, pk)
    cols = np.zeros((n, n), dtype=np.int64)
    for t in range(n):
        col = crtset._pmod([0] * int(exps[t]) + list(u_red), phi_poly, pk)
        col = col + [0] * (n - len(col))
        cols[:, t] = (T @ np.array(col[:n], dtype=np.int64)) % pk
    return cols % pk


def _solve_mod_prime_power(A: np.ndarray, b: np.ndarray, p0: int, k: int) -> np.ndarray:
    """A particular solution of A y = b over Z_{p0^k} (Gaussian elimination
    mod p0, then Hensel refinement); raises ValueError if inconsistent."""
    A = np.asarray(A, dtype=np.int64)
    b = np.asarray(b, dtype=np.int64)
    rows, cols = A.shape

    def solve_p(bb):
        M = np.concatenate([A % p0, (bb % p0)[:, None]], axis=1).astype(np.int64)
        piv_cols = []
        r = 0
        for c in range(cols):
            nz = np.nonzero(M[r:, c] % p0)[0]
            if nz.size == 0:
                continue
            pr = r + int(nz[0])
            M[[r, pr]] = M[[pr, r]]
            M[r] = M[r] * nt.modinv(int(M[r, c]) % p0, p0) % p0
            f = M[:, c].copy()
            f[r] = 0
            M = (M - np.outer(f, M[r])) % p0
            piv_cols.append(c)
            r += 1
            if r == rows:
                break
        if np.any(M[r:, -1] % p0):
            raise ValueError("slot projection system inconsistent mod p")
        y = np.zeros(cols, dtype=np.int64)
        for rr, c in enumerate(piv_cols):
            y[c] = M[rr, -1] % p0
        return y

    y = solve_p(b)
    mod = p0
    for _ in range(1, k):
        z = solve_p((b - A @ y) // mod)
        y = y + mod * z
        mod *= p0
    pk = p0**k
    if np.any((A @ y - b) % pk):
        raise ValueError("slot projection system inconsistent mod p^k")
    return y % pk


def slot_projection(r_ctx: RingContext, s_ctx: RingContext, pk: int,
                    mode: str = "select") -> Linear:
    """The E-linear tower-descent map f : R -> S (E = S) from the plaintext
    CRT sets mod pk (`crtset.crt_set_ints`, Hensel-lifted):

      mode="select": f(c_{j0(i)}) = c_i^S for one representative R-slot
        per S-slot (the first of each `slot_restriction` fiber), f(c_j) = 0
        for the rest: slots survive descent unchanged;
      mode="trace":  f(c_j) = c^S_{restr(j)} for every j: the fiber sum.

    The images are solved from the resulting linear system over Z_pk
    ((slots_R n_s) x (d n_s), pure-Python polynomial arithmetic, so only
    small towers build in reasonable time) and centred-lifted into
    integers, so a tunnel with this map acts on the plaintext slots as
    specified.  pk must be a prime power coprime to both indices."""
    m_r, m_s = r_ctx.m, s_ctx.m
    fac = fact(pk)
    if len(fac.pps) != 1:
        raise ValueError("slot_projection: pk must be a prime power")
    p0, k = fac.pps[0].p, fac.pps[0].e
    if math.gcd(p0, m_r) != 1 or math.gcd(p0, m_s) != 1:
        raise ValueError("slot_projection: plaintext prime must be coprime to the "
                         "cyclotomic indices (no CRT slot structure otherwise)")
    if mode not in ("select", "trace"):
        raise ValueError(f"slot_projection: unknown mode {mode}")
    n_s = s_ctx.n
    d = r_ctx.n // n_s
    coeff_tbl = gen.rel_coeff_table(m_s, m_r)  # (d, n_s)
    cR = crtset.crt_set_ints(m_r, p0, k)  # (slots_R, n_r)
    cS = crtset.crt_set_ints(m_s, p0, k)
    restr = crtset.slot_restriction(m_s, m_r, p0)
    rep = {}  # the representative R-slot of each fiber, for "select"
    for j in range(cR.shape[0]):
        rep.setdefault(int(restr[j]), j)
    blocks, rhs = [], []
    for j in range(cR.shape[0]):  # slot j: sum_i M_{embed(a_ij)} ys_i = rhs_j
        a = cR[j][coeff_tbl]  # (d, n_s): the relative coefficients of c_j
        blocks.append(np.concatenate([_mul_matrix_mod(m_s, a[i], pk) for i in range(d)],
                                     axis=1))
        keep = mode == "trace" or rep[int(restr[j])] == j
        rhs.append(cS[int(restr[j])] if keep else np.zeros(n_s, dtype=np.int64))
    y = _solve_mod_prime_power(np.concatenate(blocks), np.concatenate(rhs), p0, k)
    ys = y.reshape(d, n_s) % pk
    ys = np.where(ys >= (pk + 1) // 2, ys - pk, ys)  # the centred lift
    return Linear(s_ctx, r_ctx, s_ctx, tuple(ys[i] for i in range(d)))
