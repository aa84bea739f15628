"""General index-m cyclotomic transforms: the prime-power tensor algebra.

Counterpart of `lol_tpu/ops/general.py`.  For m = prod p_i^{e_i},
R_m = (x)_i R_{p_i^{e_i}}, and a ring element's flat length-phi(m)
coefficient vector is the row-major flattening of the tensor of shape
`Factored.phi_shape` (primes ascending).  Every transform factors into
per-axis ones:

- the 2-power axis (axis 0): the negacyclic NTT of `ops/ntt.py`.  Its
  root omega^(m / 2^e), for the canonical principal m-th root omega
  = g^((q-1)/m), is g^((q-1)/2^e), the canonical 2^e-th root, so the
  axis's `ntt_plan(2^(e-1), q, psi=root)` is the canonical plan object.  In
  the coefficient-major (n, B) layout the axis is the leading one, so
  (n2, rest * B) is a free reshape and the axis runs on the same
  `ntt_cm` kernels as the 2-power pipeline, the digit prologue included;
- an odd p^e axis: a dense phi x phi matrix-vector product mod q
  (`matvec_mod`), with the reference's `matvec_mod_jnp` dispatch: below
  MXU_MIN_AXIS the short-axis route `modmat_small` of `ops/cuda/modmat.py`
  (one hand-written u32 kernel launch on the card, int64 torch on the
  CPU), from it on the int8-limb route, the Hopper tensor-core kernel
  `modmat_s8` on the card (the reference's `matvec_mod_mxu`).  Both
  routes are exact, so the dispatch never changes a result.

CRT slot order: slot multi-index (u_1, ..., u_k), axis i enumerating the
units of Z_{p_i^{e_i}} (the 2-axis in NTT order, odd axes ascending);
`_global_units` gives each slot's unit of (Z/mZ)^*.

L (decoding -> powerful basis): prefix sums along each odd axis's prime
level; identity on the 2-axis.  Beside the transforms: the index tables
between rings m_sub | m_sup that ring tunneling reads, and the per-axis
Gaussian mixing factors of the decoding-basis sampler.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from .. import numtheory as nt, trace
from ..factored import Factored, PrimePower, fact
from . import ntt
from .cuda.modmat import modmat_s8, modmat_small
from .cuda.ntt_kernel import ntt_cm, redigit

# ---------------------------------------------------------------------------
# modular dense linear algebra
# ---------------------------------------------------------------------------


def _mat_inv_mod(M: np.ndarray, q: int) -> np.ndarray:
    """Exact inverse of a square matrix over Z_q (q prime), Gauss-Jordan
    in int64 (q < 2^30, so each f * row < 2^60)."""
    n = M.shape[0]
    A = np.asarray(M, dtype=np.int64) % q
    inv_m = np.eye(n, dtype=np.int64)
    for col in range(n):
        nz = np.nonzero(A[col:, col] % q)[0]
        if nz.size == 0:
            raise ValueError("matrix not invertible mod q")
        piv = col + int(nz[0])
        if piv != col:
            A[[col, piv]] = A[[piv, col]]
            inv_m[[col, piv]] = inv_m[[piv, col]]
        inv = nt.modinv(int(A[col, col]), q)
        A[col] = A[col] * inv % q
        inv_m[col] = inv_m[col] * inv % q
        f = A[:, col].copy()
        f[col] = 0
        A = (A - np.outer(f, A[col])) % q
        inv_m = (inv_m - np.outer(f, inv_m[col])) % q
    return inv_m.astype(np.uint32)


MXU_MIN_AXIS = 16  # from this axis on, the int8-limb route (as the reference)


def matvec_mod(M, x: torch.Tensor, q: int, axis: int = -1,
               use_mxu: bool | None = None) -> torch.Tensor:
    """(a, b) @ x along `axis` mod q, exact: x holds residues in [0, q)
    with x.shape[axis] == b, and the result (int32 residues) has a there.
    The counterpart of the reference's `matvec_mod_jnp` (which takes the
    last axis), with its dispatch: use_mxu=None takes the int8-limb route
    (`modmat_s8`) where min(a, b) >= MXU_MIN_AXIS, the short-axis route
    (`modmat_small`: one kernel launch on the card, int64 torch on the
    CPU) below.  x is viewed as (pre, b, post), no data moved."""
    a, b = M.shape
    if use_mxu is None:
        use_mxu = min(a, b) >= MXU_MIN_AXIS
    if use_mxu:
        trace.tag("modmat_s8")
        return modmat_s8(M, x, q, axis)
    return modmat_small(M, x, q, axis)  # tags the span with its route


def matvec_mod_mxu(M, x: torch.Tensor, q: int) -> torch.Tensor:
    """(a, b) @ (..., b) -> (..., a) mod q by the int8-limb route, the
    reference's signature (`modmat_s8` over the last axis)."""
    return modmat_s8(M, x, q, -1)


def _np_matvec_mod(M: np.ndarray, x: np.ndarray, q: int) -> np.ndarray:
    """numpy (a, b) @ (b, N) mod q, exact (int64, a reduction per term)."""
    M = np.asarray(M, dtype=np.int64)
    acc = np.zeros((M.shape[0], x.shape[1]), dtype=np.int64)
    for j in range(M.shape[1]):
        acc = (acc + M[:, j:j + 1] * x[j:j + 1].astype(np.int64)) % q
    return acc


# ---------------------------------------------------------------------------
# per-axis plans
# ---------------------------------------------------------------------------


@dataclass(frozen=True, eq=False)
class AxisPlan:
    """The transform of the p^e axis of R_m over Z_q: the 2-power axis
    holds an NTT plan (`ntt2`), an odd axis its dense CRT matrix and
    inverse (phi x phi u32); `units` enumerates Z_{p^e}^* in the axis's
    slot order."""

    pp: PrimePower
    q: int
    units: np.ndarray
    M: np.ndarray | None
    Minv: np.ndarray | None
    ntt2: ntt.NTTPlan | None

    @property
    def phi(self) -> int:
        return self.pp.phi


def _frozen(a: np.ndarray) -> np.ndarray:
    a.flags.writeable = False  # shared by every caller through the caches
    return a


@lru_cache(maxsize=1024)
def axis_plan(p: int, e: int, q: int, m: int) -> AxisPlan:
    """The plan of the p^e axis of R_m over Z_q.  Its root is
    omega^(m / p^e) for the canonical principal m-th root omega, so the
    axes of rings in a divisibility tower agree."""
    pp = PrimePower(p, e)
    pe = p ** e
    w = pow(nt.principal_root_of_unity(m, q), m // pe, q)  # principal p^e-th root
    if p == 2:
        if e == 1:  # phi(2) = 1: the trivial axis, unit 1
            one = _frozen(np.array([[1]], np.uint32))
            return AxisPlan(pp, q, _frozen(np.array([1], np.int64)), one, one, None)
        n2 = pe // 2
        units = (ntt.crt_output_exponents(n2) % pe).astype(np.int64)
        return AxisPlan(pp, q, _frozen(units), None, None, ntt.ntt_plan(n2, q, psi=w))
    units = np.array([u for u in range(pe) if u % p], dtype=np.int64)
    M = np.array([[pow(w, int(u) * j, q) for j in range(pp.phi)] for u in units],
                 dtype=np.uint32)
    return AxisPlan(pp, q, _frozen(units), _frozen(M), _frozen(_mat_inv_mod(M, q)), None)


@dataclass(frozen=True, eq=False)
class GeneralPlan:
    """Every axis plan of (m, q), primes ascending."""

    fm: Factored
    q: int
    axes: tuple[AxisPlan, ...]

    @property
    def phi_shape(self) -> tuple[int, ...]:
        return self.fm.phi_shape


@lru_cache(maxsize=512)
def general_plan(m: int, q: int) -> GeneralPlan:
    f = fact(m)
    if (q - 1) % m:
        raise ValueError(f"general_plan: need m={m} | q-1 (q={q})")
    return GeneralPlan(f, q, tuple(axis_plan(pp.p, pp.e, q, m) for pp in f.pps))


# ---------------------------------------------------------------------------
# coefficient-major (n, B) transforms
# ---------------------------------------------------------------------------


def crt_cm(plan: GeneralPlan, x: torch.Tensor, inverse: bool = False,
           pre_digit_q: int | None = None, factor: int = 1) -> torch.Tensor:
    """(n, B) int32 coefficient-major CRT (powerful -> CRT basis) or its
    inverse over one channel.  The 2-power axis runs `ntt_cm` on the free
    (n2, rest * B) reshape, the odd axes `matvec_mod` on their views
    (`modmat_small` below MXU_MIN_AXIS, `modmat_s8` from it on).
    pre_digit_q: the RNS-gadget digit re-expansion (forward only).  It is
    elementwise, so it runs before any axis transform: as the 2-axis
    kernel's prologue, or by `redigit` when the ring has no 2-axis.
    factor: the inverse's result times factor mod q (inverse only).  The
    map is linear, so it rides the 2-axis inverse's n^-1 (`ntt_cm`'s
    factor); a ring with no 2-axis multiplies at the end."""
    if pre_digit_q is not None and inverse:
        raise ValueError("crt_cm: pre_digit_q is a forward-only prologue")
    if factor != 1 and not inverse:
        raise ValueError("crt_cm: factor is an inverse-only scale")
    n, B = x.shape
    shape = plan.phi_shape
    if n != math.prod(shape):
        raise ValueError(f"crt_cm: x has n={n}, the ring has phi={math.prod(shape)}")
    axes = plan.axes
    if axes and axes[0].ntt2 is not None:
        n2 = shape[0]
        x = ntt_cm(x.reshape(n2, (n // n2) * B).contiguous(), axes[0].ntt2,
                   inverse=inverse, pre_digit_q=pre_digit_q, factor=factor).view(n, B)
        factor = 1
    elif pre_digit_q is not None:
        x = redigit(x, pre_digit_q, plan.q)
    for i, ax in enumerate(axes):
        if ax.ntt2 is not None or ax.phi == 1:
            continue
        with trace.span("crt.odd"):  # matvec_mod tags it with its route
            x = matvec_mod(ax.Minv if inverse else ax.M, x.reshape(*shape, B), plan.q,
                           axis=i).view(n, B)
    if factor % plan.q != 1:
        x = (x.long() * (factor % plan.q) % plan.q).to(torch.int32)
    return x


def _l_axis(v: torch.Tensor, pp: PrimePower, q: int, inverse: bool) -> torch.Tensor:
    """L (prefix sums) or L^-1 (differences) along the prime level of the
    axis of v viewed (pre, phi, post): the axis splits as
    (p - 1, p^(e-1))."""
    pre, _, post = v.shape
    vs = v.reshape(pre, pp.p - 1, pp.p ** (pp.e - 1) * post).long()
    if inverse:
        out = vs.clone()
        out[:, 1:] -= vs[:, :-1]
    else:
        out = torch.cumsum(vs, dim=1)
    return (out % q).view(pre, pp.phi, post)


def l_cm(plan: GeneralPlan, x: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """(n, B) int32 coefficient-major L / L^-1 (decoding <-> powerful)."""
    n, B = x.shape
    shape = plan.phi_shape
    for i, ax in enumerate(plan.axes):
        if ax.pp.p == 2 or ax.phi == 1:
            continue
        pre, post = math.prod(shape[:i]), math.prod(shape[i + 1:]) * B
        x = _l_axis(x.reshape(pre, ax.phi, post), ax.pp, plan.q, inverse).view(n, B)
    return x.to(torch.int32)


# ---------------------------------------------------------------------------
# the object forms over (..., n), and multiplication by g
# ---------------------------------------------------------------------------


def _last_axis(x: torch.Tensor, fn) -> torch.Tensor:
    """fn over the coefficient-major (n, B) view of (..., n) x: the
    reference's ring-element layout in, transposed for the (n, B)
    transforms and back.  int32 out."""
    lead, n = x.shape[:-1], x.shape[-1]
    flat = x.reshape(-1, n)
    y = fn(flat.reshape(n, 1) if flat.shape[0] == 1 else flat.t().contiguous())
    return y.t().reshape(*lead, y.shape[0]).to(torch.int32)


def crt(plan: GeneralPlan, x: torch.Tensor) -> torch.Tensor:
    """Powerful -> CRT basis over (..., n) residues (`crt_cm`)."""
    return _last_axis(x, lambda c: crt_cm(plan, c))


def crt_inv(plan: GeneralPlan, x: torch.Tensor) -> torch.Tensor:
    return _last_axis(x, lambda c: crt_cm(plan, c, inverse=True))


def l(plan: GeneralPlan, x: torch.Tensor) -> torch.Tensor:
    """Decoding -> powerful basis over (..., n) residues (`l_cm`)."""
    return _last_axis(x, lambda c: l_cm(plan, c))


def l_inv(plan: GeneralPlan, x: torch.Tensor) -> torch.Tensor:
    return _last_axis(x, lambda c: l_cm(plan, c, inverse=True))


@lru_cache(maxsize=256)
def _g_matrices(p: int, e: int, q: int) -> tuple[np.ndarray, ...]:
    """The p^e axis's matrices over Z_q, (phi, phi) u32: G (times
    g_p = 1 - zeta_p in the powerful basis), G^-1, and their decoding-basis
    conjugates L^-1 G L and its inverse.  With the axis viewed as (t, r),
    t < p - 1, (zeta_p x)[t, r] = x[t - 1, r] (t >= 1) - x[p - 2, r]."""
    pp = PrimePower(p, e)
    phi, r = pp.phi, p ** (e - 1)
    eye = np.eye(phi, dtype=np.int64).reshape(phi, p - 1, r)  # basis vectors as rows
    zx = np.concatenate([np.zeros_like(eye[:, :1]), eye[:, :-1]], axis=1) - eye[:, -1:]
    G = ((eye - zx).reshape(phi, phi).T % q).astype(np.uint32)
    Lm = (np.cumsum(eye, axis=1).reshape(phi, phi).T % q).astype(np.uint32)
    Linv = _mat_inv_mod(Lm, q)
    Gdec = _np_matvec_mod(Linv, _np_matvec_mod(G, Lm, q), q).astype(np.uint32)
    return tuple(_frozen(a) for a in (G, _mat_inv_mod(G, q), Gdec, _mat_inv_mod(Gdec, q)))


def _odd_axes_cm(plan: GeneralPlan, x: torch.Tensor, which: int) -> torch.Tensor:
    """(n, B) residues times `_g_matrices(...)[which]` along every odd axis."""
    n, B = x.shape
    shape = plan.phi_shape
    for i, ax in enumerate(plan.axes):
        if ax.pp.p == 2:
            continue
        M = _g_matrices(ax.pp.p, ax.pp.e, plan.q)[which]
        x = matvec_mod(M, x.reshape(*shape, B), plan.q, axis=i).view(n, B)
    return x.to(torch.int32)


def mul_g_pow(plan: GeneralPlan, x: torch.Tensor) -> torch.Tensor:
    return _last_axis(x, lambda c: _odd_axes_cm(plan, c, 0))


def div_g_pow(plan: GeneralPlan, x: torch.Tensor) -> torch.Tensor:
    return _last_axis(x, lambda c: _odd_axes_cm(plan, c, 1))


def mul_g_dec(plan: GeneralPlan, x: torch.Tensor) -> torch.Tensor:
    return _last_axis(x, lambda c: _odd_axes_cm(plan, c, 2))


def div_g_dec(plan: GeneralPlan, x: torch.Tensor) -> torch.Tensor:
    return _last_axis(x, lambda c: _odd_axes_cm(plan, c, 3))


@lru_cache(maxsize=512)
def _g_crt_vec(m: int, q: int) -> np.ndarray:
    """CRT(g), the flat length-phi(m) vector in slot order: per odd axis
    1 - omega_p^u over its units u, the 2-power axis all ones."""
    if m == 1:
        return _frozen(np.ones(1, dtype=np.uint32))
    plan = general_plan(m, q)
    out = np.ones(1, dtype=np.int64)
    for ax in plan.axes:
        v = np.ones(ax.phi, dtype=np.int64)
        if ax.pp.p != 2:
            wp = pow(nt.principal_root_of_unity(m, q), m // ax.pp.p, q)  # the image of zeta_p
            v = np.array([(1 - pow(wp, int(u), q)) % q for u in ax.units], dtype=np.int64)
        out = np.multiply.outer(out, v).reshape(-1) % q
    return _frozen(out.astype(np.uint32))


def _slot_mul(plan: GeneralPlan, x: torch.Tensor, v: np.ndarray) -> torch.Tensor:
    vt = torch.from_numpy(v.astype(np.int64)).to(x.device)
    return (x.long() * vt % plan.q).to(torch.int32)


def mul_g_crt(plan: GeneralPlan, x: torch.Tensor) -> torch.Tensor:
    return _slot_mul(plan, x, _g_crt_vec(plan.fm.m, plan.q))


def div_g_crt(plan: GeneralPlan, x: torch.Tensor) -> torch.Tensor:
    inv = [nt.modinv(int(v), plan.q) for v in _g_crt_vec(plan.fm.m, plan.q)]
    return _slot_mul(plan, x, np.array(inv, dtype=np.int64))


# ---------------------------------------------------------------------------
# exact numpy mirrors over (..., n) (host keygen and plaintext products)
# ---------------------------------------------------------------------------


def _np_apply_axis(shape, x: np.ndarray, i: int, fn) -> np.ndarray:
    """fn along tensor axis i of (..., n), as (pre, b, post) -> (pre, a, post)."""
    lead = x.shape[:-1]
    pre = math.prod(lead) * math.prod(shape[:i])
    post = math.prod(shape[i + 1:])
    return fn(x.reshape(pre, shape[i], post)).reshape(*lead, -1)


def _np_l_axis(v: np.ndarray, pp: PrimePower, q: int, inverse: bool) -> np.ndarray:
    pre, _, post = v.shape
    vs = v.astype(np.int64).reshape(pre, pp.p - 1, -1)
    out = np.diff(vs, axis=1, prepend=0) if inverse else np.cumsum(vs, axis=1)
    return (out % q).reshape(pre, pp.phi, post)


def l_host(m: int, x, modulus: int, inverse: bool = False) -> np.ndarray:
    """L / L^-1 of integer (..., phi(m)) coefficients mod any modulus, int64
    (L is an integer matrix, so this is the basis change of R_m / modulus R_m)."""
    f = fact(m)
    x = np.asarray(x, dtype=np.int64) % modulus
    for i, pp in enumerate(f.pps):
        if pp.p != 2:
            x = _np_apply_axis(f.phi_shape, x, i,
                               lambda v, pp=pp: _np_l_axis(v, pp, modulus, inverse))
    return x


def np_l(plan: GeneralPlan, x: np.ndarray, inverse: bool = False) -> np.ndarray:
    """The numpy mirror of L / L^-1 over (..., n) u32 residues mod plan.q."""
    return l_host(plan.fm.m, x, plan.q, inverse).astype(np.uint32)


def np_crt(plan: GeneralPlan, x: np.ndarray, inverse: bool = False) -> np.ndarray:
    """The numpy mirror of the CRT / CRT^-1 over (..., n) u32 residues."""
    q, shape = plan.q, plan.phi_shape
    x = np.asarray(x)
    for i, ax in enumerate(plan.axes):
        if ax.phi == 1:
            continue
        if ax.ntt2 is not None:
            fn = ntt.np_ntt_inverse if inverse else ntt.np_ntt_forward

            def axis_fn(v, fn=fn, p=ax.ntt2):  # (pre, n2, post): the NTT runs on the last axis
                return np.moveaxis(fn(np.moveaxis(v, 1, -1), p), -1, 1)
        else:
            M = ax.Minv if inverse else ax.M

            def axis_fn(v, M=M):
                pre, b, post = v.shape
                flat = np.moveaxis(v, 1, 0).reshape(b, -1)
                out = _np_matvec_mod(M, flat, q).reshape(-1, pre, post)
                return np.moveaxis(out, 0, 1)
        x = _np_apply_axis(shape, x, i, axis_fn)
    return x.astype(np.uint32)


# ---------------------------------------------------------------------------
# slot units
# ---------------------------------------------------------------------------


def _global_units(plan: GeneralPlan) -> np.ndarray:
    """Flat slot order -> its unit of (Z/mZ)^*, the per-axis units
    combined by the CRT."""
    m = plan.fm.m
    if m == 1:
        return np.array([0], dtype=np.int64)
    parts = []
    for ax in plan.axes:
        pe = ax.pp.value
        mi = m // pe
        c = mi * nt.modinv(mi % pe, pe) % m
        parts.append((ax.units % pe) * c % m)
    out = parts[0]
    for v in parts[1:]:
        out = np.add.outer(out, v) % m
    return out.reshape(-1) % m


# ---------------------------------------------------------------------------
# index tables between rings m_sub | m_sup
# ---------------------------------------------------------------------------


def _strides(shape) -> list[int]:
    return [math.prod(shape[a + 1:]) for a in range(len(shape))]


def _check(m_sub: int, m_sup: int, what: str) -> tuple[Factored, Factored]:
    if m_sup % m_sub:
        raise ValueError(f"{what}: need m_sub | m_sup, got {m_sub}, {m_sup}")
    return fact(m_sub), fact(m_sup)


@lru_cache(maxsize=512)
def embed_pow_table(m_sub: int, m_sup: int) -> np.ndarray:
    """(n_sub,) int64: the sup coefficient position of each sub
    coefficient (the embedding's scatter).  Per axis: a prime of both
    rings maps j' -> j' p^(e - e'); a prime of m_sup alone contributes 0."""
    fs, fS = _check(m_sub, m_sup, "embed_pow_table")
    sub = {pp.p: pp for pp in fs.pps}
    flat = np.zeros(1, dtype=np.int64)
    for pp, st in zip(fS.pps, _strides(fS.phi_shape)):
        idx = (np.arange(sub[pp.p].phi, dtype=np.int64) * pp.p ** (pp.e - sub[pp.p].e)
               if pp.p in sub else np.zeros(1, dtype=np.int64))
        flat = np.add.outer(flat, idx * st).reshape(-1)
    return _frozen(flat)


@lru_cache(maxsize=512)
def rel_coeff_table(m_sub: int, m_sup: int) -> np.ndarray:
    """(d, n_sub) int64 with T[rel, j] = the sup position of coefficient j
    of the relative coefficient a_rel: x = sum_rel b_rel * embed(a_rel),
    b_rel the relative powerful basis.  Per axis: a prime of both rings
    gives position j' r + i (r = p^(e - e'), i < r the relative index);
    a prime of m_sup alone gives i over the whole axis.  The same table
    serves the decoding basis (L acts on the prime level, the sub part)."""
    fs, fS = _check(m_sub, m_sup, "rel_coeff_table")
    sub = {pp.p: pp for pp in fs.pps}
    T = np.zeros((1, 1), dtype=np.int64)
    for pp, st in zip(fS.pps, _strides(fS.phi_shape)):
        if pp.p in sub:
            r = pp.p ** (pp.e - sub[pp.p].e)
            ax = np.arange(sub[pp.p].phi, dtype=np.int64)[None, :] * r + np.arange(r)[:, None]
        else:
            ax = np.arange(pp.phi, dtype=np.int64)[:, None]
        # (rel, sub) x (rel_a, sub_a) -> (rel * rel_a, sub * sub_a), row-major in both
        T = (T[:, None, :, None] + ax[None, :, None, :] * st).reshape(
            T.shape[0] * ax.shape[0], T.shape[1] * ax.shape[1])
    return _frozen(T)


@lru_cache(maxsize=512)
def rel_pow_basis_positions(m_sub: int, m_sup: int) -> np.ndarray:
    """(d,) int64: the sup position of each relative powerful basis
    monomial b_rel (T[rel, 0])."""
    return _frozen(rel_coeff_table(m_sub, m_sup)[:, 0].copy())


@lru_cache(maxsize=512)
def crt_embed_table(m_sub: int, m_sup: int, q: int) -> np.ndarray:
    """(n_sup,) int64: the sub slot each sup slot reads, the one whose
    unit is the sup slot's unit mod m_sub."""
    _check(m_sub, m_sup, "crt_embed_table")
    pos = {int(u): i for i, u in enumerate(_global_units(general_plan(m_sub, q)))}
    return _frozen(np.array([pos[int(u) % m_sub] for u in _global_units(general_plan(m_sup, q))],
                            dtype=np.int64))


@lru_cache(maxsize=512)
def twace_crt_twists(m_sub: int, m_sup: int, q: int) -> tuple[np.ndarray, np.ndarray]:
    """(pre, post) u32 slot vectors of the CRT tweaked trace:
    pre = t^-1 = g mhat^-1 over the sup ring, post = t' = mhat' g'^-1 over
    the sub ring."""
    g_sup = _g_crt_vec(m_sup, q).astype(np.int64)
    pre = g_sup * nt.modinv(fact(m_sup).mhat % q, q) % q
    mh_sub = fact(m_sub).mhat % q
    post = [mh_sub * nt.modinv(int(v), q) % q for v in _g_crt_vec(m_sub, q)]
    return _frozen(pre.astype(np.uint32)), _frozen(np.array(post, dtype=np.uint32))


def embed_pow(m_sub: int, m_sup: int, x: torch.Tensor) -> torch.Tensor:
    """(..., n_sub) powerful (or decoding) coefficients -> (..., n_sup):
    the `embed_pow_table` scatter."""
    tbl = torch.from_numpy(embed_pow_table(m_sub, m_sup).copy()).to(x.device)
    out = x.new_zeros((*x.shape[:-1], fact(m_sup).phi))
    out[..., tbl] = x
    return out


def twace_pow(m_sub: int, m_sup: int, x: torch.Tensor) -> torch.Tensor:
    """The tweaked trace in the powerful basis: the embedded positions'
    gather."""
    return x[..., torch.from_numpy(embed_pow_table(m_sub, m_sup).copy()).to(x.device)]


def embed_crt(m_sub: int, m_sup: int, q: int, x: torch.Tensor) -> torch.Tensor:
    """(..., n_sub) CRT slots -> (..., n_sup): each sup slot reads its sub
    slot (`crt_embed_table`)."""
    return x[..., torch.from_numpy(crt_embed_table(m_sub, m_sup, q).copy()).to(x.device)]


def twace_crt(m_sub: int, m_sup: int, q: int, x: torch.Tensor) -> torch.Tensor:
    """The tweaked trace in the CRT basis, Tw(x) = t' Tr(x / t): the slots
    times `pre`, summed over each sub slot's coset, times `post` (for
    2-power towers the coset mean)."""
    tbl = crt_embed_table(m_sub, m_sup, q)
    n_sub = fact(m_sub).phi
    pre, post = (torch.from_numpy(v.astype(np.int64)).to(x.device)
                 for v in twace_crt_twists(m_sub, m_sup, q))
    order = torch.from_numpy(np.argsort(tbl, kind="stable")).to(x.device)
    y = x.long() * pre % q
    s = y[..., order].reshape(*x.shape[:-1], n_sub, -1).sum(-1) % q
    return (s * post % q).to(torch.int32)


def coeffs_rel(m_sub: int, m_sup: int, x: torch.Tensor) -> torch.Tensor:
    """(..., n_sup) -> (d, ..., n_sub): the relative coefficients (powerful
    or decoding, one table for both) by the `rel_coeff_table` gather."""
    T = torch.from_numpy(rel_coeff_table(m_sub, m_sup).copy()).to(x.device)
    return torch.movedim(x[..., T], -2, 0)


# ---------------------------------------------------------------------------
# decoding-basis geometry (the sampler's mixing factors)
# ---------------------------------------------------------------------------


@lru_cache(maxsize=256)
def _dec_basis_complex(m: int) -> np.ndarray:
    """(n, n) complex E with E[u, j] = sigma_u(d_j): the canonical
    embedding of R_m's decoding basis (powerful basis times L)."""
    f = fact(m)
    n = f.phi
    exps = np.zeros(n, dtype=np.int64)
    for flat in range(n):
        idx = np.unravel_index(flat, f.phi_shape)
        exps[flat] = sum(int(j) * (m // pp.value) for j, pp in zip(idx, f.pps)) % m
    mm = max(m, 1)
    units = np.array([u for u in range(mm) if math.gcd(u, m) == 1] or [0], dtype=np.int64)
    P = np.exp(2j * np.pi * (np.outer(units, exps) % mm) / mm)
    Lm = l_host(m, np.eye(n, dtype=np.int64), 1 << 30).T if m > 1 else np.eye(n, dtype=np.int64)
    return P @ Lm


@lru_cache(maxsize=256)
def _axis_gram_real(p: int, e: int, with_g: bool) -> np.ndarray:
    """The real Gram matrix of the p^e ring's decoding basis under the
    canonical embedding, twisted by sigma(1 - zeta_p) if with_g (an odd
    axis's share of g)."""
    pe = p ** e
    E = _dec_basis_complex(pe)
    if with_g and p != 2:
        units = np.array([u for u in range(pe) if u % p], dtype=np.int64)
        E = E * (1 - np.exp(2j * np.pi * ((units * (pe // p)) % pe) / pe))[:, None]
    return (E.conj().T @ E).real


@lru_cache(maxsize=256)
def dec_mixing_factors(m: int) -> tuple[np.ndarray, ...]:
    """Per-axis mixing factors L_i with kron_i L_i = cholesky(Gram_dec(m)^-1),
    the decoding-basis Gaussian's mixing matrix: the Gram factors per axis,
    and inverse and Cholesky factor over Kronecker products."""
    out = []
    for pp in fact(m).pps:
        if pp.p == 2:  # the power basis is orthogonal: Gram = phi I
            out.append(np.eye(pp.phi) / np.sqrt(pp.phi))
        else:
            out.append(np.linalg.cholesky(np.linalg.inv(_axis_gram_real(pp.p, pp.e, False))))
    return tuple(out)


@lru_cache(maxsize=256)
def gram_g_dec(m: int) -> np.ndarray:
    """The integer Gram matrix G with ||g x||^2 = x^T G x for decoding-basis
    coordinates x (the canonical-embedding norm): the Kronecker product of
    the per-axis Grams twisted by each odd axis's share of g, each rounded
    to the integers it is."""
    out = np.ones((1, 1), dtype=np.int64)
    for pp in fact(m).pps:
        G = _axis_gram_real(pp.p, pp.e, True)
        Gi = np.rint(G).astype(np.int64)
        if np.max(np.abs(G - Gi)) >= min(max(1e-6, 1e-12 * float(np.max(np.abs(G))) * pp.phi), 0.4):
            raise ArithmeticError(f"gram_g_dec: the {pp.p}^{pp.e} axis Gram is not integral")
        out = np.kron(out, Gi)
    return _frozen(out)
