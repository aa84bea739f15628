"""Ring contexts and the tensor layer: cyclotomic-ring transforms over RNS
residues.

Counterpart of `lol_tpu/ring.py`: a `RingContext` is R_Q = Z_Q[zeta_m]
of degree n = phi(m), a cyclotomic index with its RNS chain.  A 2-power
m transforms by one negacyclic NTT plan per modulus (`ntt_plans`); any m
by the tensor-factored plans of `ops/general.py` (`general_plans`).

The module functions are the reference's Tensor methods over ring
elements in its layout, (..., nrns, n) int32 residues (leading axes a
batch), on whatever device the tensor lies:

  scalarPow -> scalar_pow      l/lInv -> l / l_inv
  crt/crtInv -> crt / crt_inv  mulG*/divG* -> mul_g_* / div_g_*
  twacePowDec/twaceCRT -> twace_pow / twace_crt
  embedPow/embedDec/embedCRT -> embed_pow / embed_dec / embed_crt
  coeffs -> coeffs_pow         powBasisPow -> pow_basis
  gSqNormDec -> gsq_norm_dec (on the device, one modulus) / gsq_norm_dec_host

`crt` / `crt_inv` move the residues into the kernels' coefficient-major
layout once, (nrns, n, B) with B the batch, and transform each channel's
contiguous (n, B) slice: by `ops.cuda.ntt_kernel.ntt_cm` at 2-power m and
by `ops.general.crt_cm` (its 2-power axis on the same kernels) otherwise.
So on a CUDA tensor every transform is a Hopper kernel launch, and on a
CPU tensor its plain version.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from . import numtheory as nt
from .factored import Factored, fact
from .ops import general as gen
from .ops import ntt
from .ops.cuda.ntt_kernel import ntt_cm
from .rns import RnsBasis, rns_basis


@dataclass(frozen=True, init=False)
class RingContext:
    """(cyclotomic index m, RNS chain): two ring elements interoperate iff
    their contexts are equal.  The index is given as `m` or, as the
    reference gives it, as `fm` (a `Factored`, also taken in m's place)."""

    m: int
    basis: RnsBasis

    def __init__(self, m: int | Factored | None = None, basis: RnsBasis | None = None, *,
                 fm: Factored | None = None):
        if (m is None) == (fm is None) or basis is None:
            raise TypeError("RingContext: give a basis and exactly one of m, fm")
        object.__setattr__(self, "m", int(getattr(m if fm is None else fm, "m", m)))
        object.__setattr__(self, "basis", basis)

    @property
    def fm(self) -> Factored:
        return fact(self.m)

    @property
    def n(self) -> int:
        return self.fm.phi

    @property
    def nrns(self) -> int:
        return self.basis.nrns

    def has_crt(self) -> bool:
        """Every modulus is a prime with a principal 2n-th (2-power m) or
        m-th root: the CRT basis exists.  Plaintext rings R_{2^k} have none
        (`cyc._mul_e_route` multiplies there)."""
        order = 2 * self.n if self.fm.is_pow2() else self.m
        return all(nt.is_prime(q) and (q - 1) % order == 0 for q in self.basis.qs)

    def ntt_plans(self) -> list[ntt.NTTPlan]:
        if not self.fm.is_pow2():
            raise NotImplementedError("general-m plans: use general_plans()")
        return [ntt.ntt_plan(self.n, q) for q in self.basis.qs]

    def general_plans(self) -> list[gen.GeneralPlan]:
        return [gen.general_plan(self.m, q) for q in self.basis.qs]

    def child(self, m2: int) -> "RingContext":
        """The same moduli at another index (embed / twace towers)."""
        return ring_context(m2, self.basis.qs)

    def __repr__(self):
        return f"RingContext(m={self.m}, qs={self.basis.qs})"


@lru_cache(maxsize=512)
def ring_context(m: int, qs: tuple[int, ...]) -> RingContext:
    return RingContext(m, rns_basis(tuple(qs)))


# ---------------------------------------------------------------------------
# constructors
# ---------------------------------------------------------------------------


def scalar_pow(ctx: RingContext, c, device="cuda") -> torch.Tensor:
    """A scalar as the constant of the powerful basis: (nrns, n) int32.
    c: an int (taken mod each q_i) or per-residue (nrns,) values."""
    out = torch.zeros((ctx.nrns, ctx.n), dtype=torch.int32)
    if isinstance(c, (int, np.integer)):
        out[:, 0] = torch.tensor([int(c) % q for q in ctx.basis.qs], dtype=torch.int32)
    else:
        out[:, 0] = torch.as_tensor(np.asarray(c, dtype=np.int64)).to(torch.int32)
    return out.to(device)


def zero(ctx: RingContext, batch: tuple[int, ...] = (), device="cuda") -> torch.Tensor:
    return torch.zeros((*batch, ctx.nrns, ctx.n), dtype=torch.int32, device=device)


# ---------------------------------------------------------------------------
# basis conversions
# ---------------------------------------------------------------------------


def _per_channel(ctx: RingContext, x: torch.Tensor, fn) -> torch.Tensor:
    """fn(channel i's contiguous (n, B) slice, i) over every channel of
    (..., nrns, n) x, B the flattened batch; the layout is restored."""
    lead = x.shape[:-2]
    flat = x.reshape(-1, ctx.nrns, ctx.n)
    cm = (flat.reshape(ctx.nrns, ctx.n, 1) if flat.shape[0] == 1  # (nrns, n, B), row-major
          else flat.permute(1, 2, 0).contiguous())
    out = torch.stack([fn(cm[i], i) for i in range(ctx.nrns)])
    return out.permute(2, 0, 1).reshape(*lead, ctx.nrns, out.shape[1]).to(torch.int32)


def crt(ctx: RingContext, x: torch.Tensor) -> torch.Tensor:
    """Powerful -> CRT basis (Lol Tensor.crt): the negacyclic NTT at
    2-power m, the tensor-factored transform otherwise."""
    if ctx.m > 1 and not ctx.has_crt():
        raise ValueError(f"no CRT basis over qs={ctx.basis.qs} for m={ctx.m} "
                         "(need m | q-1)")
    if ctx.fm.is_pow2():
        plans = ctx.ntt_plans()
        return _per_channel(ctx, x, lambda c, i: ntt_cm(c, plans[i]))
    plans = ctx.general_plans()
    return _per_channel(ctx, x, lambda c, i: gen.crt_cm(plans[i], c))


def crt_inv(ctx: RingContext, x: torch.Tensor) -> torch.Tensor:
    if ctx.fm.is_pow2():
        plans = ctx.ntt_plans()
        return _per_channel(ctx, x, lambda c, i: ntt_cm(c, plans[i], inverse=True))
    plans = ctx.general_plans()
    return _per_channel(ctx, x, lambda c, i: gen.crt_cm(plans[i], c, inverse=True))


def _general(ctx: RingContext, x: torch.Tensor, fn) -> torch.Tensor:
    """fn(plan, channel) over each channel's (..., n) residues."""
    plans = ctx.general_plans()
    return torch.stack([fn(plans[i], x[..., i, :]) for i in range(ctx.nrns)], dim=-2)


def l(ctx: RingContext, x: torch.Tensor) -> torch.Tensor:
    """Decoding -> powerful basis (Lol Tensor.l); the identity at 2-power m."""
    return x if ctx.fm.is_pow2() else _general(ctx, x, gen.l)


def l_inv(ctx: RingContext, x: torch.Tensor) -> torch.Tensor:
    return x if ctx.fm.is_pow2() else _general(ctx, x, gen.l_inv)


# --- multiplication by g = prod over the odd primes p | m of (1 - zeta_p) ---


def _g_op(fn):
    def op(ctx: RingContext, x: torch.Tensor) -> torch.Tensor:
        return x if ctx.fm.odd_radical == 1 else _general(ctx, x, fn)
    op.__doc__ = f"`ops.general.{fn.__name__}` per channel; the identity when g = 1."
    return op


mul_g_pow = _g_op(gen.mul_g_pow)
mul_g_dec = _g_op(gen.mul_g_dec)
mul_g_crt = _g_op(gen.mul_g_crt)
div_g_pow = _g_op(gen.div_g_pow)
div_g_dec = _g_op(gen.div_g_dec)
div_g_crt = _g_op(gen.div_g_crt)


# ---------------------------------------------------------------------------
# pointwise arithmetic (Lol zipWithT / fmapT)
# ---------------------------------------------------------------------------


def add(ctx: RingContext, a, b):
    return ctx.basis.add(a, b)


def sub(ctx: RingContext, a, b):
    return ctx.basis.sub(a, b)


def neg(ctx: RingContext, a):
    return ctx.basis.neg(a)


def mul_pointwise(ctx: RingContext, a, b):
    """The Hadamard product: ring multiplication when both are CRT."""
    return ctx.basis.mul(a, b)


def mul_scalar_int(ctx: RingContext, a: torch.Tensor, c: int) -> torch.Tensor:
    cv = torch.tensor([int(c) % q for q in ctx.basis.qs], dtype=torch.int64,
                      device=a.device).view(-1, 1)
    return ctx.basis.mul(a, cv)


# ---------------------------------------------------------------------------
# subrings: embed / twace / relative coefficients (m' | m)
# ---------------------------------------------------------------------------


def _check_sub(sub: RingContext, sup: RingContext, what: str) -> None:
    if not sub.fm.divides(sup.fm):
        raise ValueError(f"{what}: {sub.m} does not divide {sup.m}")


def embed_pow(sub: RingContext, sup: RingContext, x: torch.Tensor) -> torch.Tensor:
    _check_sub(sub, sup, "embed")
    if sub.basis.qs != sup.basis.qs:
        raise ValueError("embed: moduli must match")
    return gen.embed_pow(sub.m, sup.m, x)


def embed_dec(sub: RingContext, sup: RingContext, x: torch.Tensor) -> torch.Tensor:
    """The decoding-basis embedding (Lol embedDec): the powerful basis's
    index table (the relative factors live in the prime level, which L
    does not move)."""
    return embed_pow(sub, sup, x)


def twace_pow(sup: RingContext, sub: RingContext, x: torch.Tensor) -> torch.Tensor:
    """The tweaked trace in the powerful / decoding basis: a gather."""
    _check_sub(sub, sup, "twace")
    return gen.twace_pow(sub.m, sup.m, x)


def embed_crt(sub: RingContext, sup: RingContext, x: torch.Tensor) -> torch.Tensor:
    return torch.stack([gen.embed_crt(sub.m, sup.m, q, x[..., i, :])
                        for i, q in enumerate(sub.basis.qs)], dim=-2)


def twace_crt(sup: RingContext, sub: RingContext, x: torch.Tensor) -> torch.Tensor:
    """The CRT-basis tweaked trace: twist, coset sum, untwist."""
    _check_sub(sub, sup, "twace")
    return torch.stack([gen.twace_crt(sub.m, sup.m, q, x[..., i, :])
                        for i, q in enumerate(sup.basis.qs)], dim=-2)


def coeffs_pow(sup: RingContext, sub: RingContext, x: torch.Tensor) -> torch.Tensor:
    """The relative coefficients (Lol Tensor.coeffs): x = sum_rel b_rel
    embed(a_rel) over the relative powerful basis; the (d, ..., nrns,
    n_sub) stack of the a_rel.  The same gather serves the decoding basis."""
    _check_sub(sub, sup, "coeffs")
    return gen.coeffs_rel(sub.m, sup.m, x)


def pow_basis(sup: RingContext, sub: RingContext) -> np.ndarray:
    """The coefficient positions of the relative powerful basis monomials
    (Lol powBasisPow)."""
    _check_sub(sub, sup, "pow_basis")
    return gen.rel_pow_basis_positions(sub.m, sup.m)


# ---------------------------------------------------------------------------
# lifts and norms (host, exact)
# ---------------------------------------------------------------------------


def lift_centered_host(ctx: RingContext, x) -> np.ndarray:
    """(..., nrns, n) residues -> object ints in [-Q/2, Q/2)."""
    a = x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return ctx.basis.lift_centered(np.moveaxis(a, -2, 0))


def gsq_norm_dec_host(ctx: RingContext, x) -> np.ndarray:
    """||g x||^2, the canonical-embedding norm, from decoding-basis residues
    (Lol gSqNormDec), exact: x^T G x with G = `ops.general.gram_g_dec`
    (n I at 2-power m), by signed base-2^16 limbs of the lift."""
    lifted = lift_centered_host(ctx, x)
    flat = lifted.reshape(-1, ctx.n) if lifted.ndim > 1 else lifted[None]
    G = None if ctx.fm.is_pow2() else gen.gram_g_dec(ctx.m)
    out = [_quad_form_exact(row, G, ctx.n) for row in flat]
    return np.array(out, dtype=object).reshape(lifted.shape[:-1] or (1,))


def lift_centered(ctx: RingContext, x: torch.Tensor) -> torch.Tensor:
    """(..., 1, n) residues of a one-modulus ring -> int64 (..., n) in
    [-q/2, q/2), on x's device (`lift_centered_host` at any chain)."""
    if ctx.nrns != 1:
        raise ValueError(f"lift_centered: one modulus, the ring has {ctx.nrns}")
    q = ctx.basis.qs[0]
    v = x[..., 0, :].long()
    return torch.where(v >= (q + 1) // 2, v - q, v)


@lru_cache(maxsize=64)
def _gram_rows(m: int) -> tuple[np.ndarray, np.ndarray]:
    """gram_g_dec(m) by rows: (n, k) column indices and values of each
    row's nonzeros, padded with zeros (k = 2 at m = 18432)."""
    G = gen.gram_g_dec(m)
    k = int((G != 0).sum(1).max())
    cols = np.zeros((G.shape[0], k), dtype=np.int64)
    vals = np.zeros((G.shape[0], k), dtype=np.int64)
    for i, row in enumerate(G):
        nz = np.flatnonzero(row)
        cols[i, :nz.size], vals[i, :nz.size] = nz, row[nz]
    return cols, vals


_NORM_LIMB = 15


def gsq_norm_dec(ctx: RingContext, x: torch.Tensor) -> np.ndarray:
    """`gsq_norm_dec_host` computed on x's device, exact, for a one-modulus
    ring: the centered lift split into signed 15-bit limbs X_0, X_1, and
    x^T G x = S_00 + 2^16 S_01 + 2^30 S_11 with S_kl = X_k^T G X_l in int64
    (G by its nonzeros; n I at 2-power m), summed as Python ints.  A
    chain of several moduli, or a Gram too wide for int64 limb products,
    takes the host path."""
    n, pow2 = ctx.n, ctx.fm.is_pow2()
    if ctx.nrns != 1:
        return gsq_norm_dec_host(ctx, x)
    if not pow2:
        cols, vals = _gram_rows(ctx.m)
    row_sum = n if pow2 else int(np.abs(vals).sum(1).max())
    if n * row_sum << 2 * _NORM_LIMB >= 1 << 62:
        return gsq_norm_dec_host(ctx, x)
    v = lift_centered(ctx, x)
    a, sign = v.abs(), torch.where(v < 0, -1, 1)
    limbs = [sign * (a & ((1 << _NORM_LIMB) - 1)), sign * (a >> _NORM_LIMB)]
    if pow2:
        gx = [n * t for t in limbs]
    else:
        c = torch.from_numpy(cols).to(v.device)
        w = torch.from_numpy(vals).to(v.device)
        gx = [(t[..., c] * w).sum(-1) for t in limbs]
    def dot(k, j):  # S_kj per element, as Python ints
        return (limbs[k] * gx[j]).sum(-1).cpu().numpy().astype(object)

    total = dot(0, 0) + (dot(0, 1) << (_NORM_LIMB + 1)) + (dot(1, 1) << (2 * _NORM_LIMB))
    return np.asarray(total, dtype=object).reshape(v.shape[:-1] or (1,))


_LIMB_BITS = 16


def _quad_form_exact(row, G, n: int) -> int:
    """Exact x^T G x (G None: n I) of an object-int vector: x = sum_l
    2^(16 l) X_l with |X_l| < 2^16, so x^T G x = sum_{l, l'} 2^(16 (l + l'))
    X_l^T (G X_l'), int64 products and exact Python sums."""
    mask = (1 << _LIMB_BITS) - 1
    vals = [int(v) for v in row]
    top = max((abs(v) for v in vals), default=0).bit_length()
    nlimbs = max(1, (top + _LIMB_BITS - 1) // _LIMB_BITS)
    limbs = np.empty((nlimbs, n), dtype=np.int64)
    for j, v in enumerate(vals):
        s, a = (1, v) if v >= 0 else (-1, -v)
        for k in range(nlimbs):
            limbs[k, j] = s * ((a >> (_LIMB_BITS * k)) & mask)
    zs = limbs * np.int64(n) if G is None else limbs @ G.T  # G symmetric
    total = 0
    for k in range(nlimbs):
        xo = limbs[k].astype(object)
        for kp in range(nlimbs):
            total += int(np.sum(xo * zs[kp])) << (_LIMB_BITS * (k + kp))
    return total
