"""`Cyc`: cyclotomic ring elements that hide their representation.

Counterpart of `lol_tpu/cyc.py` (Lol's `Cyc` / `UCyc`): a ring element
tagged with its current basis (POW / DEC / CRT), whose arithmetic
converts only where it must: `*` forces CRT on both sides, `+` unifies
the representations, and `to_pow` / `to_dec` / `to_crt` are the explicit
hints.  Scalars and subring embeddings are materialized eagerly, as in
the reference.

`data` keeps the reference's layout, (..., nrns, n) int32 residues with
leading batch axes, on the device the element was made on: the card
unless the caller names another.  Every operation keeps its operands'
device; on a CUDA tensor the CRT transforms run the NTT kernels
(`ring.crt`).  Where the modulus admits no CRT basis (the plaintext rings
R_{2^k} of the PRF) `*` takes the exact E route, `_mul_e_route`.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from enum import Enum

import numpy as np
import torch

from . import numtheory as nt
from . import ring as rg
from . import zmstar
from .ring import RingContext


class Rep(Enum):
    POW = "pow"
    DEC = "dec"
    CRT = "crt"


def _as_residues(data, device) -> torch.Tensor:
    """Residues as int32 on device; by default a tensor keeps its device and
    a host array goes to the card."""
    if isinstance(data, torch.Tensor):
        return data.to(device=data.device if device is None else device, dtype=torch.int32)
    t = torch.from_numpy(np.asarray(data).astype(np.int64))
    return t.to(device="cuda" if device is None else device, dtype=torch.int32)


@dataclass(frozen=True, eq=False)
class Cyc:
    ctx: RingContext
    rep: Rep
    data: torch.Tensor  # (..., nrns, n) int32

    @property
    def device(self) -> torch.device:
        return self.data.device

    # --- constructors --------------------------------------------------
    @staticmethod
    def from_pow(ctx, data, device=None) -> "Cyc":
        """From (..., nrns, n) residues (a tensor keeps its device unless
        one is named; numpy goes to the card unless one is named)."""
        return Cyc(ctx, Rep.POW, _as_residues(data, device))

    @staticmethod
    def from_dec(ctx, data, device=None) -> "Cyc":
        return Cyc(ctx, Rep.DEC, _as_residues(data, device))

    @staticmethod
    def from_crt(ctx, data, device=None) -> "Cyc":
        return Cyc(ctx, Rep.CRT, _as_residues(data, device))

    @staticmethod
    def scalar(ctx, c: int, device="cuda") -> "Cyc":
        """Lol's Scalar constructor (materialized)."""
        return Cyc(ctx, Rep.POW, rg.scalar_pow(ctx, c, device))

    @staticmethod
    def zero(ctx, batch=(), device="cuda", rep: Rep = Rep.POW) -> "Cyc":
        """Zero, tagged POW (as the reference's) or any other basis: zero is
        zero in each, so `Cyc.zero(..., rep=Rep.CRT)` spares the transform
        of `Cyc.zero(...).to_crt()`."""
        return Cyc(ctx, rep, rg.zero(ctx, batch, device))

    @staticmethod
    def from_ints(ctx, coeffs, rep: Rep = Rep.POW, device="cuda") -> "Cyc":
        """Integer coefficient vector(s) (any int dtype or object ints, or
        an integer tensor) -> Cyc, reduced exactly into each channel."""
        if isinstance(coeffs, torch.Tensor):
            coeffs = coeffs.cpu().numpy()
        arr = ctx.basis.to_rns(np.asarray(coeffs))
        return Cyc(ctx, rep, torch.from_numpy(
            np.moveaxis(arr, 0, -2).astype(np.int32)).to(device))

    # --- representation conversions (Lol toPow / toDec / toCRT) ---------
    def to_pow(self) -> "Cyc":
        if self.rep is Rep.POW:
            return self
        if self.rep is Rep.DEC:
            return Cyc(self.ctx, Rep.POW, rg.l(self.ctx, self.data))
        return Cyc(self.ctx, Rep.POW, rg.crt_inv(self.ctx, self.data))

    def to_dec(self) -> "Cyc":
        if self.rep is Rep.DEC:
            return self
        return Cyc(self.ctx, Rep.DEC, rg.l_inv(self.ctx, self.to_pow().data))

    def to_crt(self) -> "Cyc":
        if self.rep is Rep.CRT:
            return self
        return Cyc(self.ctx, Rep.CRT, rg.crt(self.ctx, self.to_pow().data))

    # --- ring ops -------------------------------------------------------
    def _unify(self, other: "Cyc") -> tuple["Cyc", "Cyc"]:
        if self.ctx != other.ctx:
            raise ValueError(f"Cyc op across rings: {self.ctx} vs {other.ctx}")
        if self.rep is other.rep:
            return self, other
        if Rep.CRT in (self.rep, other.rep):
            return self.to_crt(), other.to_crt()
        return self.to_pow(), other.to_pow()

    def _scalar(self, c: int) -> "Cyc":
        return Cyc.scalar(self.ctx, c, self.device)

    def __add__(self, other) -> "Cyc":
        if isinstance(other, int):
            other = self._scalar(other)
        a, b = self._unify(other)
        return Cyc(a.ctx, a.rep, rg.add(a.ctx, a.data, b.data))

    def __sub__(self, other) -> "Cyc":
        if isinstance(other, int):
            other = self._scalar(other)
        a, b = self._unify(other)
        return Cyc(a.ctx, a.rep, rg.sub(a.ctx, a.data, b.data))

    def __neg__(self) -> "Cyc":
        return Cyc(self.ctx, self.rep, rg.neg(self.ctx, self.data))

    def __mul__(self, other) -> "Cyc":
        if isinstance(other, int):
            return Cyc(self.ctx, self.rep, rg.mul_scalar_int(self.ctx, self.data, other))
        if self.ctx != other.ctx:
            raise ValueError("Cyc mul across rings")
        if not self.ctx.has_crt():
            return _mul_e_route(self, other)
        a, b = self.to_crt(), other.to_crt()
        return Cyc(a.ctx, Rep.CRT, rg.mul_pointwise(a.ctx, a.data, b.data))

    __rmul__ = __mul__

    # --- g ops ----------------------------------------------------------
    def mul_g(self) -> "Cyc":
        fn = {Rep.POW: rg.mul_g_pow, Rep.DEC: rg.mul_g_dec, Rep.CRT: rg.mul_g_crt}[self.rep]
        return Cyc(self.ctx, self.rep, fn(self.ctx, self.data))

    def div_g(self) -> "Cyc":
        fn = {Rep.POW: rg.div_g_pow, Rep.DEC: rg.div_g_dec, Rep.CRT: rg.div_g_crt}[self.rep]
        return Cyc(self.ctx, self.rep, fn(self.ctx, self.data))

    # --- lifts / reductions (Lol liftCyc / reduce / rescaleCyc) ---------
    def lift_ints(self, rep: Rep = Rep.DEC) -> np.ndarray:
        """Centered integer coefficients, exact on the host (Lol liftCyc):
        object ints of shape (..., n), in the decoding basis by default
        (Lol liftDec), which is the powerful one at 2-power m."""
        c = self.to_dec() if rep is Rep.DEC else self.to_pow()
        return rg.lift_centered_host(c.ctx, c.data)

    def reduce_to(self, ctx2: RingContext) -> "Cyc":
        """Z -> Z_q' by lifting and re-reducing (exact, host)."""
        return Cyc.from_ints(ctx2, self.lift_ints(), rep=Rep.DEC, device=self.device)

    def rescale_drop_last(self, rep: Rep = Rep.POW) -> "Cyc":
        """The exact modulus switch Q -> Q / q_last (Lol rescaleCyc),
        rounding coefficientwise in the powerful (default) or decoding basis."""
        c = self.to_dec() if rep is Rep.DEC else self.to_pow()
        ctx2 = rg.ring_context(self.ctx.m, self.ctx.basis.qs[:-1])
        return Cyc(ctx2, rep, self.ctx.basis.rescale_drop_last(c.data))

    # --- subring ops ----------------------------------------------------
    def embed(self, sup_ctx: RingContext) -> "Cyc":
        if self.rep is Rep.CRT:
            return Cyc(sup_ctx, Rep.CRT, rg.embed_crt(self.ctx, sup_ctx, self.data))
        c = self.to_pow()
        return Cyc(sup_ctx, Rep.POW, rg.embed_pow(self.ctx, sup_ctx, c.data))

    def twace(self, sub_ctx: RingContext) -> "Cyc":
        if self.rep is Rep.CRT:
            return Cyc(sub_ctx, Rep.CRT, rg.twace_crt(self.ctx, sub_ctx, self.data))
        c = self.to_pow()
        return Cyc(sub_ctx, Rep.POW, rg.twace_pow(self.ctx, sub_ctx, c.data))

    def coeffs(self, sub_ctx: RingContext, rep: Rep = Rep.POW) -> list["Cyc"]:
        """The relative coefficients over sub_ctx (Lol coeffsCyc), powerful
        or decoding (one gather table for both)."""
        c = self.to_pow() if rep is Rep.POW else self.to_dec()
        stack = rg.coeffs_pow(self.ctx, sub_ctx, c.data)
        return [Cyc(sub_ctx, rep, stack[i]) for i in range(stack.shape[0])]

    @staticmethod
    def rel_pow_basis(sup_ctx: RingContext, sub_ctx: RingContext,
                      device="cuda") -> list["Cyc"]:
        """The relative powerful basis monomials b_rel as elements of the
        larger ring (Lol powBasis)."""
        out = []
        for pos in rg.pow_basis(sup_ctx, sub_ctx):
            v = np.zeros(sup_ctx.n, dtype=np.int64)
            v[int(pos)] = 1
            out.append(Cyc.from_ints(sup_ctx, v, device=device))
        return out

    def galois(self, k: int) -> "Cyc":
        """sigma_k : zeta -> zeta^k (gcd(k, m) = 1), a CRT slot permutation."""
        perm = zmstar.automorphism_slot_perm(self.ctx.m, self.ctx.basis.qs[0], k)
        c = self.to_crt()
        return Cyc(self.ctx, Rep.CRT, c.data[..., torch.from_numpy(perm).to(self.device)])

    # --- misc -----------------------------------------------------------
    def gsq_norm(self):
        """||g self||^2 in the canonical embedding (Lol gSqNorm), exact:
        on the element's device over one modulus (`ring.gsq_norm_dec`),
        on the host over a chain."""
        return rg.gsq_norm_dec(self.ctx, self.to_dec().data)

    def __eq__(self, other) -> bool:
        if not isinstance(other, Cyc):
            return NotImplemented
        if self.ctx != other.ctx:
            return False
        a, b = self._unify(other)
        return bool(torch.equal(a.data, b.data.to(a.device)))

    def __repr__(self):
        return f"Cyc({self.ctx}, {self.rep.name}, shape={tuple(self.data.shape)})"


# ---------------------------------------------------------------------------
# E-route multiplication (Lol UCyc rep E / CRTEmbed)
# ---------------------------------------------------------------------------


def _mul_e_route(a: Cyc, b: Cyc) -> Cyc:
    """The exact product where the modulus has no CRT basis (the plaintext
    rings R_{2^k}): the centered lifts multiply over an auxiliary
    NTT-friendly chain wide enough for the integer product, whose lift is
    reduced back, as the reference's E representation embeds into a ring
    that has the roots.  |coeff(xy)| <= n A B 2^omega (omega the number of
    odd prime axes); the chain holds twice that."""
    ctx = a.ctx
    ai = a.lift_ints(rep=Rep.POW)
    bi = b.lift_ints(rep=Rep.POW)
    amax = max((abs(int(v)) for v in ai.reshape(-1)), default=0)
    bmax = max((abs(int(v)) for v in bi.reshape(-1)), default=0)
    if amax == 0 or bmax == 0:
        return Cyc.zero(ctx, device=a.device)
    omega = sum(1 for pp in ctx.fm.pps if pp.p != 2)
    bound = ctx.n * amax * bmax << (omega + 1)
    divisor = 2 * ctx.n if ctx.fm.is_pow2() else ctx.m
    count, prod = 1, 1
    while prod <= 2 * bound:
        qs = tuple(nt.ntt_primes(divisor, 30, count))
        prod = math.prod(qs)
        count += 1
    aux = rg.ring_context(ctx.m, qs)
    pa = Cyc.from_ints(aux, ai, rep=Rep.POW, device=a.device)
    pb = Cyc.from_ints(aux, bi, rep=Rep.POW, device=a.device)
    return Cyc.from_ints(ctx, (pa * pb).lift_ints(rep=Rep.POW), rep=Rep.POW, device=a.device)
