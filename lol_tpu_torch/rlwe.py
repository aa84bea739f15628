"""RLWE / RLWR samples and their checks.

Counterpart of `lol_tpu/rlwe.py` (Lol's RLWE.Continuous / Discrete /
RLWR): `sample_*` draw (a, b = a s + e) with e a rounded decoding-basis
Gaussian (discrete), a real one (continuous: b as host float64 decoding
coordinates), or deterministic rounding (RLWR: b = round(a s, q -> q'));
`error_term` recovers e from a sample and the secret; `valid_instance`
checks the norm bound through gSqNorm, as the challenge verifier does;
`gaussian_quad_bound` derives that bound.  Ring elements are `Cyc`s on
the device the caller names (the card unless it names another).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from . import sampling
from .cyc import Cyc, Rep
from .ops import general as gen
from .ring import RingContext


@dataclass(frozen=True)
class RLWESample:
    a: Cyc
    b: Cyc  # a s + e, or the rounded a s for RLWR


def sample_discrete(ctx: RingContext, s: Cyc, var: float,
                    generator: torch.Generator) -> RLWESample:
    """Discrete RLWE: e a rounded decoding-basis Gaussian."""
    a = sampling.uniform(ctx, generator, device=s.device)
    e = sampling.gaussian_cyc(ctx, generator, var, device=s.device)
    return RLWESample(a, (a * s + e).to_crt())


def sample_continuous(ctx: RingContext, s: Cyc, var: float, generator: torch.Generator):
    """Continuous RLWE: (a, b) with b the decoding coordinates of a s plus a
    real Gaussian, host float64 (the lift of a s reaches q / 2, past
    float32's mantissa)."""
    a = sampling.uniform(ctx, generator, device=s.device)
    e_real = sampling.real_gaussians(generator, var, (ctx.n,)).cpu().numpy().astype(np.float64)
    lifted = (a * s).to_dec().lift_ints()
    return a, lifted.astype(np.float64) + e_real


def _round_scale(ctx: RingContext, ctx2: RingContext, prod: Cyc) -> Cyc:
    """round(q2 / q x) over ctx2, exact int64 rounding of the decoding
    coordinates."""
    q, q2 = ctx.basis.qs[0], ctx2.basis.qs[0]
    xv = prod.to_dec().data[..., 0, :].long()
    b = torch.div(xv * q2 + q // 2, q, rounding_mode="floor") % q2
    return Cyc(ctx2, Rep.DEC, b[..., None, :].to(torch.int32))


def sample_rlwr(ctx: RingContext, ctx2: RingContext, s: Cyc,
                generator: torch.Generator) -> RLWESample:
    """RLWR: b = round(q2 / q (a s)) over the rounding chain ctx2 (one
    modulus each; deterministic given a and s)."""
    if ctx.nrns != 1 or ctx2.nrns != 1:
        raise ValueError("sample_rlwr: single-modulus chains")
    a = sampling.uniform(ctx, generator, device=s.device)
    return RLWESample(a, _round_scale(ctx, ctx2, a * s))


def sample_rlwr_recompute(ctx: RingContext, ctx2: RingContext, a: Cyc, s: Cyc) -> Cyc:
    """The deterministic RLWR b from (a, s), the verifier's path."""
    return _round_scale(ctx, ctx2, a * s)


def error_term(s: Cyc, samp: RLWESample) -> np.ndarray:
    """e = b - a s as centered integers (Lol RLWE errorTerm)."""
    return (samp.b - samp.a * s).to_dec().lift_ints()


def gsq_norm_error(s: Cyc, samp: RLWESample):
    """||g e||^2, what the challenge verifier bounds (gSqNormDec)."""
    return (samp.b - samp.a * s).gsq_norm()


def valid_instance(s: Cyc, samp: RLWESample, bound: float) -> bool:
    """The error bound holds (Lol validInstance)."""
    return all(int(v) <= bound for v in np.atleast_1d(gsq_norm_error(s, samp)).reshape(-1))


def gaussian_quad_bound(ctx: RingContext, var: float, gram: str = "g", t: float = 40.0,
                        rounded: bool = True) -> int:
    """A high-probability upper bound on the error's quadratic form: the
    sampler draws x = round(sqrt(n) L z), z iid N(0, var), L L^T =
    Gram_dec^-1, and the verifier checks x^T G x (G = gram_g_dec for
    gram="g", I for "id").  Before rounding that is z^T A z with
    A = n var L^T G L, a sum of lam_i chi^2_1, so by Laurent-Massart
    P[Q > mu + 2 sqrt(s2 t) + 2 lmax t] <= e^-t (mu = tr A, s2 = tr A^2);
    t = 40 leaves a miss below 5e-18.  Rounding moves each coefficient by
    at most 1/2, adding sqrt(lmax(G) n) / 2 to the G-norm."""
    n = ctx.n
    if ctx.fm.is_pow2():
        lam = np.full(n, n * var if gram == "g" else var)
        g_lmax = float(n if gram == "g" else 1)
    else:
        L = sampling._dec_mixing_matrix(ctx.m) * np.sqrt(n)
        G = gen.gram_g_dec(ctx.m).astype(np.float64) if gram == "g" else np.eye(n)
        A = var * (L.T @ G @ L)
        lam = np.linalg.eigvalsh((A + A.T) / 2)
        g_lmax = float(np.linalg.eigvalsh((G + G.T) / 2)[-1])
    q_bound = float(np.sum(lam)) + 2.0 * np.sqrt(float(np.sum(lam * lam)) * t) \
        + 2.0 * float(np.max(lam)) * t
    if rounded:
        q_bound = (np.sqrt(q_bound) + 0.5 * np.sqrt(g_lmax * n)) ** 2
    return int(np.ceil(q_bound))
