"""Randomness: uniform ring elements, real and rounded Gaussians.

Counterpart of `lol_tpu/sampling.py`: for 2-power m the decoding basis is
orthogonal, so `var` is the per-coefficient variance of iid rounded
N(0, var) integers; at general m `gaussian_dec_ints` mixes the iid draw
axis by axis with the decoding basis's factors (the same normalization:
on the 2-power axis the factor is the identity).  Randomness comes from an
explicit `torch.Generator`; the draws are made on the generator's device
and moved to `device`.  (They do not reproduce the JAX package's
threefry bits, and need not: tests carry state across through numpy.)
Where the reference takes a key, these functions take the generator in
its place, (ctx, key, var) becoming (ctx, generator, var).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .cyc import Cyc, Rep
from .factored import fact
from .ops import general as gen


def gaussian_ints(shape, var: float, generator: torch.Generator,
                  device=None) -> torch.Tensor:
    """Rounded N(0, var) integers (float32 normals, round half to even)."""
    g = torch.randn(shape, generator=generator, device=generator.device,
                    dtype=torch.float32)
    e = torch.round(g * math.sqrt(var)).to(torch.int64)
    return e.to(device if device is not None else generator.device)


def uniform_residues(qs, shape, generator: torch.Generator,
                     device=None) -> torch.Tensor:
    """(nrns, *shape) int32 residues, channel i uniform in [0, q_i)."""
    out = torch.stack([
        torch.randint(0, q, shape, generator=generator,
                      device=generator.device, dtype=torch.int32)
        for q in qs
    ])
    return out.to(device if device is not None else generator.device)


def gaussian_dec_ints(ctx, generator: torch.Generator, var: float, batch=(),
                      device=None) -> torch.Tensor:
    """Rounded decoding-basis Gaussian coefficients, int64 of shape
    (*batch, n): iid N(0, var) float32 normals, at general m mixed along
    each tensor axis of `phi_shape` by `dec_mixing_factors` (axis 0's
    scaled by sqrt(n)), then rounded half to even.  At 2-power m this is
    `gaussian_ints`."""
    fm, n = ctx.fm, ctx.n
    if fm.is_pow2():
        return gaussian_ints((*batch, n), var, generator, device)
    g = torch.randn((*batch, n), generator=generator, device=generator.device,
                    dtype=torch.float32) * math.sqrt(var)
    shape = fm.phi_shape
    gs = g.view(*batch, *shape)
    for i, Li in enumerate(gen.dec_mixing_factors(fm.m)):
        Lf = torch.from_numpy((Li * math.sqrt(n) if i == 0 else Li).astype(np.float32))
        ax = len(batch) + i
        gs = torch.movedim(torch.movedim(gs, ax, -1) @ Lf.to(g.device).T, -1, ax)
    e = torch.round(gs.reshape(*batch, n)).to(torch.int64)
    return e.to(device if device is not None else generator.device)


def uniform(ctx, generator: torch.Generator, batch: tuple[int, ...] = (),
            device=None) -> Cyc:
    """A uniform element of R_q, tagged CRT (uniform in any basis), or POW
    where the modulus has no CRT basis (the plaintext rings R_{2^k})."""
    r = uniform_residues(ctx.basis.qs, (*batch, ctx.n), generator, device)
    return Cyc(ctx, Rep.CRT if ctx.has_crt() else Rep.POW, torch.movedim(r, 0, -2))


def real_gaussians(generator: torch.Generator, var: float, shape) -> torch.Tensor:
    """Continuous spherical Gaussians of variance var, float32 (Lol
    realGaussians)."""
    return torch.randn(shape, generator=generator, device=generator.device,
                       dtype=torch.float32) * math.sqrt(var)


def _dec_mixing_matrix(m: int) -> np.ndarray:
    """The dense L with L L^T = Gram_dec(m)^-1 (I / sqrt(n) at 2-power m),
    the Kronecker product of `dec_mixing_factors`: only the bounds of
    `rlwe.gaussian_quad_bound` want it; the sampler applies the factors."""
    f = fact(m)
    if f.is_pow2():
        return np.eye(f.phi) / np.sqrt(max(f.phi, 1))
    out = np.ones((1, 1))
    for Li in gen.dec_mixing_factors(m):
        out = np.kron(out, Li)
    return out


def _ints_to_rns(ctx, x: torch.Tensor) -> torch.Tensor:
    """Signed integer coefficients (..., n) -> (..., nrns, n) int32 residues."""
    return torch.stack([torch.remainder(x.long(), q) for q in ctx.basis.qs],
                       dim=-2).to(torch.int32)


def gaussian_cyc(ctx, generator: torch.Generator, var: float,
                 batch: tuple[int, ...] = (), device=None) -> Cyc:
    """A rounded decoding-basis Gaussian error element."""
    return Cyc(ctx, Rep.DEC, _ints_to_rns(ctx, gaussian_dec_ints(ctx, generator, var, batch,
                                                                  device)))


def gaussian_ints_np(ctx, generator: torch.Generator, var: float) -> np.ndarray:
    """The sampled integers on the host, int64 (secrets kept as ints)."""
    return gaussian_dec_ints(ctx, generator, var, device="cpu").numpy()


def error_coset(ctx, generator: torch.Generator, var: float, coset_ints, p: int,
                device=None) -> Cyc:
    """An error congruent to coset_ints mod p (Lol errorCoset):
    coset + p * (rounded Gaussian), in the decoding basis."""
    g = gaussian_dec_ints(ctx, generator, var, device=device)
    coset = torch.as_tensor(np.asarray(coset_ints, dtype=np.int64)).to(g.device)
    return Cyc(ctx, Rep.DEC, _ints_to_rns(ctx, coset + p * g))
