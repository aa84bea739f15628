"""Randomness: rounded Gaussian coefficients and uniform residues.

Counterpart of `lol_tpu/sampling.py`: for 2-power m the decoding basis is
orthogonal, so `var` is the per-coefficient variance of iid rounded
N(0, var) integers; at general m `gaussian_dec_ints` mixes the iid draw
axis by axis with the decoding basis's factors (the same normalization:
on the 2-power axis the factor is the identity).  Randomness comes from an
explicit `torch.Generator`; the draws are made on the generator's device
and moved to `device`.  (They do not reproduce the JAX package's
threefry bits, and need not: tests carry state across through numpy.)
"""

from __future__ import annotations

import math

import numpy as np
import torch

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


def gaussian_dec_ints(ctx, var: float, generator: torch.Generator, batch=(),
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
