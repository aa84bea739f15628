"""Randomness: rounded Gaussian coefficients and uniform residues.

Counterpart of the 2-power branch of `lol_tpu/sampling.py`: for 2-power m
the decoding basis is orthogonal, so `var` is the per-coefficient
variance of iid rounded N(0, var) integers.  Randomness comes from an
explicit `torch.Generator`; the draws are made on the generator's device
and moved to `device`.  (They do not reproduce the JAX package's
threefry bits, and need not: tests carry state across through numpy.)
"""

from __future__ import annotations

import math

import torch


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
