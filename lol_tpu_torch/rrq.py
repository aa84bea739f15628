"""RRq, the torus R/qZ ("reals mod q") of the continuous RLWE samples.

Counterpart of `lol_tpu/rrq.py` (Lol's RRq): additive-group arithmetic,
Reduce (R -> R/qZ), Lift (the centered representative), Rescale
(R/qZ -> R/q'Z), and rounding to Z_q, over float32 tensors holding centered
representatives in [-q/2, q/2), as the reference holds them.
"""

from __future__ import annotations

import torch


def reduce(x: torch.Tensor, q: float) -> torch.Tensor:
    """R -> R/qZ, the centered representative."""
    r = torch.fmod(x, q)  # exact, then moved into [0, q) as jnp.mod does
    r = torch.where((r != 0) & ((r < 0) != (q < 0)), r + q, r)
    return torch.where(r >= q / 2, r - q, r)


def lift(x: torch.Tensor) -> torch.Tensor:
    """The centered representative (the identity on the canonical one)."""
    return x


def add(a: torch.Tensor, b: torch.Tensor, q: float) -> torch.Tensor:
    return reduce(a + b, q)


def neg(a: torch.Tensor, q: float) -> torch.Tensor:
    return reduce(-a, q)


def rescale(x: torch.Tensor, q: float, q2: float) -> torch.Tensor:
    """R/qZ -> R/q2Z: times q2 / q (Lol Rescale RRq)."""
    return reduce(x * (q2 / q), q2)


def round_to_zq(x: torch.Tensor, q: int) -> torch.Tensor:
    """R/qZ -> Z_q by coefficient rounding (half to even), int32 residues."""
    return torch.remainder(torch.round(x).to(torch.int32), q)
