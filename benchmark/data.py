"""Inputs made on the device from a seed."""

from __future__ import annotations

import torch


def draw_residues(shape, axis: int, qs, g: torch.Generator, device) -> torch.Tensor:
    """Uniform int32 residues of `shape`, index i of `axis` mod qs[i]: one
    draw a modulus."""
    x = torch.empty(shape, dtype=torch.int32, device=device)
    for i, q in enumerate(qs):
        x.select(axis, i).random_(0, q, generator=g)
    return x
