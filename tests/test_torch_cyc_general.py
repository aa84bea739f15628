"""The port's tensor layer and `Cyc` against the JAX package at the
composite rings m = 36, 72 and 90: every `ring` transform and every `Cyc`
method on the same residues in both packages (test_torch_cyc.py's
`check_ring_transforms` and `check_cyc_methods`, which run the 2-power
rings there), bit for bit."""

import pytest
import torch

from test_torch_cyc import GENERAL_RINGS, check_cyc_methods, check_ring_transforms

torch.set_num_threads(2)


@pytest.mark.parametrize("m", GENERAL_RINGS)
def test_ring_transforms_match_jax(m):
    check_ring_transforms(m)


@pytest.mark.parametrize("m", GENERAL_RINGS)
def test_cyc_methods_match_jax(m):
    check_cyc_methods(m)
