"""The port's ring-sharded NTT at D = 2 against the JAX package's
interpret-mode remote-DMA kernels (`test_torch_ring_ntt.check_interpret`,
its two-call path at a batch below 128); a file of its own, since the two
interpret-mode calls take ~100 s."""

import pytest

from test_torch_ring_ntt import check_interpret


@pytest.mark.parametrize("D,n,batch,jax_overlap", [(2, 256, (2,), False)])
def test_ring_ntt_matches_jax_interpret(D, n, batch, jax_overlap):
    check_interpret(D, n, batch, jax_overlap)
