"""The Hopper NTT kernels against their plain torch versions on the card.

Marked `cuda`: every test takes the `cuda` fixture, which skips without a
CUDA device.  On a machine with an H100 and nvcc, run
`python -m pytest tests/test_torch_kernels_cuda.py -q`.
"""

import numpy as np
import pytest
import torch

from lol_tpu_torch import numtheory as nt, she
from lol_tpu_torch.ops import ntt
from lol_tpu_torch.ops.cuda import ntt_kernel as tk
from lol_tpu_torch.she_batched import BatchedBGV

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("n", [2, 256, 2048, 4096, 8192, 16384])
@pytest.mark.parametrize("B", [1, 1000, 1024])
def test_kernels_match_plain(cuda, n, B):
    q_src, q = nt.ntt_primes(2 * n, 30, 2)
    plan = ntt.ntt_plan(n, q)
    g = torch.Generator(device=cuda).manual_seed(n + B)
    x = torch.randint(0, q, (n, B), generator=g, device=cuda, dtype=torch.int32)
    x[0] = q - 1
    for inverse in (False, True):
        assert torch.equal(tk.ntt_cm(x, plan, inverse=inverse),
                           tk.ntt_cm_ref(x, plan, inverse=inverse))
    for src in (q_src, 12289):
        xs = torch.randint(0, src, (n, B), generator=g, device=cuda, dtype=torch.int32)
        xs[0] = src - 1
        assert torch.equal(tk.ntt_cm(xs, plan, pre_digit_q=src),
                           tk.ntt_cm_ref(xs, plan, pre_digit_q=src))
    assert torch.equal(tk.ntt_cm(tk.ntt_cm(x, plan), plan, inverse=True), x)


def test_launch_counter_counts_each_pass(cuda):
    n = 16384
    plan = ntt.ntt_plan(n, nt.ntt_primes(2 * n, 30, 1)[0])
    x = torch.zeros((n, 8), dtype=torch.int32, device=cuda)
    before = dict(tk.LAUNCHES)
    tk.ntt_cm(x, plan)
    tk.ntt_cm(x, plan, inverse=True)
    passes = len(tk._schedule(n))
    assert tk.LAUNCHES["ntt_fwd"] - before["ntt_fwd"] == passes
    assert tk.LAUNCHES["ntt_inv"] - before["ntt_inv"] == passes


def test_step_on_card_equals_step_on_cpu(cuda):
    m = 512
    params = she.SHEParams(m=m, p=257, qs=tuple(nt.ntt_primes(m, 30, 3)), var=2.0)
    g = torch.Generator().manual_seed(0)
    sk = she.gen_sk(params, g)
    bb = BatchedBGV(params, cuda)
    hint = bb.gen_ks_quad_hint(sk, g)
    enc = bb.build_encrypt(sk)
    cts = (*enc(she.pt_random(params, g, (40,)), g),
           *enc(she.pt_random(params, g, (40,)), g))
    e_gpu = bb.build_step(hint)(*cts)
    e_cpu = BatchedBGV(params, "cpu").build_step(hint)(*(c.cpu() for c in cts))
    for a, b in zip(e_gpu, e_cpu):
        assert torch.equal(a.cpu(), b)
