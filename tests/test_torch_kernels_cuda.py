"""The Hopper kernels against their plain torch versions on the card.

Marked `cuda`: every test takes the `cuda` fixture, which skips without a
CUDA device.  On a machine with an H100 and nvcc, run
`python -m pytest tests/test_torch_kernels_cuda.py -q`.
"""

import numpy as np
import pytest
import torch

from lol_tpu_torch import numtheory as nt, she
from lol_tpu_torch.bench import mxu_ntt as mx
from lol_tpu_torch.ops import ntt
from lol_tpu_torch.ops.cuda import ntt_kernel as tk, pointwise as pw
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


@pytest.mark.parametrize("n,B", [(n, B) for n in (2, 256, 4096, 8192, 16384)
                                  for B in (1, 1000, 1024)] + [(4096, 16384)])
def test_route_b_inverse_matches_plain_and_gs(cuda, n, B):
    for q in nt.ntt_primes(2 * n, 30, 2):
        plan = ntt.ntt_plan(n, q)
        g = torch.Generator(device=cuda).manual_seed(n * B + q % 97)
        x = torch.randint(0, q, (n, B), generator=g, device=cuda, dtype=torch.int32)
        x[0] = q - 1
        if n > 2:
            x[1], x[2] = 0, 1
        got = tk.ntt_cm(x, plan, inverse=True, alg="dit")
        assert torch.equal(got, tk.ntt_cm_ref(x, plan, inverse=True, alg="dit"))
        assert torch.equal(got, tk.ntt_cm(x, plan, inverse=True))


@pytest.mark.parametrize("shape", [(1, 1), (3, 5), (256, 100), (512, 1024), (4096, 1000)])
def test_ct_mul_matches_plain(cuda, shape):
    for q in nt.ntt_primes(2 ** 15, 30, 3) + [12289]:
        g = torch.Generator(device=cuda).manual_seed(q % 1009 + shape[1])
        ops = [torch.randint(0, q, shape, generator=g, device=cuda, dtype=torch.int32)
               for _ in range(4)]
        ext = torch.tensor([0, 1, q - 1], device=cuda, dtype=torch.int32)
        flat = [o.view(-1) for o in ops]
        k = min(flat[0].numel(), 81)
        for j, f in enumerate(flat):  # every combination of 0, 1, q-1
            f[:k] = ext[(torch.arange(k, device=cuda) // 3 ** j) % 3]
        got = pw.ct_mul_cm(*ops, q)
        want = pw.ct_mul_cm_ref(*ops, q)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    # an operand offset by one element: the unaligned (scalar) kernel
    big = torch.randint(0, q, (4, 4097), generator=g, device=cuda, dtype=torch.int32)
    ops = [big[i, 1:] for i in range(4)]
    for a, b in zip(pw.ct_mul_cm(*ops, q), pw.ct_mul_cm_ref(*ops, q)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("shape,iters", [((1,), 0), ((33, 7), 5), ((512, 512), 64),
                                         ((mx.GRID * mx.ROWS, mx.LANES), mx.ITERS)])
def test_chain_matches_plain(cuda, shape, iters):
    g = torch.Generator(device=cuda).manual_seed(iters)
    x = torch.randint(-(1 << 31), 1 << 31, shape, generator=g, device=cuda,
                      dtype=torch.int32)
    assert torch.equal(mx.chain(x, iters), mx.chain_ref(x, iters))


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
    tk.ntt_cm(x, plan, inverse=True, alg="dit")
    assert tk.LAUNCHES["ntt_invb_block"] - before["ntt_invb_block"] == 1
    assert tk.LAUNCHES["ntt_invb_cross"] - before["ntt_invb_cross"] == passes - 1


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
    before = pw.LAUNCHES["ct_mul"]
    e_gpu = bb.build_step(hint)(*cts)
    assert pw.LAUNCHES["ct_mul"] - before == len(params.qs)
    e_cpu = BatchedBGV(params, "cpu").build_step(hint)(*(c.cpu() for c in cts))
    for a, b in zip(e_gpu, e_cpu):
        assert torch.equal(a.cpu(), b)
