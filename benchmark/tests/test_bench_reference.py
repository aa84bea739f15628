"""The plain reference against the program's CPU path, bit for bit, on
small rings of both kinds (2-power m, and m = 2^a 3^2 with its
tensor-factored CRT): every transform in both directions, and the step
on the benchmark's own key and hint.  And the hint is a real one: the
step on real encryptions decrypts to the plaintexts' product."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from bench_tiny import primes

from benchmark.reference import bgv as ref_bgv, ring as ref_ring
from lol_tpu_torch import numtheory as nt, prng, she
from lol_tpu_torch.she_batched import BatchedBGV

RINGS = [(64, 257), (128, 257), (72, 7), (144, 7)]


def _inputs(m, p, B, seed):
    qs = primes(m)
    ring = ref_ring.Ring(m, qs, "cpu")
    n = ring.n
    g = torch.Generator().manual_seed(seed)
    s = torch.randint(-1, 2, (n,), generator=g)
    a = torch.stack([torch.stack([torch.randint(0, q, (n,), generator=g) for q in qs])
                     for _ in qs])
    e = torch.randint(-6, 7, (len(qs), n), generator=g)
    h0, h1 = ref_bgv.relin_hint(ring, p, s, a, e)
    cts = [torch.stack([torch.randint(0, q, (n, B), generator=g, dtype=torch.int32)
                        for q in qs]) for _ in range(4)]
    return ring, she.SHEParams(m=m, p=p, qs=tuple(qs)), s, h0, h1, cts


@pytest.mark.parametrize("m, p", RINGS)
def test_transforms_equal_the_programs(m, p):
    ring, params, *_ = _inputs(m, p, 1, m)
    bb = BatchedBGV(params, "cpu")
    g = torch.Generator().manual_seed(m + 1)
    for ch, q in enumerate(params.qs):
        x = torch.randint(0, q, (ring.n, 6), generator=g, dtype=torch.int32)
        x[0, 0] = q - 1
        for inverse in (False, True):
            assert torch.equal(ring.crt(x, ch, inverse), bb._crt_one(x, ch, inverse).long())


@pytest.mark.parametrize("m, p", RINGS)
def test_step_equals_the_programs(m, p):
    ring, params, s, h0, h1, cts = _inputs(m, p, 7, m + 2)
    want = BatchedBGV(params, "cpu").build_step(she.KSHint(params, h0, h1))(*cts)
    got = ref_bgv.step(ring, p, *cts, h0, h1)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    low = ref_ring.Ring(m, params.qs, "cpu", mul=ref_ring.mul_float64)
    assert any(not torch.equal(a, b) for a, b in zip(ref_bgv.step(low, p, *cts, h0, h1), want))


def _negacyclic(a, b, p):
    n = len(a)
    out = np.zeros(n, dtype=np.int64)
    for i in range(n):
        for j in range(n):
            k, sgn = (i + j, 1) if i + j < n else (i + j - n, -1)
            out[k] += sgn * int(a[i]) * int(b[j])
    return out % p


def test_the_hint_relinearises():
    m, p, B = 64, 257, 3
    ring, params, s, h0, h1, _ = _inputs(m, p, B, 5)
    sk = she.SK(params, s, params.var)
    bb = BatchedBGV(params, "cpu")
    enc = bb.build_encrypt(sk)
    keys = prng.KeyChain(11)
    g = torch.Generator().manual_seed(12)
    m1, m2 = (torch.randint(0, p, (ring.n, B), generator=g) for _ in range(2))
    (c0, c1), (d0, d1) = enc(m1, keys()), enc(m2, keys())
    out = ref_bgv.step(ring, p, c0, c1, d0, d1, h0, h1)
    low = she.SHEParams(m=m, p=p, qs=params.qs[:-1])
    dec = BatchedBGV(low, "cpu").build_decrypt(she.SK(low, s, params.var),
                                               f=nt.modinv(params.qs[-1] % p, p))
    got = dec(*out)
    for b in range(B):
        assert np.array_equal(got[:, b].numpy(), _negacyclic(m1[:, b], m2[:, b], p))
