"""The port's ring tunnel against the benchmark's plain reference
(`benchmark/reference/tunnel.py`, plain int64 torch written from the
definitions): `BatchedBGV.build_tunnel` on the reference's hint gives the
reference's tunnel word for word, and the targets the port's
`gen_tunnel_hint` encrypts, L(b_i s_R) over S, are the reference's.
Three 30-bit primes, p = 257; (E, R, S) with E = S (the reference bench's
tower descent, ys = [1, 0] or random images), E below S, and a composite
tower."""

import numpy as np
import pytest
import torch

from benchmark.reference import ring as ref_ring, tunnel as ref_tunnel
from lol_tpu_torch import linear, numtheory as nt, prng, she
from lol_tpu_torch.she_batched import BatchedBGV

torch.set_num_threads(2)

P, B = 257, 5


def _setup(m_e, m_r, m_s, ys_kind, seed):
    qs = tuple(nt.ntt_primes(m_r, 30, 3))
    ring_r, ring_s = ref_ring.Ring(m_r, qs, "cpu"), ref_ring.Ring(m_s, qs, "cpu")
    d = ring_r.n // ref_ring.Ring(m_e, qs, "cpu").n
    g = torch.Generator().manual_seed(seed)
    ys = torch.zeros((d, ring_s.n), dtype=torch.int64)
    if ys_kind == "descent":
        ys[0, 0] = 1
    else:
        ys = torch.randint(-3, 4, (d, ring_s.n), generator=g)
    lmap = ref_tunnel.Map(m_e, ring_r, ring_s, ys)
    params_r, params_s = (she.SHEParams(m=m, p=P, qs=qs, var=2.0) for m in (m_r, m_s))
    lin = linear.linear_pow(*(she.SHEParams(m=m, p=P, qs=qs).ctx for m in (m_e, m_r, m_s)),
                            list(ys.numpy()))
    return lmap, lin, params_r, params_s, g


@pytest.mark.parametrize("m_e, m_r, m_s, ys_kind", [
    (32, 64, 32, "descent"), (32, 64, 32, "random"), (64, 128, 64, "descent"),
    (64, 128, 64, "random"), (16, 64, 32, "random"), (36, 72, 36, "random")])
def test_port_tunnel_equals_the_reference(m_e, m_r, m_s, ys_kind):
    lmap, lin, params_r, params_s, g = _setup(m_e, m_r, m_s, ys_kind, m_r + m_e)
    qs, d, n_r, n_s = params_r.qs, lmap.d, lmap.r.n, lmap.s.n
    s_r = torch.randint(-1, 2, (n_r,), generator=g)
    s_s = torch.randint(-1, 2, (n_s,), generator=g)
    a = torch.stack([torch.randint(0, q, (d, 3, n_s), generator=g) for q in qs], dim=2)
    e = torch.randint(-4, 5, (d, 3, n_s), generator=g)
    h0, h1 = ref_tunnel.tunnel_hint(lmap, P, s_r, s_s, a, e)
    th = she.TunnelHint(lin, tuple(she.KSHint(params_s, h0[i], h1[i]) for i in range(d)))
    c0, c1 = (torch.stack([torch.randint(0, q, (n_r, B), generator=g, dtype=torch.int32)
                           for q in qs]) for _ in range(2))
    c1[:, 0, 0] = torch.tensor(qs) - 1  # the digits' largest residues
    got = BatchedBGV(params_r, "cpu").build_tunnel(th)(c0, c1)
    want = ref_tunnel.tunnel(lmap, c0, c1, h0, h1)
    assert all(x.dtype == torch.int32 and torch.equal(x, w) for x, w in zip(got, want))


@pytest.mark.parametrize("m_e, m_r, m_s, ys_kind", [
    (32, 64, 32, "random"), (64, 128, 64, "descent"), (16, 64, 32, "random")])
def test_reference_targets_are_the_ports(m_e, m_r, m_s, ys_kind, monkeypatch):
    lmap, lin, params_r, params_s, g = _setup(m_e, m_r, m_s, ys_kind, m_r - m_e)
    s_r = torch.randint(-1, 2, (lmap.r.n,), generator=g)
    s_s = torch.randint(-1, 2, (lmap.s.n,), generator=g)
    seen = []
    gen_hints = BatchedBGV._gen_gadget_hints

    def spy(self, sk, targets, key, gadget=None):
        seen.append(targets.clone())
        return gen_hints(self, sk, targets, key, gadget)

    monkeypatch.setattr(BatchedBGV, "_gen_gadget_hints", spy)
    BatchedBGV(params_r, "cpu").gen_tunnel_hint(
        lin, she.SK(params_s, s_s, 2.0), she.SK(params_r, s_r, 2.0), prng.PRNGKey(m_s))
    assert len(seen) == 1
    np.testing.assert_array_equal(seen[0].numpy(), ref_tunnel.tunnel_targets(lmap, s_r).numpy())
