"""The reference's constructor arguments on the port's classes (the
argument names themselves: tests/test_torch_parity_names.py).  Each class
built by the reference's keywords, with the reference's forms of the
values where the port holds another (a `Factored`, `Modulus` descriptors,
tuples of `Cyc`), equals the one built by the port's own names, and an
argument that contradicts the others is refused.  `BatchedBGV(params,
use_pallas=...)` keeps the knob and computes what `BatchedBGV(params)`
computes (on the card it launches the same kernels: `chip_smoke.phase_3m`).
"""

import numpy as np
import pytest
import torch

from lol_tpu_torch import gadget as gd, numtheory as nt, prf, prng, she, zq
from lol_tpu_torch.cyc import Cyc, Rep
from lol_tpu_torch.factored import fact
from lol_tpu_torch.ring import RingContext, ring_context
from lol_tpu_torch.rns import RnsBasis, rns_basis
from lol_tpu_torch.she_batched import BatchedBGV

torch.set_num_threads(2)

QS = tuple(nt.ntt_primes(32, 30, 3))
PARAMS = she.SHEParams(m=32, p=257, qs=QS[:2], var=2.0)


@pytest.mark.parametrize("use_pallas", [False, True, None])
def test_batched_bgv_takes_use_pallas_and_computes_the_same(use_pallas):
    bb = BatchedBGV(PARAMS, use_pallas=use_pallas)
    assert bb.use_pallas is use_pallas and bb.device == torch.device("cuda")  # the card by default
    plain, knob = BatchedBGV(PARAMS, "cpu"), BatchedBGV(PARAMS, use_pallas=use_pallas, device="cpu")
    g, rng = prng.KeyChain(3), np.random.default_rng(3)
    sk = she.gen_sk(PARAMS, g(), "cpu")
    hint = plain.gen_ks_quad_hint(sk, g())
    cts = [plain.build_encrypt(sk)(she.pt_random(PARAMS, rng, (4,), "cpu"), g()) for _ in range(2)]
    want = plain.build_step(hint)(*cts[0], *cts[1])
    got = knob.build_step(hint)(*cts[0], *cts[1])
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_ring_context_takes_fm():
    basis = rns_basis(QS)
    want = ring_context(32, QS)
    for ctx in (RingContext(fm=fact(32), basis=basis), RingContext(fact(32), basis),
                RingContext(m=32, basis=basis), RingContext(32, basis)):
        assert ctx == want and hash(ctx) == hash(want) and ctx.m == 32 and ctx.fm == fact(32)
    for bad in (dict(m=32, fm=fact(32), basis=basis), dict(basis=basis), dict(m=32)):
        with pytest.raises(TypeError):
            RingContext(**bad)


def test_rns_basis_takes_moduli():
    want = rns_basis(QS)
    for b in (RnsBasis(moduli=tuple(zq.Modulus(q) for q in QS)), RnsBasis(moduli=QS),
              RnsBasis(qs=QS), RnsBasis(QS), RnsBasis(tuple(zq.Modulus(q) for q in QS))):
        assert b == want and b.qs == QS and all(type(q) is int for q in b.qs)
    with pytest.raises(TypeError):
        RnsBasis(QS, moduli=QS)
    with pytest.raises(ValueError, match="not coprime"):
        RnsBasis(moduli=(QS[0], QS[0]))


def test_prf_family_takes_ctx_and_cyc_rows():
    ctx = ring_context(32, (257,))
    fam = prf.PRFFamily.random(ctx, gd.BaseBGad(2), prf.balanced(3), prng.PRNGKey(0), device="cpu")
    rows = {k: tuple(Cyc.from_ints(ctx, r, device="cpu") for r in getattr(fam, k))
            for k in ("a0", "a1")}
    for other in (prf.PRFFamily(ctx=ctx, spec=fam.spec, tree=fam.tree, **rows),
                  prf.PRFFamily(ctx=ctx, spec=fam.spec, tree=fam.tree, a0=fam.a0, a1=fam.a1),
                  prf.PRFFamily(32, 257, fam.spec, fam.tree, fam.a0, fam.a1)):
        assert (other.m, other.p, other.ctx) == (32, 257, ctx)
        np.testing.assert_array_equal(other.a0, fam.a0)
        np.testing.assert_array_equal(other.a1, fam.a1)
        np.testing.assert_array_equal(other.a_t((1, 0, 1)), fam.a_t((1, 0, 1)))
    with pytest.raises(ValueError, match="not R_p"):
        prf.PRFFamily(m=64, ctx=ctx, spec=fam.spec, tree=fam.tree, a0=fam.a0, a1=fam.a1)
    with pytest.raises(ValueError, match="not R_p"):
        prf.PRFFamily(ctx=ring_context(32, QS[:2]), spec=fam.spec, tree=fam.tree,
                      a0=fam.a0, a1=fam.a1)


def _cycs(ctx, t):
    return tuple(Cyc(ctx, Rep.CRT, t[j]) for j in range(t.shape[0]))


def test_ks_hint_takes_ctx_and_cyc_rows():
    sk = she.gen_sk(PARAMS, prng.PRNGKey(1), "cpu")
    h = she.ks_quad_circ_hint(sk, gd.RnsGad(), prng.PRNGKey(2), device="cpu")
    ctx = PARAMS.ctx
    for other in (she.KSHint(params=PARAMS, ctx=ctx, spec=h.spec, h0=_cycs(ctx, h.h0),
                             h1=_cycs(ctx, h.h1)),
                  she.KSHint(PARAMS, h.h0, h.h1, h.spec, ctx=ctx)):
        assert other.ctx == ctx and other.spec == h.spec
        assert torch.equal(other.h0, h.h0) and torch.equal(other.h1, h.h1)
    with pytest.raises(ValueError, match="not params' ring"):
        she.KSHint(params=PARAMS, ctx=ring_context(64, PARAMS.qs), spec=h.spec, h0=h.h0, h1=h.h1)


def test_ks_hint_ext_takes_ctx_ext():
    sk = she.gen_sk(PARAMS, prng.PRNGKey(1), "cpu")
    h = she.ks_quad_circ_hint_ext(sk, gd.RnsGad(), prng.PRNGKey(2), QS[2:], device="cpu")
    ctx_ext = ring_context(32, QS)
    for other in (she.KSHintExt(params=PARAMS, ctx_ext=ctx_ext, n_special=1, spec=h.spec,
                                h0=_cycs(ctx_ext, h.h0), h1=_cycs(ctx_ext, h.h1)),
                  she.KSHintExt(PARAMS, QS, 1, h.h0, h.h1, h.spec, ctx_ext=ctx_ext),
                  she.KSHintExt(PARAMS, list(QS), 1, h.h0, h.h1)):
        assert other.ext_qs == h.ext_qs == QS and other.ctx_ext == ctx_ext
        assert torch.equal(other.h0, h.h0) and torch.equal(other.h1, h.h1)
    with pytest.raises(ValueError, match="ctx_ext"):
        she.KSHintExt(PARAMS, QS[::-1], 1, h.h0, h.h1, ctx_ext=ctx_ext)
    with pytest.raises(ValueError, match="ctx_ext"):
        she.KSHintExt(PARAMS, n_special=1, h0=h.h0, h1=h.h1, ctx_ext=ring_context(64, QS))
    with pytest.raises(TypeError, match="needs ext_qs"):
        she.KSHintExt(PARAMS, n_special=1, h0=h.h0, h1=h.h1)
