"""The port's CRT sets, finite fields and slot maps against the JAX package.

`lol_tpu_torch.crtset` (cyclotomic polynomials, the power -> powerful
rebasing, the slot orbits and degrees, the Hensel-lifted idempotents, the
slot restriction) and `lol_tpu_torch.gf` over the cases of
tests/test_crtset.py and tests/test_rlwe_gf.py; `linear.slot_projection`'s
images at (R, S, pk) = (32, 16, 257) and (63, 21, 4) in both modes; and
`prf.make_eval_hints`' map choice under "slots" and "auto" at odd p (both
packages' hint generators stubbed: the maps are the point).  Every
comparison is exact.  Host numpy only, so the file runs in seconds.
"""

import jax
import numpy as np
import pytest
import torch

from lol_tpu import crtset as jcrtset
from lol_tpu import gadget as jgd
from lol_tpu import gf as jgf
from lol_tpu import linear as jlinear
from lol_tpu import prf as jprf
from lol_tpu import she as jshe
from lol_tpu.cyc import Rep as JRep
from lol_tpu.ring import ring_context as j_ring_context
from lol_tpu_torch import convert, crtset, gf, linear, numtheory as nt, prf, she
from lol_tpu_torch.ring import ring_context
from lol_tpu_torch.she_batched import BatchedBGV

CASES = [(7, 2, 1), (7, 2, 3), (12, 5, 2), (15, 2, 1), (16, 7, 2), (9, 2, 2)]


@pytest.mark.parametrize("m", [2, 4, 6, 7, 9, 12, 15, 16, 21, 36, 63])
def test_cyclotomic_poly_and_powerful_rebasing_match_jax(m):
    assert crtset.cyclotomic_poly(m) == jcrtset.cyclotomic_poly(m)
    assert crtset.cyclotomic_poly(1) == jcrtset.cyclotomic_poly(1) == (-1, 1)
    np.testing.assert_array_equal(crtset.power_to_powerful(m), jcrtset.power_to_powerful(m))
    np.testing.assert_array_equal(linear._powerful_exponents(m), jlinear._powerful_exponents(m))


@pytest.mark.parametrize("m,p,k", CASES)
def test_crt_sets_match_jax(m, p, k):
    """Orbits, degree, count, the idempotents (k = 1, and Hensel-lifted for
    k > 1) and their powerful-basis rows (the JAX package's `crt_set_cyc`),
    which sum to 1 mod p^k."""
    assert crtset.slot_orbits(m, p) == jcrtset.slot_orbits(m, p)
    assert crtset.slot_degree(m, p) == jcrtset.slot_degree(m, p)
    assert crtset.num_slots(m, p) == jcrtset.num_slots(m, p)
    assert crtset._factor_phi_mod_p(m, p) == jcrtset._factor_phi_mod_p(m, p)
    for kk in sorted({1, k}):
        np.testing.assert_array_equal(crtset.crt_set_powerful(m, p, kk),
                                      jcrtset.crt_set_powerful(m, p, kk))
    rows = crtset.crt_set_ints(m, p, k)
    want = np.stack([np.asarray(e.lift_ints(rep=JRep.POW), dtype=np.int64) % p**k
                     for e in jcrtset.crt_set_cyc(m, p, k)])
    np.testing.assert_array_equal(rows, want)
    one = np.zeros(rows.shape[1], dtype=np.int64)
    one[0] = 1
    np.testing.assert_array_equal(rows.sum(0) % p**k, one)


@pytest.mark.parametrize("m_sub,m_sup,p", [(3, 21, 2), (21, 63, 2), (16, 32, 257), (4, 12, 5)])
def test_slot_restriction_matches_jax(m_sub, m_sup, p):
    np.testing.assert_array_equal(crtset.slot_restriction(m_sub, m_sup, p),
                                  jcrtset.slot_restriction(m_sub, m_sup, p))
    with pytest.raises(ValueError, match="m_sub | m_sup"):
        crtset.slot_restriction(5, m_sup, p)


def test_crtset_refuses_p_dividing_m():
    for mod in (crtset, jcrtset):
        with pytest.raises(ValueError, match="coprime"):
            mod.slot_orbits(12, 3)


@pytest.mark.parametrize("p,d", [(2, 1), (2, 4), (3, 2), (5, 3), (257, 2)])
def test_gf_matches_jax(p, d):
    """The irreducible modulus and the field operations: products, powers,
    inverses, Frobenius and trace of a few elements."""
    assert gf.irreducible_poly(p, d) == jgf.irreducible_poly(p, d)
    rng = np.random.default_rng(p * 10 + d)
    for _ in range(4):
        a, b = (rng.integers(0, p, d).tolist() for _ in range(2))
        x, y = gf.GF.of(p, d, a), gf.GF.of(p, d, b)
        jx, jy = jgf.GF.of(p, d, a), jgf.GF.of(p, d, b)
        assert (x * y).cs == (jx * jy).cs and (x - y).cs == (jx - jy).cs
        assert x.pow(5).cs == jx.pow(5).cs and x.frobenius().cs == jx.frobenius().cs
        assert x.trace() == jx.trace()
        if any(a):
            assert x.inv().cs == jx.inv().cs and (x * x.inv()) == gf.GF.one(p, d)
    with pytest.raises(ValueError, match="not prime"):
        gf.irreducible_poly(4, 2)


def test_numtheory_additions_match_jax():
    from lol_tpu import numtheory as jnt

    for n in range(1, 200):
        assert nt.euler_phi(n) == jnt.euler_phi(n)
        for a in (2, 3, 5, 7, 257):
            if np.gcd(a, n) == 1:
                assert nt.multiplicative_order(a % n, n) == jnt.multiplicative_order(a % n, n)
    with pytest.raises(ValueError, match="not a unit"):
        nt.multiplicative_order(4, 12)


def test_mul_matrix_and_solver_match_jax():
    rng = np.random.default_rng(0)
    for m, pk in ((16, 257), (21, 4)):
        u = rng.integers(0, pk, crtset.fact(m).phi)
        np.testing.assert_array_equal(linear._mul_matrix_mod(m, u, pk),
                                      jlinear._mul_matrix_mod(m, u, pk))
    A = rng.integers(0, 9, (6, 4))
    b = A @ rng.integers(0, 9, 4) % 9
    np.testing.assert_array_equal(linear._solve_mod_prime_power(A, b, 3, 2),
                                  jlinear._solve_mod_prime_power(A, b, 3, 2))
    for mod in (linear, jlinear):
        with pytest.raises(ValueError, match="inconsistent"):
            mod._solve_mod_prime_power(np.zeros((2, 2), np.int64), np.array([1, 0]), 3, 2)


@pytest.mark.parametrize("R,S,pk", [(32, 16, 257), (63, 21, 4)])
@pytest.mark.parametrize("mode", ["select", "trace"])
def test_slot_projection_matches_jax(R, S, pk, mode):
    """The images ys, centred-lifted integers over S, equal the JAX
    package's (its ring elements' powerful-basis lifts)."""
    qs = tuple(nt.ntt_primes(2 * 63 * 16, 30, 2))  # = 1 mod both rings' indices
    f = linear.slot_projection(ring_context(R, qs), ring_context(S, qs), pk, mode)
    jf = jlinear.slot_projection(j_ring_context(R, qs), j_ring_context(S, qs), pk, mode)
    assert (f.e_ctx.m, f.r_ctx.m, f.s_ctx.m) == (S, R, S)
    np.testing.assert_array_equal(np.stack(f.ys),
                                  np.stack([y.lift_ints(rep=JRep.POW) for y in jf.ys]))
    assert np.abs(np.stack(f.ys)).max() <= pk // 2
    with pytest.raises(ValueError, match="unknown mode"):
        linear.slot_projection(ring_context(R, qs), ring_context(S, qs), pk, "dense")


def test_slot_projection_refusals_match_jax():
    qs = tuple(nt.ntt_primes(64, 30, 2))
    for pk, what in ((12, "prime power"), (8, "coprime")):
        with pytest.raises(ValueError, match=what):
            linear.slot_projection(ring_context(32, qs), ring_context(16, qs), pk)
        with pytest.raises(ValueError, match=what):
            jlinear.slot_projection(j_ring_context(32, qs), j_ring_context(16, qs), pk)


def _maps(monkeypatch, p, rings, e_rings, maps):
    """The Linear maps each package's make_eval_hints hands its hint
    generator (stubbed), or the exception type it raises."""
    qs = tuple(nt.ntt_primes(2 * 63 * 16, 30, 2))  # = 1 mod every ring index here
    monkeypatch.setattr(jshe, "tunnel_hint", lambda lin, *args: lin)
    monkeypatch.setattr(BatchedBGV, "gen_tunnel_hint", lambda self, lin, *args: lin)
    params = [she.SHEParams(m=m, p=p, qs=qs, var=2.0) for m in rings]
    jsks = [jshe.SK(jshe.SHEParams(m=m, p=p, qs=qs, var=2.0),
                    np.zeros(prm.ctx.n, np.int64), 2.0) for m, prm in zip(rings, params)]
    sks = [convert.sk_from_numpy(prm, np.zeros(prm.ctx.n)) for prm in params]
    out = []
    for run in (lambda: jprf.make_eval_hints(None, jsks, rings, e_rings, jgd.RnsGad(),
                                             jax.random.PRNGKey(2), maps=maps),
                lambda: prf.make_eval_hints(None, sks, rings, e_rings,
                                            torch.Generator().manual_seed(3), maps=maps,
                                            device="cpu")):
        try:
            out.append(run()[0].tunnels)
        except (ValueError, ZeroDivisionError) as exc:
            out.append(type(exc))
    return out


@pytest.mark.parametrize("p,rings,e_rings", [
    (257, [32, 16, 8], [16, 8]),   # a slot map at each hop
    (257, [32, 16, 8], [16, 4]),   # the second hop's E is not S: the projection there
    (9, [16, 8, 4], [8, 4]),       # p = 3^2: the slot system is inconsistent mod 3
    (4, [63, 21], [21]),           # p = 2^2 at odd rings: a Hensel-lifted slot map
    (8, [16, 8], [8]),             # even p at 2-power rings: no slot structure
])
@pytest.mark.parametrize("maps", ["slots", "auto"])
def test_make_eval_hints_picks_the_jax_maps(monkeypatch, p, rings, e_rings, maps):
    """Hop by hop the same map as the JAX package (its E, R, S and the
    images), or under "slots" the same refusal."""
    jt, pt = _maps(monkeypatch, p, rings, e_rings, maps)
    if isinstance(jt, type):
        assert pt is jt and maps == "slots"
        return
    assert len(pt) == len(jt)
    for lin, jlin in zip(pt, jt):
        assert (lin.e_ctx.m, lin.r_ctx.m, lin.s_ctx.m) == (jlin.e_ctx.m, jlin.r_ctx.m,
                                                          jlin.s_ctx.m)
        np.testing.assert_array_equal(np.stack(lin.ys),
                                      np.stack([y.lift_ints(rep=JRep.POW) for y in jlin.ys]))
