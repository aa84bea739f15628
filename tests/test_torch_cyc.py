"""The port's tensor layer and `Cyc` against the JAX package, bit for bit.

Every `ring` / `ops.general` operation and every `Cyc` method runs on the
same residues (made from a numpy seed) in both packages, at the 2-power
rings m = 16 and 64 and the composite ones 36 = 2^2 3^2, 72 = 2^3 3^2 and
90 = 2 3^2 5, over two 30-bit primes; the E-route product at the
moduli 2^8 (m = 16) and 2^4 (m = 36), the number theory, gadget,
sampling, rrq, complexfield and rlwe pieces of the slice likewise.  The
JAX object path reaches no Pallas kernel, so it runs as it is, op by op.
The transforms and `Cyc` methods at the composite rings:
test_torch_cyc_general.py (`check_ring_transforms`, `check_cyc_methods`).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lol_tpu import complexfield as jcf
from lol_tpu import gadget as jgd
from lol_tpu import numtheory as jnt
from lol_tpu import ring as jrg
from lol_tpu import rlwe as jrlwe
from lol_tpu import rrq as jrrq
from lol_tpu import zmstar as jzm
from lol_tpu.cyc import Cyc as JCyc, Rep as JRep
from lol_tpu.crtset import crt_set_cyc as j_crt_set_cyc
from lol_tpu.ops import general as jgen
from lol_tpu_torch import prng
from lol_tpu_torch import complexfield as cf
from lol_tpu_torch import convert, crtset, gadget, numtheory as nt, ring as rg
from lol_tpu_torch import rlwe, rrq, sampling, zmstar
from lol_tpu_torch.cyc import Cyc, Rep
from lol_tpu_torch.ops import general as gen

torch.set_num_threads(2)

RINGS = (16, 64, 36, 72, 90)
# the transforms and Cyc methods at the composite rings run from
# test_torch_cyc_general.py: the slowest comparisons, in a short file
POW2_RINGS, GENERAL_RINGS = RINGS[:2], RINGS[2:]
SUBS = {16: 8, 64: 16, 36: 12, 72: 36, 90: 30}  # a proper subring of each


def _qs(m):
    return tuple(nt.ntt_primes(m, 30, 2))


def _ctxs(m, qs=None):
    qs = _qs(m) if qs is None else qs
    return rg.ring_context(m, qs), jrg.ring_context(m, qs)


def _x(m, seed, batch=(2,)):
    """(*batch, nrns, n) u32 residues uniform over each channel."""
    ctx = rg.ring_context(m, _qs(m))
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, q, (*batch, ctx.n)) for q in ctx.basis.qs],
                    axis=-2).astype(np.uint32)


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int32))


def _eq(got, want):
    got, want = (x.data if isinstance(x, (Cyc, JCyc)) else x for x in (got, want))
    got, want = (x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x) for x in (got, want))
    np.testing.assert_array_equal(got.astype(np.int64), want.astype(np.int64))


def _pair(ctx, jctx, rep, a):
    """The same ring element in both packages."""
    return (convert.cyc_from_numpy(ctx, rep, a, "cpu"),
            JCyc(jctx, JRep(rep), jnp.asarray(a)))


@pytest.mark.parametrize("m", POW2_RINGS)
def test_ring_transforms_match_jax(m):
    check_ring_transforms(m)


def check_ring_transforms(m):
    """crt / crt_inv / l / l_inv, g multiplication and division in all three
    bases, the pointwise ops, the constructors, the lifts and the norm."""
    ctx, jctx = _ctxs(m)
    x, y = _x(m, 1), _x(m, 2)
    tx, jx, ty = _t(x), jnp.asarray(x), _t(y)
    for name in ("crt", "crt_inv", "l", "l_inv", "mul_g_pow", "mul_g_dec", "mul_g_crt",
                 "div_g_pow", "div_g_dec", "div_g_crt", "neg"):
        _eq(getattr(rg, name)(ctx, tx), getattr(jrg, name)(jctx, jx))
    for name in ("add", "sub", "mul_pointwise"):
        _eq(getattr(rg, name)(ctx, tx, ty), getattr(jrg, name)(jctx, jx, jnp.asarray(y)))
    _eq(rg.mul_scalar_int(ctx, tx, -12345), jrg.mul_scalar_int(jctx, jx, -12345))
    _eq(rg.scalar_pow(ctx, -7, "cpu"), jrg.scalar_pow(jctx, -7))
    _eq(rg.scalar_pow(ctx, np.array([3, 4]), "cpu"), jrg.scalar_pow(jctx, np.array([3, 4])))
    _eq(rg.zero(ctx, (3,), "cpu"), jrg.zero(jctx, (3,)))
    _eq(rg.crt_inv(ctx, rg.crt(ctx, tx)), x)
    _eq(rg.l_inv(ctx, rg.l(ctx, tx)), x)
    np.testing.assert_array_equal(rg.lift_centered_host(ctx, tx), jrg.lift_centered_host(jctx, jx))
    small = np.stack([np.mod(np.arange(ctx.n) % 7 - 3, q) for q in ctx.basis.qs]).astype(np.uint32)
    np.testing.assert_array_equal(rg.gsq_norm_dec_host(ctx, _t(small)),
                                  jrg.gsq_norm_dec_host(jctx, jnp.asarray(small)))
    np.testing.assert_array_equal(rg.gsq_norm_dec_host(ctx, tx), jrg.gsq_norm_dec_host(jctx, jx))
    assert ctx.nrns == jctx.nrns and ctx.has_crt()
    assert ctx.child(SUBS[m]) == rg.ring_context(SUBS[m], ctx.basis.qs)


@pytest.mark.parametrize("m", RINGS)
def test_subring_ops_and_tables_match_jax(m):
    """embed / twace in the powerful and CRT bases, the relative
    coefficients and basis positions, and the ops.general tables behind
    them; twace o embed is the identity."""
    ms = SUBS[m]
    qs = _qs(m)
    (sup, jsup), (sub, jsub) = _ctxs(m, qs), _ctxs(ms, qs)
    x, xs = _x(m, 3), _x(m, 4)[..., :sub.n]
    xs = np.stack([xs[..., i, :] % q for i, q in enumerate(qs)], axis=-2).astype(np.uint32)
    tx, jx, txs, jxs = _t(x), jnp.asarray(x), _t(xs), jnp.asarray(xs)
    _eq(rg.embed_pow(sub, sup, txs), jrg.embed_pow(jsub, jsup, jxs))
    _eq(rg.embed_dec(sub, sup, txs), jrg.embed_dec(jsub, jsup, jxs))
    _eq(rg.embed_crt(sub, sup, txs), jrg.embed_crt(jsub, jsup, jxs))
    _eq(rg.twace_pow(sup, sub, tx), jrg.twace_pow(jsup, jsub, jx))
    _eq(rg.twace_crt(sup, sub, tx), jrg.twace_crt(jsup, jsub, jx))
    _eq(rg.coeffs_pow(sup, sub, tx), jrg.coeffs_pow(jsup, jsub, jx))
    np.testing.assert_array_equal(rg.pow_basis(sup, sub), jrg.pow_basis(jsup, jsub))
    _eq(rg.twace_pow(sup, sub, rg.embed_pow(sub, sup, txs)), xs)
    _eq(rg.twace_crt(sup, sub, rg.embed_crt(sub, sup, txs)), xs)
    q = qs[0]
    np.testing.assert_array_equal(gen.crt_embed_table(ms, m, q), jgen.crt_embed_table(ms, m, q))
    for a, b in zip(gen.twace_crt_twists(ms, m, q), jgen.twace_crt_twists(ms, m, q)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(gen._g_crt_vec(m, q), jgen._g_crt_vec(m, q))
    for pp in rg.fact(m).pps:
        if pp.p != 2:
            for a, b in zip(gen._g_matrices(pp.p, pp.e, q), jgen._g_matrices(pp.p, pp.e, q)):
                np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(gen.gram_g_dec(m), jgen.gram_g_dec(m))
    plan, jplan = gen.general_plan(m, q), jgen.general_plan(m, q)
    for name in ("crt", "crt_inv", "l", "l_inv", "mul_g_pow", "div_g_pow", "mul_g_dec",
                 "div_g_dec", "mul_g_crt", "div_g_crt"):
        _eq(getattr(gen, name)(plan, tx[..., 0, :]), getattr(jgen, name)(jplan, jx[..., 0, :]))
    _eq(gen.coeffs_rel(ms, m, tx), jgen.coeffs_rel(ms, m, jx))


@pytest.mark.parametrize("m", POW2_RINGS)
def test_cyc_methods_match_jax(m):
    check_cyc_methods(m)


def check_cyc_methods(m):
    """Every Cyc method on the same element in both packages: the
    conversions, + - * (Cyc, int), the g ops per basis, lifts, the exact
    rescale in both bases, embed / twace / coeffs / rel_pow_basis, the
    Galois automorphisms, gSqNorm and equality."""
    ms = SUBS[m]
    qs = _qs(m)
    ctx, jctx = _ctxs(m, qs)
    sub, jsub = _ctxs(ms, qs)
    x, y = _x(m, 5), _x(m, 6)
    for rx, ry in (("pow", "crt"), ("dec", "pow"), ("crt", "dec")):
        a, ja = _pair(ctx, jctx, rx, x)
        b, jb = _pair(ctx, jctx, ry, y)
        for fn in (lambda u, v: u + v, lambda u, v: u - v, lambda u, v: u * v,
                   lambda u, v: -u, lambda u, v: u + 5, lambda u, v: u - 9, lambda u, v: u * -3,
                   lambda u, v: u.to_pow(), lambda u, v: u.to_dec(), lambda u, v: u.to_crt(),
                   lambda u, v: u.mul_g(), lambda u, v: u.div_g(), lambda u, v: u.galois(7),
                   lambda u, v: u.rescale_drop_last(), lambda u, v: u.rescale_drop_last(Rep.DEC)
                   if isinstance(u, Cyc) else u.rescale_drop_last(JRep.DEC),
                   lambda u, v: u.twace(sub if isinstance(u, Cyc) else jsub)):
            got, want = fn(a, b), fn(ja, jb)
            assert got.rep.value == want.rep.value and got.ctx.m == want.ctx.m
            assert got.ctx.basis.qs == want.ctx.basis.qs
            _eq(got, want)
        for r, jr in ((Rep.POW, JRep.POW), (Rep.DEC, JRep.DEC)):
            np.testing.assert_array_equal(a.lift_ints(r), ja.lift_ints(jr))
            for c, jc in zip(a.coeffs(sub, r), ja.coeffs(jsub, jr)):
                assert c.rep.value == jc.rep.value
                _eq(c, jc)
        np.testing.assert_array_equal(a.gsq_norm(), ja.gsq_norm())
        assert a == Cyc(a.ctx, a.rep, a.data.clone()) and (a == b) == (ja == jb)
        e, je = _pair(sub, jsub, rx, x[..., :sub.n] % min(qs))
        _eq(e.embed(ctx), je.embed(jctx))
    for c, jc in zip(Cyc.rel_pow_basis(ctx, sub, "cpu"), JCyc.rel_pow_basis(jctx, jsub)):
        _eq(c, jc)
    ints = np.arange(ctx.n, dtype=np.int64) * 1_000_003 - 77
    for rep in ("pow", "dec", "crt"):
        _eq(Cyc.from_ints(ctx, ints, Rep(rep), "cpu"), JCyc.from_ints(jctx, ints, JRep(rep)))
    _eq(Cyc.scalar(ctx, 11, "cpu"), JCyc.scalar(jctx, 11))
    _eq(Cyc.zero(ctx, (2,), "cpu"), JCyc.zero(jctx, (2,)))
    if ctx.fm.is_pow2():  # the reference's reduce_to tags decoding coefficients POW
        c2, jc2 = _ctxs(m, (qs[1],))
        a, ja = _pair(ctx, jctx, "dec", x)
        np.testing.assert_array_equal(a.reduce_to(c2).lift_ints(), ja.reduce_to(jc2).lift_ints())


@pytest.mark.parametrize("m,mod", [(16, 256), (36, 16)])
def test_mul_e_route_matches_jax(m, mod):
    """The exact product over a modulus with no CRT basis (2^k), through an
    auxiliary chain: equal to the reference's and to the schoolbook
    product at 2-power m."""
    ctx, jctx = _ctxs(m, (mod,))
    assert not ctx.has_crt()
    rng = np.random.default_rng(m)
    a, b = (rng.integers(0, mod, (1, ctx.n)).astype(np.uint32) for _ in range(2))
    got = Cyc.from_pow(ctx, a, "cpu") * Cyc.from_pow(ctx, b, "cpu")
    want = JCyc.from_pow(jctx, a) * JCyc.from_pow(jctx, b)
    assert got.rep is Rep.POW
    _eq(got, want)
    if ctx.fm.is_pow2():
        from lol_tpu_torch.ops.ntt import np_negacyclic_mul_schoolbook
        np.testing.assert_array_equal(got.data[0].numpy(),
                                      np_negacyclic_mul_schoolbook(a[0], b[0], mod))
    _eq(Cyc.zero(ctx, device="cpu") * Cyc.from_pow(ctx, a, "cpu"), np.zeros((1, ctx.n)))


def test_numtheory_zmstar_crtset_additions():
    for n in (1, 12, 360, 2 ** 10, 97 * 3):
        assert nt.radical(n) == jnt.radical(n)
        assert nt.divides(4, n) == jnt.divides(4, n)
    qs = [12289, 7681, 257]
    rs = [5, 100, 3]
    assert nt.crt_reconstruct(rs, qs) == jnt.crt_reconstruct(rs, qs)
    for m in (1, 2, 12, 36, 64):
        assert zmstar.order(m) == jzm.order(m)
        np.testing.assert_array_equal(zmstar.mul_table(m), jzm.mul_table(m))
    for c, jc in zip(crtset.crt_set_cyc(15, 2, 2, "cpu"), j_crt_set_cyc(15, 2, 2)):
        _eq(c, jc)


@pytest.mark.parametrize("spec_name", ["triv", "base", "rns"])
def test_gadgets_match_jax(spec_name):
    """num_digits / gadget_ints / gadget_rns / encode_int, decompose (the
    elementwise forms and the host oracle) and correct_host, over a
    one-prime and a two-prime chain."""
    spec, jspec = {"triv": (gadget.TrivGad(), jgd.TrivGad()),
                   "base": (gadget.BaseBGad(1 << 12), jgd.BaseBGad(1 << 12)),
                   "rns": (gadget.RnsGad(), jgd.RnsGad())}[spec_name]
    for qs in (_qs(64)[:1], _qs(64)):
        basis, jbasis = rg.rns_basis(qs), jrg.rns_basis(qs)
        assert gadget.num_digits(spec, basis) == jgd.num_digits(jspec, jbasis)
        assert gadget.gadget_ints(spec, basis) == jgd.gadget_ints(jspec, jbasis)
        np.testing.assert_array_equal(gadget.gadget_rns(spec, basis), jgd.gadget_rns(jspec, jbasis))
        assert gadget.encode_int(spec, basis, -5) == jgd.encode_int(jspec, jbasis, -5)
        x = _x(64, 7)[..., :len(qs), :]
        x = np.stack([x[..., i, :] % q for i, q in enumerate(qs)], axis=-2).astype(np.uint32)
        _eq(gadget.decompose(spec, basis, _t(x)), jgd.decompose(jspec, jbasis, jnp.asarray(x)))
        np.testing.assert_array_equal(gadget.decompose_host(spec, basis, x),
                                      jgd.decompose_host(jspec, jbasis, x))
        # noisy = x g + e with small e: correct_host recovers x and e
        g = gadget.gadget_ints(spec, basis)
        rng = np.random.default_rng(len(qs))
        xs = rng.integers(0, basis.modulus % (1 << 62), 8).astype(object)
        e = rng.integers(-2, 3, (len(g), 8)) if not isinstance(spec, gadget.TrivGad) \
            else np.zeros((1, 8), dtype=np.int64)
        noisy = np.stack([np.moveaxis(basis.to_rns(xs * gj + e[j].astype(object)), 0, -2)
                          for j, gj in enumerate(g)])[:, None]  # (ell, 1, nrns, 8)
        got, jwant = gadget.correct_host(spec, basis, noisy), jgd.correct_host(jspec, jbasis, noisy)
        for u, v in zip(got, jwant):
            np.testing.assert_array_equal(np.asarray(u, dtype=object), np.asarray(v, dtype=object))


def test_sampling_rest():
    """uniform (CRT-tagged where the ring has a CRT basis, POW where not),
    gaussian_cyc, error_coset (congruent to its coset mod p),
    real_gaussians and gaussian_ints_np, all from one `prng` key chain."""
    ctx, _ = _ctxs(64)
    g = prng.KeyChain(0)
    u = sampling.uniform(ctx, g(), (3,), device="cpu")
    assert u.rep is Rep.CRT and u.data.shape == (3, 2, 32)
    assert all(int(u.data[:, i].max()) < q for i, q in enumerate(ctx.basis.qs))
    assert sampling.uniform(rg.ring_context(16, (256,)), g(), device="cpu").rep is Rep.POW
    e = sampling.gaussian_cyc(ctx, g(), 4.0, device="cpu")
    assert e.rep is Rep.DEC and max(abs(int(v)) for v in e.lift_ints()) < 40
    coset = np.arange(32) % 17
    ec = sampling.error_coset(ctx, g(), 4.0, coset, 17, device="cpu")
    np.testing.assert_array_equal(ec.lift_ints() % 17, coset)
    r = sampling.real_gaussians(g(), 9.0, (20000,), "cpu")
    assert r.dtype == torch.float32 and abs(float(r.var()) - 9.0) < 0.5
    gi = sampling.gaussian_ints_np(rg.ring_context(36, _qs(36)), g(), 2.0, "cpu")
    assert gi.shape == (12,) and gi.dtype == np.int64


def test_rrq_complexfield_match_jax():
    x = np.random.default_rng(3).normal(0, 3000.0, 64).astype(np.float32)
    q, q2 = 12289.0, 7681.0
    tx, jx = torch.from_numpy(x), jnp.asarray(x)
    for got, want in ((rrq.reduce(tx, q), jrrq.reduce(jx, q)),
                      (rrq.add(tx, tx, q), jrrq.add(jx, jx, q)),
                      (rrq.neg(tx, q), jrrq.neg(jx, q)),
                      (rrq.rescale(tx, q, q2), jrrq.rescale(jx, q, q2)),
                      (rrq.lift(tx), jrrq.lift(jx))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    _eq(rrq.round_to_zq(tx, 12289), jrrq.round_to_zq(jx, 12289))
    for m in (16, 36, 90):
        n = rg.fact(m).phi
        v = np.arange(n) - n // 2
        y = cf.crt_embed(v, m)
        np.testing.assert_array_equal(y, jcf.crt_embed(v, m))
        np.testing.assert_array_equal(cf.crt_embed_inv(y, m), jcf.crt_embed_inv(y, m))
        np.testing.assert_array_equal(cf.round_complex(cf.crt_embed_inv(y, m)), v)
        assert cf._canonical_units_c(m) == jcf._canonical_units_c(m)
    with pytest.raises(ValueError, match="imaginary"):
        cf.round_complex(np.array([1 + 1j]))


@pytest.mark.parametrize("m", [64, 36])
def test_rlwe_matches_jax(m):
    """A port sample carried into the reference: the error terms, the
    gSqNorm, validity against the derived bound, RLWR's recomputation,
    and the bound itself agree; a continuous sample's b is a s plus a
    small real error."""
    ctx, jctx = _ctxs(m)
    g = prng.KeyChain(m)
    s = Cyc.from_ints(ctx, np.arange(ctx.n) % 3 - 1, rep=Rep.DEC, device="cpu")
    js = JCyc.from_ints(jctx, np.arange(ctx.n) % 3 - 1, rep=JRep.DEC)
    samp = rlwe.sample_discrete(ctx, s, 2.0, g())
    jsamp = jrlwe.RLWESample(*(JCyc(jctx, JRep(c.rep.value), jnp.asarray(c.data.numpy().astype(np.uint32)))
                               for c in (samp.a, samp.b)))
    np.testing.assert_array_equal(rlwe.error_term(s, samp), jrlwe.error_term(js, jsamp))
    assert rlwe.gsq_norm_error(s, samp) == jrlwe.gsq_norm_error(js, jsamp)
    bound = rlwe.gaussian_quad_bound(ctx, 2.0)
    assert bound == jrlwe.gaussian_quad_bound(jctx, 2.0)
    assert rlwe.gaussian_quad_bound(ctx, 2.0, "id", rounded=False) == \
        jrlwe.gaussian_quad_bound(jctx, 2.0, "id", rounded=False)
    assert rlwe.valid_instance(s, samp, bound) and jrlwe.valid_instance(js, jsamp, bound)
    a, b = rlwe.sample_continuous(ctx, s, 0.25, g())
    lifted = (a * s).to_dec().lift_ints().astype(np.float64)
    assert b.dtype == np.float64 and np.abs(b - lifted).max() < 4.0
    c1, jc1 = _ctxs(m, (_qs(m)[0],))
    c2, jc2 = _ctxs(m, (257,)) if m == 64 else _ctxs(m, (37,))
    s1 = Cyc.from_ints(c1, np.arange(ctx.n) % 3 - 1, device="cpu")
    r = rlwe.sample_rlwr(c1, c2, s1, g())
    ja = JCyc(jc1, JRep(r.a.rep.value), jnp.asarray(r.a.data.numpy().astype(np.uint32)))
    js1 = JCyc.from_ints(jc1, np.arange(ctx.n) % 3 - 1)
    _eq(rlwe.sample_rlwr_recompute(c1, c2, r.a, s1), jrlwe.sample_rlwr_recompute(jc1, jc2, ja, js1))
    _eq(r.b, rlwe.sample_rlwr_recompute(c1, c2, r.a, s1))
