"""The port's general-m rings against the JAX package.

`lol_tpu_torch.factored`, `ops.general` (plans, the coefficient-major
CRT and L with the digit prologue, their numpy mirrors, `matvec_mod`,
the index tables, the sampler's mixing factors) and the batched pipeline
at composite m: the JAX package makes the keys, hints and ciphertexts
(m = 72 = 2^3 3^2 and 90 = 2 3^2 5, three 30-bit primes, B = 3; MSD at
m = 36; the tunnel 72 -> 36), they are carried across through
`lol_tpu_torch.convert`, and every output must equal
`lol_tpu.she_batched.BatchedBGV(params, use_pallas=False)`'s bit for bit
(the noise budget, float32, within 1e-4).  The JAX builders run under
`jax.disable_jit()`, which compiles each primitive once per shape and
beats compiling every builder.
"""

from functools import reduce

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lol_tpu import factored as jfactored
from lol_tpu import linear as jlinear
from lol_tpu import she as jshe
from lol_tpu.cyc import Cyc as JCyc, Rep as JRep
from lol_tpu.ops import general as jgen
from lol_tpu.ring import ring_context as j_ring_context
from lol_tpu.she_batched import BatchedBGV as JBatchedBGV
from lol_tpu_torch import prng
from lol_tpu_torch import convert, factored, linear, numtheory as nt, sampling, she
from lol_tpu_torch.ops import general as gen
from lol_tpu_torch.ops import ntt
from lol_tpu_torch.ring import ring_context
from lol_tpu_torch.she_batched import BatchedBGV

torch.set_num_threads(2)

MS = [3, 8, 9, 12, 21, 36, 45, 72, 90]
TOWERS = [(4, 8), (3, 9), (3, 21), (7, 21), (12, 24), (12, 36), (1, 3), (5, 45), (9, 45),
          (36, 72), (18, 90), (1, 72), (8, 72), (9216, 18432)]
B = 3


def _q(m):
    return nt.ntt_primes(m, 30, 1)[0] if m & (m - 1) else nt.ntt_primes(2 * m, 30, 1)[0]


def _u32(t: torch.Tensor):
    return np.asarray(t.numpy()).astype(np.uint32)


@pytest.mark.parametrize("m", MS + [1, 2, 18432])
def test_factored_matches_reference(m):
    mine, ref = factored.fact(m), jfactored.fact(m)
    assert [(pp.p, pp.e, pp.phi, pp.value) for pp in mine.pps] == [
        (pp.p, pp.e, pp.phi, pp.value) for pp in ref.pps]
    assert (mine.phi, mine.phi_shape, mine.is_pow2()) == (ref.phi, ref.phi_shape, ref.is_pow2())
    assert all(mine.divides(factored.fact(k)) == ref.divides(jfactored.fact(k))
               for k in (m, 2 * m, 3 * m + 1, 72))


@pytest.mark.parametrize("m", [4, 8, 32, 256, 12, 72, 9216, 18432])
def test_axis_plan_is_its_ntt_plan(m):
    """The 2^e axis's root omega^(m / 2^e) is the canonical 2^e-th root, so
    the axis runs ntt_plan(2^(e-1), q) itself (one plan and one set of
    device tables per (n2, q)), with the JAX package's axis plan's tables;
    at m = 2^e that is the ring's own plan."""
    q = _q(m)
    e = (m & -m).bit_length() - 1
    ax = gen.axis_plan(2, e, q, m).ntt2
    jax_ax = jgen.axis_plan(2, e, q, m).ntt2
    assert ax is ntt.ntt_plan(1 << (e - 1), q)
    assert ax.psi == pow(nt.principal_root_of_unity(m, q), m >> e, q) == jax_ax.psi
    for name in ("psi_rev", "psi_rev_sh", "ipsi_rev", "ipsi_rev_sh"):
        np.testing.assert_array_equal(getattr(ax, name), getattr(jax_ax, name))
    assert (ax.n_inv, ax.n_inv_sh) == (jax_ax.n_inv, jax_ax.n_inv_sh)


@pytest.mark.parametrize("m", MS)
def test_transforms_match_reference(m):
    """crt_cm / l_cm (coefficient-major, (n, B)) and np_crt / np_l
    (over the last axis) == the JAX package's numpy mirrors, both ways;
    the plans' dense matrices and slot units equal its plans'."""
    q = _q(m)
    plan, jplan = gen.general_plan(m, q), jgen.general_plan(m, q)
    for ax, jax_ in zip(plan.axes, jplan.axes):
        np.testing.assert_array_equal(ax.units, jax_.units)
        for name in ("M", "Minv"):
            assert (getattr(ax, name) is None) == (getattr(jax_, name) is None)
            if getattr(ax, name) is not None:
                np.testing.assert_array_equal(getattr(ax, name), getattr(jax_, name))
    n = plan.fm.phi
    x = np.random.default_rng(m).integers(0, q, (n, B)).astype(np.uint32)
    x[0, 0], x[-1, -1] = q - 1, 0
    xt = torch.from_numpy(x.astype(np.int32))
    for inverse in (False, True):
        want_crt = jgen.np_crt(jplan, x.T, inverse).T
        want_l = jgen.np_l(jplan, x.T, inverse).T
        np.testing.assert_array_equal(_u32(gen.crt_cm(plan, xt, inverse)), want_crt)
        np.testing.assert_array_equal(_u32(gen.l_cm(plan, xt, inverse)), want_l)
        np.testing.assert_array_equal(gen.np_crt(plan, x.T, inverse), want_crt.T)
        np.testing.assert_array_equal(gen.np_l(plan, x.T, inverse), want_l.T)
    back = gen.crt_cm(plan, gen.crt_cm(plan, xt), inverse=True)
    assert torch.equal(back, xt)


@pytest.mark.parametrize("m", [9, 36, 90])
def test_crt_cm_prologue_matches_reference(m):
    """The digit prologue: inside the 2-axis kernel at m = 36, by
    `redigit` at odd m = 9 and at m = 90 (its 2-axis has phi = 1), from a
    source modulus above and below q: == the JAX package's crt_cm at
    m = 9, and == its np_crt of the centered re-expansion (what its
    prologue computes) at all three."""
    q = _q(m)
    plan, jplan = gen.general_plan(m, q), jgen.general_plan(m, q)
    n = plan.fm.phi
    for src in (nt.ntt_primes(m if m % 2 else 2 * m, 30, 2)[1], 12289):
        x = np.random.default_rng(src).integers(0, src, (n, B)).astype(np.uint32)
        x[0, 0], x[1, 0] = src - 1, (src + 1) // 2
        got = _u32(gen.crt_cm(plan, torch.from_numpy(x.astype(np.int32)), pre_digit_q=src))
        centered = np.where(x >= (src + 1) // 2, x.astype(np.int64) - src, x) % q
        np.testing.assert_array_equal(got, jgen.np_crt(jplan, centered.T.astype(np.uint32)).T)
        if m == 9:
            with jax.disable_jit():
                want = np.asarray(jgen.crt_cm(jplan, jnp.asarray(x), pre_digit_q=src))
            np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="forward-only"):
        gen.crt_cm(plan, torch.zeros((n, 1), dtype=torch.int32), inverse=True, pre_digit_q=src)


@pytest.mark.parametrize("m_sub,m_sup", TOWERS)
def test_index_tables_match_reference(m_sub, m_sup):
    for name in ("embed_pow_table", "rel_coeff_table", "rel_pow_basis_positions"):
        mine, ref = getattr(gen, name)(m_sub, m_sup), getattr(jgen, name)(m_sub, m_sup)
        assert mine.dtype == ref.dtype and mine.shape == ref.shape
        np.testing.assert_array_equal(mine, ref)


@pytest.mark.parametrize("m_sub,m_sup", [(1, 2), (2, 8), (16, 64), (8, 8), (1024, 32768)])
def test_2power_tables_are_the_closed_forms(m_sub, m_sup):
    """At 2-power indices the general tables are the power basis's closed
    forms: with r = n_sup / n_sub, sub coefficient j sits at j r, and
    relative basis element b_i = x^i gathers i, i + r, i + 2r, ..."""
    n_sub, n_sup = max(m_sub // 2, 1), max(m_sup // 2, 1)
    r = n_sup // n_sub
    np.testing.assert_array_equal(gen.embed_pow_table(m_sub, m_sup), np.arange(n_sub) * r)
    T = np.arange(n_sub)[None, :] * r + np.arange(r)[:, None]
    np.testing.assert_array_equal(gen.rel_coeff_table(m_sub, m_sup), T)
    np.testing.assert_array_equal(gen.rel_pow_basis_positions(m_sub, m_sup), np.arange(r))


@pytest.mark.parametrize("a,b", [(16, 20)])
def test_matvec_mod_matches_both_reference_routes(a, b):
    q = nt.ntt_primes(1 << 12, 30, 1)[0]
    rng = np.random.default_rng(a * b)
    M = rng.integers(0, q, (a, b)).astype(np.uint32)
    x = rng.integers(0, q, (5, 7, b)).astype(np.uint32)
    M[0], x[0, 0] = q - 1, q - 1
    got = gen.matvec_mod(M, torch.from_numpy(x.astype(np.int64)), q)
    for use_mxu in (False, True):  # each route compiled as one program
        want = jax.jit(lambda M_, x_, u=use_mxu: jgen.matvec_mod_jnp(M_, x_, q, use_mxu=u))(
            jnp.asarray(M), jnp.asarray(x))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    mid = gen.matvec_mod(M, torch.from_numpy(np.moveaxis(x, -1, 1).astype(np.int64)), q, axis=1)
    np.testing.assert_array_equal(np.moveaxis(mid.numpy(), 1, -1), got.numpy())


@pytest.mark.parametrize("m", [12, 36, 90, 18432])
def test_dec_mixing_factors_match_reference(m):
    for mine, ref in zip(gen.dec_mixing_factors(m), jgen.dec_mixing_factors(m)):
        np.testing.assert_allclose(mine, ref, rtol=1e-12, atol=1e-12)
    if m < 100:
        E = gen._dec_basis_complex(m)
        np.testing.assert_allclose(reduce(np.kron, gen.dec_mixing_factors(m)),
                                   np.linalg.cholesky(np.linalg.inv((E.conj().T @ E).real)),
                                   rtol=1e-8, atol=1e-10)


def test_gaussian_dec_ints_covariance_at_config3():
    """At m = 18432's factors (2^11 with 3^2) the sampler's covariance is
    var n (kron_i L_i L_i^T) plus the rounding's 1/12: along the 3^2 axis
    var n / 1024 inv(Gram_9) (the 2^11 axis's factor is I / sqrt(1024)),
    none across 2-axis positions; at 2-power m it is iid."""
    m, var, rows = 18432, 16.0, 24
    ctx = ring_context(m, (nt.ntt_primes(m, 30, 1)[0],))
    x = sampling.gaussian_dec_ints(ctx, prng.PRNGKey(3), var, (rows,), "cpu")
    assert x.shape == (rows, 6144) and x.dtype == torch.int64
    v = x.view(rows * 1024, 6).double().numpy()
    L1 = gen.dec_mixing_factors(m)[1]
    want = var * 6 * (L1 @ L1.T) + np.eye(6) / 12
    cov = v.T @ v / len(v)
    np.testing.assert_allclose(cov, want, rtol=0, atol=0.05 * np.abs(want).max())
    pairs = x.view(rows, 1024, 6)[:, ::2].reshape(-1, 6).double()
    nxt = x.view(rows, 1024, 6)[:, 1::2].reshape(-1, 6).double()
    cross = (pairs.T @ nxt / len(pairs)).numpy()
    assert np.abs(cross).max() < 0.05 * np.abs(want).max()
    ctx2 = ring_context(64, (nt.ntt_primes(64, 30, 1)[0],))
    assert torch.equal(sampling.gaussian_dec_ints(ctx2, prng.PRNGKey(4), 2.0, (3,), "cpu"),
                       sampling.gaussian_ints((3, 32), 2.0, prng.PRNGKey(4), "cpu"))


def test_ring_context_at_general_m():
    qs = tuple(nt.ntt_primes(72, 30, 2))
    ctx = ring_context(72, qs)
    assert (ctx.n, ctx.fm.phi_shape) == (24, (4, 6))
    assert [gp.q for gp in ctx.general_plans()] == list(qs)
    with pytest.raises(NotImplementedError, match="general_plans"):
        ctx.ntt_plans()
    assert len(ring_context(64, tuple(nt.ntt_primes(64, 30, 1))).ntt_plans()) == 1


def _hint_np(h):
    return (np.stack([np.asarray(c.data) for c in h.h0]),
            np.stack([np.asarray(c.data) for c in h.h1]))


_STATE = {}


def _state(m, p, full=True):
    """The port's key and ciphertexts at m (three 30-bit primes), the JAX
    package's quad hint from that key, and the JAX package's step on
    those inputs; with full, also its decryptions, error term and noise
    bits."""
    if m in _STATE:
        return _STATE[m]
    qs = tuple(nt.ntt_primes(m, 30, 3))
    params = she.SHEParams(m=m, p=p, qs=qs, var=2.0)
    g, rng = prng.KeyChain(m), np.random.default_rng(m)
    sk = she.gen_sk(params, g(), "cpu")
    bb = BatchedBGV(params, "cpu")
    m1, m2 = she.pt_random(params, rng, (B,), "cpu"), she.pt_random(params, rng, (B,), "cpu")
    enc = bb.build_encrypt(sk)
    c, d = enc(m1, g()), enc(m2, g())
    jp, jp2 = (jshe.SHEParams(m=m, p=p, qs=q_, var=2.0) for q_ in (qs, qs[:-1]))
    jsk = jshe.SK(jp, sk.s_ints.numpy(), 2.0)
    jc, jd = ([jnp.asarray(_u32(t)) for t in x] for x in (c, d))
    jbb = JBatchedBGV(jp, use_pallas=False)
    hint = jbb.gen_ks_quad_hint(jsk, jax.random.PRNGKey(m))  # jitted: threefry runs slowly op by op
    out = dict(params=params, sk=sk, bb=bb, m1=m1.numpy(), m2=m2.numpy(), c=c, d=d, jp=jp,
               jsk=jsk, jbb=jbb, jc=jc, hint=hint,
               hint_port=convert.hint_from_numpy(params, *_hint_np(hint), device="cpu"))
    with jax.disable_jit():
        je = out["je"] = jbb.build_step(hint)(*jc, *jd)
        if full:
            out.update(dec=np.asarray(jbb.build_decrypt(jsk)(*jc)),
                       dec_step=np.asarray(JBatchedBGV(jp2, use_pallas=False).build_decrypt(
                           jshe.SK(jp2, jsk.s_ints, 2.0), f=jbb.step_f(1, 1))(*je)),
                       err=np.asarray(jbb.build_error_term(jsk)(*jc)),
                       bits=np.asarray(jbb.build_noise_bits(jsk)(*jc)))
    _STATE[m] = out
    return out


@pytest.mark.parametrize("m,p", [(72, 5), (90, 7)])
def test_pipeline_matches_reference(m, p):
    """At composite m, on the port's key and ciphertexts and the JAX
    package's hint: the step equals the JAX package's and decrypts to
    pt_mul; at m = 72 also: the port's encryptions decrypt in both
    packages, and the decryption after the step, the error term and the
    noise bits equal the JAX package's.  (m = 90 = 2 3^2 5 puts a p = 5
    dense axis and a phi = 1 2-axis through the step.)"""
    full = m == 72
    st = _state(m, p, full)
    params, sk, bb = st["params"], st["sk"], st["bb"]
    got = bb.build_decrypt(sk)(*st["c"])
    np.testing.assert_array_equal(got.numpy(), st["m1"])
    if full:
        np.testing.assert_array_equal(st["dec"], st["m1"])
    e = bb.build_step(st["hint_port"])(*st["c"], *st["d"])
    for mine, ref in zip(e, st["je"]):
        np.testing.assert_array_equal(_u32(mine), np.asarray(ref))
    p2 = she.SHEParams(m=m, p=p, qs=params.qs[:-1], var=2.0)
    got = BatchedBGV(p2, "cpu").build_decrypt(she.SK(p2, sk.s_ints, 2.0), f=bb.step_f())(*e)
    for b in range(B):
        want = she.pt_mul(params, st["m1"][:, b], st["m2"][:, b])
        np.testing.assert_array_equal(want, jshe.pt_mul(st["jp"], st["m1"][:, b],
                                                        st["m2"][:, b]))
        np.testing.assert_array_equal(got[:, b].numpy(), want)
    if not full:
        return
    np.testing.assert_array_equal(got.numpy(), st["dec_step"])
    np.testing.assert_array_equal(_u32(bb.build_error_term(sk)(*st["c"])), st["err"])
    np.testing.assert_allclose(bb.build_noise_bits(sk)(*st["c"]).numpy(), st["bits"], rtol=0,
                               atol=1e-4)


def test_public_ops_at_general_m_match_reference():
    """add_public (MSD, at (n, 1)) and mul_public (at (n, B)) route their
    plaintexts through L at composite m (m = 72)."""
    st = _state(72, 5)
    bb, jbb = st["bb"], st["jbb"]
    pub = np.random.default_rng(5).integers(0, 5, (bb.ctx.n, B)).astype(np.int32)
    cases = [(lambda b: b.build_add_public(3, "msd"), pub[:, :1]),
             (lambda b: b.build_mul_public(), pub)]
    for make, pb in cases:
        with jax.disable_jit():
            ref = make(jbb)(*st["jc"], jnp.asarray(pb))
        for x, y in zip(make(bb)(*st["c"], torch.from_numpy(pb)), ref):
            np.testing.assert_array_equal(_u32(x), np.asarray(y))


def test_msd_step_at_m36_matches_reference():
    m, p = 36, 5
    qs = tuple(nt.ntt_primes(m, 30, 3))
    params = she.SHEParams(m=m, p=p, qs=qs, var=2.0)
    g, rng = prng.KeyChain(36), np.random.default_rng(36)
    sk = she.gen_sk(params, g(), "cpu")
    bb = BatchedBGV(params, "cpu")
    enc = bb.build_encrypt(sk, "msd")
    m1, m2 = she.pt_random(params, rng, (B,), "cpu"), she.pt_random(params, rng, (B,), "cpu")
    c, d = enc(m1, g()), enc(m2, g())
    np.testing.assert_array_equal(bb.build_decrypt(sk, encoding="msd")(*c).numpy(), m1.numpy())
    jp = jshe.SHEParams(m=m, p=p, qs=qs, var=2.0)
    jsk = jshe.SK(jp, sk.s_ints.numpy(), 2.0)
    jbb = JBatchedBGV(jp, use_pallas=False)
    hint = jbb.gen_ks_quad_hint(jsk, jax.random.PRNGKey(36))
    with jax.disable_jit():
        je = jbb.build_step(hint, encoding="msd")(*(jnp.asarray(_u32(t)) for t in (*c, *d)))
    e = bb.build_step(convert.hint_from_numpy(params, *_hint_np(hint), device="cpu"),
                      encoding="msd")(*c, *d)
    for mine, ref in zip(e, je):
        np.testing.assert_array_equal(_u32(mine), np.asarray(ref))
    p2 = she.SHEParams(m=m, p=p, qs=qs[:-1], var=2.0)
    got = BatchedBGV(p2, "cpu").build_decrypt(she.SK(p2, sk.s_ints, 2.0),
                                              f=bb.step_f(1, 1, "msd"), encoding="msd")(*e)
    for b in range(B):
        np.testing.assert_array_equal(got[:, b].numpy(),
                                      she.pt_mul(params, m1[:, b].numpy(), m2[:, b].numpy()))


def test_tunnel_72_to_36_matches_reference():
    """The fused tunnel 72 -> 36 (E = S, random ys) on the JAX package's
    `gen_tunnel_hint` (its general branch) == the JAX tunnel, on the
    step's output; the port's own hint (its general branch) gives a
    ciphertext the port decrypts to eval_lin of the message, with L on
    either side, and eval_lin == the JAX package's."""
    st = _state(72, 5)
    qs, p = st["params"].qs[:-1], st["params"].p
    p2 = she.SHEParams(m=72, p=p, qs=qs, var=2.0)
    ps = she.SHEParams(m=36, p=p, qs=qs, var=2.0)
    g, rng = prng.KeyChain(7), np.random.default_rng(7)
    sk_s, sk2 = she.gen_sk(ps, g(), "cpu"), she.SK(p2, st["sk"].s_ints, 2.0)
    E = S = j_ring_context(36, qs)
    rng = np.random.default_rng(72)
    ys = [rng.integers(-2, 3, 12) for _ in range(2)]
    jf = jlinear.linear_pow(E, j_ring_context(72, qs), S, [JCyc.from_ints(S, y) for y in ys])
    jp2 = jshe.SHEParams(m=72, p=p, qs=qs, var=2.0)
    jbb2 = JBatchedBGV(jp2, use_pallas=False)
    th = jbb2.gen_tunnel_hint(jf, jshe.SK(jshe.SHEParams(m=36, p=p, qs=qs, var=2.0),
                                          sk_s.s_ints.numpy(), 2.0),
                              jshe.SK(jp2, sk2.s_ints.numpy(), 2.0), jax.random.PRNGKey(6))
    with jax.disable_jit():
        want = jbb2.build_tunnel(th)(*st["je"])
    lin = convert.linear_from_numpy(qs, 36, 72, 36, [y.lift_ints(rep=JRep.POW) for y in jf.ys])
    pth = convert.tunnel_hint_from_numpy(
        ps, lin, *(np.stack([np.stack([np.asarray(x.data) for x in getattr(h, k)])
                             for h in th.hints]) for k in ("h0", "h1")), device="cpu")
    bb2 = BatchedBGV(p2, "cpu")
    e = convert.cts_from_numpy(*(np.asarray(a) for a in st["je"]), device="cpu")
    for mine, ref in zip(bb2.build_tunnel(pth)(*e), want):
        np.testing.assert_array_equal(_u32(mine), np.asarray(ref))
    th2 = bb2.gen_tunnel_hint(lin, sk_s, sk2, g())
    t0, t1 = bb2.build_tunnel(th2)(*bb2.build_encrypt(sk2)(torch.from_numpy(st["m1"]), g()))
    got = bb2.target_pipeline(th2).build_decrypt(sk_s)(t0, t1)
    for b in range(B):
        x_pow = gen.l_host(72, st["m1"][:, b], p)
        want_pow = linear.eval_lin_ints(lin, x_pow, p)
        if b == 0:
            with jax.disable_jit():
                ref_pow = jlinear.eval_lin(jf, JCyc.from_ints(jf.r_ctx, x_pow)).lift_ints(
                    rep=JRep.POW)
            np.testing.assert_array_equal(want_pow, np.asarray(ref_pow) % p)
        np.testing.assert_array_equal(got[:, b].numpy(), gen.l_host(36, want_pow, p, inverse=True))


@pytest.mark.parametrize("m", [36, 45, 90])
def test_ring_mul_sum_and_l_host_match_reference(m):
    """pt_mul (the general ring_mul_sum in the decoding basis) == the JAX
    package's; the powerful-basis product is the same ring product seen
    through L; l_host mod q == the JAX package's np_l."""
    p = 7
    qs = tuple(nt.ntt_primes(m, 30, 1))
    n = factored.fact(m).phi
    rng = np.random.default_rng(m)
    a, b, c, d = rng.integers(0, p, (4, n))
    jp = jshe.SHEParams(m=m, p=p, qs=qs, var=2.0)
    ab = she.pt_mul(she.SHEParams(m=m, p=p, qs=qs), a, b)
    np.testing.assert_array_equal(ab, jshe.pt_mul(jp, a, b))
    dec_sum = (ab + she.pt_mul(she.SHEParams(m=m, p=p, qs=qs), c, d)) % p
    np.testing.assert_array_equal(she.ring_mul_sum([(a, b), (c, d)], p, m), dec_sum)
    L = [gen.l_host(m, v, p) for v in (a, b, c, d)]
    np.testing.assert_array_equal(
        she.ring_mul_sum([(L[0], L[1]), (L[2], L[3])], p, m, basis="pow"),
        gen.l_host(m, dec_sum, p))
    plan = jgen.general_plan(m, qs[0])
    x = rng.integers(0, qs[0], (2, n)).astype(np.uint32)
    for inverse in (False, True):
        np.testing.assert_array_equal(gen.l_host(m, x, qs[0], inverse), jgen.np_l(plan, x, inverse))
    with pytest.raises(ValueError, match="phi"):
        she.ring_mul_sum([(a[:-1], b[:-1])], p, m)
