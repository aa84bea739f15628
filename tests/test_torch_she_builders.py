"""The port's standalone BGV builders against the JAX package, bit for bit.

MSD encryption, decryption and step, the modulus switch, the linear key
switch, ciphertext and public-plaintext add / multiply, the encoding
switches, exact division, the error term and the noise budget, each
against `lol_tpu.she_batched.BatchedBGV(params, use_pallas=False)` at
m = 64, three 30-bit primes, p = 257, B = 4.  The JAX package makes the
keys, hints and ciphertexts; they are carried across as numpy arrays
through `lol_tpu_torch.convert`.  Everything is compared exactly except
the float32 noise budget, which must agree within NOISE_ATOL: XLA may
sum a group's float32 terms and take its log2 with other roundings.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lol_tpu import gadget as jgd
from lol_tpu import she as jshe
from lol_tpu.cyc import Cyc as JCyc, Rep as JRep
from lol_tpu.rns import rns_basis as j_rns_basis
from lol_tpu.she_batched import BatchedBGV as JBatchedBGV
from lol_tpu_torch import prng
from lol_tpu_torch import convert, numtheory as nt, she
from lol_tpu_torch.she_batched import BatchedBGV

torch.set_num_threads(2)

M = 64
N = M // 2
QS = tuple(nt.ntt_primes(M, 30, 3))
P = 257
J_PARAMS = jshe.SHEParams(m=M, p=P, qs=QS, var=2.0)
PARAMS = she.SHEParams(m=M, p=P, qs=QS, var=2.0)
DROPPED = she.SHEParams(m=M, p=P, qs=QS[:-1], var=2.0)
B = 4
NOISE_ATOL = 1e-4  # float32 log2 of magnitudes below 2^90: ~1e-5 apart at most
ENCODINGS = ("lsd", "msd")


def _np(x) -> np.ndarray:
    return np.asarray(x).astype(np.int64)


def _jax(t: torch.Tensor):
    return jnp.asarray(t.numpy().astype(np.uint32))


def _hint_arrays(hint):
    return (np.stack([np.asarray(c.data) for c in hint.h0]),
            np.stack([np.asarray(c.data) for c in hint.h1]))


@pytest.fixture(scope="module")
def st():
    """Keys, hints and batches of LSD and MSD ciphertexts, made by the JAX
    package, and the same state carried across to the port."""
    ks, kn, kh, kl, *kes = jax.random.split(jax.random.PRNGKey(7), 8)
    jbb = JBatchedBGV(J_PARAMS, use_pallas=False)
    jsk, jsk_new = jshe.gen_sk(J_PARAMS, ks), jshe.gen_sk(J_PARAMS, kn)
    rng = np.random.default_rng(7)
    msgs = [rng.integers(0, P, (N, B)).astype(np.int32) for _ in range(2)]
    cts = {}
    for e, enc in enumerate(ENCODINGS):
        f = jbb.build_encrypt(jsk, encoding=enc)
        cts[enc] = [tuple(map(_np, f(jnp.asarray(m), kes[2 * e + k])))
                    for k, m in enumerate(msgs)]
    quad = jbb.gen_ks_quad_hint(jsk, kh)
    lin = jbb.gen_ks_linear_hint(jsk_new, jsk, kl)
    return dict(
        jbb=jbb, jsk=jsk, jsk_new=jsk_new, msgs=msgs, quad=quad, lin=lin,
        jdec={enc: jbb.build_decrypt(jsk, encoding=enc) for enc in ENCODINGS},
        jksl=jbb.build_key_switch_linear(lin),
        bb=BatchedBGV(PARAMS, "cpu"),
        sk=convert.sk_from_numpy(PARAMS, jsk.s_ints),
        sk_new=convert.sk_from_numpy(PARAMS, jsk_new.s_ints),
        cts={enc: [convert.cts_from_numpy(*c, device="cpu") for c in pair]
             for enc, pair in cts.items()},
        quad_hint=convert.hint_from_numpy(PARAMS, *_hint_arrays(quad), device="cpu"),
        lin_hint=convert.hint_from_numpy(PARAMS, *_hint_arrays(lin), device="cpu"),
    )


def _same(got, want):
    """Port output (int32 tensors) == JAX output (u32 arrays), exactly."""
    if isinstance(got, torch.Tensor):
        got, want = (got,), (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy().astype(np.int64), _np(w))


def _args(st, enc, k=0):
    """(port args, JAX args) of ciphertext k of encoding enc."""
    ct = st["cts"][enc][k]
    return ct, tuple(_jax(t) for t in ct)


def test_pos_mod_matches_reference(rng):
    basis = PARAMS.ctx.basis
    r = np.stack([rng.integers(0, q, (N, 3)) for q in QS]).astype(np.uint32)
    r[:, 0, 0] = 0
    r[:, 1, 0] = [(basis.modulus - 1) % q for q in QS]  # x = Q - 1
    got = basis.pos_mod(torch.from_numpy(r.astype(np.int32)), P)
    want = j_rns_basis(QS).pos_mod_jnp(jnp.moveaxis(jnp.asarray(r), 0, 1), P)
    _same(got, want)


@pytest.mark.parametrize("enc", ENCODINGS)
def test_decrypt_matches_jax_pipeline(st, enc):
    mine, theirs = _args(st, enc)
    got = st["bb"].build_decrypt(st["sk"], encoding=enc)(*mine)
    _same(got, st["jdec"][enc](*theirs))
    np.testing.assert_array_equal(got.numpy(), st["msgs"][0])


def test_msd_decrypt_refuses_an_even_modulus():
    params = she.SHEParams(m=M, p=P, qs=(QS[0], 2), var=2.0)
    sk = convert.sk_from_numpy(params, np.zeros(N, dtype=np.int64))
    with pytest.raises(ValueError, match="odd Q"):
        BatchedBGV(params, "cpu").build_decrypt(sk, encoding="msd")


def test_msd_step_matches_jax_pipeline(st):
    (c0, c1), (jc0, jc1) = _args(st, "msd", 0)
    (d0, d1), (jd0, jd1) = _args(st, "msd", 1)
    got = st["bb"].build_step(st["quad_hint"], encoding="msd")(c0, c1, d0, d1)
    _same(got, st["jbb"].build_step(st["quad"], encoding="msd")(jc0, jc1, jd0, jd1))
    f = st["bb"].step_f(1, 1, encoding="msd")
    assert f == st["jbb"].step_f(1, 1, encoding="msd")
    sk2 = she.SK(DROPPED, st["sk"].s_ints, st["sk"].var)
    dec = BatchedBGV(DROPPED, "cpu").build_decrypt(sk2, f=f, encoding="msd")(*got)
    m1, m2 = st["msgs"]
    for b in range(B):
        np.testing.assert_array_equal(dec[:, b].numpy(),
                                      she.pt_mul(PARAMS, m1[:, b], m2[:, b]))


@pytest.mark.parametrize("enc", ENCODINGS)
def test_mod_switch_matches_jax_pipeline(st, enc):
    mine, theirs = _args(st, enc)
    got = st["bb"].build_mod_switch(encoding=enc)(*mine)
    _same(got, st["jbb"].build_mod_switch(encoding=enc)(*theirs))
    f = st["bb"].mod_switch_f(1) if enc == "lsd" else 1
    sk2 = she.SK(DROPPED, st["sk"].s_ints, st["sk"].var)
    dec = BatchedBGV(DROPPED, "cpu").build_decrypt(sk2, f=f, encoding=enc)(*got)
    np.testing.assert_array_equal(dec.numpy(), st["msgs"][0])


@pytest.mark.parametrize("enc", ENCODINGS)
def test_key_switch_linear_matches_jax_pipeline(st, enc):
    mine, theirs = _args(st, enc)
    got = st["bb"].build_key_switch_linear(st["lin_hint"])(*mine)
    _same(got, st["jksl"](*theirs))
    dec = st["bb"].build_decrypt(st["sk_new"], encoding=enc)(*got)
    np.testing.assert_array_equal(dec.numpy(), st["msgs"][0])


@pytest.mark.parametrize("sub", [False, True])
def test_add_with_unequal_scales_matches_jax_pipeline(st, sub):
    f_a, f_b = 1, 3  # u = f_a f_b^-1 mod p != 1: the second operand is scaled
    (c, jc), (d, jd) = _args(st, "lsd", 0), _args(st, "lsd", 1)
    got = st["bb"].build_add(f_a, f_b, sub=sub)(*c, *d)
    _same(got, st["jbb"].build_add(f_a=f_a, f_b=f_b, sub=sub)(*jc, *jd))


@pytest.mark.parametrize("cols", [B, 1])
@pytest.mark.parametrize("enc", ENCODINGS)
def test_add_public_matches_jax_pipeline(st, enc, cols):
    mine, theirs = _args(st, enc)
    pub = np.random.default_rng(cols).integers(0, P, (N, cols)).astype(np.int32)
    got = st["bb"].build_add_public(f=5, encoding=enc)(*mine, torch.from_numpy(pub))
    _same(got, st["jbb"].build_add_public(f=5, encoding=enc)(*theirs, jnp.asarray(pub)))


@pytest.mark.parametrize("cols", [B, 1])
def test_mul_public_matches_jax_pipeline(st, cols):
    mine, theirs = _args(st, "lsd")
    pub = np.random.default_rng(cols).integers(0, P, (N, cols)).astype(np.int32)
    got = st["bb"].build_mul_public()(*mine, torch.from_numpy(pub))
    _same(got, st["jbb"].build_mul_public()(*theirs, jnp.asarray(pub)))


def test_encoding_switches_match_jax_pipeline(st):
    mine, theirs = _args(st, "msd")
    lsd = st["bb"].build_to_lsd()(*mine)
    _same(lsd, st["jbb"].build_to_lsd()(*theirs))
    msd = st["bb"].build_to_msd()(*lsd)
    _same(msd, st["jbb"].build_to_msd()(*(_jax(t) for t in lsd)))
    f = st["bb"].to_msd_f(st["bb"].to_lsd_f(1))
    dec = st["bb"].build_decrypt(st["sk"], f=f, encoding="msd")(*msd)
    np.testing.assert_array_equal(dec.numpy(), st["msgs"][0])


@pytest.mark.parametrize("d", [3, 5])
def test_div_d_matches_jax_pipeline(st, d):
    """At the composite p = 15 (coprime to the chain); the builder scales
    any residues, so the carried ciphertexts serve as its input."""
    mine, theirs = _args(st, "lsd")
    params15 = she.SHEParams(m=M, p=15, qs=QS, var=2.0)
    jbb15 = JBatchedBGV(jshe.SHEParams(m=M, p=15, qs=QS, var=2.0), use_pallas=False)
    _same(BatchedBGV(params15, "cpu").build_div_d(d)(*mine), jbb15.build_div_d(d)(*theirs))
    with pytest.raises(ValueError, match="divide"):
        BatchedBGV(params15, "cpu").build_div_d(7)


def test_div_d_divides_the_plaintext():
    g = prng.KeyChain(3)
    params15 = she.SHEParams(m=M, p=15, qs=QS, var=2.0)
    sk = she.gen_sk(params15, g(), "cpu")
    m = she.pt_random(she.SHEParams(m=M, p=5, qs=QS, var=2.0), np.random.default_rng(3), (B,),
                      "cpu")
    bb = BatchedBGV(params15, "cpu")
    ct = bb.build_div_d(3)(*bb.build_encrypt(sk)(3 * m, g()))
    p5 = she.SHEParams(m=M, p=5, qs=QS, var=2.0)
    got = BatchedBGV(p5, "cpu").build_decrypt(she.SK(p5, sk.s_ints, sk.var),
                                              f=bb.div_d_f(3, 1))(*ct)
    assert torch.equal(got, m)


def test_error_term_and_noise_bits_match_jax_pipeline(st):
    """Fresh ciphertexts and their sums (larger noise) in one batch."""
    (c, _), (d, _) = _args(st, "lsd", 0), _args(st, "lsd", 1)
    s0, s1 = st["bb"].build_add()(*c, *d)
    x0, x1 = torch.cat([c[0], s0], -1), torch.cat([c[1], s1], -1)
    jx = (_jax(x0), _jax(x1))
    _same(st["bb"].build_error_term(st["sk"])(x0, x1),
          st["jbb"].build_error_term(st["jsk"])(*jx))
    got = st["bb"].build_noise_bits(st["sk"])(x0, x1)
    want = np.asarray(st["jbb"].build_noise_bits(st["jsk"])(*jx))
    assert got.dtype == torch.float32 and got.shape == (2 * B,)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=NOISE_ATOL)
    assert bool((got >= 0).all()) and bool((got < np.log2(float(np.prod(QS)))).all())


@pytest.mark.parametrize("f", [1, 2, 100, 256])
def test_scale_factor_helpers_match_jax_pipeline(st, f):
    bb, jbb = st["bb"], st["jbb"]
    for d in (1, 257):
        assert bb.div_d_f(d, f) == jbb.div_d_f(d, f)
    assert bb.to_lsd_f(f) == jbb.to_lsd_f(f)
    assert bb.to_msd_f(f) == jbb.to_msd_f(f)
    assert bb.mod_switch_f(f) == jbb.mod_switch_f(f)
    for enc in ENCODINGS:
        assert bb.step_f(f, 3, encoding=enc) == jbb.step_f(f, 3, encoding=enc)


def test_pack_unpack_round_trip(st):
    bb = st["bb"]
    x = st["cts"]["msd"][0]
    cts = bb.unpack(x, encoding="msd")
    assert len(cts) == B and cts[0].cs[0].data.shape == (len(QS), N)
    assert cts[0].encoding == "msd" and cts[0].cs[0].rep.value == "crt"
    for a, b in zip(bb.pack(cts), x):
        assert torch.equal(a, b)


def test_port_msd_ciphertexts_decrypt_in_jax_package(st):
    g, rng = prng.KeyChain(11), np.random.default_rng(11)
    m = she.pt_random(PARAMS, rng, (B,), "cpu")
    c0, c1 = st["bb"].build_encrypt(st["sk"], encoding="msd")(m, g())
    got = st["jdec"]["msd"](_jax(c0), _jax(c1))
    np.testing.assert_array_equal(np.asarray(got), m.numpy())


def test_port_linear_hint_switches_keys_in_jax_package(st):
    g = prng.KeyChain(12)
    hint = st["bb"].gen_ks_linear_hint(st["sk_new"], st["sk"], g())
    ctx = J_PARAMS.ctx
    jhint = jshe.KSHint(J_PARAMS, ctx, jgd.RnsGad(), *(
        tuple(JCyc(ctx, JRep.CRT, jnp.asarray(h[j].numpy().astype(np.uint32)))
              for j in range(len(QS)))
        for h in (hint.h0, hint.h1)))
    _, theirs = _args(st, "lsd")
    e0, e1 = st["jbb"].build_key_switch_linear(jhint)(*theirs)
    got = st["jbb"].build_decrypt(st["jsk_new"])(e0, e1)
    np.testing.assert_array_equal(np.asarray(got), st["msgs"][0])
    with pytest.raises(ValueError, match="SK params"):
        BatchedBGV(DROPPED, "cpu").gen_ks_linear_hint(st["sk_new"], st["sk"], g())
