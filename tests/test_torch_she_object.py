"""The port's object path (`she` over `Cyc`) against the JAX package, bit
for bit, and against the port's batched path.

The JAX package makes the keys, ciphertexts and hints at m = 64 over three
30-bit primes (= 1 mod 128, so the ring embeds into m = 128), p = 257,
LSD and MSD, and p = 9 for the rounding; they are carried across with
`convert` and every object operation must give the JAX package's
ciphertext exactly (the components, their bases, f and the encoding).
The port's own keygen, encryption and hints decrypt to their plaintexts;
one `KSHint` / `TunnelHint` serves the object and the batched path; the
object path equals the batched one (the step, the tunnel, HomomPRF
32 -> 2); and the README's Quick start at m = 8192 agrees between the
packages.
"""

from dataclasses import replace

import jax
import numpy as np
import pytest
import torch

from lol_tpu import gadget as jgd
from lol_tpu import linear as jlinear
from lol_tpu import she as jshe
from lol_tpu.cyc import Cyc as JCyc
from lol_tpu.ring import ring_context as j_ring_context
from lol_tpu_torch import convert, gadget as gd, linear, numtheory as nt, prf, she
from lol_tpu_torch.cyc import Cyc, Rep
from lol_tpu_torch.ring import ring_context
from lol_tpu_torch.she_batched import BatchedBGV

torch.set_num_threads(2)

M, MS = 64, 32
QS = tuple(nt.ntt_primes(128, 30, 3))
SPECIAL = tuple(nt.ntt_primes(128, 30, 5)[3:])
BASE = 1 << 16


def _params(jp):
    return she.SHEParams(m=jp.m, p=jp.p, qs=tuple(jp.qs), var=jp.var)


def _ct(jct):
    """A JAX ciphertext carried across."""
    return convert.ct_from_numpy(_params(jct.params), [(c.rep.value, np.asarray(c.data))
                                                      for c in jct.cs],
                                 jct.f, jct.encoding, device="cpu")


def _hint(jh, spec=gd.RnsGad()):
    return convert.hint_from_numpy(_params(jh.params), np.stack([np.asarray(c.data) for c in jh.h0]),
                                   np.stack([np.asarray(c.data) for c in jh.h1]), "cpu", spec)


def _hint_ext(jh):
    return convert.hint_ext_from_numpy(
        _params(jh.params), jh.ctx_ext.basis.qs, jh.n_special,
        np.stack([np.asarray(c.data) for c in jh.h0]),
        np.stack([np.asarray(c.data) for c in jh.h1]), "cpu")


def _same(ct, jct):
    assert (ct.params.m, ct.params.p, ct.params.qs) == (jct.params.m, jct.params.p,
                                                        tuple(jct.params.qs))
    assert ct.ctx.m == jct.ctx.m and ct.ctx.basis.qs == jct.ctx.basis.qs
    assert (ct.f, ct.encoding, len(ct.cs)) == (jct.f, jct.encoding, len(jct.cs))
    for c, jc in zip(ct.cs, jct.cs):
        assert c.rep.value == jc.rep.value
        np.testing.assert_array_equal(c.data.numpy().astype(np.int64),
                                      np.asarray(jc.data).astype(np.int64))


@pytest.fixture(scope="module")
def st():
    """The JAX package's keys, ciphertexts and hints."""
    rng = np.random.default_rng(0)
    k = iter(jax.random.split(jax.random.PRNGKey(0), 20))
    jp = jshe.SHEParams(m=M, p=257, qs=QS, var=2.0)
    jsk = jshe.gen_sk(jp, next(k))
    jsk2 = jshe.gen_sk(jp, next(k))
    m1, m2 = jshe.pt_random(jp, rng), jshe.pt_random(jp, rng)
    out = dict(jp=jp, jsk=jsk, jsk2=jsk2, m1=m1, m2=m2,
               a=jshe.encrypt(jsk, m1, next(k)), b=jshe.encrypt(jsk, m2, next(k)),
               a2=jshe.encrypt(jsk2, m1, next(k)),
               msd=jshe.encrypt_msd(jsk, m1, next(k)), msd_b=jshe.encrypt_msd(jsk, m2, next(k)),
               quad=jshe.ks_quad_circ_hint(jsk, jgd.RnsGad(), next(k)),
               quad_b=jshe.ks_quad_circ_hint(jsk, jgd.BaseBGad(BASE), next(k)),
               lin=jshe.ks_linear_hint(jsk, jsk2, jgd.RnsGad(), next(k)),
               gal=jshe.ks_galois_hint(5, jsk, jgd.RnsGad(), next(k)),
               quad_ext=jshe.ks_quad_circ_hint_ext(jsk, jgd.RnsGad(), next(k), SPECIAL),
               lin_ext=jshe.ks_linear_hint_ext(jsk, jsk2, jgd.RnsGad(), next(k), SPECIAL))
    # the tunnel 64 -> 32 (E = S) with images (y0, y1) of the relative basis
    jps = jshe.SHEParams(m=MS, p=257, qs=QS, var=2.0)
    out["jsk_s"] = jshe.gen_sk(jps, next(k))
    S, R = j_ring_context(MS, QS), j_ring_context(M, QS)
    ys = [rng.integers(-2, 3, MS // 2) for _ in range(2)]
    out["ys"] = ys
    jf = jlinear.linear_pow(S, R, S, [JCyc.from_ints(S, y) for y in ys])
    out["jth"] = jshe.tunnel_hint(jf, out["jsk_s"], jsk, jgd.RnsGad(), next(k))
    # the rounding Z_9 -> Z_3 over the same chain
    jp9 = jshe.SHEParams(m=M, p=9, qs=QS, var=2.0)
    jsk9 = jshe.SK(jp9, jsk.s_ints, jsk.var)
    msg9 = np.zeros(M // 2, dtype=np.int64)
    msg9[0] = 5
    out.update(jsk9=jsk9, c9=jshe.encrypt(jsk9, msg9, next(k)),
               rh9=jshe.pt_round_hints(jsk9, jgd.RnsGad(), next(k)))
    return out


def _port(st):
    return (_params(st["jp"]), convert.sk_from_numpy(_params(st["jp"]), st["jsk"].s_ints),
            _ct(st["a"]), _ct(st["b"]))


def test_decrypt_error_and_noise_match_jax(st):
    """decrypt (LSD and MSD), decrypt_unrestricted, error_term and its
    unrestricted form, noise_bits (within 1e-4) and absorb_g_factors."""
    params, sk, a, _ = _port(st)
    jsk = st["jsk"]
    for key in ("a", "msd"):
        ct, jct = _ct(st[key]), st[key]
        np.testing.assert_array_equal(she.decrypt(sk, ct), jshe.decrypt(jsk, jct))
        np.testing.assert_array_equal(she.decrypt_unrestricted(sk, ct), st["m1"])
        np.testing.assert_array_equal(she.error_term(sk, ct), jshe.error_term(jsk, jct))
        np.testing.assert_array_equal(she.error_term_unrestricted(sk, ct),
                                      jshe.error_term_unrestricted(jsk, jct))
    assert abs(she.noise_bits(sk, a) - jshe.noise_bits(jsk, st["a"])) < 1e-4
    assert she.absorb_g_factors(a) is a
    cs, f, encoding = convert.ct_to_numpy(a)  # the round trip through numpy
    _same(convert.ct_from_numpy(params, cs, f, encoding, "cpu"), st["a"])
    np.testing.assert_array_equal(she.pt_add(params, st["m1"], st["m2"]),
                                  jshe.pt_add(st["jp"], st["m1"], st["m2"]))


def test_arithmetic_matches_jax(st):
    """ct_add / ct_sub (equal and unequal scales), ct_mul (1 x 1 on the
    ct_mul kernel's path, 2 x 1 on the Hadamards, MSD x LSD, MSD x MSD),
    the encoding switches and the public ops, LSD and MSD."""
    _, sk, a, b = _port(st)
    ja, jb, jm, jmb = st["a"], st["b"], st["msd"], st["msd_b"]
    m, mb = _ct(jm), _ct(jmb)
    a3, ja3 = replace(a, f=3), replace(ja, f=3)
    for got, want in ((she.ct_add(a, b), jshe.ct_add(ja, jb)),
                      (she.ct_sub(a, b), jshe.ct_sub(ja, jb)),
                      (she.ct_add(a3, b), jshe.ct_add(ja3, jb)),
                      (she.ct_sub(b, a3), jshe.ct_sub(jb, ja3)),
                      (she.ct_add(m, mb), jshe.ct_add(jm, jmb)),
                      (she.ct_mul(a, b), jshe.ct_mul(ja, jb)),
                      (she.ct_mul(she.ct_mul(a, b), a3), jshe.ct_mul(jshe.ct_mul(ja, jb), ja3)),
                      (she.ct_mul(m, b), jshe.ct_mul(jm, jb)),
                      (she.ct_mul(m, mb), jshe.ct_mul(jm, jmb)),
                      (she.ct_add(she.ct_mul(a, b), a), jshe.ct_add(jshe.ct_mul(ja, jb), ja)),
                      (she.to_lsd(m), jshe.to_lsd(jm)), (she.to_msd(a), jshe.to_msd(ja)),
                      (she.to_lsd(a), jshe.to_lsd(ja)), (she.to_msd(m), jshe.to_msd(jm)),
                      (she.add_public(a3, st["m2"]), jshe.add_public(ja3, st["m2"])),
                      (she.add_public(m, st["m2"]), jshe.add_public(jm, st["m2"])),
                      (she.mul_public(a, st["m2"]), jshe.mul_public(ja, st["m2"])),
                      (she.mul_public(m, st["m2"]), jshe.mul_public(jm, st["m2"]))):
        _same(got, want)
    np.testing.assert_array_equal(she.decrypt(sk, she.add_public(m, st["m2"])),
                                  she.pt_add(_params(st["jp"]), st["m1"], st["m2"]))
    with pytest.raises(ValueError, match="encodings"):
        she.ct_add(a, m)


def test_key_switches_match_jax(st):
    """Quadratic (RNS and base-b gadgets), linear, Galois and the two
    extended-modulus key switches on the JAX hints, and their decryptions."""
    params, sk, a, b = _port(st)
    ja, jb = st["a"], st["b"]
    prod, jprod = she.ct_mul(a, b), jshe.ct_mul(ja, jb)
    want = she.pt_mul(params, st["m1"], st["m2"])
    for got, jgot in ((she.key_switch_quad_circ(_hint(st["quad"]), prod),
                       jshe.key_switch_quad_circ(st["quad"], jprod)),
                      (she.key_switch_quad_circ(_hint(st["quad_b"], gd.BaseBGad(BASE)), prod),
                       jshe.key_switch_quad_circ(st["quad_b"], jprod)),
                      (she.key_switch_quad_circ_ext(_hint_ext(st["quad_ext"]), prod),
                       jshe.key_switch_quad_circ_ext(st["quad_ext"], jprod))):
        _same(got, jgot)
        np.testing.assert_array_equal(she.decrypt(sk, got), want)
    a2, ja2 = _ct(st["a2"]), st["a2"]
    for got, jgot in ((she.key_switch_linear(_hint(st["lin"]), a2),
                       jshe.key_switch_linear(st["lin"], ja2)),
                      (she.key_switch_linear_ext(_hint_ext(st["lin_ext"]), a2),
                       jshe.key_switch_linear_ext(st["lin_ext"], ja2))):
        _same(got, jgot)
        np.testing.assert_array_equal(she.decrypt(sk, got), st["m1"])
    got = she.ct_galois(_hint(st["gal"]), 5, a)
    _same(got, jshe.ct_galois(st["gal"], 5, ja))
    np.testing.assert_array_equal(she.decrypt(sk, got), she.galois_ints(M, st["m1"], 5, 257))
    with pytest.raises(ValueError, match="quadratic"):
        she.key_switch_quad_circ(_hint(st["quad"]), a)


def test_modulus_switches_and_rounding_match_jax(st):
    """mod_switch (LSD, MSD), mod_switch_pt (LSD, MSD), div_d, div_2 and
    pt_round (Z_9 -> Z_3 on the JAX rounding hints)."""
    params, sk, a, b = _port(st)
    ja, jm = st["a"], st["msd"]
    m = _ct(jm)
    for got, want in ((she.mod_switch(a), jshe.mod_switch(ja)),
                      (she.mod_switch(m), jshe.mod_switch(jm)),
                      (she.mod_switch(she.mod_switch(a)), jshe.mod_switch(jshe.mod_switch(ja)))):
        _same(got, want)
        sk2 = she.SK(got.params, sk.s_ints, sk.var)
        np.testing.assert_array_equal(she.decrypt(sk2, got), st["m1"])
    c9, jc9 = _ct(st["c9"]), st["c9"]
    for got, want in ((she.mod_switch_pt(c9, 3), jshe.mod_switch_pt(jc9, 3)),
                      (she.mod_switch_pt(she.to_msd(c9), 3), jshe.mod_switch_pt(jshe.to_msd(jc9), 3)),
                      (she.div_d(c9, 3), jshe.div_d(jc9, 3))):
        _same(got, want)
    c514, jc514 = (replace(x, params=replace(x.params, p=514)) for x in (a, ja))
    _same(she.div_2(c514), jshe.div_2(jc514))
    rh = she.PTRoundHints(tuple(_hint(h) for h in st["rh9"].hints))
    got = she.pt_round(c9, rh)
    _same(got, jshe.pt_round(jc9, st["rh9"]))
    sk_out = she.SK(got.params, sk.s_ints, sk.var)
    assert she.decrypt(sk_out, got)[0] == 2 and not she.decrypt(sk_out, got)[1:].any()  # 5/3
    _same(she.pt_round(she.to_msd(c9), rh), jshe.pt_round(jshe.to_msd(jc9), st["rh9"]))


def test_ring_switching_matches_jax(st):
    """embed_sk / embed_ct (64 -> 128), twace_ct (64 -> 32), and the tunnel
    64 -> 32 on the JAX tunnel hint (the map carried as its images)."""
    params, sk, a, _ = _port(st)
    ja, jsk = st["a"], st["jsk"]
    sk_up = she.embed_sk(sk, 2 * M)
    np.testing.assert_array_equal(sk_up.s_ints.numpy(), jshe.embed_sk(jsk, 2 * M).s_ints)
    up = she.embed_ct(a, 2 * M)
    _same(up, jshe.embed_ct(ja, 2 * M))
    np.testing.assert_array_equal(she.decrypt(sk_up, up)[::2], st["m1"])
    _same(she.twace_ct(up, M), jshe.twace_ct(jshe.embed_ct(ja, 2 * M), M))
    _same(she.twace_ct(a, MS), jshe.twace_ct(ja, MS))
    jth = st["jth"]
    lin = convert.linear_from_numpy(QS, MS, M, MS, st["ys"])
    th = convert.tunnel_hint_from_numpy(
        replace(params, m=MS), lin,
        np.stack([np.stack([np.asarray(c.data) for c in h.h0]) for h in jth.hints]),
        np.stack([np.stack([np.asarray(c.data) for c in h.h1]) for h in jth.hints]), "cpu")
    got = she.tunnel(th, a)
    _same(got, jshe.tunnel(jth, ja))
    sk_s = convert.sk_from_numpy(replace(params, m=MS), st["jsk_s"].s_ints)
    np.testing.assert_array_equal(she.decrypt(sk_s, got),
                                  linear.eval_lin_ints(lin, st["m1"], 257))
    # eval_lin over Cyc == the reference's on the same element
    x = Cyc.from_ints(params.ctx, st["m1"], device="cpu")
    np.testing.assert_array_equal(linear.eval_lin(lin, x).lift_ints(),
                                  jlinear.eval_lin(jth.lin, JCyc.from_ints(ja.ctx, st["m1"])).lift_ints())
    for c, jc in zip(linear.rel_basis_elements(params.ctx, ring_context(MS, QS), "cpu"),
                     jlinear.rel_basis_elements(ja.ctx, j_ring_context(MS, QS))):
        np.testing.assert_array_equal(c.data.numpy(), np.asarray(jc.data).astype(np.int64))


def test_port_keygen_encryption_and_hints_decrypt():
    """The port's own gen_sk, encrypt / encrypt_msd and every hint
    generator, at m = 64 and at m = 36: each decryption == its plaintext."""
    for m, p in ((M, 257), (36, 5)):
        qs = QS if m == M else tuple(nt.ntt_primes(36, 30, 3))
        params = she.SHEParams(m=m, p=p, qs=qs, var=2.0)
        g = torch.Generator().manual_seed(m)
        sk, sk2 = she.gen_sk(params, g), she.gen_sk(params, g)
        n = params.ctx.n
        m1, m2 = (torch.randint(0, p, (n,), generator=g).numpy() for _ in range(2))
        a, b = she.encrypt(sk, m1, g, "cpu"), she.encrypt(sk, m2, g, "cpu")
        assert a.cs[1].rep is Rep.CRT and a.cs[0].data.device.type == "cpu"
        np.testing.assert_array_equal(she.decrypt(sk, she.encrypt_msd(sk, m1, g, "cpu")), m1)
        want = she.pt_mul(params, m1, m2)
        prod = she.ct_mul(a, b)
        for spec in (gd.RnsGad(), gd.BaseBGad(BASE)):
            out = she.mod_switch(she.key_switch_quad_circ(
                she.ks_quad_circ_hint(sk, spec, g, "cpu"), prod))
            np.testing.assert_array_equal(she.decrypt(she.SK(out.params, sk.s_ints, 2.0), out),
                                          want)
        out = she.key_switch_quad_circ_ext(she.ks_quad_circ_hint_ext(
            sk, gd.RnsGad(), g, SPECIAL if m == M else tuple(nt.ntt_primes(36, 30, 4)[3:]),
            "cpu"), prod)
        np.testing.assert_array_equal(she.decrypt(sk, out), want)
        a2 = she.encrypt(sk2, m1, g, "cpu")
        np.testing.assert_array_equal(she.decrypt(sk, she.key_switch_linear(
            she.ks_linear_hint(sk, sk2, gd.RnsGad(), g, "cpu"), a2)), m1)
        k = 5 if m == M else 7
        np.testing.assert_array_equal(she.decrypt(sk, she.ct_galois(
            she.ks_galois_hint(k, sk, gd.RnsGad(), g, "cpu"), k, a)), she.galois_ints(m, m1, k, p))
    # the tunnel 64 -> 32 on the port's hint
    params = she.SHEParams(m=M, p=257, qs=QS, var=2.0)
    g = torch.Generator().manual_seed(1)
    sk, sk_s = she.gen_sk(params, g), she.gen_sk(replace(params, m=MS), g)
    S = ring_context(MS, QS)
    lin = linear.linear_pow(S, params.ctx, S, [np.eye(1, MS // 2, 0)[0], np.eye(1, MS // 2, 3)[0]])
    th = she.tunnel_hint(lin, sk_s, sk, gd.RnsGad(), g, "cpu")
    m1 = torch.randint(0, 257, (M // 2,), generator=g).numpy()
    got = she.decrypt(sk_s, she.tunnel(th, she.encrypt(sk, m1, g, "cpu")))
    np.testing.assert_array_equal(got, linear.eval_lin_ints(lin, m1, 257))


@pytest.mark.parametrize("m", [M, 36])
def test_one_hint_serves_both_paths(m):
    """An object-path hint runs in BatchedBGV.build_step and build_tunnel;
    a gen_ks_quad_hint / gen_tunnel_hint hint runs in
    she.key_switch_quad_circ / she.tunnel; the object path's output equals
    the batched column bit for bit (components in the CRT basis, f)."""
    p = 257 if m == M else 5
    qs = QS if m == M else tuple(nt.ntt_primes(36, 30, 3))
    params = she.SHEParams(m=m, p=p, qs=qs, var=2.0)
    g = torch.Generator().manual_seed(7)
    sk = she.gen_sk(params, g)
    n = params.ctx.n
    msgs = [torch.randint(0, p, (n,), generator=g).numpy() for _ in range(4)]
    cts = [she.encrypt(sk, x, g, "cpu") for x in msgs]
    bb = BatchedBGV(params, "cpu")
    params2 = replace(params, qs=qs[:-1])
    for hint in (she.ks_quad_circ_hint(sk, gd.RnsGad(), g, "cpu"), bb.gen_ks_quad_hint(sk, g)):
        e0, e1 = bb.build_step(hint)(*bb.pack(cts[:2]), *bb.pack(cts[2:]))
        outs = BatchedBGV(params2, "cpu").unpack((e0, e1), f=bb.step_f())
        for col in range(2):
            ref = she.mod_switch(she.key_switch_quad_circ(hint, she.ct_mul(cts[col],
                                                                           cts[2 + col])))
            assert ref.f == outs[col].f
            for c, o in zip(ref.cs, outs[col].cs):
                assert torch.equal(c.to_crt().data, o.data)
            np.testing.assert_array_equal(she.decrypt(she.SK(params2, sk.s_ints, 2.0), outs[col]),
                                          she.pt_mul(params, msgs[col], msgs[2 + col]))
    with pytest.raises(ValueError, match="RNS-gadget hints only"):
        bb.build_step(she.ks_quad_circ_hint(sk, gd.BaseBGad(BASE), g, "cpu"))
    if m != M:
        return
    sk_s = she.gen_sk(replace(params, m=MS), g)
    S = ring_context(MS, qs)
    lin = linear.linear_pow(S, params.ctx, S, [np.eye(1, MS // 2, 0)[0], np.eye(1, MS // 2, 1)[0]])
    for th in (she.tunnel_hint(lin, sk_s, sk, gd.RnsGad(), g, "cpu"),
               bb.gen_tunnel_hint(lin, sk_s, sk, g)):
        e0, e1 = bb.build_tunnel(th)(*bb.pack(cts[:2]))
        for col in range(2):
            ref = she.tunnel(th, cts[col])
            assert torch.equal(ref.cs[0].to_crt().data, e0[..., col])
            assert torch.equal(ref.cs[1].to_crt().data, e1[..., col])


def test_object_homom_prf_equals_batched():
    """HomomPRF 32 -> 16 -> 8 -> 4 -> 2 with the rounding, p = 8, on the
    port's hints: the object path's homom_prf_component of each key
    ciphertext == the batched column, and homom_prf decrypts to the clear
    PRF of every component, which `prf` over Cyc computes as prf_ints does."""
    from lol_tpu_torch import serving

    p, rings = 8, [32, 16, 8, 4, 2]
    qs = tuple(nt.ntt_primes(64, 30, she.pt_round_mults(p) + 5))
    g = torch.Generator().manual_seed(5)
    sks = [she.gen_sk(she.SHEParams(m=r, p=p, qs=qs, var=2.0), g) for r in rings]
    fam = prf.PRFFamily.random(ring_context(32, (p,)), gd.BaseBGad(2), prf.balanced(2), g)
    hints, sk_out = prf.make_eval_hints(fam, sks, rings, rings[1:], g, homomorphic_round=True,
                                        maps="project", device="cpu")
    keys = [torch.randint(0, p, (16,), generator=g).numpy() for _ in range(2)]
    cts = [she.encrypt(sks[0], k, g, "cpu") for k in keys]
    bb = BatchedBGV(sks[0].params, "cpu")
    bits = (1, 0)
    bb_out, f_out, (e0, e1) = serving.batched_homom_prf_component(
        fam, hints, bb, *bb.pack(cts), bits, 0)
    sk_fin = she.SK(bb_out.params, sk_out.s_ints, 2.0)
    for col, key in enumerate(keys):
        ref = prf.homom_prf_component(fam, hints, cts[col], bits, 0)
        assert ref.params.p == 2 and ref.f == f_out and ref.ctx.m == 2
        assert torch.equal(ref.cs[0].to_crt().data, e0[..., col])
        assert torch.equal(ref.cs[1].to_crt().data, e1[..., col])
    outs = prf.homom_prf(fam, hints, cts[0], bits)
    s_cyc = Cyc.from_ints(fam.ctx, keys[0], device="cpu")
    want = prf.prf(fam, s_cyc, bits, 2)
    np.testing.assert_array_equal(want, prf.prf_ints(fam, keys[0], bits, 2))
    assert [int(she.decrypt(sk_fin, o)[0]) for o in outs] == [int(w[0]) for w in want]
    pre = prf.prf_pre_round(fam, s_cyc, bits)
    np.testing.assert_array_equal(np.stack([c.lift_ints(Rep.POW) % p for c in pre]),
                                  prf.prf_pre_round_ints(fam, keys[0], bits))


def test_quickstart_at_8192_matches_jax():
    """The README's Quick start at m = 8192 in both packages: the JAX
    ciphertext and hint carried across, ct_mul -> key_switch_quad_circ ->
    mod_switch agrees bit for bit and decrypts to pt_mul."""
    qs = tuple(nt.ntt_primes(8192, 30, 3))
    jp = jshe.SHEParams(m=8192, p=257, qs=qs)
    jsk = jshe.gen_sk(jp, jax.random.PRNGKey(0))
    m1 = jshe.pt_random(jp, np.random.default_rng(0))
    jct = jshe.encrypt(jsk, m1, jax.random.PRNGKey(1))
    jhint = jshe.ks_quad_circ_hint(jsk, jgd.RnsGad(), jax.random.PRNGKey(2))
    jprod = jshe.mod_switch(jshe.key_switch_quad_circ(jhint, jshe.ct_mul(jct, jct)))
    params = _params(jp)
    sk = convert.sk_from_numpy(params, jsk.s_ints)
    ct = _ct(jct)
    assert (she.decrypt(sk, ct) == m1).all()
    prod = she.mod_switch(she.key_switch_quad_circ(_hint(jhint), she.ct_mul(ct, ct)))
    _same(prod, jprod)
    np.testing.assert_array_equal(she.decrypt(she.SK(prod.params, sk.s_ints, sk.var), prod),
                                  she.pt_mul(params, m1, m1))
