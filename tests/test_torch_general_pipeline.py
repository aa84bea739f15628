"""The port's batched pipeline at composite m against the JAX package's,
bit for bit (the general-m rings' plans, transforms and tables:
test_torch_general.py): the JAX package makes the keys, hints and
ciphertexts (m = 72 = 2^3 3^2 and 90 = 2 3^2 5, three 30-bit primes, B = 3;
MSD at m = 36; the tunnel 72 -> 36), carried across through
`lol_tpu_torch.convert`; every output equals
`lol_tpu.she_batched.BatchedBGV(params, use_pallas=False)`'s (the noise
budget, float32, within 1e-4).  The JAX builders run under
`jax.disable_jit()`."""

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

from test_torch_general import B, _hint_np, _q, _state, _u32

torch.set_num_threads(2)


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
