"""The port's ring tunneling against the JAX package.

The 2-power index tables (`lol_tpu_torch.ops.general`) equal the JAX
package's; the host `linear.eval_lin` is the E-linear map of its images;
the fused tunnel (`BatchedBGV.build_tunnel`) reproduces
`lol_tpu.she_batched.BatchedBGV(params, use_pallas=False).build_tunnel`
bit for bit on a JAX-made `TunnelHint` carried across through
`lol_tpu_torch.convert`, at (E, R, S) = (16, 64, 32) and (32, 64, 32),
three 30-bit primes, p = 257; and on a hint the port makes, both
tunnels give one ciphertext, which decrypts to `eval_lin` of the message.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lol_tpu import gadget as jgd
from lol_tpu import linear as jlinear
from lol_tpu import she as jshe
from lol_tpu.cyc import Cyc as JCyc, Rep as JRep
from lol_tpu.ops import general as jgen
from lol_tpu.ring import ring_context as j_ring_context
from lol_tpu.she_batched import BatchedBGV as JBatchedBGV
from lol_tpu_torch import prng
from lol_tpu_torch import convert, linear, numtheory as nt, she
from lol_tpu_torch.ops import general as gen
from lol_tpu_torch.ring import ring_context
from lol_tpu_torch.she_batched import BatchedBGV

torch.set_num_threads(2)

QS = tuple(nt.ntt_primes(64, 30, 3))
P = 257
M_R, M_S = 64, 32
B = 3
J_PR, J_PS = (jshe.SHEParams(m=m, p=P, qs=QS, var=2.0) for m in (M_R, M_S))
PR, PS = (she.SHEParams(m=m, p=P, qs=QS, var=2.0) for m in (M_R, M_S))


def _jax_lin(m_e, ys):
    E, R, S = (j_ring_context(m, QS) for m in (m_e, M_R, M_S))
    return jlinear.linear_pow(E, R, S, [JCyc.from_ints(S, y) for y in ys])


def _ys(m_e, seed):
    d = (M_R // 2) // (m_e // 2)
    return [np.random.default_rng(seed + i).integers(-2, 3, M_S // 2) for i in range(d)]


@pytest.fixture(scope="module")
def keys():
    kr, ks_ = jax.random.split(jax.random.PRNGKey(30))
    jsk_r, jsk_s = jshe.gen_sk(J_PR, kr), jshe.gen_sk(J_PS, ks_)
    return dict(jsk_r=jsk_r, jsk_s=jsk_s,
                sk_r=convert.sk_from_numpy(PR, jsk_r.s_ints),
                sk_s=convert.sk_from_numpy(PS, jsk_s.s_ints))


def _encrypt(sk_r, seed):
    """A port-encrypted batch over R: (messages, (c0, c1))."""
    g, rng = prng.KeyChain(seed), np.random.default_rng(seed)
    msgs = she.pt_random(PR, rng, (B,), "cpu")
    return msgs, BatchedBGV(PR, "cpu").build_encrypt(sk_r)(msgs, g())


def _jax(t: torch.Tensor):
    return jnp.asarray(t.numpy().astype(np.uint32))


@pytest.mark.parametrize("m_sub,m_sup", [(16, 64), (32, 64), (64, 64), (1, 8), (2, 8),
                                         (16384, 32768)])
def test_index_tables_match_jax_package(m_sub, m_sup):
    for name in ("embed_pow_table", "rel_coeff_table", "rel_pow_basis_positions"):
        mine, ref = getattr(gen, name)(m_sub, m_sup), getattr(jgen, name)(m_sub, m_sup)
        assert mine.dtype == ref.dtype and mine.shape == ref.shape
        np.testing.assert_array_equal(mine, ref)


@pytest.mark.parametrize("m_e", [16, 32])
def test_eval_lin_is_the_e_linear_map_of_its_images(rng, m_e):
    """f(b_i) = ys_i, f is additive, and f(embed(c) x) = embed(c) f(x) for
    c in E (the identities the JAX package's tests check of its eval_lin)."""
    ys = _ys(m_e, 40)
    f = linear.linear_pow(*(ring_context(m, QS) for m in (m_e, M_R, M_S)), ys)
    n_r = M_R // 2
    for i, pos in enumerate(gen.rel_pow_basis_positions(m_e, M_R)):
        np.testing.assert_array_equal(linear.eval_lin_ints(f, np.eye(1, n_r, pos)[0], P), ys[i] % P)
    x, y = rng.integers(0, P, n_r), rng.integers(0, P, n_r)
    np.testing.assert_array_equal(linear.eval_lin_ints(f, x + y, P),
                                  (linear.eval_lin_ints(f, x, P) + linear.eval_lin_ints(f, y, P)) % P)
    c = rng.integers(0, P, m_e // 2)
    cx = she.pt_mul(PR, _embed(c, m_e, M_R), x)
    np.testing.assert_array_equal(linear.eval_lin_ints(f, cx, P),
                                  she.pt_mul(PS, _embed(c, m_e, M_S), linear.eval_lin_ints(f, x, P)))


def _embed(c, m_sub, m_sup):
    out = np.zeros(m_sup // 2, dtype=np.int64)
    out[gen.embed_pow_table(m_sub, m_sup)] = c
    return out


@pytest.mark.parametrize("m_e", [16, 32])
def test_tunnel_matches_jax_pipeline(keys, m_e):
    """On the JAX package's own hint (its device keygen), carried across."""
    jf = _jax_lin(m_e, _ys(m_e, m_e))
    jbb = JBatchedBGV(J_PR, use_pallas=False)
    jth = jbb.gen_tunnel_hint(jf, keys["jsk_s"], keys["jsk_r"], jax.random.PRNGKey(m_e))
    f = convert.linear_from_numpy(QS, m_e, M_R, M_S, [y.lift_ints(rep=JRep.POW)
                                                     for y in jf.ys])
    th = convert.tunnel_hint_from_numpy(
        PS, f, *(np.stack([[np.asarray(c.data) for c in getattr(h, k)] for h in jth.hints])
                 for k in ("h0", "h1")), device="cpu")
    msgs, (c0, c1) = _encrypt(keys["sk_r"], m_e)
    bb = BatchedBGV(PR, "cpu")
    tun = bb.build_tunnel(th)
    e0, e1 = tun(c0, c1)
    assert e0.dtype == torch.int32 and e0.shape == (len(QS), M_S // 2, B)
    j0, j1 = jbb.build_tunnel(jth)(_jax(c0), _jax(c1))
    np.testing.assert_array_equal(e0.numpy(), np.asarray(j0).astype(np.int32))
    np.testing.assert_array_equal(e1.numpy(), np.asarray(j1).astype(np.int32))
    assert {k for k, _ in tun.named_buffers()} == {"qv", "coeff", "embed", "ys", "h0", "h1"}
    got = bb.target_pipeline(th).build_decrypt(keys["sk_s"])(e0, e1)
    for b in range(B):
        np.testing.assert_array_equal(got[:, b].numpy(), linear.eval_lin_ints(f, msgs[:, b], P))


def test_port_tunnel_hint_decrypts_through_both_tunnels(keys):
    """The port's gen_tunnel_hint (its sampler, its hint pass) under the
    port's tunnel decrypts to eval_lin, and the JAX package's tunnel on
    the same hint gives the same ciphertext, on the E = S map of the
    reference bench (ys = [1, 0])."""
    f = linear.linear_pow(*(ring_context(m, QS) for m in (M_S, M_R, M_S)),
                          [np.eye(1, M_S // 2, dtype=np.int64)[0], np.zeros(M_S // 2)])
    bb = BatchedBGV(PR, "cpu")
    th = bb.gen_tunnel_hint(f, keys["sk_s"], keys["sk_r"], prng.PRNGKey(4))
    assert len(th.hints) == 2 and th.hints[0].h0.shape == (len(QS), len(QS), M_S // 2)
    msgs, (c0, c1) = _encrypt(keys["sk_r"], 5)
    want = np.stack([linear.eval_lin_ints(f, msgs[:, b], P) for b in range(B)], -1)
    e0, e1 = bb.build_tunnel(th)(c0, c1)
    got = bb.target_pipeline(th).build_decrypt(keys["sk_s"])(e0, e1)
    np.testing.assert_array_equal(got.numpy(), want)
    S = j_ring_context(M_S, QS)
    jf = jlinear.linear_pow(S, j_ring_context(M_R, QS), S,
                            [JCyc.scalar(S, 1), JCyc.zero(S)])
    jth = jshe.TunnelHint(jf, jgd.RnsGad(), tuple(
        jshe.KSHint(J_PS, S, jgd.RnsGad(), *(
            tuple(JCyc(S, JRep.CRT, _jax(h[j])) for j in range(len(QS)))
            for h in (k.h0, k.h1)))
        for k in th.hints))
    j0, j1 = JBatchedBGV(J_PR, use_pallas=False).build_tunnel(jth)(_jax(c0), _jax(c1))
    np.testing.assert_array_equal(e0.numpy(), np.asarray(j0).astype(np.int32))
    np.testing.assert_array_equal(e1.numpy(), np.asarray(j1).astype(np.int32))


def test_tunnel_refuses_mismatched_rings(keys):
    f = linear.linear_pow(*(ring_context(m, QS) for m in (M_S, M_R, M_S)),
                          [np.zeros(M_S // 2)] * 2)
    g = prng.KeyChain(0)
    with pytest.raises(ValueError, match="source ring"):
        BatchedBGV(PS, "cpu").gen_tunnel_hint(f, keys["sk_s"], keys["sk_r"], g())
    with pytest.raises(ValueError, match="basis images"):
        linear.linear_pow(*(ring_context(m, QS) for m in (M_S, M_R, M_S)), [np.zeros(16)])


def test_general_m_tower_raises():
    """A general-m ring has no single NTT plan (its transforms take
    `general_plans`), as in the JAX package, and a map whose E divides
    neither ring is refused; the general tower's index tables (ported
    since this test first held that they raise) equal the JAX package's."""
    qs = tuple(nt.ntt_primes(72, 30, 2))
    with pytest.raises(NotImplementedError, match="general_plans"):
        ring_context(72, qs).ntt_plans()
    with pytest.raises(ValueError, match="must divide"):
        linear.linear_pow(ring_context(24, qs), ring_context(72, qs), ring_context(36, qs),
                          [np.zeros(12)] * 2)
    for m_sub, m_sup in ((36, 72), (4, 12)):
        for name in ("embed_pow_table", "rel_coeff_table"):
            np.testing.assert_array_equal(getattr(gen, name)(m_sub, m_sup),
                                          getattr(jgen, name)(m_sub, m_sup))
    f = linear.linear_pow(ring_context(36, qs), ring_context(72, qs), ring_context(36, qs),
                          [np.zeros(12)] * 2)
    assert f.d == 2
