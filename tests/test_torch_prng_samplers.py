"""The port's samplers against the JAX package's, from the same key (the
draws themselves: test_torch_prng.py): gen_sk at real rings, the general-m
samplers, the batched pipeline's encryptions and hint generators, the
object path's hint makers, and a JAX key carried across."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lol_tpu import gadget as jgd
from lol_tpu import linear as jlinear
from lol_tpu import prf as jprf
from lol_tpu import rlwe as jrlwe
from lol_tpu import sampling as jsampling
from lol_tpu import she as jshe
from lol_tpu.challenges import driver as jdriver
from lol_tpu.cyc import Cyc as JCyc, Rep as JRep
from lol_tpu.ring import ring_context as j_ring_context
from lol_tpu.she_batched import BatchedBGV as JBatchedBGV
from lol_tpu_torch import convert, gadget as gd, linear, numtheory as nt, prf, prng, rlwe
from lol_tpu_torch import sampling, she
from lol_tpu_torch.challenges import ChallengeParams, generate
from lol_tpu_torch.cyc import Cyc
from lol_tpu_torch.ops.cuda import prng as kernel
from lol_tpu_torch.ring import ring_context
from lol_tpu_torch.she_batched import BatchedBGV

from test_torch_prng import M, QS, SPECIAL, _hints_equal, _key, _np, _same_ct

torch.set_num_threads(2)


@pytest.mark.parametrize("m,p", [(32768, 257), (18432, 7)])
def test_gen_sk_matches_jax(m, p):
    qs = tuple(nt.ntt_primes(m, 30, 2))
    for seed in (0, 5):
        js = jshe.gen_sk(jshe.SHEParams(m=m, p=p, qs=qs, var=2.0), jax.random.PRNGKey(seed))
        ts = she.gen_sk(she.SHEParams(m=m, p=p, qs=qs, var=2.0), prng.PRNGKey(seed), "cpu")
        np.testing.assert_array_equal(np.asarray(js.s_ints), ts.s_ints.numpy())


@pytest.mark.parametrize("m", [72, 90])
def test_sampling_matches_jax_at_general_m(m):
    """gaussian_dec_ints with a batch (the mixing's sums over the odd axes,
    as XLA's dot takes them), uniform, gaussian_cyc, error_coset."""
    qs = tuple(nt.ntt_primes(m, 30, 2))
    jctx, ctx = j_ring_context(m, qs), ring_context(m, qs)
    jk, tk = _key(13)
    np.testing.assert_array_equal(_np(jsampling.gaussian_dec_ints(jctx, jk, 3.0, (5,))),
                                  sampling.gaussian_dec_ints(ctx, tk, 3.0, (5,), "cpu").numpy())
    for jc, c in ((jsampling.uniform(jctx, jk, (2,)), sampling.uniform(ctx, tk, (2,), "cpu")),
                  (jsampling.gaussian_cyc(jctx, jk, 2.0), sampling.gaussian_cyc(ctx, tk, 2.0, device="cpu")),
                  (jsampling.error_coset(jctx, jk, 2.0, np.arange(ctx.n) % 5, 5),
                   sampling.error_coset(ctx, tk, 2.0, np.arange(ctx.n) % 5, 5, "cpu"))):
        assert c.rep.value == jc.rep.value
        np.testing.assert_array_equal(_np(jc.data), c.data.numpy())
    np.testing.assert_array_equal(jsampling.gaussian_ints_np(jctx, jk, 2.0),
                                  sampling.gaussian_ints_np(ctx, tk, 2.0, "cpu"))


@pytest.fixture(scope="module")
def small():
    jp, tp = jshe.SHEParams(m=M, p=257, qs=QS, var=2.0), she.SHEParams(m=M, p=257, qs=QS, var=2.0)
    jk, tk = _key(30)
    jsks = [jshe.gen_sk(jp, k) for k in jax.random.split(jk, 2)]
    sks = [she.gen_sk(tp, k, "cpu") for k in prng.split(tk, 2)]
    for a, b in zip(jsks, sks):
        np.testing.assert_array_equal(np.asarray(a.s_ints), b.s_ints.numpy())
    return dict(jp=jp, tp=tp, jsks=jsks, sks=sks, jbb=JBatchedBGV(jp, use_pallas=False),
                bb=BatchedBGV(tp, "cpu"))


@pytest.mark.parametrize("encoding", ["lsd", "msd"])
def test_batched_encrypt_matches_jax(small, encoding):
    rng = np.random.default_rng(2)
    msgs = rng.integers(0, 257, (small["tp"].ctx.n, 6)).astype(np.int32)
    jk, tk = _key(31)
    jc = small["jbb"].build_encrypt(small["jsks"][0], encoding)(jnp.asarray(msgs), jk)
    c = small["bb"].build_encrypt(small["sks"][0], encoding)(torch.from_numpy(msgs), tk)
    for a, b in zip(c, jc):
        np.testing.assert_array_equal(a.numpy(), _np(b))


def test_batched_hint_generators_match_jax(small):
    jbb, bb = small["jbb"], small["bb"]
    (jsk, jsk2), (sk, sk2) = small["jsks"], small["sks"]
    jk, tk = _key(32)
    _hints_equal(bb.gen_ks_quad_hint(sk, tk), jbb.gen_ks_quad_hint(jsk, jk))
    _hints_equal(bb.gen_ks_linear_hint(sk2, sk, tk), jbb.gen_ks_linear_hint(jsk2, jsk, jk))
    _hints_equal(bb.gen_galois_hint(5, sk, tk), jbb.gen_galois_hint(5, jsk, jk))
    jx, x = jbb.gen_ks_quad_hint_ext(jsk, SPECIAL, jk), bb.gen_ks_quad_hint_ext(sk, SPECIAL, tk)
    _hints_equal(x, jx)
    jx = jbb.gen_ks_linear_hint_ext(jsk2, jsk, SPECIAL, jk)
    _hints_equal(bb.gen_ks_linear_hint_ext(sk2, sk, SPECIAL, tk), jx)


def test_batched_tunnel_hint_matches_jax(small):
    """gen_tunnel_hint 64 -> 32 (E = S, ys = [1, 0])."""
    jp, tp = small["jp"], small["tp"]
    jps = jshe.SHEParams(m=M // 2, p=257, qs=QS, var=2.0)
    ps = she.SHEParams(m=M // 2, p=257, qs=QS, var=2.0)
    jk, tk = _key(33)
    jsk_s, sk_s = jshe.gen_sk(jps, jk), she.gen_sk(ps, tk, "cpu")
    jr, jsc = j_ring_context(M, QS), j_ring_context(M // 2, QS)
    jf = jlinear.linear_pow(jsc, jr, jsc, [JCyc.scalar(jsc, 1), JCyc.zero(jsc)])
    n_s = ps.ctx.n
    f = linear.linear_pow(ps.ctx, tp.ctx, ps.ctx, [np.eye(1, n_s, dtype=np.int64)[0],
                                                   np.zeros(n_s, dtype=np.int64)])
    jk, tk = _key(34)
    jth = small["jbb"].gen_tunnel_hint(jf, jsk_s, small["jsks"][0], jk)
    th = small["bb"].gen_tunnel_hint(f, sk_s, small["sks"][0], tk)
    for h, jh in zip(th.hints, jth.hints):
        _hints_equal(h, jh)


def test_object_hints_match_jax(small):
    """The object path's hint makers (_ks_hint's split chain, the ext one,
    pt_round_hints') from the same key."""
    (jsk, jsk2), (sk, sk2) = small["jsks"], small["sks"]
    jk, tk = _key(35)
    _hints_equal(she.ks_quad_circ_hint(sk, gd.BaseBGad(1 << 16), tk, "cpu"),
                 jshe.ks_quad_circ_hint(jsk, jgd.BaseBGad(1 << 16), jk))
    _hints_equal(she.ks_linear_hint(sk2, sk, gd.RnsGad(), tk, "cpu"),
                 jshe.ks_linear_hint(jsk2, jsk, jgd.RnsGad(), jk))
    _hints_equal(she.ks_quad_circ_hint_ext(sk, gd.RnsGad(), tk, SPECIAL, "cpu"),
                 jshe.ks_quad_circ_hint_ext(jsk, jgd.RnsGad(), jk, SPECIAL))


def test_key_from_numpy_carries_a_jax_key():
    jk = jax.random.split(jax.random.PRNGKey(77))[1]
    k = convert.key_from_numpy(np.asarray(jk))
    np.testing.assert_array_equal(_np(jax.random.bits(jk, (5,), jnp.uint32)),
                                  prng.random_bits(k, (5,), "cpu").numpy())
    with pytest.raises(ValueError, match="two u32 words"):
        convert.key_from_numpy(np.zeros(3, dtype=np.uint32))
