"""The port's heavier keyed paths against the JAX package's, from the same
key (the draws: test_torch_prng.py; the samplers: test_torch_prng_samplers.py):
the object path's encryption at m = 8192, the KH-PRF family and
make_eval_hints down 32 -> 2, RLWE samples, and a challenge directory
byte for byte."""

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


def test_object_encrypt_matches_jax_at_8192():
    m, qs = 8192, tuple(nt.ntt_primes(8192, 30, 2))
    jp, tp = jshe.SHEParams(m=m, p=257, qs=qs, var=2.0), she.SHEParams(m=m, p=257, qs=qs, var=2.0)
    jk, tk = _key(21)
    jsk, sk = jshe.gen_sk(jp, jk), she.gen_sk(tp, tk, "cpu")
    msg = jshe.pt_random(jp, np.random.default_rng(1))
    np.testing.assert_array_equal(msg, she.pt_random(tp, np.random.default_rng(1), device="cpu"))
    for jenc, enc in ((jshe.encrypt, she.encrypt), (jshe.encrypt_msd, she.encrypt_msd)):
        jk, tk = _key(22)
        _same_ct(enc(sk, msg, tk, "cpu"), jenc(jsk, msg, jk))


def test_prf_family_and_eval_hints_match_jax():
    """PRFFamily.random and make_eval_hints down 32 -> 2 (the project maps,
    with the rounding's hints), from the same key."""
    p, rings = 8, [32, 16, 8, 4, 2]
    qs = tuple(nt.ntt_primes(64, 30, jshe.pt_round_mults(p) + 2))
    jk, tk = _key(40)
    jfam = jprf.PRFFamily.random(j_ring_context(32, (p,)), jgd.BaseBGad(2), jprf.balanced(2), jk)
    fam = prf.PRFFamily.random(ring_context(32, (p,)), gd.BaseBGad(2), prf.balanced(2), tk, "cpu")
    np.testing.assert_array_equal(fam.a0, np.stack([a.lift_ints(rep=JRep.POW) % p for a in jfam.a0]))
    np.testing.assert_array_equal(fam.a1, np.stack([a.lift_ints(rep=JRep.POW) % p for a in jfam.a1]))
    ks = jax.random.split(jk, len(rings))
    jsks = [jshe.gen_sk(jshe.SHEParams(m=r, p=p, qs=qs, var=2.0), k) for r, k in zip(rings, ks)]
    sks = [she.gen_sk(she.SHEParams(m=r, p=p, qs=qs, var=2.0), k, "cpu")
           for r, k in zip(rings, prng.split(tk, len(rings)))]
    jk, tk = _key(41)
    jh, _ = jprf.make_eval_hints(jfam, jsks, rings, rings[1:], jgd.RnsGad(), jk,
                                 homomorphic_round=True, maps="project")
    h, _ = prf.make_eval_hints(fam, sks, rings, rings[1:], gd.RnsGad(), tk,
                               homomorphic_round=True, maps="project", device="cpu")
    assert len(h.tunnels) == len(jh.tunnels) == len(rings) - 1
    for th, jth in zip(h.tunnels, jh.tunnels):
        for a, b in zip(th.hints, jth.hints):
            _hints_equal(a, b)
    for a, b in zip(h.rounds.hints, jh.rounds.hints):
        _hints_equal(a, b)


def test_rlwe_samples_match_jax():
    jctx, ctx = j_ring_context(M, QS[:1]), ring_context(M, QS[:1])
    jk, tk = _key(50)
    js, s = JCyc.from_ints(jctx, np.arange(ctx.n) % 3 - 1), Cyc.from_ints(ctx, np.arange(ctx.n) % 3 - 1,
                                                                          device="cpu")
    js, s = js.to_crt(), s.to_crt()
    for jsamp, samp in ((jrlwe.sample_discrete(jctx, js, 2.0, jk),
                         rlwe.sample_discrete(ctx, s, 2.0, tk)),
                        (jrlwe.sample_rlwr(jctx, j_ring_context(M, (257,)), js, jk),
                         rlwe.sample_rlwr(ctx, ring_context(M, (257,)), s, tk))):
        for c, jc in ((samp.a, jsamp.a), (samp.b, jsamp.b)):
            assert c.rep.value == jc.rep.value
            np.testing.assert_array_equal(c.data.numpy(), _np(jc.data))
    ja, jb = jrlwe.sample_continuous(jctx, js, 2.0, jk)
    a, b = rlwe.sample_continuous(ctx, s, 2.0, tk)
    np.testing.assert_array_equal(a.data.numpy(), _np(ja.data))
    np.testing.assert_array_equal(b.view(np.uint64), np.asarray(jb).view(np.uint64))


def test_challenge_directory_is_the_jax_packages(tmp_path):
    """generate(seed) writes the JAX package's files, byte for byte."""
    q64, q72 = nt.ntt_primes(64, 30, 1)[0], nt.ntt_primes(72, 30, 1)[0]

    def params(P):
        return [P(0, 64, q64, 4.0, 2, "disc", beacon_epoch=11),
                P(1, 64, q64, 4.0, 2, "cont", beacon_epoch=12, beacon_offset=8),
                P(2, 64, q64, 4.0, 2, "rlwr", qprime=257, beacon_epoch=13),
                P(3, 72, q72, 4.0, 1, "disc", beacon_epoch=14)]

    jdriver.generate(tmp_path / "jax", params(jdriver.ChallengeParams), seed=7)
    generate(tmp_path / "port", params(ChallengeParams), seed=7, device="cpu")
    jfiles = sorted(p.relative_to(tmp_path / "jax") for p in (tmp_path / "jax").rglob("*")
                    if p.is_file())
    assert jfiles == sorted(p.relative_to(tmp_path / "port") for p in (tmp_path / "port").rglob("*")
                            if p.is_file())
    for rel in jfiles:
        assert (tmp_path / "port" / rel).read_bytes() == (tmp_path / "jax" / rel).read_bytes(), rel
