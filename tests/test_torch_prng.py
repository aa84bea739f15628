"""The port's randomness (`lol_tpu_torch.prng`) against `jax.random` and the
JAX package, bit for bit.

The threefry twin's keys, splits, words, `randint` and `uniform` equal
`jax.random`'s; its float32 normal equals `sqrt(2) * jax.lax.erf_inv(u)`
on every one of the 2^23 values u can take, and the rounded samplers'
maps (sqrt(2) folded into the scale where XLA compiles the product as one
program, or not) equal XLA's at every variance the packages use.  Then,
from the same key, each sampler of the port must give the JAX package's
integers, keys, ciphertexts, hints, PRF families, RLWE samples and
challenge files.  The JAX hint generators are jitted; the rest runs as
the packages' own tests run it, on small rings.
"""

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

torch.set_num_threads(2)

M = 64
QS = tuple(nt.ntt_primes(128, 30, 3))
SPECIAL = tuple(nt.ntt_primes(128, 30, 5)[3:])
VARS = (1.0, 2.0, 4.0, 9.0)


def _key(seed):
    return jax.random.PRNGKey(seed), prng.PRNGKey(seed)


def _np(x):
    return np.asarray(x).astype(np.int64)


# --- jax.random ---------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 42, 2**31 + 5, 2**40 + 7, -1, -12345])
def test_prngkey_and_split_match_jax(seed):
    jk, tk = _key(seed)
    np.testing.assert_array_equal(_np(jk), tk.numpy())
    for num in (2, 3, 7):
        np.testing.assert_array_equal(_np(jax.random.split(jk, num)), prng.split(tk, num).numpy())
    chain = prng.KeyChain(seed)
    jkey = jk
    for _ in range(3):
        jkey, jsub = jax.random.split(jkey)
        np.testing.assert_array_equal(_np(jsub), chain().numpy())


@pytest.mark.parametrize("shape", [(1,), (7,), (3, 5), (2, 3, 33)])
def test_random_bits_match_jax(shape):
    jk, tk = _key(11)
    np.testing.assert_array_equal(_np(jax.random.bits(jk, shape, jnp.uint32)),
                                  prng.random_bits(tk, shape, device="cpu").numpy())


@pytest.mark.parametrize("q", [*nt.ntt_primes(32768, 30, 2), *nt.ntt_primes(18432, 30, 2),
                               257, 7, 2, 1 << 16, (1 << 16) + 1])
def test_randint_matches_jax(q):
    """randint over [0, q) (u32), at the 30-bit primes of m = 32768 and
    18432 and small moduli: above 2^16 the high word drops out of it, as
    XLA's wrapping u32 multiplier makes it."""
    jk, tk = _key(3)
    np.testing.assert_array_equal(_np(jax.random.randint(jk, (40, 33), 0, q, dtype=jnp.uint32)),
                                  prng.randint(tk, (40, 33), 0, q, device="cpu").numpy())
    np.testing.assert_array_equal(_np(jax.random.randint(jk, (9,), -q, q)),
                                  prng.randint(tk, (9,), -q, q, device="cpu").numpy())
    assert prng.randint_multiplier(q) == (0 if q > 1 << 16 else (1 << 32) % q)


@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (-0.3, 2.7), (-1.0, 1.0)])
def test_uniform_matches_jax(lo, hi):
    jk, tk = _key(5)
    want = np.asarray(jax.random.uniform(jk, (1000,), minval=lo, maxval=hi))
    np.testing.assert_array_equal(want.view(np.uint32),
                                  prng.uniform(tk, (1000,), lo, hi, "cpu").numpy().view(np.uint32))


@pytest.fixture(scope="module")
def all_inputs():
    """Every word's top 23 bits (the only bits a normal reads): jax's u for
    each, XLA's erf_inv(u), and the twin's erf_inv from the words."""
    lo = np.nextafter(np.float32(-1), np.float32(0))
    unit = (np.arange(1 << 23, dtype=np.uint32) | np.uint32(0x3F800000)).view(np.float32) - 1
    u = np.maximum(lo, unit * np.float32(2) + lo)
    r = prng.gaussian_from_bits(torch.arange(1 << 23, dtype=torch.int64) << 9, pre=1.0)
    return u, np.asarray(jax.jit(jax.lax.erf_inv)(u)), r


def test_normal_matches_jax_on_every_input(all_inputs):
    """The twin's float32 erf_inv and normal == XLA's for all 2^23 u, and
    real draws == jax.random.normal."""
    u, erf, r = all_inputs
    assert np.count_nonzero(r.numpy().view(np.uint32) != erf.view(np.uint32)) == 0
    want = np.asarray(jax.jit(lambda v: np.float32(math.sqrt(2)) * jax.lax.erf_inv(v))(u))
    got = (r * prng.SQRT2).numpy()
    assert np.count_nonzero(got.view(np.uint32) != want.view(np.uint32)) == 0
    jk, tk = _key(9)
    np.testing.assert_array_equal(np.asarray(jax.random.normal(jk, (4, 1000))).view(np.uint32),
                                  prng.normal(tk, (4, 1000), "cpu").numpy().view(np.uint32))


@pytest.mark.parametrize("var", VARS)
def test_rounded_maps_match_xla_on_every_input(all_inputs, var):
    """At each variance, over all 2^23 inputs: the sampler compiled as one
    program (`jnp.round(normal * s)`, s traced or constant: XLA folds
    sqrt(2) into s) == the twin's folded map; and an eager normal times
    sqrt(var) (`real_gaussians`) == the twin's draw with both roundings."""
    u, _, r = all_inputs
    sqrt2 = np.float32(math.sqrt(2))
    traced = jax.jit(lambda v, s: jnp.round(sqrt2 * jax.lax.erf_inv(v) * s).astype(jnp.int32))
    const = jax.jit(lambda v: jnp.round(sqrt2 * jax.lax.erf_inv(v) * np.sqrt(var)).astype(jnp.int32))
    for how, want in (("f32", traced(u, jnp.sqrt(jnp.float32(var)))),
                      ("f64", traced(u, np.float32(np.sqrt(var)))), ("f64", const(u))):
        got = torch.round(r * prng.folded_scale(var, how)).to(torch.int32).numpy()
        assert np.count_nonzero(got != np.asarray(want)) == 0, how
    eager = np.asarray(jax.random.normal(jax.random.PRNGKey(2), (1 << 14,)) * jnp.sqrt(jnp.float32(var)))
    mine = sampling.real_gaussians(prng.PRNGKey(2), var, (1 << 14,), "cpu").numpy()
    np.testing.assert_array_equal(eager.view(np.uint32), mine.view(np.uint32))


def test_draw_modes_and_refusals():
    """The wrapper's plain version: one row per key; bits are the words'
    u32 patterns; a CUDA draw without a card raises, nothing falls back."""
    keys = list(prng.split(prng.PRNGKey(4), 3))
    bits = kernel.draw(keys, 10, "bits", device="cpu")
    for k, row in zip(keys, bits):
        np.testing.assert_array_equal(row.numpy().view(np.uint32),
                                      prng.random_bits(k, (10,), "cpu").numpy().astype(np.uint32))
    res = kernel.draw(keys, 10, "randint", qs=[7, 257, 2], device="cpu")
    assert res.dtype == torch.int32 and bool((res < torch.tensor([[7], [257], [2]])).all())
    with pytest.raises(ValueError, match="mode"):
        kernel.draw(keys, 10, "poisson", device="cpu")
    with pytest.raises(ValueError, match="one modulus"):
        kernel.draw(keys, 10, "randint", qs=[7], device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            prng.normal(prng.PRNGKey(0), (4,), device="cuda")


def test_draws_default_to_the_card(monkeypatch):
    """With no device every draw goes to the kernel's wrapper for the card,
    as the port's other entry points do; "cpu" is asked for."""
    seen = []

    def record(keys, count, mode, qs=None, pre=1.0, scale=1.0, device="cuda"):
        seen.append(torch.device(device).type)
        return kernel.draw_ref(keys, count, mode, qs, pre, scale)

    monkeypatch.setattr(kernel, "draw", record)
    key = prng.PRNGKey(6)
    for fn, args in ((prng.random_bits, ((3,),)), (prng.randint, ((3,), 0, 257)),
                     (prng.uniform, ((3,),)), (prng.gaussian, ((3,), 2.0)),
                     (prng.normal, ((3,),))):
        fn(key, *args)
    assert seen == ["cuda"] * 5
    jk, _ = _key(6)
    np.testing.assert_array_equal(_np(jax.random.bits(jk, (3,), jnp.uint32)),
                                  prng.random_bits(key, (3,)).numpy())


SPANS = (2, 257, 65535, 65536, 65537, 2**31 - 1, *nt.ntt_primes(32768, 30, 3))


@pytest.mark.parametrize("q", SPANS)
def test_draw_ref_randint_matches_jax(q):
    """The kernel's plain version of randint (`randint_at` at the draw's
    indices) == jax.random.randint, alone and as one channel of three,
    over spans on both sides of 2^16, where the kernel hashes once a word
    or twice."""
    jk, tk = _key(17)
    want = _np(jax.random.randint(jk, (1031,), 0, q, dtype=jnp.uint32))
    np.testing.assert_array_equal(kernel.draw_ref([tk], 1031, "randint", qs=[q])[0].numpy(), want)
    keys = [tk, *prng.split(prng.PRNGKey(18), 2)]
    got = kernel.draw(keys, 1031, "randint", qs=[q, 257, SPANS[-1]], device="cpu")
    np.testing.assert_array_equal(got[0].numpy(), want)
    for c in (1, 2):
        np.testing.assert_array_equal(got[c].numpy(), prng.randint(keys[c], (1031,), 0,
                                                                   [0, 257, SPANS[-1]][c], "cpu"))


def _mod_q(w: int, q: int) -> int:
    """csrc/prng.cu's `mod_q` on Python ints: Barrett with mu = floor((2^32
    - 1) / q), the high word of w * mu, then one conditional subtract."""
    r = w - ((w * ((1 << 32) - 1) // q) >> 32) * q
    return r - q if r >= q else r


@pytest.mark.parametrize("q", SPANS)
def test_barrett_reduction_on_the_edge_words(q):
    """The kernel's reduction (its exactness argument, `_mod_q`) == w mod
    q on 0, q - 1, q, 2q - 1, multiples of q and their neighbours, 2^32 -
    1 and random words, with its remainder before the subtract below 2q."""
    mults = [k * q for k in (2, 3, (1 << 32) // q - 1, (1 << 32) // q) if k * q < 1 << 32]
    edge = {w for w in [0, 1, q - 1, q, q + 1, 2 * q - 1, 2 * q, (1 << 32) - 1, (1 << 31) - 1,
                        1 << 31, *mults, *(m - 1 for m in mults), *(m + 1 for m in mults)]
            if 0 <= w < 1 << 32}
    rand = np.random.default_rng(q).integers(0, 1 << 32, 4096).tolist()
    for w in [*edge, *rand]:
        assert _mod_q(w, q) == w % q, (w, q)
        assert w - ((w * ((1 << 32) - 1) // q) >> 32) * q < 2 * q


def test_draw_at_ref_is_the_draw_at_those_indices():
    """The plain values at given element indices (the card check's sample
    past 2^31 elements) == the whole draw's at them, in every mode."""
    keys = list(prng.split(prng.PRNGKey(19), 2))
    idx = torch.tensor([0, 1, 2, 517, 998, 999], dtype=torch.int64)
    for mode, kw in (("bits", {}), ("randint", {"qs": [257, SPANS[-1]]}),
                     ("float", {"pre": prng.SQRT2}), ("round", {"scale": 1.5})):
        want = kernel.draw_ref(keys, 1000, mode, **kw)[:, idx]
        got = kernel.draw_at_ref(keys, idx, mode, **kw)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32)), mode
    far = torch.tensor([(1 << 32) - 1, 1 << 32, (1 << 32) + 5], dtype=torch.int64)
    b0, b1 = prng.threefry2x32(*prng.key_words(keys[0]), far >> 32, far & prng.MASK)
    assert torch.equal(prng.bits_at(keys[0], far), b0 ^ b1)
    assert bool((prng.bits_at(keys[0], far) != prng.bits_at(keys[0], far & prng.MASK)).any())


# --- the packages' samplers, from the same key ---------------------------------


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


def _same_ct(ct, jct):
    assert (ct.f, ct.encoding, len(ct.cs)) == (jct.f, jct.encoding, len(jct.cs))
    for c, jc in zip(ct.cs, jct.cs):
        assert c.rep.value == jc.rep.value
        np.testing.assert_array_equal(c.data.numpy(), _np(jc.data))


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


def _hints_equal(h, jh):
    np.testing.assert_array_equal(h.h0.numpy(), np.stack([_np(c.data) for c in jh.h0]))
    np.testing.assert_array_equal(h.h1.numpy(), np.stack([_np(c.data) for c in jh.h1]))


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


def test_key_from_numpy_carries_a_jax_key():
    jk = jax.random.split(jax.random.PRNGKey(77))[1]
    k = convert.key_from_numpy(np.asarray(jk))
    np.testing.assert_array_equal(_np(jax.random.bits(jk, (5,), jnp.uint32)),
                                  prng.random_bits(k, (5,), "cpu").numpy())
    with pytest.raises(ValueError, match="two u32 words"):
        convert.key_from_numpy(np.zeros(3, dtype=np.uint32))
