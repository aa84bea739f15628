"""The port's randomness (`lol_tpu_torch.prng`) against `jax.random` and the
JAX package, bit for bit.

The threefry twin's keys, splits, words, `randint` and `uniform` equal
`jax.random`'s; its float32 normal equals `sqrt(2) * jax.lax.erf_inv(u)`
on every one of the 2^23 values u can take, and the rounded samplers'
maps (sqrt(2) folded into the scale where XLA compiles the product as one
program, or not) equal XLA's at every variance the packages use.  From
the same key each sampler of the port must give the JAX package's
integers, keys, ciphertexts, hints, PRF families, RLWE samples and
challenge files: test_torch_prng_samplers.py and test_torch_prng_object.py,
on the helpers below.  The JAX hint generators are jitted; the rest runs
as the packages' own tests run it, on small rings.
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


# --- helpers of the samplers' comparisons (test_torch_prng_*.py) -------------


def _same_ct(ct, jct):
    assert (ct.f, ct.encoding, len(ct.cs)) == (jct.f, jct.encoding, len(jct.cs))
    for c, jc in zip(ct.cs, jct.cs):
        assert c.rep.value == jc.rep.value
        np.testing.assert_array_equal(c.data.numpy(), _np(jc.data))


def _hints_equal(h, jh):
    np.testing.assert_array_equal(h.h0.numpy(), np.stack([_np(c.data) for c in jh.h0]))
    np.testing.assert_array_equal(h.h1.numpy(), np.stack([_np(c.data) for c in jh.h1]))
