"""The port's Galois automorphisms against the JAX package.

`lol_tpu_torch.zmstar` (units, slot units, the automorphisms' slot
permutations) and `ops.general._global_units` at 2-power and composite
m; the batched `build_galois` and the hoisted `build_galois_many` at
m = 64 (p = 257) and m = 36 (p = 5), three 30-bit primes, B = 3, on the
port's key and ciphertexts and the JAX package's sigma_k hints from that
key: each output equals `lol_tpu.she_batched.BatchedBGV(params,
use_pallas=False)`'s bit for bit, the hoisted ones equal the separate
ones at 2-power m, and every output decrypts to the host
`she.galois_ints` of the message, which equals the JAX package's
`Cyc.galois`.  The port's own `gen_galois_hint` decrypts as the JAX
package's does.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lol_tpu import zmstar as jzmstar
from lol_tpu import she as jshe
from lol_tpu.cyc import Cyc as JCyc, Rep as JRep
from lol_tpu.ops import general as jgen
from lol_tpu.she_batched import BatchedBGV as JBatchedBGV
from lol_tpu_torch import prng
from lol_tpu_torch import convert, numtheory as nt, she, zmstar
from lol_tpu_torch.ops import general as gen
from lol_tpu_torch.she_batched import BatchedBGV

torch.set_num_threads(2)

B = 3
KS = {64: (3, 63), 36: (5, 7)}
P = {64: 257, 36: 5}


def _u32(t: torch.Tensor):
    return t.numpy().astype(np.uint32)


@pytest.mark.parametrize("m", [16, 64, 9, 36, 45, 72, 90])
def test_units_and_slot_perms_match_reference(m):
    q = nt.ntt_primes(m if m & (m - 1) else 2 * m, 30, 1)[0]
    assert zmstar.units(m) == jzmstar.units(m)
    assert zmstar.unit_index(m) == jzmstar.unit_index(m)
    np.testing.assert_array_equal(gen._global_units(gen.general_plan(m, q)),
                                  jgen._global_units(jgen.general_plan(m, q)))
    np.testing.assert_array_equal(zmstar.canonical_slot_units(m, q),
                                  jzmstar.canonical_slot_units(m, q))
    for k in range(1, 2 * m, 2 * m // 7 + 1):
        if math.gcd(k, m) == 1:
            perm = zmstar.automorphism_slot_perm(m, q, k)
            np.testing.assert_array_equal(perm, jzmstar.automorphism_slot_perm(m, q, k))
            assert sorted(perm.tolist()) == list(range(len(perm)))
    with pytest.raises(ValueError, match="not a unit"):
        zmstar.automorphism_slot_perm(m, q, m)


_STATE = {}


def _state(m):
    """The port's key and ciphertexts at m, the JAX package's sigma_k
    hints from that key, and its build_galois / build_galois_many
    outputs on them."""
    if m in _STATE:
        return _STATE[m]
    p, ks = P[m], KS[m]
    qs = tuple(nt.ntt_primes(m, 30, 3))
    params = she.SHEParams(m=m, p=p, qs=qs, var=2.0)
    g, rng = prng.KeyChain(m), np.random.default_rng(m)
    sk = she.gen_sk(params, g(), "cpu")
    bb = BatchedBGV(params, "cpu")
    msgs = she.pt_random(params, rng, (B,), "cpu")
    c = bb.build_encrypt(sk)(msgs, g())
    jp = jshe.SHEParams(m=m, p=p, qs=qs, var=2.0)
    jsk = jshe.SK(jp, sk.s_ints.numpy(), 2.0)
    jbb = JBatchedBGV(jp, use_pallas=False)
    jhints = {k: jbb.gen_galois_hint(k, jsk, jax.random.PRNGKey(k)) for k in ks}
    jc = [jnp.asarray(_u32(t)) for t in c]
    with jax.disable_jit():
        one = {k: jbb.build_galois(jhints[k], k)(*jc) for k in ks}
        many = jbb.build_galois_many(jhints)(*jc)
    hints = {k: convert.hint_from_numpy(
        params, *(np.stack([np.asarray(x.data) for x in getattr(h, name)])
                  for name in ("h0", "h1")), device="cpu") for k, h in jhints.items()}
    _STATE[m] = dict(params=params, sk=sk, bb=bb, msgs=msgs.numpy(), c=c, jsk=jsk, jbb=jbb,
                     jc=jc, jhints=jhints, hints=hints, one=one, many=many)
    return _STATE[m]


@pytest.mark.parametrize("m", [64, 36])
def test_build_galois_matches_reference(m):
    st = _state(m)
    bb, dec = st["bb"], st["bb"].build_decrypt(st["sk"])
    for k in KS[m]:
        gal = bb.build_galois(st["hints"][k], k)
        assert {name for name, _ in gal.named_buffers()} == {"qv", "hint_sh", "perm"}
        out = gal(*st["c"])
        for mine, ref in zip(out, st["one"][k]):
            np.testing.assert_array_equal(_u32(mine), np.asarray(ref))
        got = dec(*out).numpy()
        for b in range(B):
            np.testing.assert_array_equal(got[:, b], she.galois_ints(m, st["msgs"][:, b], k, P[m]))


@pytest.mark.parametrize("m", [64, 36])
def test_build_galois_many_matches_reference(m):
    """The hoisted rotations == the JAX package's hoisted ones; == the
    separate ones bit for bit at 2-power m; at m = 36 they differ from
    them (other digits) and decrypt the same."""
    st = _state(m)
    bb, dec = st["bb"], st["bb"].build_decrypt(st["sk"])
    gal_many = bb.build_galois_many(st["hints"])
    assert {name for name, _ in gal_many.named_buffers()} == {
        f"{name}_{k}" for k in KS[m] for name in ("hint_sh", "perm")}
    many = gal_many(*st["c"])
    assert list(many) == sorted(KS[m])
    differs = False
    for k in KS[m]:
        for mine, ref in zip(many[k], st["many"][k]):
            np.testing.assert_array_equal(_u32(mine), np.asarray(ref))
        one = bb.build_galois(st["hints"][k], k)(*st["c"])
        same = all(torch.equal(a, b) for a, b in zip(many[k], one))
        assert same or m != 64
        differs |= not same
        np.testing.assert_array_equal(dec(*many[k]).numpy(), dec(*one).numpy())
    assert differs or m == 64


def test_host_galois_matches_cyc_galois():
    """she.galois_ints at m = 36 (the slot permutation over an auxiliary
    chain) == the JAX package's Cyc.galois of the decoding-basis element,
    mod p; at 2-power m it is x^i -> x^(ik mod 2n) with the sign of the
    wrap (the rotations above hold it against the JAX outputs' decrypts);
    sigma_k sigma_k^-1 is the identity at both."""
    st = _state(36)
    p, ctx = P[36], st["jsk"].params.ctx
    x = st["msgs"][:, 0].astype(np.int64)
    xc = np.where(x >= (p + 1) // 2, x - p, x)
    k = KS[36][0]
    with jax.disable_jit():
        want = np.asarray(JCyc.from_ints(ctx, xc, rep=JRep.DEC).galois(k).lift_ints(
            rep=JRep.DEC)) % p
    got = she.galois_ints(36, x, k, p)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(she.galois_ints(36, got, pow(k, -1, 36), p), x % p)
    e1 = np.eye(1, 32, 1, dtype=np.int64)[0]  # x at m = 64
    np.testing.assert_array_equal(she.galois_ints(64, e1, 3, 257), np.eye(1, 32, 3)[0])
    np.testing.assert_array_equal(she.galois_ints(64, e1, 63, 257),
                                  (-np.eye(1, 32, 31)[0]) % 257)  # x^63 = -x^31
    y = np.arange(32) % 257
    np.testing.assert_array_equal(she.galois_ints(64, she.galois_ints(64, y, 3, 257),
                                                  pow(3, -1, 64), 257), y)


@pytest.mark.parametrize("m", [64, 36])
def test_port_galois_hint_decrypts_as_reference(m):
    """A port-made sigma_k hint: the rotation decrypts to sigma_k of the
    message, as the JAX hint's rotation does, and the JAX package's
    build_galois on it decrypts the same."""
    st = _state(m)
    bb, dec = st["bb"], st["bb"].build_decrypt(st["sk"])
    k = KS[m][1]
    hint = bb.gen_galois_hint(k, st["sk"], prng.PRNGKey(1))
    assert hint.h0.shape == hint.h1.shape == (3, 3, bb.ctx.n)
    got = dec(*bb.build_galois(hint, k)(*st["c"]))
    np.testing.assert_array_equal(got.numpy(), dec(*bb.build_galois(st["hints"][k], k)(*st["c"])).numpy())
    jh = jshe.KSHint(st["jhints"][k].params, st["jhints"][k].ctx, st["jhints"][k].spec,
                     *(tuple(JCyc(x.ctx, x.rep, jnp.asarray(_u32(t))) for x, t in
                             zip(getattr(st["jhints"][k], name), getattr(hint, name)))
                       for name in ("h0", "h1")))
    with jax.disable_jit():
        jout = st["jbb"].build_galois(jh, k)(*st["jc"])
        jgot = st["jbb"].build_decrypt(st["jsk"])(*jout)
    np.testing.assert_array_equal(np.asarray(jgot), got.numpy())
