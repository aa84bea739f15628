"""The port's extended-modulus (hybrid) key switching against the JAX package.

`BatchedBGV.build_step_ext` and `build_key_switch_linear_ext`, LSD and
MSD, equal `lol_tpu.she_batched.BatchedBGV(params, use_pallas=False)`'s
bit for bit at m = 64, three 30-bit primes and two special primes
(`ntt_primes(64, 30, 5)[3:]`), p = 257, B = 3, on the JAX package's keys,
extended hints (its device keygen) and ciphertexts carried across through
`lol_tpu_torch.convert` (the JAX builders run with jit disabled: the same
jnp integer operations, op by op, its keygen too: at this size that
costs less than compiling each function).  On the port's own extended hints the
outputs decrypt to `pt_mul` / the message under the new key, and their
noise budget is strictly below the base-gadget builders' on the same
inputs: dropping P divides the key-switch noise by P.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lol_tpu import she as jshe
from lol_tpu.she_batched import BatchedBGV as JBatchedBGV
from lol_tpu_torch import prng
from lol_tpu_torch import convert, numtheory as nt, she
from lol_tpu_torch.she_batched import BatchedBGV

torch.set_num_threads(2)

M, P, B = 64, 257, 3
ALL5 = tuple(nt.ntt_primes(M, 30, 5))
QS, SPECIAL = ALL5[:3], ALL5[3:]
PARAMS = she.SHEParams(m=M, p=P, qs=QS, var=2.0)
J_PARAMS = jshe.SHEParams(m=M, p=P, qs=QS, var=2.0)
DROPPED = she.SHEParams(m=M, p=P, qs=QS[:-1], var=2.0)


def _np(x) -> np.ndarray:
    return np.asarray(x).astype(np.int64)


def _ext_arrays(hint):
    return tuple(np.stack([np.asarray(c.data) for c in getattr(hint, k)]) for k in ("h0", "h1"))


@pytest.fixture(scope="module")
def st():
    """The JAX package's keys, extended hints and LSD / MSD ciphertext
    pairs, and the same state carried across."""
    ks, kn, kq, kl, *kes = jax.random.split(jax.random.PRNGKey(210), 8)
    rng = np.random.default_rng(210)
    msgs = [rng.integers(0, P, (M // 2, B)).astype(np.int32) for _ in range(2)]
    with jax.disable_jit():
        jbb = JBatchedBGV(J_PARAMS, use_pallas=False)
        jsk, jsk_new = jshe.gen_sk(J_PARAMS, ks), jshe.gen_sk(J_PARAMS, kn)
        quad = jbb.gen_ks_quad_hint_ext(jsk, SPECIAL, kq)
        lin = jbb.gen_ks_linear_hint_ext(jsk_new, jsk, SPECIAL, kl)
        cts = {e: [tuple(map(_np, jbb.build_encrypt(jsk, encoding=e)(jnp.asarray(m), kes[2 * i + k])))
                   for k, m in enumerate(msgs)] for i, e in enumerate(("lsd", "msd"))}
    assert quad.ctx_ext.basis.qs == ALL5 and quad.n_special == 2

    def ext(h):
        return convert.hint_ext_from_numpy(PARAMS, ALL5, 2, *_ext_arrays(h), device="cpu")

    return dict(jbb=jbb, quad_j=quad, lin_j=lin, msgs=msgs, cts=cts, quad=ext(quad), lin=ext(lin),
                sk=convert.sk_from_numpy(PARAMS, jsk.s_ints),
                sk_new=convert.sk_from_numpy(PARAMS, jsk_new.s_ints))


def _port(cts):
    return [t for c in cts for t in convert.cts_from_numpy(*c, device="cpu")]


def _jax(cts):
    return [jnp.asarray(t.astype(np.uint32)) for c in cts for t in c]


def _same(got, want):
    for a, b in zip(got, want):
        assert a.dtype == torch.int32
        np.testing.assert_array_equal(a.numpy().astype(np.int64), _np(b))


@pytest.mark.parametrize("encoding", ["lsd", "msd"])
def test_step_ext_matches_jax(st, encoding):
    bb = BatchedBGV(PARAMS, "cpu")
    step = bb.build_step_ext(st["quad"], encoding=encoding)
    assert {k for k, _ in step.named_buffers()} == {"qv", "hint_sh"}
    got = step(*_port(st["cts"][encoding]))
    assert got[0].shape == (len(QS) - 1, M // 2, B)
    with jax.disable_jit():
        want = st["jbb"].build_step_ext(st["quad_j"], encoding=encoding)(*_jax(st["cts"][encoding]))
    _same(got, want)


@pytest.mark.parametrize("encoding", ["lsd", "msd"])
def test_key_switch_linear_ext_matches_jax(st, encoding):
    bb = BatchedBGV(PARAMS, "cpu")
    got = bb.build_key_switch_linear_ext(st["lin"])(*_port(st["cts"][encoding][:1]))
    with jax.disable_jit():
        want = st["jbb"].build_key_switch_linear_ext(st["lin_j"])(*_jax(st["cts"][encoding][:1]))
    _same(got, want)
    dec = bb.build_decrypt(st["sk_new"], encoding=encoding)(*got)
    np.testing.assert_array_equal(dec.numpy(), st["msgs"][0])


def test_port_ext_hints_decrypt_with_less_noise():
    """The port's own extended hints (its sampler, one hint pass over
    Q*P): the ext step decrypts to pt_mul and the ext linear key switch
    to the message under the new key, LSD and MSD, each with a noise
    budget strictly below the base-gadget builder's on the same inputs."""
    g, rng = prng.KeyChain(5), np.random.default_rng(5)
    bb, bb2 = BatchedBGV(PARAMS, "cpu"), BatchedBGV(DROPPED, "cpu")
    sk, sk_new = she.gen_sk(PARAMS, g(), "cpu"), she.gen_sk(PARAMS, g(), "cpu")
    sk2 = she.SK(DROPPED, sk.s_ints, sk.var)
    quad_ext = bb.gen_ks_quad_hint_ext(sk, SPECIAL, g())
    lin_ext = bb.gen_ks_linear_hint_ext(sk_new, sk, SPECIAL, g())
    assert quad_ext.h0.shape == (len(QS), len(ALL5), M // 2) and quad_ext.ext_qs == ALL5
    quad, lin = bb.gen_ks_quad_hint(sk, g()), bb.gen_ks_linear_hint(sk_new, sk, g())
    m1, m2 = she.pt_random(PARAMS, rng, (B,), "cpu"), she.pt_random(PARAMS, rng, (B,), "cpu")
    for encoding in ("lsd", "msd"):
        enc = bb.build_encrypt(sk, encoding)
        a, b = enc(m1, g()), enc(m2, g())
        f2 = bb.step_f(1, 1, encoding)
        ext = bb.build_step_ext(quad_ext, encoding)(*a, *b)
        base = bb.build_step(quad, encoding)(*a, *b)
        got = bb2.build_decrypt(sk2, f=f2, encoding=encoding)(*ext)
        for k in range(B):
            np.testing.assert_array_equal(got[:, k].numpy(),
                                          she.pt_mul(PARAMS, m1[:, k].numpy(), m2[:, k].numpy()))
        x = ext if encoding == "lsd" else bb2.build_to_lsd()(*ext)
        y = base if encoding == "lsd" else bb2.build_to_lsd()(*base)
        bits = bb2.build_noise_bits(sk2)
        assert float(bits(*x).mean()) < float(bits(*y).mean())
        ks_ext = bb.build_key_switch_linear_ext(lin_ext)(*a)
        ks = bb.build_key_switch_linear(lin)(*a)
        got = bb.build_decrypt(sk_new, encoding=encoding)(*ks_ext)
        np.testing.assert_array_equal(got.numpy(), m1.numpy())
        x = ks_ext if encoding == "lsd" else bb.build_to_lsd()(*ks_ext)
        y = ks if encoding == "lsd" else bb.build_to_lsd()(*ks)
        bits = bb.build_noise_bits(sk_new)
        assert float(bits(*x).mean()) < float(bits(*y).mean())


def test_ext_builders_refuse_a_hint_of_another_chain(st):
    h = st["quad"]
    for bad in (she.KSHintExt(PARAMS, (QS[1], QS[0], QS[2]) + SPECIAL, 2, h.h0, h.h1),
                she.KSHintExt(PARAMS, ALL5[:4], 1, h.h0, h.h1),
                she.KSHintExt(PARAMS, ALL5, 2, h.h0[:, :4], h.h1[:, :4])):
        with pytest.raises(ValueError, match="extend|shape"):
            BatchedBGV(PARAMS, "cpu").build_step_ext(bad)
    with pytest.raises(ValueError, match="another ring"):
        BatchedBGV(she.SHEParams(m=M, p=17, qs=QS, var=2.0), "cpu").build_key_switch_linear_ext(h)
