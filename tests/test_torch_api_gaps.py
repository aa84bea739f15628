"""The names the port gained to match the JAX package's API, against their
JAX counterparts: `zq.Modulus` / `modulus`, the u32 forms (`mulhi32`,
`mul32_wide`, `mul_mod_shoup`, `mul_shoup_lazy`, lazy range included) on
edge words, the numpy mirrors, `Factored.value` / `coprime` / `gcd` /
`lcm`, `ops.ntt.ntt_forward` / `ntt_inverse` and their `_stages` names,
`RnsBasis.qs`, `RingContext.m`, `BatchedBGV.qs` / `ctx`,
`ntt_kernel.ntt_batched` and `she_batched.gd_gadget_rns`."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lol_tpu import factored as jfactored, she as jshe, zq as jzq
from lol_tpu.ops import ntt as jntt
from lol_tpu.she_batched import gd_gadget_rns as j_gd_gadget_rns
from lol_tpu_torch import factored, numtheory as nt, she, zq
from lol_tpu_torch.ops import ntt
from lol_tpu_torch.ops.cuda import ntt_kernel as tk
from lol_tpu_torch.she_batched import BatchedBGV, gd_gadget_rns

Q = nt.ntt_primes(1 << 12, 30, 1)[0]
EDGE = np.array([0, 1, 2, 0xFFFF, 0x10000, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFE, 0xFFFFFFFF,
                 Q - 1, Q, 2 * Q - 1, 123456789], dtype=np.uint32)


def _pairs():
    a, b = np.meshgrid(EDGE, EDGE)
    return a.ravel(), b.ravel()


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a.astype(np.int64))


def test_mulhi32_and_mul32_wide():
    a, b = _pairs()
    np.testing.assert_array_equal(zq.mulhi32(_t(a), _t(b)).numpy(),
                                  np.asarray(jzq.mulhi32(jnp.asarray(a), jnp.asarray(b))))
    hi, lo = zq.mul32_wide(_t(a), _t(b))
    jhi, jlo = jzq.mul32_wide(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi))
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))
    # int32 tensors holding u32 bits read the same words
    np.testing.assert_array_equal(zq.mulhi32(_t(a).to(torch.int32), _t(b).to(torch.int32)).numpy(),
                                  np.asarray(jhi))


@pytest.mark.parametrize("q", [Q, 12289, 257, 3])
def test_shoup_forms(q):
    a = EDGE
    w = np.array([0, 1, q - 1, q // 2, (q * 7) // 11], dtype=np.uint32)
    A, W = (x.ravel() for x in np.meshgrid(a, w))
    W_sh = zq.shoup_np(W, q)
    got = zq.mul_mod_shoup(_t(A), _t(W), _t(W_sh), q).numpy()
    np.testing.assert_array_equal(got, np.asarray(jzq.mul_mod_shoup(
        jnp.asarray(A), jnp.asarray(W), jnp.asarray(W_sh), q)))
    np.testing.assert_array_equal(got, A.astype(object) * W.astype(object) % q)
    hi, lo = W_sh >> 16, W_sh & 0xFFFF
    lazy = zq.mul_shoup_lazy(_t(A), _t(W), _t(hi), _t(lo), q).numpy()
    np.testing.assert_array_equal(lazy, np.asarray(jzq.mul_shoup_lazy(
        jnp.asarray(A), jnp.asarray(W), jnp.asarray(hi), jnp.asarray(lo), q)))
    assert lazy.min() >= 0 and lazy.max() < 2 * q
    np.testing.assert_array_equal(lazy % q, got)


def test_numpy_mirrors_and_modulus():
    rng = np.random.default_rng(0)
    A = rng.integers(0, Q, (7, 300)).astype(np.uint32)
    x = rng.integers(0, Q, (300, 5)).astype(np.uint32)
    np.testing.assert_array_equal(zq.np_matvec_mod(A, x, Q), jzq.np_matvec_mod(A, x, Q))
    np.testing.assert_array_equal(zq.np_mul_mod(A, A, Q), jzq.np_mul_mod(A, A, Q))
    for q in (Q, 12289, 257, 4, 2):
        mine, ref = zq.modulus(q), jzq.modulus(q)
        assert (mine.q, mine.mu, mine.is_prime, repr(mine)) == (ref.q, ref.mu, ref.is_prime, repr(ref))
        assert mine.has_crt(256) == ref.has_crt(256) and mine.has_crt(3) == ref.has_crt(3)
        if mine.is_prime and q > 2:
            assert mine.inv(2) == ref.inv(2)
    assert zq.modulus(Q).root_of_unity(1 << 12) == jzq.modulus(Q).root_of_unity(1 << 12)
    assert zq.modulus(Q) is zq.modulus(Q)
    for bad in (1, 1 << 30):
        with pytest.raises(ValueError):
            zq.Modulus(bad)


@pytest.mark.parametrize("a,b", [(12, 18), (8, 9), (1, 7), (36, 36), (18432, 9216)])
def test_factored_value_coprime_gcd_lcm(a, b):
    fa, fb, ja, jb = factored.fact(a), factored.fact(b), jfactored.fact(a), jfactored.fact(b)
    assert fa.value == ja.value == a
    assert fa.coprime(fb) == ja.coprime(jb)
    assert fa.gcd(fb).m == ja.gcd(jb).m and fa.lcm(fb).m == ja.lcm(jb).m
    assert fa.gcd(fb) == factored.fact(ja.gcd(jb).m)


@pytest.mark.parametrize("n", [1, 8, 256])
def test_row_major_ntt_forms(n):
    q = nt.ntt_primes(max(2 * n, 4), 30, 1)[0]
    plan, jplan = ntt.ntt_plan(n, q), jntt.ntt_plan(n, q)
    x = np.random.default_rng(n).integers(0, q, (2, 3, n)).astype(np.uint32)
    xt = torch.from_numpy(x.astype(np.int32))
    # the reference's ntt_forward / ntt_inverse are its _stages functions jitted
    for mine, stages, ref in ((ntt.ntt_forward, ntt.ntt_forward_stages, jntt.ntt_forward),
                              (ntt.ntt_inverse, ntt.ntt_inverse_stages, jntt.ntt_inverse)):
        got = mine(xt, plan)
        assert got.dtype == torch.int32 and got.shape == xt.shape
        np.testing.assert_array_equal(got.numpy().astype(np.uint32),
                                      np.asarray(ref(jnp.asarray(x), jplan)))
        assert torch.equal(stages(xt, plan), got)
    np.testing.assert_array_equal(tk.ntt_batched(xt, plan).numpy(), ntt.ntt_forward(xt, plan).numpy())
    np.testing.assert_array_equal(tk.ntt_batched(xt, plan, inverse=True).numpy(),
                                  ntt.ntt_inverse(xt, plan).numpy())


def test_context_attributes_and_gadget_table():
    m, qs = 64, tuple(nt.ntt_primes(64, 30, 3))
    params, jparams = she.SHEParams(m=m, p=257, qs=qs), jshe.SHEParams(m=m, p=257, qs=qs)
    assert params.ctx.m == jparams.ctx.m == m
    assert params.ctx.basis.qs == jparams.ctx.basis.qs == qs
    bb = BatchedBGV(params, "cpu")
    assert bb.qs == qs and bb.ctx == params.ctx
    np.testing.assert_array_equal(gd_gadget_rns(params.ctx.basis),
                                  j_gd_gadget_rns(jparams.ctx.basis))
