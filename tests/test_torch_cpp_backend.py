"""The port's C++ host backend (`lol_tpu_torch.tensor.cpp_backend`) against
the JAX package's (`lol_tpu.tensor.cpp_backend`) and against the port's
plain torch versions, on the same seeded inputs, bit for bit.

Every public function of the reference module is called in both: the Z_q
ops, the NTT both ways, the dense odd-axis transform, L, the g stencils
in both bases, the cross-ring index ops and both norms.  The port builds
its own copy of the source into `lol_tpu_torch/_build/`, never beside the
source, and refuses a tensor that lies on a card.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from lol_tpu import numtheory as jnt
from lol_tpu.ops import ntt as jntt
from lol_tpu.tensor import cpp_backend as jcpp
from lol_tpu_torch import numtheory as nt, ring, zq
from lol_tpu_torch.factored import fact
from lol_tpu_torch.ops import general as gen, ntt
from lol_tpu_torch.ring import ring_context
from lol_tpu_torch.tensor import cpp_backend as cpp

Q = nt.ntt_primes(8192, 30, 1)[0]


def _u32(t: torch.Tensor) -> np.ndarray:
    assert t.dtype == torch.int32
    return t.numpy().astype(np.uint32)


def _res(rng, q, shape) -> np.ndarray:
    x = rng.integers(0, q, shape).astype(np.uint32)
    x.flat[:3] = (0, 1, q - 1)
    return x


def _t(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x.astype(np.int64)).to(torch.int32)


def test_zq_ops(rng):
    a, b = _res(rng, Q, 1000), _res(rng, Q, 1000)
    for mine, ref, plain in ((cpp.zq_mul, jcpp.zq_mul, zq.mul_mod),
                             (cpp.zq_add, jcpp.zq_add, zq.add_mod)):
        got = _u32(mine(_t(a), _t(b), Q))
        np.testing.assert_array_equal(got, ref(a, b, Q))
        np.testing.assert_array_equal(got, plain(_t(a), _t(b), Q).numpy())


@pytest.mark.parametrize("n", [64, 1024])
def test_ntt_both_ways(n, rng):
    q = nt.ntt_primes(2 * n, 30, 1)[0]
    plan, jplan = ntt.ntt_plan(n, q), jntt.ntt_plan(n, q)
    x = _res(rng, q, (3, n))
    fwd, inv = cpp.ntt_forward(_t(x), plan), cpp.ntt_inverse(_t(x), plan)
    np.testing.assert_array_equal(_u32(fwd), jcpp.ntt_forward(x, jplan))
    np.testing.assert_array_equal(_u32(inv), jcpp.ntt_inverse(x, jplan))
    np.testing.assert_array_equal(_u32(fwd), _u32(ntt.ntt_forward_cm(_t(x).t(), plan).t()
                                                   .to(torch.int32)))
    np.testing.assert_array_equal(_u32(inv), _u32(ntt.ntt_inverse(_t(x), plan)))
    assert torch.equal(cpp.ntt_inverse(fwd, plan), _t(x))


@pytest.mark.parametrize("m,phi", [(9, 6), (17, 16), (None, 40)])
def test_axis_matvec(m, phi, rng):
    """The CRT matrix of an odd axis (phi 6: the int64 route; 16: the
    int8-limb route), and a random 40 x 40 (the every-16 lazy reduction)."""
    q = nt.ntt_primes(m, 30, 1)[0] if m else (1 << 30) - 35
    M = gen.general_plan(m, q).axes[0].M if m else _res(rng, q, (phi, phi))
    x = _res(rng, q, (5, phi))
    got = _u32(cpp.axis_matvec(M, _t(x), q))
    np.testing.assert_array_equal(got, jcpp.axis_matvec(M, x, q))
    np.testing.assert_array_equal(got, _u32(gen.matvec_mod(M, _t(x), q)))


@pytest.mark.parametrize("m,p,inner", [(9, 3, 3), (17, 17, 1), (25, 5, 5)])
def test_l_and_g(m, p, inner, rng):
    """L, L^-1 and the g stencils along a p^e axis, against the reference
    and the port's plain ones (the 17-axis's g ops on the int8-limb route)."""
    q = nt.ntt_primes(m, 30, 1)[0]
    plan = gen.general_plan(m, q)
    x = _res(rng, q, (4, fact(m).phi))
    plain = {"l_fwd": gen.l, "l_inv": gen.l_inv, "mul_g_pow": gen.mul_g_pow,
             "div_g_pow": gen.div_g_pow, "mul_g_dec": gen.mul_g_dec, "div_g_dec": gen.div_g_dec}
    for name, fn in plain.items():
        got = _u32(getattr(cpp, name)(_t(x), p, inner, q))
        np.testing.assert_array_equal(got, getattr(jcpp, name)(x, p, inner, q), err_msg=name)
        np.testing.assert_array_equal(got, _u32(fn(plan, _t(x))), err_msg=name)
    back = cpp.div_g_pow(cpp.mul_g_pow(_t(x), p, inner, q), p, inner, q)
    assert torch.equal(back, _t(x))


@pytest.mark.parametrize("m_sub,m_sup", [(16, 64), (12, 36), (6, 18)])
def test_cross_ring_index_ops(m_sub, m_sup, rng):
    q = nt.ntt_primes(int(np.lcm(m_sub, m_sup)), 30, 1)[0]
    xs, xS = _res(rng, q, (3, fact(m_sub).phi)), _res(rng, q, (3, fact(m_sup).phi))
    cases = (("embed_pow", xs, (q,), lambda v: gen.embed_pow(m_sub, m_sup, v)),
             ("twace_pow", xS, (q,), lambda v: gen.twace_pow(m_sub, m_sup, v)),
             ("embed_crt", xs, (q,), lambda v: gen.embed_crt(m_sub, m_sup, q, v)),
             ("twace_crt", xS, (q,), lambda v: gen.twace_crt(m_sub, m_sup, q, v)),
             ("coeffs_rel", xS, (), lambda v: gen.coeffs_rel(m_sub, m_sup, v)))
    for name, x, qa, fn in cases:
        got = _u32(getattr(cpp, name)(_t(x), m_sub, m_sup, *qa))
        np.testing.assert_array_equal(got, getattr(jcpp, name)(x, m_sub, m_sup, *qa),
                                      err_msg=name)
        np.testing.assert_array_equal(got, _u32(fn(_t(x)).to(torch.int32)), err_msg=name)


def test_norms(rng):
    """gsq_norm_pow2 (the raw sum of squared centred lifts) and gsq_norm_gram
    (x^T G x at general m) against the reference and the port's exact
    `ring.gsq_norm_dec` (n times the raw sum at 2-power m)."""
    n = 64
    x = _res(rng, Q, (2, n))
    np.testing.assert_array_equal(cpp.gsq_norm_pow2(_t(x), Q).numpy(), jcpp.gsq_norm_pow2(x, Q))
    x = (rng.integers(-1000, 1000, (2, n)) % Q).astype(np.uint32)  # float64-exact sums
    got = cpp.gsq_norm_pow2(_t(x), Q)
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(got.numpy(), jcpp.gsq_norm_pow2(x, Q))
    ctx = ring_context(2 * n, (Q,))
    want = ring.gsq_norm_dec(ctx, _t(x)[:, None, :])
    assert [int(v) * n for v in got.tolist()] == [int(v) for v in want]
    m = 36
    ctx = ring_context(m, tuple(jnt.ntt_primes(m, 30, 1)))
    lifted = rng.integers(-1000, 1000, (3, ctx.n))
    got = cpp.gsq_norm_gram(torch.from_numpy(lifted), m)
    np.testing.assert_array_equal(got.numpy(), jcpp.gsq_norm_gram(lifted, m))
    q = ctx.basis.qs[0]
    want = ring.gsq_norm_dec(ctx, _t(lifted % q)[:, None, :])
    assert [int(v) for v in got.tolist()] == [int(v) for v in want]


def test_host_backend_builds_apart_and_refuses_a_card_tensor():
    lib = cpp.library_path()
    cpp.zq_add(torch.zeros(4, dtype=torch.int32), torch.zeros(4, dtype=torch.int32), Q)
    pkg = Path(cpp.__file__).resolve().parents[1]
    assert lib.exists() and lib.parents[1] == pkg / "_build"
    assert not list((pkg / "native").glob("*.so"))

    class OnCard(torch.Tensor):  # a tensor that reports a card, without one
        @property
        def device(self):
            return torch.device("cuda", 0)

    x = torch.zeros(4, dtype=torch.int32).as_subclass(OnCard)
    with pytest.raises(ValueError, match="host backend"):
        cpp.zq_add(x, x, Q)
