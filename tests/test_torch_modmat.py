"""The int8-limb modular matrix product and its route, against the JAX
package's MXU route, on the CPU.

`lol_tpu_torch.ops.cuda.modmat` (`modmat_ref`, the plain version the
Hopper kernel `modmat_s8` is held to; `class_sums`), `ops.general`'s
dispatch (`matvec_mod(use_mxu=)`, `MXU_MIN_AXIS`, `matvec_mod_mxu`), the
general-m transforms and the g ops at rings with a phi = 16 axis (m = 68
and 136), the general step at m = 68 on the port's keys and hints carried
into `lol_tpu.she_batched.BatchedBGV(use_pallas=False)` (its builders op by
op under `jax.disable_jit()`, where the reference's odd axis takes its MXU
route), and `bench.mxu_ntt`'s stage matrices and four-step NTT.  Inputs
from seeded numpy; every comparison is bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lol_tpu import gadget as jgd
from lol_tpu import she as jshe
from lol_tpu.bench import mxu_ntt as jmx
from lol_tpu.cyc import Cyc as JCyc, Rep as JRep
from lol_tpu.ops import general as jgen
from lol_tpu.ops import ntt as jntt
from lol_tpu.she_batched import BatchedBGV as JBatchedBGV
from lol_tpu_torch import numtheory as nt, prng, she
from lol_tpu_torch.bench import mxu_ntt as mx
from lol_tpu_torch.ops import general as gen, ntt
from lol_tpu_torch.ops.cuda import modmat as mm
from lol_tpu_torch.she_batched import BatchedBGV

torch.set_num_threads(2)

Q30 = nt.ntt_primes(1 << 12, 30, 1)[0]
Q8 = 257  # one limb


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().astype(np.uint32)


def _operands(q, a, b, lead, seed):
    rng = np.random.default_rng(seed)
    M = rng.integers(0, q, (a, b)).astype(np.uint32)
    x = rng.integers(0, q, (*lead, b)).astype(np.uint32)
    M[0], M[1, :2], x.flat[:3] = q - 1, 0, (0, 1, q - 1)
    return M, x


@pytest.mark.parametrize("q", [Q30, Q8])
@pytest.mark.parametrize("b", [6, 16, 18, 42, 64])
def test_mxu_route_matches_the_reference(q, b):
    """modmat_ref / matvec_mod_mxu == the reference's matvec_mod_mxu ==
    its VPU route, over the last axis and moved to axes 0 and 1."""
    M, x = _operands(q, max(b, 16) if b % 2 else b, b, (3, 5), b * 31 + q % 97)
    want, vpu = (np.asarray(r) for r in jax.jit(lambda M_, x_: (
        jgen.matvec_mod_mxu(M_, x_, q), jgen.matvec_mod_jnp(M_, x_, q, use_mxu=False)))(M, x))
    np.testing.assert_array_equal(want, vpu)
    xt = torch.from_numpy(x.astype(np.int64))
    for got in (mm.modmat_ref(M, xt, q), gen.matvec_mod_mxu(M, xt, q),
                gen.matvec_mod(M, xt, q, use_mxu=True), gen.matvec_mod(M, xt, q, use_mxu=False)):
        np.testing.assert_array_equal(_u32(got), want)
    for axis in (0, 1):
        got = mm.modmat_ref(M, torch.from_numpy(np.moveaxis(x, -1, axis).astype(np.int64)), q, axis)
        np.testing.assert_array_equal(np.moveaxis(_u32(got), axis, -1), want)


@pytest.mark.parametrize("fill", ["zero", "q-1"])
def test_mxu_route_at_the_extremes(fill):
    q, b = Q30, 64
    v = 0 if fill == "zero" else q - 1
    M, x = np.full((16, b), v, np.uint32), np.full((4, b), v, np.uint32)
    want = np.asarray(jgen.matvec_mod_mxu(jnp.asarray(M), jnp.asarray(x), q))
    np.testing.assert_array_equal(_u32(mm.modmat_ref(M, torch.from_numpy(x), q)), want)
    np.testing.assert_array_equal(want, (M.astype(object) @ x.T.astype(object)).T % q)


@pytest.mark.parametrize("q", [Q30, 65537, Q8])
def test_class_sums_are_the_raw_limb_products(q):
    """S_k == sum over i + j = k of (raw limb i of M) @ (raw limb j of x),
    exactly, and the fold of the S_k is M @ x mod q."""
    rng = np.random.default_rng(q % 1000)
    M = rng.integers(0, q, (2, 18, 42)).astype(np.uint32)  # a stack: one matrix a row
    x = rng.integers(0, q, (2, 42, 9)).astype(np.uint32)
    nl = mm.limbs_needed(q)
    S = mm.class_sums(M, torch.from_numpy(x.astype(np.int64)), q)
    assert len(S) == 2 * nl - 1
    limb = lambda a, i: (a.astype(np.int64) >> (8 * i)) & 0xFF  # noqa: E731
    for k, Sk in enumerate(S):
        want = sum(limb(M, i) @ limb(x, k - i) for i in range(nl) if 0 <= k - i < nl)
        np.testing.assert_array_equal(Sk.numpy(), want)
        assert int(Sk.max()) < 1 << 31
    np.testing.assert_array_equal(_u32(mm.fold(S, q)), np.stack(
        [(M[g].astype(object) @ x[g].astype(object)) % q for g in range(2)]).astype(np.uint32))


def test_route_choice_matches_the_reference(monkeypatch):
    """use_mxu=None takes the int8-limb route exactly where the reference's
    matvec_mod_jnp does (traced, not run): min(a, b) >= MXU_MIN_AXIS (16)."""
    assert gen.MXU_MIN_AXIS == jgen.MXU_MIN_AXIS == 16
    mine, ref = [], []
    real_mm, real_jmx = gen.modmat_s8, jgen.matvec_mod_mxu
    monkeypatch.setattr(gen, "modmat_s8", lambda *a: mine.append(1) or real_mm(*a))
    monkeypatch.setattr(jgen, "matvec_mod_mxu", lambda *a: ref.append(1) or real_jmx(*a))
    for a, b in ((15, 16), (16, 15), (16, 16), (6, 6), (18, 42), (42, 18), (15, 40)):
        M, x = _operands(Q30, a, b, (2,), a * b)
        mine.clear(), ref.clear()
        got = gen.matvec_mod(M, torch.from_numpy(x), Q30)
        jax.eval_shape(lambda M_, x_: jgen.matvec_mod_jnp(M_, x_, Q30), M, x)
        assert len(mine) == len(ref) == int(min(a, b) >= 16), (a, b)
        np.testing.assert_array_equal(_u32(got), (M.astype(object) @ x.T.astype(object)).T % Q30)


@pytest.mark.parametrize("m", [68, 136])
def test_crt_and_g_ops_on_a_phi16_axis_match_the_reference(m):
    """crt_cm / its inverse and the six g ops at m = 4 17 and 8 17, whose
    17-axis (phi = 16) takes the int8-limb route in both packages (the
    reference's eight in one compiled program)."""
    q = nt.ntt_primes(m, 30, 1)[0]
    plan, jplan = gen.general_plan(m, q), jgen.general_plan(m, q)
    n = plan.fm.phi
    assert plan.phi_shape[-1] == 16
    rng = np.random.default_rng(m)
    x = rng.integers(0, q, (n, 3)).astype(np.uint32)
    xt = torch.from_numpy(x.astype(np.int64)).to(torch.int32)
    g_ops = ("mul_g_pow", "div_g_pow", "mul_g_dec", "div_g_dec", "mul_g_crt", "div_g_crt")
    want = jax.jit(lambda v: [jgen.crt_cm(jplan, v, inverse=i) for i in (False, True)]
                   + [getattr(jgen, op)(jplan, v.T) for op in g_ops])(jnp.asarray(x))
    got = [gen.crt_cm(plan, xt, inverse=i) for i in (False, True)]
    got += [getattr(gen, op)(plan, xt.t()) for op in g_ops]
    for name, a, b in zip(("crt_cm", "crt_cm inverse", *g_ops), got, want):
        np.testing.assert_array_equal(_u32(a), np.asarray(b), err_msg=name)


@pytest.mark.parametrize("encoding", ["lsd", "msd"])
def test_general_step_at_m68_matches_the_reference(encoding):
    """The step at m = 68 (the 17-axis on the int8-limb route), B = 4, on
    the port's key, hint and ciphertexts carried into the reference."""
    m, p, B = 68, 257, 4
    params = she.SHEParams(m=m, p=p, qs=tuple(nt.ntt_primes(m, 30, 3)), var=2.0)
    g, rng = prng.KeyChain(m), np.random.default_rng(m)
    sk = she.gen_sk(params, g(), "cpu")
    bb = BatchedBGV(params, "cpu")
    hint = bb.gen_ks_quad_hint(sk, g())
    enc = bb.build_encrypt(sk, encoding)
    m1, m2 = she.pt_random(params, rng, (B,), "cpu"), she.pt_random(params, rng, (B,), "cpu")
    cts = (*enc(m1, g()), *enc(m2, g()))
    got = bb.build_step(hint, encoding=encoding)(*cts)
    jp = jshe.SHEParams(m=m, p=p, qs=params.qs, var=2.0)
    jhint = jshe.KSHint(jp, jp.ctx, jgd.RnsGad(), *(
        tuple(JCyc(jp.ctx, JRep.CRT, jnp.asarray(_u32(t[j]))) for j in range(t.shape[0]))
        for t in (hint.h0, hint.h1)))
    with jax.disable_jit():
        want = JBatchedBGV(jp, use_pallas=False).build_step(jhint, encoding=encoding)(
            *(jnp.asarray(_u32(c)) for c in cts))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(_u32(a), np.asarray(b))
    p2 = she.SHEParams(m=m, p=p, qs=params.qs[:-1], var=2.0)
    dec = BatchedBGV(p2, "cpu").build_decrypt(she.SK(p2, sk.s_ints, sk.var),
                                              f=bb.step_f(1, 1, encoding), encoding=encoding)
    for k in range(B):
        np.testing.assert_array_equal(dec(*got)[:, k].numpy(),
                                      she.pt_mul(params, m1[:, k].numpy(), m2[:, k].numpy()))


def test_stage_matrices_and_mxu_ntt_match_the_reference():
    n, P = 256, 16
    q = nt.ntt_primes(2 * n, 30, 1)[0]
    plan, jplan = ntt.ntt_plan(n, q), jntt.ntt_plan(n, q)
    for mine, ref in zip(mx.stage_matrices(plan, P), jmx.stage_matrices(jplan, P)):
        np.testing.assert_array_equal(mine, ref)
    x = np.random.default_rng(n).integers(0, q, (n, 8)).astype(np.uint32)
    x[0, 0], x[1, 0] = q - 1, 0
    want = np.asarray(jax.jit(lambda v: jmx.mxu_ntt(v, jplan, P))(jnp.asarray(x)))
    np.testing.assert_array_equal(want, jntt.np_ntt_forward(x.T, jplan).T)
    np.testing.assert_array_equal(_u32(mx.mxu_ntt(torch.from_numpy(x.astype(np.int32)), plan, P)),
                                  want)


def test_modmat_refuses_what_the_reference_refuses():
    M = np.zeros((16, 4097), np.uint32)
    with pytest.raises(ValueError, match="4096"):
        mm.modmat_ref(M, torch.zeros((2, 4097), dtype=torch.int32), Q30)
    with pytest.raises(ValueError, match="axis"):
        mm.modmat_s8(np.zeros((16, 16), np.uint32), torch.zeros((2, 15), dtype=torch.int32), Q30)
