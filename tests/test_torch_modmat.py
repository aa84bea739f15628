"""The int8-limb modular matrix product and its route, against the JAX
package's MXU route, on the CPU.

`lol_tpu_torch.ops.cuda.modmat` (`modmat_ref`, the plain version the
Hopper kernel `modmat_s8` is held to; `class_sums`; `modmat_small_ref`,
the plain version of the short-axis kernel `modmat_small`, and that
kernel's arithmetic emulated in numpy), `ops.general`'s
dispatch (`matvec_mod(use_mxu=)`, `MXU_MIN_AXIS`, `matvec_mod_mxu`), the
general-m transforms and the g ops at rings with a phi = 16 axis (m = 68
and 136), the general step at m = 68 on the port's keys and hints carried
into `lol_tpu.she_batched.BatchedBGV(use_pallas=False)` (its builders op by
op under `jax.disable_jit()`, where the reference's odd axis takes its MXU
route), and `bench.mxu_ntt`'s stage matrices and four-step NTT.  Inputs
from seeded numpy; every comparison is bit for bit.
"""

import functools

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
    """S_i == A_i @ Xbytes over exact Python ints, A_i[r, 4 c + j] = byte i
    of (M[r, c] 2^(8 j) mod q) and Xbytes[4 c + j] = byte j of x's words,
    each below 2^31, for a random stack and at b = 4096 with every entry
    q - 1; and the fold of the S_i is M @ x mod q."""
    rng = np.random.default_rng(q % 1000)
    nl = mm.limbs_needed(q)
    M = rng.integers(0, q, (2, 18, 42)).astype(np.uint32)  # a stack: one matrix a row
    x = rng.integers(0, q, (2, 42, 9)).astype(np.uint32)
    Mf, xf = np.full((1, 2, 4096), q - 1, np.uint32), np.full((1, 4096, 2), q - 1, np.uint32)
    for Mc, xc in ((M, x), (Mf, xf)):
        S = mm.class_sums(Mc, torch.from_numpy(xc.astype(np.int64)), q)
        assert len(S) == nl
        xb = np.array([[[(int(v) >> (8 * j)) & 0xFF for v in row] for row in xg for j in range(4)]
                       for xg in xc], dtype=object)  # (G, 4 b, N)
        for i, Si in enumerate(S):
            A = np.array([[[(((int(v) << (8 * j)) % q) >> (8 * i)) & 0xFF for v in row
                            for j in range(4)] for row in Mg] for Mg in Mc], dtype=object)
            want = np.stack([A[g] @ xb[g] for g in range(len(Mc))])
            np.testing.assert_array_equal(Si.numpy(), want.astype(np.int64))
            assert int(Si.max()) < 1 << 31
        np.testing.assert_array_equal(_u32(mm.fold(S, q)), np.stack(
            [(Mc[g].astype(object) @ xc[g].astype(object)) % q for g in range(len(Mc))]
        ).astype(np.uint32))


# ---------------------------------------------------------------------------
# the kernel's schedule, emulated in numpy
# ---------------------------------------------------------------------------

_LANE = np.arange(32)
_GID, _TIG = _LANE >> 2, _LANE & 3
_PI = np.where(_GID & 1, 4 + (_GID >> 1), _GID >> 1)  # a loader lane's 4-column group
_MASK = np.uint64(0xFFFFFFFF)


def _byte(w: np.ndarray, j: int) -> np.ndarray:
    return (w.astype(np.int64) >> (8 * j)) & 0xFF


def _emu_mma(af: np.ndarray, b0: np.ndarray, b1: np.ndarray) -> np.ndarray:
    """mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 on the lanes' words in
    the PTX fragment layouts, for each class's A (nl, 32, 4) against each
    virtual tile's two B registers (4, 32): the (nl, 4, 32, 4) C
    registers' addends."""
    A = np.zeros((af.shape[0], 16, 32), np.int64)
    B = np.zeros((b0.shape[0], 32, 8), np.int64)
    for reg in range(4):  # a0: row gid, k 4 tig + j; a1: row + 8; a2, a3: k + 16
        for j in range(4):
            A[:, _GID + 8 * (reg & 1), 4 * _TIG + j + 16 * (reg >> 1)] = _byte(af[..., reg], j)
    for reg, w in enumerate((b0, b1)):  # column gid, k 4 tig + j (+ 16)
        for j in range(4):
            B[:, 4 * _TIG + j + 16 * reg, _GID] = _byte(w, j)
    C = A[:, None] @ B[None]
    return np.stack([C[..., _GID + 8 * (i >> 1), 2 * _TIG + (i & 1)] for i in range(4)], -1)


def _emu_kernel(prep: mm.Prepared, x3: np.ndarray, q: int) -> np.ndarray:
    """csrc/modmat.cu's work items over x3 (G, b, N) u32 words, each as the
    kernel runs it: per chunk of 8 rows, lane (gid, tig)'s words of rows
    tig and 4 + tig at columns 4 pi(gid) + e (zero past b and N) as the B
    registers of virtual tile e, `prep.frag`'s A fragments, one mma a class
    and tile; the fold's 64-bit sum and its two Shoup products in u32; each
    accumulator stored where the kernel stores it."""
    G, b, N = x3.shape
    frag = prep.frag.numpy().view(np.uint32)
    RT, KS, nl = frag.shape[1:4]
    y = np.full((G, prep.a, N), 0xFFFFFFFF, np.uint32)
    w = np.array([pow(2, 8 * i, q) for i in range(nl)], np.uint64)
    q64, w32 = np.uint64(q), np.uint64((1 << 32) % q)
    w32sh, onesh = np.uint64((int(w32) << 32) // q), np.uint64((1 << 32) // q)
    for g in range(G):
        fg = frag[0 if prep.shared else g]
        for rt in range(RT):
            for cg in range(-(-N // 32)):
                acc = np.zeros((nl, 4, 32, 4), np.int64)
                for ks in range(KS):
                    xw = np.zeros((2, 4, 32), np.uint32)
                    for h in range(2):
                        for e in range(4):
                            r, c = 8 * ks + 4 * h + _TIG, 32 * cg + 4 * _PI + e
                            ok = (r < b) & (c < N)
                            xw[h, e][ok] = x3[g, r[ok], c[ok]]
                    acc += _emu_mma(fg[rt, ks], xw[0], xw[1])
                assert 0 <= acc.min() and acc.max() < 1 << 31
                t = sum(acc[i].astype(np.uint64) * w[i] for i in range(nl))  # < 2^63
                hi, lo = t >> np.uint64(32), t & _MASK
                res = (hi * w32 - ((hi * w32sh) >> np.uint64(32)) * q64) & _MASK
                res = (res + lo - ((lo * onesh) >> np.uint64(32)) * q64) & _MASK
                res = np.minimum(res, (res - 2 * q64) & _MASK)
                res = np.minimum(res, (res - q64) & _MASK)
                for e in range(4):
                    for r in range(4):
                        row = 16 * rt + _GID + 8 * (r >> 1)
                        col = 32 * cg + 16 * (r & 1) + 4 * _TIG + e
                        ok = (row < prep.a) & (col < N)
                        y[g, row[ok], col[ok]] = res[e, :, r][ok]
    return y


_EMU_BS, _EMU_AS, _EMU_G, _EMU_N = (6, 16, 33, 64), (16, 18), 2, 40


@functools.lru_cache(maxsize=None)
def _emu_reference(q: int):
    """The operands of every (b, a, shared / stacked) case at q, and the
    reference's `matvec_mod_mxu` on them, in one compiled call: each
    case's matrix is a block of rows of one (18 len(_EMU_BS), 64) matrix,
    zero past its b, whose rows 0-15 are the a = 16 case; the stack
    through `jax.vmap`."""
    rng = np.random.default_rng(q % 997)
    bmax, amax = max(_EMU_BS), max(_EMU_AS)
    M = np.zeros((_EMU_G, amax * len(_EMU_BS), bmax), np.uint32)  # [shared: 0, stacked]
    for v, b in enumerate(_EMU_BS):
        M[:, amax * v:amax * (v + 1), :b] = rng.integers(0, q, (_EMU_G, amax, b))
        M[:, amax * v, :2] = (0, q - 1)
    x = rng.integers(0, q, (_EMU_G, bmax, _EMU_N)).astype(np.uint32)
    x[0, :3, 0] = (0, 1, q - 1)
    shared, stacked = jax.jit(lambda M_, x_: (
        jgen.matvec_mod_mxu(M_[0], jnp.swapaxes(x_, 1, 2), q),
        jax.vmap(lambda m, v: jgen.matvec_mod_mxu(m, v.T, q))(M_, x_)))(M, x)
    return M, x, np.swapaxes(np.asarray(shared), 1, 2), np.swapaxes(np.asarray(stacked), 1, 2)


@pytest.mark.parametrize("stacked", [False, True])
@pytest.mark.parametrize("a", _EMU_AS)
@pytest.mark.parametrize("b", _EMU_BS)
@pytest.mark.parametrize("q", [251, 257, 65537, Q30])  # nl = 1, 2, 3, 4
def test_kernel_schedule_emulated_matches_the_reference(q, b, a, stacked):
    """The kernel's u8 m16n8k32 tiles over x's words read as little-endian
    bytes (k = 4 row + j), `_prepare`'s tables in the kernel's fragment
    order, its column order, ragged b and N (40 columns: a full tile and 8
    of 32) and its fold == the reference's matvec_mod_mxu bit for bit, for
    one shared matrix and a stack of two."""
    assert mm.limbs_needed(q) == [251, 257, 65537, Q30].index(q) + 1
    M, x, want_shared, want_stacked = _emu_reference(q)
    v = _EMU_BS.index(b)
    rows = slice(max(_EMU_AS) * v, max(_EMU_AS) * v + a)
    Mc = M[:, rows, :b] if stacked else M[0, rows, :b]
    Mc.flags.writeable = False
    want = (want_stacked if stacked else want_shared)[:, rows]
    prep = mm._prepare(Mc, q, torch.device("cpu"))
    assert prep.frag.shape == (_EMU_G if stacked else 1, -(-a // 16), -(-b // 8), prep.nl, 32, 4)
    np.testing.assert_array_equal(_emu_kernel(prep, x[:, :b], q), want)
    np.testing.assert_array_equal(_u32(mm.modmat_ref(Mc, torch.from_numpy(x[:, :b].astype(
        np.int64)), q, 1)), want)


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


# ---------------------------------------------------------------------------
# the short axes: modmat_small's plain version and its arithmetic
# ---------------------------------------------------------------------------

_SMALL_SHAPES = [(2, 2), (4, 4), (6, 6), (10, 10), (12, 12), (15, 40), (6, 3)]
_Q18432 = tuple(nt.ntt_primes(18432, 30, 3))  # bgv_m18432's chain


@functools.lru_cache(maxsize=None)
def _small_case(a: int, b: int):
    """M (a, b), x (4, 5, b) at Q30 (0, 1 and q - 1 planted), and the
    reference's matvec_mod_jnp below the int8-limb route on them."""
    M, x = _operands(Q30, a, b, (4, 5), 7 * a + b)
    want = jax.jit(lambda M_, x_: jgen.matvec_mod_jnp(M_, x_, Q30, use_mxu=False))(M, x)
    return M, x, np.asarray(want)


@pytest.mark.parametrize("axis", [0, 1, 2])
@pytest.mark.parametrize("a,b", _SMALL_SHAPES)
def test_small_route_matches_the_exact_product_and_the_reference(a, b, axis):
    """modmat_small_ref, modmat_small and matvec_mod(use_mxu=None) on the
    CPU == the exact object-integer product == the reference's
    matvec_mod_jnp (use_mxu=False), with b moved to the first, the middle
    and the last axis; x is not written."""
    M, x, want = _small_case(a, b)
    exact = (x.astype(object) @ M.T.astype(object)) % Q30
    np.testing.assert_array_equal(want, exact.astype(np.uint32))
    xt = torch.from_numpy(np.moveaxis(x, -1, axis).astype(np.int64))
    before = xt.clone()
    for fn in (mm.modmat_small_ref, mm.modmat_small, gen.matvec_mod):
        got = fn(M, xt, Q30, axis)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(np.moveaxis(_u32(got), axis, -1), want, err_msg=fn.__name__)
    assert torch.equal(xt, before)


def _umulhi64(t: np.ndarray, mu: int) -> np.ndarray:
    """The high 64 bits of t mu for u64 t, from 32-bit halves (numpy wraps
    mod 2^64), as __umul64hi computes them."""
    m32 = np.uint64(0xFFFFFFFF)
    s32 = np.uint64(32)
    t0, t1 = t & m32, t >> s32
    m0, m1 = np.uint64(mu & 0xFFFFFFFF), np.uint64(mu >> 32)
    lo, mid0, mid1 = t0 * m0, t1 * m0, t0 * m1
    carry = ((lo >> s32) + (mid0 & m32) + (mid1 & m32)) >> s32
    return t1 * m1 + (mid0 >> s32) + (mid1 >> s32) + carry


def _emu_small(M: np.ndarray, x3: np.ndarray, q: int) -> np.ndarray:
    """csrc/modmat_small.cu's arithmetic over x3 (pre, b, post) u32 words:
    each output's products of M's words (read from `small_words`' table)
    summed in a u64, SMALL_TERMS at a time, each sum reduced by the 64-bit
    Barrett step with the table's mu (qhat = umulhi64(t, mu), r = t -
    qhat q in u32, one conditional subtraction) and carried into the
    next."""
    words = mm.small_words(M, q)
    qw, mu = int(words[0]), int(words[1]) | int(words[2]) << 32
    a, b = M.shape
    Mw = words[4:].reshape(a, b).astype(np.uint64)
    xs = x3.astype(np.uint64)
    y = np.empty((x3.shape[0], a, x3.shape[2]), np.uint32)

    def reduce(t):
        assert t.dtype == np.uint64
        r = (t.astype(np.uint32) - (_umulhi64(t, mu).astype(np.uint32) * np.uint32(qw)))
        assert int(r.max()) < 2 * qw
        return np.where(r >= qw, r - np.uint32(qw), r)

    for i in range(a):
        acc = np.zeros((x3.shape[0], x3.shape[2]), np.uint64)
        for j0 in range(0, b, mm.SMALL_TERMS):
            for j in range(j0, min(b, j0 + mm.SMALL_TERMS)):
                acc = acc + Mw[i, j] * xs[:, j]
            if j0 + mm.SMALL_TERMS < b:
                acc = reduce(acc).astype(np.uint64)
        y[:, i] = reduce(acc)
    return y


@pytest.mark.parametrize("q", [(1 << 30) - 1, *_Q18432, Q8])
def test_small_kernel_arithmetic_emulated_matches_the_twin(q):
    """The kernel's u64 sums of at most 15 products and its 64-bit
    Barrett reduction with the host's constants == modmat_small_ref, at a
    q just under 2^30, bgv_m18432's three primes and 257: random operands
    at phi = 6 and the non-square (15, 40) and (6, 3), and every entry
    q - 1 at b = 15 and 40, where the sums come nearest 2^64."""
    rng = np.random.default_rng(q % 9973)
    cases = [(rng.integers(0, q, (a, b)).astype(np.uint32),
              rng.integers(0, q, (3, b, 8)).astype(np.uint32)) for a, b in ((6, 6), (15, 40), (6, 3))]
    cases += [(np.full((a, b), q - 1, np.uint32), np.full((2, b, 4), q - 1, np.uint32))
              for a, b in ((6, 15), (15, 40))]
    for M, x3 in cases:
        want = _u32(mm.modmat_small_ref(M, torch.from_numpy(x3.astype(np.int64)), q, 1))
        np.testing.assert_array_equal(_emu_small(M, x3, q), want, err_msg=str(M.shape))


@pytest.mark.parametrize("b", [15, 40])
def test_small_route_at_the_extremes(b):
    """M = x = q - 1 at b = 15 (one u64 sum) and 40 (three): the twin ==
    the exact product == the reference's route, and 0 everywhere at 0."""
    q = (1 << 30) - 1
    for v in (q - 1, 0):
        M, x = np.full((15, b), v, np.uint32), np.full((3, b), v, np.uint32)
        got = _u32(mm.modmat_small(M, torch.from_numpy(x.astype(np.int64)), q))
        np.testing.assert_array_equal(got, (x.astype(object) @ M.T.astype(object)) % q)
        np.testing.assert_array_equal(got, np.asarray(
            jgen.matvec_mod_jnp(jnp.asarray(M), jnp.asarray(x), q, use_mxu=False)))


@pytest.mark.parametrize("m", [20, 28, 44, 52, 72, 105])
def test_crt_on_small_odd_axes_matches_the_reference(m):
    """crt_cm and its inverse on rings whose odd axes all lie below
    MXU_MIN_AXIS, the short-axis route in both packages: m = 4 5, 4 7,
    4 11, 4 13 (phi 4, 6, 10, 12 beside the 2-power axis), 8 9 and the
    odd 3 5 7 (three axes, phi 2, 4, 6, no 2-power axis) == the
    reference's crt_cm (both in one compiled program)."""
    q = nt.ntt_primes(m, 30, 1)[0]
    plan, jplan = gen.general_plan(m, q), jgen.general_plan(m, q)
    assert all(ax.phi < gen.MXU_MIN_AXIS for ax in plan.axes if ax.ntt2 is None)
    x = np.random.default_rng(m).integers(0, q, (plan.fm.phi, 5)).astype(np.uint32)
    x[0, 0], x[-1, -1] = q - 1, 0
    xt = torch.from_numpy(x.astype(np.int32))
    want = jax.jit(lambda v: [jgen.crt_cm(jplan, v, inverse=i) for i in (False, True)])(
        jnp.asarray(x))
    for inverse, w in zip((False, True), want):
        np.testing.assert_array_equal(_u32(gen.crt_cm(plan, xt, inverse=inverse)), np.asarray(w),
                                      err_msg=f"inverse={inverse}")


@pytest.mark.parametrize("m", [68, 136, 76, 900, 323])
def test_crt_and_g_ops_on_a_phi16_axis_match_the_reference(m):
    """crt_cm / its inverse and the six g ops on rings whose last odd axis
    (phi >= 16) takes the int8-limb route in both packages (the
    reference's eight in one compiled program): m = 4 17 and 8 17 (the
    17-axis, phi = 16), 4 19 (phi = 18), 4 9 25 (the 25-axis, phi = 20,
    beside a phi = 6 axis on the int64 route) and 17 19 (two such axes).
    The 2-power axes of the first four run the plan `axis_plan` builds at
    the axis root (`ntt_plan(n2, q, psi=w)`)."""
    q = nt.ntt_primes(m, 30, 1)[0]
    plan, jplan = gen.general_plan(m, q), jgen.general_plan(m, q)
    n = plan.fm.phi
    assert plan.phi_shape[-1] >= gen.MXU_MIN_AXIS
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
