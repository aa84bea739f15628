"""The port's number theory, Z_q helpers and NTT against the JAX package.

Inputs come from a seeded numpy RNG and go through both packages; every
comparison is bit-exact equality (all arithmetic is exact mod q).  The
Pallas kernel runs in interpret mode, as the JAX package's own tests run
it on the CPU.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from lol_tpu import numtheory as jnt, zq as jzq
from lol_tpu.ops import ntt as jntt
from lol_tpu.ops.pallas import ntt_kernel as pk
from lol_tpu.she_batched import decompose_cm as j_decompose_cm
from lol_tpu_torch import numtheory as nt, zq
from lol_tpu_torch.ops import ntt
from lol_tpu_torch.ops.cuda import ntt_kernel as tk, remote_ntt as rn
from lol_tpu_torch.she_batched import decompose_cm

torch.set_num_threads(2)


@pytest.mark.parametrize("m,nbits,count", [
    (64, 30, 4), (512, 30, 3), (8192, 30, 2), (32768, 30, 3), (256, 29, 5),
])
def test_primes_and_roots_match_reference(m, nbits, count):
    qs = nt.ntt_primes(m, nbits, count)
    assert qs == jnt.ntt_primes(m, nbits, count)
    for q in qs:
        assert nt.primitive_root(q) == jnt.primitive_root(q)
        assert nt.principal_root_of_unity(m, q) == jnt.principal_root_of_unity(m, q)
    window = range(qs[-1] - 50, qs[-1] + 50)
    assert [nt.is_prime(v) for v in window] == [jnt.is_prime(v) for v in window]


@pytest.mark.parametrize("n", [1, 64, 1024, 4096])
def test_ntt_plan_tables_match_reference(n):
    q = nt.ntt_primes(max(2 * n, 4), 30, 1)[0]
    mine, ref = ntt.ntt_plan(n, q), jntt.ntt_plan(n, q)
    assert (mine.n, mine.q, mine.psi, mine.n_inv, mine.n_inv_sh) == (
        ref.n, ref.q, ref.psi, ref.n_inv, ref.n_inv_sh)
    for name in ("psi_rev", "psi_rev_sh", "ipsi_rev", "ipsi_rev_sh"):
        np.testing.assert_array_equal(getattr(mine, name), getattr(ref, name))
    np.testing.assert_array_equal(ntt.crt_output_exponents(n),
                                  jntt.crt_output_exponents(n))


@pytest.mark.parametrize("op", ["add", "sub", "neg", "mul", "reduce"])
def test_zq_plain_matches_reference_at_max_modulus(op, rng):
    q = nt.ntt_primes(2048, 30, 1)[0]  # the tight end of q < 2^30
    a = rng.integers(0, q, 4096, dtype=np.uint64).astype(np.uint32)
    b = rng.integers(0, q, 4096, dtype=np.uint64).astype(np.uint32)
    a[:3], b[:3] = [0, q - 1, 1], [q - 1, 0, q - 1]  # borrow / wrap edges
    ta, tb = torch.from_numpy(a.astype(np.int64)), torch.from_numpy(b.astype(np.int64))
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    mine, ref = {
        "add": (lambda: zq.add_mod(ta, tb, q), lambda: jzq.add_mod(ja, jb, q)),
        "sub": (lambda: zq.sub_mod(ta, tb, q), lambda: jzq.sub_mod(ja, jb, q)),
        "neg": (lambda: zq.neg_mod(ta, q), lambda: jzq.neg_mod(ja, q)),
        "mul": (lambda: zq.mul_mod(ta, tb, q), lambda: jzq.mul_mod(ja, jb, q)),
        "reduce": (lambda: zq.reduce_mod(ta, 12289), lambda: jzq.reduce_mod(ja, 12289)),
    }[op]
    np.testing.assert_array_equal(mine().numpy(), np.asarray(ref()).astype(np.int64))
    assert zq.barrett_mu(q) == jzq.barrett_mu(q)
    assert zq.shoup(int(a[5]), q) == jzq.shoup(int(a[5]), q)
    np.testing.assert_array_equal(zq.shoup_np(a, q), jzq.shoup_np(a, q))


@pytest.mark.parametrize("n", [64, 256, 1024])
@pytest.mark.parametrize("inverse", [False, True])
def test_ntt_cm_matches_pallas_interpret_and_numpy(n, inverse, rng):
    q = nt.ntt_primes(2 * n, 30, 1)[0]  # as close to 2^30 as the primes go
    plan = ntt.ntt_plan(n, q)
    B = 128
    a = rng.integers(0, q, (n, B), dtype=np.uint64).astype(np.uint32)
    a[0, :] = q - 1  # extremal residues
    got = tk.ntt_cm(torch.from_numpy(a.astype(np.int32)), plan, inverse=inverse)
    assert got.dtype == torch.int32 and got.shape == (n, B)
    pallas = pk.ntt_cm(jnp.asarray(a), jntt.ntt_plan(n, q), inverse=inverse,
                       interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(pallas).astype(np.int32))
    np_fn = jntt.np_ntt_inverse if inverse else jntt.np_ntt_forward
    np.testing.assert_array_equal(got.numpy(), np_fn(a.T, plan).T.astype(np.int32))
    # the port's own numpy mirror is the same map
    mine_np = ntt.np_ntt_inverse if inverse else ntt.np_ntt_forward
    np.testing.assert_array_equal(mine_np(a.T, plan), np_fn(a.T, plan))


@pytest.mark.parametrize("case", ["src_above_q", "src_below_q", "src_equals_q"])
def test_pre_digit_prologue_matches_pallas_interpret(case, rng):
    n, B = 256, 128
    q_hi, q_lo = nt.ntt_primes(2 * n, 30, 2)
    q_src, q = {"src_above_q": (q_hi, q_lo), "src_below_q": (q_lo, q_hi),
                "src_equals_q": (q_hi, q_hi)}[case]
    a = rng.integers(0, q_src, (n, B), dtype=np.uint64).astype(np.uint32)
    a[0, :] = q_src - 1  # centering branch
    a[1, :] = (q_src + 1) // 2  # first "high" residue
    a[2, :] = (q_src - 1) // 2  # last "low" residue
    got = tk.ntt_cm(torch.from_numpy(a.astype(np.int32)), ntt.ntt_plan(n, q),
                    pre_digit_q=q_src)
    want = pk.ntt_cm(jnp.asarray(a), jntt.ntt_plan(n, q), pre_digit_q=q_src,
                     interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(np.int32))
    r = tk.redigit(torch.from_numpy(a.astype(np.int32)), q_src, q)
    np.testing.assert_array_equal(
        r.numpy(), np.asarray(pk._redigit(jnp.asarray(a), q_src, q)).astype(np.int32))


def test_ntt_product_matches_schoolbook(rng):
    n = 256
    q = nt.ntt_primes(2 * n, 30, 1)[0]
    plan = ntt.ntt_plan(n, q)
    a = rng.integers(0, q, n, dtype=np.uint64).astype(np.uint32)
    b = rng.integers(0, q, n, dtype=np.uint64).astype(np.uint32)
    fa = tk.ntt_cm(torch.from_numpy(a.astype(np.int32))[:, None], plan)
    fb = tk.ntt_cm(torch.from_numpy(b.astype(np.int32))[:, None], plan)
    prod = (zq.mul_mod(fa, fb, q)).to(torch.int32)
    got = tk.ntt_cm(prod, plan, inverse=True)[:, 0]
    np.testing.assert_array_equal(
        got.numpy(), jntt.np_negacyclic_mul_schoolbook(a, b, q).astype(np.int32))


@pytest.mark.parametrize("n", [1, 2, 512])
def test_ntt_cm_round_trip_and_ragged_batch(n, rng):
    q = nt.ntt_primes(max(2 * n, 4), 30, 1)[0]
    plan = ntt.ntt_plan(n, q)
    a = torch.from_numpy(rng.integers(0, q, (n, 7)).astype(np.int32))
    back = tk.ntt_cm(tk.ntt_cm(a, plan), plan, inverse=True)
    assert torch.equal(back, a)


def test_ntt_cm_rejects_bad_arguments():
    plan = ntt.ntt_plan(64, nt.ntt_primes(128, 30, 1)[0])
    x = torch.zeros((64, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="n=32"):
        tk.ntt_cm(torch.zeros((32, 4), dtype=torch.int32), plan)
    with pytest.raises(ValueError, match="forward-only"):
        tk.ntt_cm(x, plan, inverse=True, pre_digit_q=12289)
    with pytest.raises(ValueError, match="int32"):
        tk.ntt_cm(x.long(), plan)
    with pytest.raises(ValueError, match="power of 2"):
        ntt.ntt_plan(48, 97)


@pytest.mark.parametrize("n", [1, 2, 256, 2048, 4096, 8192, 16384, 65536])
@pytest.mark.parametrize("sched", ["schedule", "cm_schedule"])
def test_kernel_schedule_covers_every_stage(n, sched):
    """The CUDA pass geometry, checked where the CPU can reach it: the
    passes' stages add up to log2(n), every sequence tile divides evenly,
    each block's shared memory fits the H100 and twiddle indices stay in
    the n-entry table.  For the forward / GS kernels: a kernel is built
    for each (L, TB), the round plan covers the pass's stages, each CTA's
    shared memory fits, a cluster is portable (<= 8 CTAs, G = 1) and holds
    the whole column tile, and the threads are whole warps."""
    passes = getattr(tk, sched)(n)
    assert sum(p.L.bit_length() - 1 for p in passes) == n.bit_length() - 1
    for p in passes:
        assert p.nseq % p.G == 0
        assert p.TB >= tk.MIN_COLS and p.L * p.G * p.TB <= tk.MAX_TILE_ELEMS * p.cluster
        assert p.L * p.nseq == n
        top = ((p.base0 + (p.nseq - 1) * p.base_step) << (p.L.bit_length() - 2)) \
            + (p.L // 2 - 1) if p.L > 1 else 0
        assert top < n
        if p.cluster == 1:
            assert (p.L, p.TB) in tk.KERNEL_TILES
        else:
            assert tk.CLUSTER[p.L] == p.cluster <= 8 and p.G == p.nseq == 1
            # the first round's stages reach every CTA: rows L/2 .. L/2^rs apart
            assert tk.rounds(p.L)[0] >= p.cluster.bit_length() - 1
        assert sum(tk.rounds(p.L)) == p.L.bit_length() - 1
        assert max(tk.rounds(p.L)) <= tk.MAX_ROUND
        assert len(tk.rounds(p.L)) == 1 or tk.rounds(p.L)[-1] >= 2
        assert 0 <= tk.kernel_smem_bytes(p) <= 4 * tk.MAX_TILE_ELEMS
        t = tk.kernel_threads(p)
        assert 32 <= t <= 1024 and t % 32 == 0
    assert len(getattr(tk, sched)(n)) == (1 if n <= 4096 or sched == "cm_schedule" and
                                          n in tk.CLUSTER else 2)


@pytest.mark.parametrize("n", [256, 4096, 8192, 16384, 65536])
def test_route_b_and_ring_schedules_are_pinned(n):
    """Route B runs ntt_cm's own schedule at n = 2^14 (one cluster pass,
    its block DFT over all n rows) and `schedule` elsewhere (one pass up
    to 4096, WINDOW-row blocks and a cross pass above); the ring's phase B
    runs ntt_cm's at base D + d: one pass up to 4096 rows, a cluster pass
    at 8192 and 16384, two passes above."""
    assert tk.dit_schedule(n) == (tk.cm_schedule if n == 16384 else tk.schedule)(n)
    assert tk._dit_block_rows(n) == (n if n <= 4096 or n == 16384 else 512)
    for D in (2, 4, 8):
        tS = n // D
        for d in (0, D - 1):
            if tS <= 4096:
                want = [tk.Pass(tS, 1, 1, 0, D + d, 0, 1, max(8, min(32, 32768 // tS)))]
            elif tS in tk.CLUSTER:
                want = [tk.Pass(tS, 1, 1, 0, D + d, 0, 1, 8, tS // 2048)]
            else:
                P = tS // 512
                want = [tk.Pass(P, 512, 512, 1, D + d, 0, 16384 // (P * 32), 32),
                        tk.Pass(512, P, 1, 512, (D + d) * P, 1, 1, 32)]
            assert rn.phase_b_passes(tS, D, d) == want


def _run_rounds(x, plan, passes, inverse, scale=True, fold=None):
    """A plain int64 run of the forward / GS kernels' register rounds
    (csrc/ntt_rounds.cuh `ntt_round`), in their order: for each pass, each
    round of `tk.rounds` (the inverse from the last), each unit of 2^rs
    rows row0 | m << LK, and each stage's twiddle index
    ((base0 + sq*base_step) << (A + s)) + (j << s) + grp; exact mod q.
    scale: the inverse ends with n^-1 (not so the ring's phase B').
    fold: `tk.scale_consts`' words (ninv, _, w0n, _), applied as the GS
    kernel applies them: global stage 0 (the last pass's stage A = s = 0)
    multiplies its sum by ninv and its difference by w0n in place of its
    twiddle, and a pass of no stages multiplies by ninv."""
    q = plan.q
    w = plan.tables("cpu")[2 if inverse else 0].long()
    x = x.long() % q
    B = x.shape[1]
    for p in passes:
        k = p.L.bit_length() - 1
        sq = torch.arange(p.nseq)
        rows = (torch.arange(p.L)[None, :] * p.elem_stride + sq[:, None] * p.seq_stride)
        y = x[rows]  # (nseq, L, B)
        plan_r = tk.rounds(p.L)
        starts = [sum(plan_r[:i]) for i in range(len(plan_r))]
        order = range(len(plan_r) - 1, -1, -1) if inverse else range(len(plan_r))
        for r in order:
            A, rs = starts[r], plan_r[r]
            LK = k - A - rs
            j = torch.arange(1 << A)[:, None, None]
            kk = torch.arange(1 << LK)[None, :, None]
            m = torch.arange(1 << rs)[None, None, :]
            idx = (j << (k - A)) | kk | (m << LK)  # (J, K, M)
            v = y[:, idx]  # (nseq, J, K, M, B)
            stages = range(rs - 1, -1, -1) if inverse else range(rs)
            for s in stages:
                h = (1 << rs) >> (s + 1)
                vv = v.reshape(p.nseq, 1 << A, 1 << LK, 1 << s, 2, h, B)
                t = (((p.base0 + sq * p.base_step)[:, None, None] << (A + s))
                     + (torch.arange(1 << A)[None, :, None] << s)
                     + torch.arange(1 << s)[None, None, :])
                wt = w[t].view(p.nseq, 1 << A, 1, 1 << s, 1, 1)
                a0, a1 = vv[:, :, :, :, 0], vv[:, :, :, :, 1]
                if inverse and fold is not None and p is passes[-1] and A == s == 0:
                    out = ((a0 + a1) * fold[0] % q, (a0 - a1) * fold[2] % q)
                elif inverse:
                    out = ((a0 + a1) % q, (a0 - a1) * wt % q)
                else:
                    out = ((a0 + a1 * wt) % q, (a0 - a1 * wt) % q)
                v = torch.stack(out, dim=4).reshape(v.shape)
            y[:, idx] = v
        x[rows] = y
    if inverse and fold is not None:
        return x * fold[0] % q if plan.n == 1 else x
    return x * plan.n_inv % q if inverse and scale else x


@pytest.mark.parametrize("n", [1, 2, 256, 4096, 16384])
@pytest.mark.parametrize("inverse", [False, True])
def test_register_rounds_equal_the_plain_networks(n, inverse, rng):
    """The rounds of ntt_fwd_pass / ntt_inv_pass, run plainly in their
    order over both schedules, equal ntt_forward_cm / ntt_inverse_cm and,
    at n <= 4096, the interpret-mode Pallas ntt_cm, bit for bit; n = 1
    (the m = 2 ring) is one round of no stages."""
    q = nt.ntt_primes(2 * n, 30, 1)[0]
    plan = ntt.ntt_plan(n, q)
    B = 128 if n <= 4096 else 8
    a = rng.integers(0, q, (n, B), dtype=np.uint64).astype(np.uint32)
    a[0, :] = q - 1
    x = torch.from_numpy(a.astype(np.int64))
    want = (ntt.ntt_inverse_cm if inverse else ntt.ntt_forward_cm)(x, plan)
    for sched in (tk.schedule(n), tk.cm_schedule(n)):
        got = _run_rounds(x, plan, sched[::-1] if inverse else sched, inverse)
        assert torch.equal(got, want)
    if n <= 4096:
        pallas = pk.ntt_cm(jnp.asarray(a), jntt.ntt_plan(n, q), inverse=inverse,
                           interpret=True)
        np.testing.assert_array_equal(want.numpy(), np.asarray(pallas).astype(np.int64))


@pytest.mark.parametrize("n", [1, 2, 256, 16384])
@pytest.mark.parametrize("factor", ["one", "q-1", "random"])
def test_register_rounds_fold_the_factor_into_stage_0(n, factor, rng):
    """The GS kernel's inverse with `ntt_cm`'s factor: `scale_consts`'
    words folded into global stage 0 (or the length-1 pass) as
    ntt_inv_pass folds them give the unscaled inverse times the factor mod
    q, over both schedules; so does the plain version, and a factor of 1
    keeps the constants the kernel always had."""
    q = nt.ntt_primes(2 * n, 30, 1)[0]
    plan = ntt.ntt_plan(n, q)
    f = {"one": 1, "q-1": q - 1, "random": int(rng.integers(2, q))}[factor]
    consts = tk.scale_consts(plan, f)
    ninv, ninv_sh, w0n, w0n_sh = consts
    assert ninv == plan.n_inv * f % q and w0n == int(plan.ipsi_rev[1 % n]) * ninv % q
    assert (ninv_sh, w0n_sh) == (zq.shoup(ninv, q), zq.shoup(w0n, q))
    assert tk.scale_consts(plan, f + q) == consts
    if f == 1:
        assert (ninv, ninv_sh) == (plan.n_inv, plan.n_inv_sh)
    B = 8
    a = rng.integers(0, q, (n, B), dtype=np.uint64).astype(np.uint32)
    a[0, :] = q - 1
    x = torch.from_numpy(a.astype(np.int64))
    want = ntt.ntt_inverse_cm(x, plan) * f % q
    for sched in (tk.schedule(n), tk.cm_schedule(n)):
        assert torch.equal(_run_rounds(x, plan, sched[::-1], True, fold=consts), want)
    x32 = x.to(torch.int32)
    assert torch.equal(tk.ntt_cm(x32, plan, inverse=True, factor=f).long(), want)
    assert torch.equal(tk.ntt_cm_ref(x32, plan, inverse=True, factor=f + q).long(), want)


def test_ntt_cm_refuses_a_factor_off_the_gs_inverse():
    plan = ntt.ntt_plan(64, nt.ntt_primes(128, 30, 1)[0])
    x = torch.zeros((64, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="GS inverse"):
        tk.ntt_cm(x, plan, factor=3)
    with pytest.raises(ValueError, match="GS inverse"):
        tk.ntt_cm(x, plan, inverse=True, alg="dit", factor=3)
    with pytest.raises(ValueError, match="last inverse pass"):
        tk.run_passes(x, plan, tk.cm_schedule(64), inverse=True, last=False, factor=3)
    assert torch.equal(tk.ntt_cm(x, plan, inverse=True, alg="dit", factor=1), x)


def _smem_words(p, A, rs, u, rank, m):
    """Word offset, in the shared memory of the CTA holding it, of word m
    of unit u (CTA `rank`) in the round of stages [A, A + rs) of pass p
    (csrc/ntt.cu `Tile` and `ntt_round`), and that CTA."""
    k = p.L.bit_length() - 1
    logc = p.cluster.bit_length() - 1
    lk, logu, logtb = k - A - rs, k - rs, p.TB.bit_length() - 1
    plan_r = tk.rounds(p.L)
    rows_cta = p.L >> logc
    pad = p.TB < 32 and len(plan_r) > 1
    row = (lambda i: i + (i >> plan_r[-1])) if pad else (lambda i: i)
    seq_words = (rows_cta + (rows_cta >> plan_r[-1] if pad else 0)) * p.TB
    c = u & (p.TB - 1)
    rest = ((u >> logtb) & ((1 << (logu - logc)) - 1)) | (rank << (logu - logc))
    g = u >> (logtb + logu - logc)
    j = rest >> lk
    r = (j << (k - A)) | (rest & ((1 << lk) - 1)) | (m << lk)
    return g * seq_words + row(r & (rows_cta - 1)) * p.TB + c, r // rows_cta


@pytest.mark.parametrize("n", [1 << k for k in range(5, 17)])
def test_round_exchanges_are_free_of_bank_conflicts(n):
    """Every warp's shared-memory access between two rounds (word m of 32
    consecutive units) touches 32 distinct banks, for every pass of both
    schedules: TB = 32 rows, and the padded TB = 8 / 16 tiles."""
    seen = set()
    for p in tk.schedule(n) + tk.cm_schedule(n):
        if (p.L, p.TB, p.G, p.cluster) in seen or len(tk.rounds(p.L)) == 1:
            continue
        seen.add((p.L, p.TB, p.G, p.cluster))
        plan_r = tk.rounds(p.L)
        units_cta = p.L * p.G * p.TB // p.cluster
        for r, rs in enumerate(plan_r):
            A = sum(plan_r[:r])
            for rank in range(p.cluster):
                for w0 in range(0, units_cta >> rs, 32):
                    for m in range(1 << rs):
                        addr = [_smem_words(p, A, rs, u, rank, m) for u in range(w0, w0 + 32)]
                        assert len({cta for _, cta in addr}) == 1
                        assert len({a % 32 for a, _ in addr}) == 32, (p, r, w0, m)


# the (n, D) of every ring-sharded transform chip_smoke.py runs (phases 2 and 3b)
SMOKE_RING = [(n, D) for n in (256, 4096, 16384, 65536) for D in (2, 4, 8) if n % (D * D) == 0]


def _ring_words(p, D, d, tS):
    """Every word that the first round (stages [0, RS)) of shard d's ring
    pass p reads (gather) or that the inverse's last round, the same round,
    writes (scatter), at column 0, as csrc/ntt_rounds.cuh `ntt_round` with
    csrc/remote_ntt.cu `RingIO` addresses it: for each sequence tile, CTA
    of the cluster, unit u and word m, its block row r, the shard e =
    m >> (RS - log2 D) the kernel takes statically, and the row of shard e
    it touches, r + (d - e)*C (the host's pointer shard[e] = peer[e] +
    (d - e)*C rows).  numpy arrays (r, e, row), one entry a word."""
    k, logd = p.L.bit_length() - 1, D.bit_length() - 1
    logc, logtb, logg = (v.bit_length() - 1 for v in (p.cluster, p.TB, p.G))
    rs = tk.rounds(p.L)[0]
    lk = logu = k - rs
    C = tS // D
    by = np.arange(p.nseq // p.G)[:, None, None, None]
    rank = np.arange(p.cluster)[None, :, None, None]
    u = np.arange(0, p.TB << (logu - logc + logg), p.TB)[None, None, :, None]  # column 0
    m = np.arange(1 << rs)[None, None, None, :]
    rest = ((u >> logtb) & ((1 << (logu - logc)) - 1)) | (rank << (logu - logc))
    g = u >> (logtb + logu - logc)
    j = rest >> lk
    row0 = (j << k) | (rest & ((1 << lk) - 1))
    sq = (by << logg) + g
    r = row0 * p.elem_stride + sq * p.seq_stride + (m << lk) * p.elem_stride
    e = np.broadcast_to(m >> (rs - logd), r.shape)
    return r.ravel(), e.ravel(), (r + (d - e) * C).ravel()


@pytest.mark.parametrize("n,D", SMOKE_RING)
def test_ring_passes_map_each_word_to_its_shard_statically(n, D):
    """For every phase-B pass that chip_smoke.py runs: the first round has
    at least log2 D stages; the geometry passes the host's checks
    (elem_stride * L = tS, (nseq - 1) * seq_stride < elem_stride); each
    word's static shard m >> (RS - log2 D) is its block row's, r >> log2 C;
    and shard d's gather reads, and its scatter writes, each of the rows
    d*C ... (d+1)*C - 1 of every shard exactly once."""
    tS, C = rn.check_ring(n, D)
    for d in range(D):
        p = rn.phase_b_passes(tS, D, d)[0]
        assert tk.rounds(p.L)[0] >= D.bit_length() - 1
        assert p.elem_stride * p.L == tS and (p.nseq - 1) * p.seq_stride < p.elem_stride
        r, e, row = _ring_words(p, D, d, tS)
        assert np.array_equal(e, r >> (C.bit_length() - 1))
        touched = np.sort(e * tS + row)
        want = (np.arange(D)[:, None] * tS + d * C + np.arange(C)[None, :]).ravel()
        assert np.array_equal(touched, want)


@pytest.mark.parametrize("n,D", [(256, 2), (256, 4), (256, 8), (4096, 8), (16384, 2),
                                 (16384, 4), (65536, 4)])
def test_gathered_and_scattered_rounds_equal_the_plain_ring_passes(n, D, rng):
    """A plain int64 run of the fused kernels: each shard's block gathered
    by `_ring_words` from every shard's lazy phase-A words (below 4q),
    then the rounds of its phase-B passes (`_run_rounds`), equals
    ntt_fwd_gather_ref; and the rounds of phase B' on residues, scattered
    by the same addresses into every shard's landing buffer, equal
    ntt_inv_scatter_ref (mod q)."""
    q = nt.ntt_primes(2 * n, 30, 1)[0]
    plan = ntt.ntt_plan(n, q)
    tS, C = rn.check_ring(n, D)
    B = 3
    lazy = rng.integers(0, 4 * q, (D, tS, B), dtype=np.int64)
    lazy[0, :3, 0] = [0, 1, 4 * q - 1]
    words = torch.from_numpy(lazy)
    want = rn.ntt_fwd_gather_ref([torch.from_numpy(v.astype(np.uint32).view(np.int32))
                                  for v in lazy], plan)
    res = torch.from_numpy(lazy % q)
    lands = torch.empty_like(res)
    for d in range(D):
        passes = rn.phase_b_passes(tS, D, d)
        r, e, row = (torch.from_numpy(np.ascontiguousarray(v)) for v in _ring_words(passes[0], D, d, tS))
        block = torch.empty((tS, B), dtype=torch.int64)
        block[r] = words[e, row]
        assert torch.equal(_run_rounds(block, plan, passes, inverse=False), want[d].long())
        out = _run_rounds(res[d], plan, passes[::-1], inverse=True, scale=False)
        lands[e, row] = out[r]
    scattered = rn.ntt_inv_scatter_ref([v.to(torch.int32) for v in res], plan)
    for got, ref in zip(lands, scattered):
        assert torch.equal(got % q, ref.long())


def test_decompose_cm_matches_reference(rng):
    qs = tuple(nt.ntt_primes(128, 30, 3))
    x = np.stack([rng.integers(0, q, (64, 5)) for q in qs]).astype(np.uint32)
    got = decompose_cm(qs, torch.from_numpy(x.astype(np.int32)))
    want = j_decompose_cm(qs, jnp.asarray(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(np.int32))
