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
from lol_tpu_torch.ops.cuda import ntt_kernel as tk
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


@pytest.mark.parametrize("n", [256, 2048, 4096, 8192, 16384, 65536])
def test_kernel_schedule_covers_every_stage(n):
    """The CUDA pass geometry, checked where the CPU can reach it: the
    passes' stages add up to log2(n), every sequence tile divides evenly,
    each block's shared memory fits the H100 and twiddle indices stay in
    the n-entry table."""
    passes = tk.schedule(n)
    assert sum(p.L.bit_length() - 1 for p in passes) == n.bit_length() - 1
    for p in passes:
        assert p.nseq % p.G == 0
        assert p.TB >= tk.MIN_COLS and p.L * p.G * p.TB <= tk.MAX_TILE_ELEMS
        assert p.L * p.nseq == n
        top = ((p.base0 + (p.nseq - 1) * p.base_step) << (p.L.bit_length() - 2)) \
            + (p.L // 2 - 1) if p.L > 1 else 0
        assert top < n
        assert 32 <= p.threads <= 1024 and p.threads % 32 == 0


def test_decompose_cm_matches_reference(rng):
    qs = tuple(nt.ntt_primes(128, 30, 3))
    x = np.stack([rng.integers(0, q, (64, 5)) for q in qs]).astype(np.uint32)
    got = decompose_cm(qs, torch.from_numpy(x.astype(np.int32)))
    want = j_decompose_cm(qs, jnp.asarray(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(np.int32))
