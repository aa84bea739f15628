"""The port's route-B inverse NTT (`ntt_cm(..., inverse=True, alg="dit")`)
against the JAX package.

Its tables must equal the reference's `_invb_tables` table for table, and
on the CPU its plain version (block DFT, twist, cross DFT, scale) must
equal the Pallas route B in interpret mode, the numpy inverse and the
port's own GS inverse, bit for bit; so must a plain run of the kernel's
register rounds (`_run_invb_rounds`).  Interpret-mode calls stay at
n <= 4096; larger n are held against numpy alone.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lol_tpu.ops import ntt as jntt
from lol_tpu.ops.pallas import ntt_kernel as pk
from lol_tpu_torch import numtheory as nt
from lol_tpu_torch.ops import ntt
from lol_tpu_torch.ops.cuda import ntt_kernel as tk

torch.set_num_threads(2)


def _split_cases():
    """(n, tS): the port's own split at each n, and the reference's
    default route-B windows (64 at 2048 <= n <= 4096, else 512)."""
    cases = []
    for n in (2, 256, 2048, 4096, 8192, 16384):
        cases.append((n, tk._dit_block_rows(n)))
        cases.append((n, min(n, 64 if 2048 <= n <= 4096 else 512)))
    return sorted(set(cases))


@pytest.mark.parametrize("n,tS", _split_cases())
def test_invb_tables_match_reference(n, tS):
    q = nt.ntt_primes(2 * n, 30, 1)[0]
    plan, jplan = ntt.ntt_plan(n, q), jntt.ntt_plan(n, q)
    k, S, got_tS = ntt.split(n, tS)
    assert (k, S, got_tS) == pk._split(n, tS)
    for mine, ref in zip(ntt.invb_tables(plan, S, tS), pk._invb_tables(jplan, S, tS)):
        assert (mine is None) == (ref is None)
        if ref is not None:
            assert mine.dtype == ref.dtype
            np.testing.assert_array_equal(mine, ref)
    root = pow(pow(int(plan.psi), -2, q), n // tS, q)
    np.testing.assert_array_equal(ntt.stage_table_bitrev(root, tS, q),
                                  pk._stage_table_bitrev(root, tS, q))
    np.testing.assert_array_equal(ntt.pow_seq(root, 9, q, start=5),
                                  pk._pow_seq(root, 9, q, start=5))


def _run_invb_rounds(x, plan):
    """A plain int64 run of ntt_invb_pass's register rounds (csrc/
    ntt_rounds.cuh `ntt_round`, Net::INVB) over `tk.dit_schedule`, in
    their order: for each pass, the block pass (table "blk", then the
    twist or, alone, the scale) and the cross pass ("cross", the scale),
    each round of `tk.rounds` from the last, each unit of 2^rs rows
    row0 | m << LK, its stages from s = rs - 1 down with the DIT butterfly
    and the twiddle at entry (s_b << log2 L) + ((h + i) << LK) + k of the
    packed table (s_b = LK + rs - 1 - s, i = m mod h), and in the last
    round the per-row multiplier of each word's (n, B) row; exact mod q."""
    n, q = plan.n, plan.q
    passes = tk.dit_schedule(n)[::-1]
    tab = plan.dit_tables(tk._dit_block_rows(n), "cpu")
    x = x.long() % q
    B = x.shape[1]
    for i, p in enumerate(passes):
        table = tab[("blk", "cross")[i]].long()
        post = tab["scale" if i == len(passes) - 1 else "twist"].long()
        k = p.L.bit_length() - 1
        sq = torch.arange(p.nseq)
        rows = (torch.arange(p.L)[None, :] * p.elem_stride + sq[:, None] * p.seq_stride)
        y = x[rows]  # (nseq, L, B)
        plan_r = tk.rounds(p.L)
        starts = [sum(plan_r[:r]) for r in range(len(plan_r))]
        for r in range(len(plan_r) - 1, -1, -1):
            A, rs = starts[r], plan_r[r]
            LK = k - A - rs
            J, K, M = 1 << A, 1 << LK, 1 << rs
            idx = ((torch.arange(J)[:, None, None] << (k - A)) | torch.arange(K)[None, :, None]
                   | (torch.arange(M)[None, None, :] << LK))  # (J, K, M)
            v = y[:, idx]  # (nseq, J, K, M, B)
            for s in range(rs - 1, -1, -1):
                h = M >> (s + 1)
                t = (((LK + rs - 1 - s) << k) + ((h + torch.arange(h))[None, :] << LK)
                     + torch.arange(K)[:, None])  # (K, h)
                wt = table[t].view(1, 1, K, 1, h, 1)
                vv = v.reshape(p.nseq, J, K, 1 << s, 2, h, B)
                a0, a1 = vv[:, :, :, :, 0], vv[:, :, :, :, 1] * wt % q
                v = torch.stack(((a0 + a1) % q, (a0 - a1) % q), dim=4).reshape(v.shape)
            if r == 0:  # the last round: each word times its row's multiplier
                v = v * post[rows[:, idx]][..., None] % q
            y[:, idx] = v
        x[rows] = y
    return x


@pytest.mark.parametrize("n", [2, 256, 4096, 8192, 16384, 65536])
def test_invb_rounds_equal_the_plain_route_b_and_numpy(n, rng):
    """The rounds of ntt_invb_pass, run plainly, equal `ntt_inverse_dit_cm`
    and the numpy inverse bit for bit: one pass up to 4096 and at 2^14
    (over all n rows), block and cross passes at 8192 and 2^16."""
    q = nt.ntt_primes(2 * n, 30, 1)[0]
    plan = ntt.ntt_plan(n, q)
    B = 8 if n <= 16384 else 2
    a = rng.integers(0, q, (n, B), dtype=np.uint64).astype(np.uint32)
    a[0, :] = q - 1
    x = torch.from_numpy(a.astype(np.int64))
    got = _run_invb_rounds(x, plan)
    assert torch.equal(got, ntt.ntt_inverse_dit_cm(x, plan, tk._dit_block_rows(n)))
    np.testing.assert_array_equal(got.numpy(), ntt.np_ntt_inverse(a.T, plan).T.astype(np.int64))


@pytest.mark.parametrize("n", [256, 4096])
def test_dit_inverse_matches_pallas_interpret_numpy_and_gs(n, rng):
    q = nt.ntt_primes(2 * n, 30, 1)[0]  # as close to 2^30 as the primes go
    plan, jplan = ntt.ntt_plan(n, q), jntt.ntt_plan(n, q)
    B = 128
    a = rng.integers(0, q, (n, B), dtype=np.uint64).astype(np.uint32)
    a[0, :], a[1, :], a[2, :] = q - 1, 0, 1  # extremal residues
    x = torch.from_numpy(a.astype(np.int32))
    got = tk.ntt_cm(x, plan, inverse=True, alg="dit")
    assert got.dtype == torch.int32 and got.shape == (n, B)
    pallas = pk.ntt_cm(jnp.asarray(a), jplan, inverse=True, alg="dit", interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(pallas).astype(np.int32))
    np.testing.assert_array_equal(got.numpy(),
                                  jntt.np_ntt_inverse(a.T, jplan).T.astype(np.int32))
    assert torch.equal(got, tk.ntt_cm(x, plan, inverse=True))
    assert torch.equal(got.long(), _run_invb_rounds(x, plan))  # the kernel's rounds


@pytest.mark.parametrize("n", [2, 8192, 16384, 65536])
def test_dit_inverse_matches_numpy_two_pass_and_ragged(n, rng):
    q = nt.ntt_primes(2 * n, 30, 1)[0]
    plan = ntt.ntt_plan(n, q)
    a = rng.integers(0, q, (n, 7), dtype=np.uint64).astype(np.uint32)
    a[0, :] = q - 1
    got = tk.ntt_cm(torch.from_numpy(a.astype(np.int32)), plan, inverse=True, alg="dit")
    np.testing.assert_array_equal(got.numpy(),
                                  ntt.np_ntt_inverse(a.T, plan).T.astype(np.int32))
    back = tk.ntt_cm(tk.ntt_cm(got, plan), plan, inverse=True, alg="dit")
    assert torch.equal(back, got)


def test_dit_inverse_really_runs_route_b(monkeypatch, rng):
    """The plain route B is its own network: with the GS inverse made to
    fail, alg="dit" still gives the inverse."""
    n = 1024
    q = nt.ntt_primes(2 * n, 30, 1)[0]
    plan = ntt.ntt_plan(n, q)
    a = rng.integers(0, q, (n, 3), dtype=np.uint64).astype(np.uint32)

    def no_gs(*_):
        raise AssertionError("route B called the GS inverse")

    monkeypatch.setattr(tk, "ntt_inverse_cm", no_gs)
    got = tk.ntt_cm(torch.from_numpy(a.astype(np.int32)), plan, inverse=True, alg="dit")
    np.testing.assert_array_equal(got.numpy(),
                                  ntt.np_ntt_inverse(a.T, plan).T.astype(np.int32))


def test_dit_rejects_forward_and_unknown_alg():
    plan = ntt.ntt_plan(256, 12289)
    x = torch.zeros((256, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="inverse-only"):
        tk.ntt_cm(x, plan, alg="dit")
    with pytest.raises(ValueError, match="inverse-only"):
        tk.ntt_cm_ref(x, plan, alg="dit")
    with pytest.raises(ValueError, match="unknown alg"):
        tk.ntt_cm(x, plan, inverse=True, alg="radix4")


@pytest.mark.parametrize("n", [256, 4096, 8192, 16384, 65536])
def test_dit_tables_fit_the_pass_geometry(n):
    """What the route-B kernel reads, checked where the CPU can reach it:
    each pass's stage table holds log2(L) stages of L rows, and the
    per-row multipliers cover the n rows the passes address."""
    q = nt.ntt_primes(2 * n, 30, 1)[0]
    plan = ntt.ntt_plan(n, q)
    passes = tk.dit_schedule(n)[::-1]
    tab = plan.dit_tables(tk._dit_block_rows(n), "cpu")
    assert tab is plan.dit_tables(tk._dit_block_rows(n), "cpu")  # made once
    for p, name in zip(passes, ("blk", "cross")):
        assert tab[name].numel() == tab[name + "_sh"].numel() == \
            max(p.L.bit_length() - 1, 1) * p.L
        assert int((tab[name].long() & 0xFFFFFFFF).max()) < q
    for name in ("twist", "scale"):
        if len(passes) == 1 and name == "twist":
            assert tab[name] is None
            continue
        assert tab[name].numel() == n and int(tab[name].max()) < q
