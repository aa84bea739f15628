"""The port's ring-sharded NTT (`parallel/sharding.py`,
`ops/cuda/remote_ntt.py`) against the JAX package, bit for bit.

The JAX package runs its ring-sharded transforms on the 8-virtual-device
CPU mesh of tests/conftest.py: the Pallas remote-DMA kernels in interpret
mode (`remote_ntt.ntt_ring_sharded_pallas` / `intt_ring_sharded_pallas`,
as tests/test_sharding.py runs them) and the XLA twin
`sharding.ntt_ring_sharded`.  The port runs a mesh of "cpu" devices,
where every wrapper takes its plain version.  Inputs come from numpy
seeds and carry across as numpy; everything is exact mod q, so the
tolerance is zero.

Interpret mode takes 20-50 s per call here, so it runs once per
direction on one input at each D, each D in a file of its own
(`check_interpret`; D = 2 and 8 in test_torch_ring_ntt_d2.py / _d8.py).  Below a flattened batch of 128 the
JAX package's overlap=True is its two-call path (`remote_ntt.py:480`,
`:511`), so at batch 2 or 3 one JAX run stands for both of its routes;
the (3, 128, 256) batch (F = 384: three 128-wide slabs, a recycled
landing slot, a mid-loop drain) runs its fused kernels.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lol_tpu import numtheory as jnt
from lol_tpu.ops import ntt as jntt
from lol_tpu.ops.pallas import remote_ntt as jrn
from lol_tpu.ops.pallas.ntt_kernel import _block_twiddles
from lol_tpu.parallel import sharding as jsh
from lol_tpu_torch import convert
from lol_tpu_torch.ops import ntt
from lol_tpu_torch.ops.cuda import ntt_kernel as tk, remote_ntt as rn
from lol_tpu_torch.parallel import sharding as sh

torch.set_num_threads(2)


def _cpu_mesh(shape):
    return sh.make_mesh(shape, ["cpu"] * int(np.prod(list(shape.values()))))


def _jax_ring(x, D):
    mesh = jsh.make_mesh({"ring": D})
    spec = jax.sharding.PartitionSpec(*([None] * (x.ndim - 1)), "ring")
    return mesh, jax.device_put(jnp.asarray(x), jax.sharding.NamedSharding(mesh, spec))


def _port_ring(x, D, plan, inverse, overlap):
    """The port's transform of the JAX-layout (..., n) array x, back as
    (..., n) u32."""
    mesh = _cpu_mesh({"ring": D})
    shards = convert.ring_shards_from_numpy(x, mesh)
    fn = rn.intt_ring_sharded_cm if inverse else rn.ntt_ring_sharded_cm
    return convert.ring_shards_to_numpy(fn(mesh, shards, plan, overlap=overlap), x.shape[:-1])


def _input(D, n, batch, seed):
    q = jnt.ntt_primes(2 * n, 30, 1 + D % 3)[-1]
    x = np.random.default_rng(seed).integers(0, q, batch + (n,), dtype=np.uint64)
    x = x.astype(np.uint32)
    x.reshape(-1)[:3] = [0, 1, q - 1]
    return q, x


def check_interpret(D, n, batch, jax_overlap):
    """Both port routes, forward and inverse, == the JAX package's
    interpret-mode Pallas kernels on the same input (each computed once)."""
    q, x = _input(D, n, batch, seed=D)
    jmesh, xj = _jax_ring(x, D)
    jplan = jntt.ntt_plan(n, q)
    want_f = np.asarray(jrn.ntt_ring_sharded_pallas(jmesh, xj, jplan, interpret=True,
                                                    overlap=jax_overlap))
    want_i = np.asarray(jrn.intt_ring_sharded_pallas(jmesh, xj, jplan, interpret=True,
                                                     overlap=jax_overlap))
    plan = ntt.ntt_plan(n, q)
    for overlap in (False, True):
        np.testing.assert_array_equal(_port_ring(x, D, plan, False, overlap), want_f)
        np.testing.assert_array_equal(_port_ring(x, D, plan, True, overlap), want_i)


# the two two-call cases, ~100 s each, run from test_torch_ring_ntt_d2.py and
# _d8.py: one file a case keeps each file short under --dist loadfile
@pytest.mark.parametrize("D,n,batch,jax_overlap", [(4, 256, (3, 128), True)])
def test_ring_ntt_matches_jax_interpret(D, n, batch, jax_overlap):
    check_interpret(D, n, batch, jax_overlap)


@pytest.mark.parametrize("D", [2, 4, 8])
@pytest.mark.parametrize("n", [256, 512])
@pytest.mark.parametrize("batch", [(2,), (3,)])
def test_ring_ntt_matches_jax_xla_and_oracle(D, n, batch):
    """Both port routes and the port's plain `sh.ntt_ring_sharded` == the
    JAX package's XLA `ntt_ring_sharded` and numpy oracles; the inverse
    == `np_ntt_inverse` and round-trips."""
    q, x = _input(D, n, batch, seed=10 * D + n + len(batch))
    jplan = jntt.ntt_plan(n, q)
    jmesh, xj = _jax_ring(x, D)
    want_f = np.asarray(jsh.ntt_ring_sharded(jmesh, xj, jplan))
    np.testing.assert_array_equal(want_f, jntt.np_ntt_forward(x, jplan))
    want_i = jntt.np_ntt_inverse(x, jplan)
    plan = ntt.ntt_plan(n, q)
    mesh = _cpu_mesh({"ring": D})
    shards = convert.ring_shards_from_numpy(x, mesh)
    np.testing.assert_array_equal(
        convert.ring_shards_to_numpy(sh.ntt_ring_sharded(mesh, shards, plan), batch), want_f)
    for overlap in (False, True):
        fwd = rn.ntt_ring_sharded_cm(mesh, shards, plan, overlap=overlap)
        np.testing.assert_array_equal(convert.ring_shards_to_numpy(fwd, batch), want_f)
        inv = rn.intt_ring_sharded_cm(mesh, shards, plan, overlap=overlap)
        np.testing.assert_array_equal(convert.ring_shards_to_numpy(inv, batch), want_i)
        back = rn.intt_ring_sharded_cm(mesh, fwd, plan, overlap=overlap)
        np.testing.assert_array_equal(convert.ring_shards_to_numpy(back, batch), x)


def _stage_rows(passes):
    """For each pass of a length-tS phase-B schedule (forward order): the
    kernel's twiddle index ((base0 + sq*base_step) << sp) + g of every
    (local stage sp, sequence sq, group g), beside the row of the DIT
    layout table (`_block_twiddles`) that the length-tS network reads
    there: 2^s + global group, s the stage of the length-tS network."""
    idx, rows, done = [], [], 0
    for p in passes:
        for sp in range(p.L.bit_length() - 1):
            sq = np.arange(p.nseq)[:, None]
            g = np.arange(1 << sp)[None, :]
            idx.append((((p.base0 + sq * p.base_step) << sp) + g).ravel())
            # the schedule's block pass runs its sequences as consecutive
            # groups of the length-tS network; its cross pass has one
            grp = sq * (1 << sp) * (p.base_step != 0) + g
            rows.append(((1 << (done + sp)) + grp).ravel())
        done += p.L.bit_length() - 1
    return np.concatenate(idx), np.concatenate(rows)


@pytest.mark.parametrize("D,n", [(2, 256), (4, 256), (8, 512), (4, 16384), (2, 16384),
                                 (4, 65536)])
def test_phase_tables_match_jax(D, n):
    """The twiddles the kernels read for phase B of shard d (base D + d,
    one pass up to tS = 4096 and over a cluster at 8192 and 16384, cross +
    block above) are the JAX package's
    `_block_twiddles(plan, inverse, S, tS)[d]`, and phase A's (base 1)
    its `_plan_tables` wA, in both directions."""
    q = jnt.ntt_primes(2 * n, 30, 1)[0]
    jplan = jntt.ntt_plan(n, q)
    tS, C = rn.check_ring(n, D)
    S = D.bit_length() - 1
    for inverse in (False, True):
        src = jplan.ipsi_rev if inverse else jplan.psi_rev
        TB = _block_twiddles(jplan, inverse, S=S, tS=tS)
        wA, _, TBj, _ = jrn._plan_tables(jplan, D, inverse)
        np.testing.assert_array_equal(np.asarray(TBj), TB)
        for d in range(D):
            passes = rn.phase_b_passes(tS, D, d)
            assert len(passes) == (1 if tS <= tk.SINGLE_PASS_MAX_N or tS in tk.CLUSTER else 2)
            idx, rows = _stage_rows(passes)
            assert len(set(rows.tolist())) == tS - 1  # every table row, once
            np.testing.assert_array_equal(src[idx], TB[d][rows])
        idx, rows = _stage_rows([rn.phase_a_pass(D, C)])
        np.testing.assert_array_equal(src[idx], np.asarray(wA)[rows])


@pytest.mark.parametrize("D,tS,B", [(1, 4, 3), (2, 8, 1), (4, 16, 5), (8, 64, 2)])
def test_a2a_chunks_ref_is_the_all_to_all_involution(D, tS, B, rng):
    """out[d] chunk e = shard e's chunk d (the reference's `_all_to_all`:
    out[e] on device d = x_e[d]); applied twice it is the identity; the
    wrapper takes it on CPU shards."""
    C = tS // D
    xs = [torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, (tS, B)).astype(np.int32))
          for _ in range(D)]
    out = rn.a2a_chunks_ref(xs)
    for d in range(D):
        for e in range(D):
            assert torch.equal(out[d][e * C:(e + 1) * C], xs[e][d * C:(d + 1) * C])
    assert all(torch.equal(a, b) for a, b in zip(rn.a2a_chunks_ref(out), xs))
    assert all(torch.equal(a, b) for a, b in zip(rn.a2a_chunks(xs), out))


def test_fused_wrappers_take_lazy_words_and_match_plain(rng):
    """On CPU shards the fused wrappers are their plain versions, which
    read the kernels' lazy u32 words (phase A's output lies below 4q and
    may pass 2^31) and equal the exchange + plain phase B (B')."""
    D, n = 4, 256
    q = jnt.ntt_primes(2 * n, 30, 1)[0]
    plan = ntt.ntt_plan(n, q)
    lazy = rng.integers(0, 4 * q, (D, n // D, 3), dtype=np.int64)
    lazy.reshape(-1)[:3] = [0, 1, 4 * q - 1]
    xs = [torch.from_numpy(v.astype(np.uint32).view(np.int32)) for v in lazy]
    res = [torch.from_numpy(v % q).to(torch.int32) for v in lazy]
    assert xs[0].min() < 0  # words at or above 2^31
    got = rn.ntt_fwd_gather(xs, plan)
    want = [rn.phase_b_ref(v, plan, D, d, False) for d, v in enumerate(rn.a2a_chunks(res))]
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    got = rn.ntt_inv_scatter(res, plan)
    want = rn.a2a_chunks([rn.phase_b_ref(v, plan, D, d, True) for d, v in enumerate(res)])
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("inverse", [False, True])
def test_overlap_never_runs_the_two_call_path(inverse, monkeypatch, rng):
    """overlap=True makes one exchange and one fused call per transform,
    overlap=False two exchanges and no fused call, at every shape."""
    calls = []
    for name in ("a2a_chunks", "ntt_fwd_gather", "ntt_inv_scatter"):
        real = getattr(rn, name)
        monkeypatch.setattr(rn, name, lambda *a, _f=real, _n=name: calls.append(_n) or _f(*a))
    D, n = 2, 64
    q = jnt.ntt_primes(2 * n, 30, 1)[0]
    plan = ntt.ntt_plan(n, q)
    mesh = _cpu_mesh({"ring": D})
    shards = sh.ring_shard(torch.from_numpy(rng.integers(0, q, (n, 5)).astype(np.int32)), mesh)
    fn = rn.intt_ring_sharded_cm if inverse else rn.ntt_ring_sharded_cm
    fused = "ntt_inv_scatter" if inverse else "ntt_fwd_gather"
    fn(mesh, shards, plan, overlap=True)
    assert sorted(calls) == sorted(["a2a_chunks", fused])
    calls.clear()
    fn(mesh, shards, plan, overlap=False)
    assert calls == ["a2a_chunks", "a2a_chunks"]


class _Plan:
    """Just n and q: the ring's checks run before any table is read."""

    def __init__(self, n, q):
        self.n, self.q = n, q


@pytest.mark.parametrize("D,n", [(3, 48), (8, 32), (4, 8)])
def test_ring_checks_raise_like_jax(D, n):
    """A D that is not a power of 2, or D^2 not dividing n, raises
    ValueError in the port and in the JAX package alike."""
    jmesh, xj = _jax_ring(np.zeros((2, n), dtype=np.uint32), D)
    with pytest.raises(ValueError):
        jrn.ntt_ring_sharded_pallas(jmesh, xj, _Plan(n, 97), interpret=True)
    with pytest.raises(ValueError):
        rn.check_ring(n, D)
    mesh = _cpu_mesh({"ring": D})
    shards = [torch.zeros((n // D, 2), dtype=torch.int32) for _ in range(D)]
    for fn in (rn.ntt_ring_sharded_cm, rn.intt_ring_sharded_cm):
        with pytest.raises(ValueError):
            fn(mesh, shards, _Plan(n, 97), overlap=True)


def test_make_mesh_needs_a_card_or_named_devices(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sh.make_mesh({"ring": 4})
    with pytest.raises(ValueError, match="needs 4 devices"):
        sh.make_mesh({"ring": 4}, ["cpu"] * 3)
    mesh = sh.make_mesh({"data": 2, "rns": 4}, ["cpu"] * 8)
    assert mesh.shape == {"data": 2, "rns": 4}
    assert mesh.axis_devices("rns") == [torch.device("cpu")] * 4
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    mesh = sh.make_mesh({"ring": 4})  # round-robin, repeating a card
    assert [d.index for d in mesh.axis_devices("ring")] == [0, 1, 2, 0]


@pytest.mark.parametrize("batch", [(), (3,), (3, 5)])
def test_ring_shards_round_trip(batch, rng):
    n, D = 64, 4
    x = rng.integers(0, 2 ** 30, batch + (n,)).astype(np.uint32)
    mesh = _cpu_mesh({"ring": D})
    shards = convert.ring_shards_from_numpy(x, mesh)
    B = int(np.prod(batch)) if batch else 1
    assert [tuple(s.shape) for s in shards] == [(n // D, B)] * D
    assert torch.equal(shards[1][:, 0], torch.from_numpy(x.reshape(B, n)[0, 16:32].astype(np.int32)))
    np.testing.assert_array_equal(convert.ring_shards_to_numpy(shards, batch), x)


def test_batched_ntt_and_hadamard_sharded_match_jax(rng):
    """rns x data sharding: `ntt_cm` per block and the plain Hadamards ==
    the JAX package's `batched_ntt_sharded` / `batched_hadamard_sharded`
    on the (data=2, rns=4) mesh, in the port's (nrns, n, B) layout."""
    n = 256
    qs = tuple(jnt.ntt_primes(2 * n, 30, 4))
    x = np.stack([rng.integers(0, q, (8, n)) for q in qs]).astype(np.uint32)
    y = np.stack([rng.integers(0, q, (8, n)) for q in qs]).astype(np.uint32)
    jmesh = jsh.make_mesh({"data": 2, "rns": 4})
    jplans = [jntt.ntt_plan(n, q) for q in qs]
    want = np.asarray(jsh.batched_ntt_sharded(jmesh, jsh.shard_batch_rns(jmesh, jnp.asarray(x)),
                                              jplans))
    want_h = np.asarray(jsh.batched_hadamard_sharded(
        jmesh, jsh.shard_batch_rns(jmesh, jnp.asarray(x)),
        jsh.shard_batch_rns(jmesh, jnp.asarray(y)), qs))
    mesh = _cpu_mesh({"data": 2, "rns": 4})
    cm = [torch.from_numpy(np.ascontiguousarray(a.transpose(0, 2, 1)).astype(np.int32))
          for a in (x, y)]
    blocks = sh.shard_batch_rns(mesh, cm[0])
    assert blocks.shape == (4, 2) and blocks[0, 0].shape == (1, n, 4)
    plans = [ntt.ntt_plan(n, q) for q in qs]
    out = sh.batched_ntt_sharded(mesh, blocks, plans)
    got = sh.unshard_batch_rns(out).numpy().transpose(0, 2, 1)
    np.testing.assert_array_equal(got, want.astype(np.int32))
    back = sh.unshard_batch_rns(sh.batched_ntt_sharded(mesh, out, plans, inverse=True))
    assert torch.equal(back, cm[0])
    had = sh.batched_hadamard_sharded(mesh, blocks, sh.shard_batch_rns(mesh, cm[1]), qs)
    got_h = sh.unshard_batch_rns(had).numpy().transpose(0, 2, 1)
    np.testing.assert_array_equal(got_h, want_h.astype(np.int32))
