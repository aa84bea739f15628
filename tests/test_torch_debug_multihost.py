"""The port's debug guards (`ops/debug`) and multi-process meshes
(`parallel/multihost`), against the JAX package's where it has them.

Mirrors `tests/test_debug_multihost.py` and `tests/test_multihost.py`:
`assert_reduced` passes reduced residues and raises on a planted q and on
a planted u32 wraparound word (0x80000000, negative as the port's int32);
`ntt_cm_checked` == the plain transform and the JAX package's
`ntt_cm_checked` in every direction and route; `global_mesh`'s shapes and
refusals; `initialize`'s backend; and two processes over localhost with
gloo (`parallel.multihost_check`): a data-sharded NTT, one `all_reduce`,
and the BGV step and the extended-modulus step over the mesh == the
unsharded run's columns.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from lol_tpu.ops import debug as jdbg
from lol_tpu.ops import ntt as jntt
from lol_tpu_torch import numtheory as nt
from lol_tpu_torch.ops import debug as dbg
from lol_tpu_torch.ops import ntt
from lol_tpu_torch.ops.cuda import ntt_kernel as tk
from lol_tpu_torch.parallel import multihost, multihost_check, sharding

torch.set_num_threads(2)

Q = nt.ntt_primes(128, 30, 1)[0]


def test_assert_reduced_passes_residues_and_raises_on_planted_words():
    x = torch.tensor([0, 1, Q - 1], dtype=torch.int32)
    assert dbg.assert_reduced(x, Q) is x
    assert dbg.assert_reduced(torch.zeros(0, dtype=torch.int32), Q).numel() == 0
    with pytest.raises(dbg.ReductionError, match=r"\[here\]: residue .* >= modulus"):
        dbg.assert_reduced(torch.tensor([5, Q], dtype=torch.int32), Q, where="here")
    wrapped = torch.tensor([5, 0x80000000], dtype=torch.int64).to(torch.int32)  # -2^31
    with pytest.raises(dbg.ReductionError, match="u32 word 2147483648"):
        dbg.assert_reduced(wrapped, Q)
    with pytest.raises(jdbg.ReductionError):  # the JAX guard on the same planted q
        jdbg.assert_reduced(np.array([5, Q], dtype=np.uint32), Q)


@pytest.mark.parametrize("n", [64, 4096])
def test_ntt_cm_checked_is_the_plain_transform(n):
    """Forward (with and without the digit prologue), the GS inverse and
    route B == ntt_cm_ref, and the forward == the JAX package's checked
    transform; a planted word raises on the way in, and a bad output on
    the way out."""
    rng = np.random.default_rng(n)
    q_src, q = nt.ntt_primes(2 * n, 30, 2)
    plan, B = ntt.ntt_plan(n, q), 128 if n == 64 else 8  # the Pallas kernel's lanes at 64
    x = torch.from_numpy(rng.integers(0, q, (n, B)).astype(np.int32))
    y = dbg.ntt_cm_checked(x, plan)
    assert torch.equal(y, tk.ntt_cm_ref(x, plan))
    for alg in ("gs", "dit"):
        assert torch.equal(dbg.ntt_cm_checked(y, plan, inverse=True, alg=alg), x)
    xs = torch.from_numpy(rng.integers(0, q_src, (n, B)).astype(np.int32))
    xs[0, 0] = q_src - 1  # at or above q: a residue mod the source prime
    assert q_src > q and torch.equal(dbg.ntt_cm_checked(xs, plan, pre_digit_q=q_src),
                                     tk.ntt_cm_ref(xs, plan, pre_digit_q=q_src))
    if n == 64:
        jy = jdbg.ntt_cm_checked(x.numpy().astype(np.uint32), jntt.ntt_plan(n, q), interpret=True)
        np.testing.assert_array_equal(y.numpy().astype(np.uint32), np.asarray(jy))
    for word in (q, -(1 << 31)):
        bad = x.clone()
        bad[3, 5] = word
        with pytest.raises(dbg.ReductionError, match="input"):
            dbg.ntt_cm_checked(bad, plan, inverse=True, alg="dit")


def test_ntt_cm_checked_checks_the_output(monkeypatch):
    plan = ntt.ntt_plan(64, Q)
    monkeypatch.setattr(tk, "ntt_cm", lambda x, plan, inverse=False, **kw: x + Q)
    with pytest.raises(dbg.ReductionError, match="output n=64"):
        dbg.ntt_cm_checked(torch.zeros((64, 8), dtype=torch.int32), plan)


def test_global_mesh_shapes_and_refusals():
    """One process with eight CPU entries, as the reference's 8-virtual-
    device test; then the layout rule over several processes."""
    mesh = multihost.global_mesh({"data": -1, "rns": 2}, ["cpu"] * 8)
    assert mesh.shape == {"data": 4, "rns": 2} and mesh.local().shape == mesh.shape
    assert sharding.local_columns(mesh, 16) == slice(0, 16)
    with pytest.raises(ValueError, match="divisible"):
        multihost.global_mesh({"data": -1, "rns": 3}, ["cpu"] * 8)
    with pytest.raises(ValueError, match="at most one"):
        multihost.global_mesh({"a": -1, "b": -1}, ["cpu"] * 8)
    with pytest.raises(ValueError, match="device count"):
        multihost.global_mesh({"data": 3, "rns": 2}, ["cpu"] * 8)
    ranks = multihost.rank_grid({"data": -1, "rns": 3}, 3, 2)
    assert ranks.tolist() == [[0, 0, 0], [1, 1, 1]]
    for shape in ({"data": 1, "rns": 6}, {"rns": 2, "data": 3}, {"ring": -1}):
        with pytest.raises(ValueError, match="would cross processes"):
            multihost.rank_grid(shape, 3, 2)


def test_mesh_local_parts():
    """A mesh that spans two processes: each one's entries, rows and
    columns, and shard_batch_rns placing only those columns."""
    devs = np.empty((4, 2), dtype=object)
    devs[:] = torch.device("cpu")
    mesh = sharding.Mesh(devs, ("data", "rns"), multihost.rank_grid({"data": 4, "rns": 2}, 4, 2))
    assert mesh.local_rows(1) == slice(2, 4) and mesh.local(1).shape == {"data": 2, "rns": 2}
    assert mesh.local(0).ranks is None
    assert sharding.local_columns(mesh, 8) == slice(0, 4)  # this process is rank 0
    x = torch.arange(2 * 3 * 8, dtype=torch.int32).view(2, 3, 8)
    blocks = sharding.shard_batch_rns(mesh, x)
    assert blocks.shape == (2, 2)
    assert torch.equal(sharding.unshard_batch_rns(blocks), x[..., :4])
    with pytest.raises(ValueError, match="holds no entry"):
        mesh.local(2)


def test_initialize_takes_the_backend_it_is_given():
    """Without CUDA the default is gloo; a backend that cannot start raises
    (nothing downgrades); a second call is a no-op."""
    assert not dist.is_initialized()
    if not dist.is_nccl_available():
        with pytest.raises(RuntimeError):
            multihost.initialize(f"localhost:{multihost_check._free_port()}", 1, 0,
                                 backend="nccl")
        assert not dist.is_initialized()
    multihost.initialize(f"localhost:{multihost_check._free_port()}", 1, 0)
    try:
        assert dist.get_backend() == ("nccl" if torch.cuda.is_available() else "gloo")
        multihost.initialize("localhost:1", 7, 3, backend="gloo")  # already up: untouched
        assert dist.get_world_size() == 1
    finally:
        dist.destroy_process_group()


def test_two_processes_over_gloo():
    """Two OS processes, one mesh {"data": 2, "rns": 3} over three CPU
    entries each: every check of `multihost_check` passes on both ranks
    (each raises otherwise), and they hold complementary columns."""
    reports = multihost_check.spawn(2, timeout=300, device="cpu", backend="gloo", m=32,
                                    batch=8, ext_m=64)
    assert [r["rank"] for r in reports] == [0, 1]
    assert [r["columns"] for r in reports] == [[0, 4], [4, 8]]
    assert all(r["backend"] == "gloo" and r["mesh"] == {"data": 2, "rns": 3} for r in reports)
