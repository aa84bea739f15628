"""The port's argument-level counterparts of the JAX package, bit for bit.

`ntt_plan(n, q, psi=)` at a non-canonical root psi' = psi^3 (an odd power
of a principal 2n-th root is one again, and differs from psi for n >= 2):
its tables, the plan cache's identity rule, and every NTT route of the
port at that plan (`ntt_cm` both ways, route B, the digit prologue, the
ring-sharded transform, the C++ host backend) against the JAX package's
interpret-mode Pallas `ntt_cm` and against direct evaluation.  Then
`RnsBasis.rescale_drop_last(dec_basis=)`, `zq.mul_mod(mu=)` and
`sampling.gaussian_ints_np(ctx_or_n=)`.  Inputs come from a seeded numpy
RNG; every comparison is exact equality.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lol_tpu import rns as jrns, sampling as jsampling, zq as jzq
from lol_tpu.ops import ntt as jntt
from lol_tpu.ops.pallas import ntt_kernel as pk
from lol_tpu.ring import ring_context as j_ring_context
from lol_tpu_torch import numtheory as nt, prng, rns, sampling, zq
from lol_tpu_torch.ops import general as gen, ntt
from lol_tpu_torch.ops.cuda import ntt_kernel as tk, remote_ntt as rn
from lol_tpu_torch.parallel import sharding as sh
from lol_tpu_torch.ring import ring_context
from lol_tpu_torch.tensor import cpp_backend as cpp

torch.set_num_threads(2)


def _plans(n: int):
    """(canonical plan, plan at psi' = psi^3, q) at the largest 30-bit
    prime with 2n | q - 1."""
    q = nt.ntt_primes(max(2 * n, 4), 30, 1)[0]
    canon = ntt.ntt_plan(n, q)
    return canon, ntt.ntt_plan(n, q, psi=pow(canon.psi, 3, q)), q


def _res(rng, q, shape) -> np.ndarray:
    x = rng.integers(0, q, shape).astype(np.uint32)
    x.flat[:3] = (0, 1, q - 1)
    return x


def _t(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x.astype(np.int64)).to(torch.int32)


def _u32(t: torch.Tensor) -> np.ndarray:
    return (t.long() & 0xFFFFFFFF).numpy()


@pytest.mark.parametrize("n", [2, 64, 4096])
def test_plan_tables_at_a_non_canonical_root_match_the_reference(n):
    canon, plan, q = _plans(n)
    psi = pow(canon.psi, 3, q)
    ref = jntt.ntt_plan(n, q, psi=psi)
    assert plan.psi == ref.psi == psi != canon.psi
    assert (plan.n, plan.q, plan.n_inv, plan.n_inv_sh) == (ref.n, ref.q, ref.n_inv, ref.n_inv_sh)
    for name in ("psi_rev", "psi_rev_sh", "ipsi_rev", "ipsi_rev_sh"):
        np.testing.assert_array_equal(getattr(plan, name), getattr(ref, name))
    tS = min(n, 64)
    _, S, _ = ntt.split(n, tS)
    for mine, want in zip(ntt.invb_tables(plan, S, tS), pk._invb_tables(ref, S, tS)):
        assert (mine is None) == (want is None)
        if want is not None:
            np.testing.assert_array_equal(mine, want)


def test_plan_cache_identity_rule():
    """None, the canonical root by keyword or by position: one plan object.
    A non-canonical root is its own cached plan; an axis plan is the
    canonical plan of its 2-power axis."""
    n = 64
    canon, plan, q = _plans(n)
    assert ntt.ntt_plan(n, q, psi=None) is canon
    assert ntt.ntt_plan(n, q, psi=canon.psi) is canon
    assert ntt.ntt_plan(n, q, canon.psi) is canon
    assert ntt.ntt_plan(n, q, psi=np.uint32(canon.psi)) is canon
    assert plan is not canon and ntt.ntt_plan(n, q, plan.psi) is plan
    assert canon.tables("cpu") is ntt.ntt_plan(n, q, psi=canon.psi).tables("cpu")
    q72 = nt.ntt_primes(72, 30, 1)[0]
    axis = gen.general_plan(72, q72).axes[0]
    assert axis.ntt2 is ntt.ntt_plan(4, q72)


def test_plan_refuses_what_the_reference_refuses():
    q = nt.ntt_primes(128, 30, 1)[0]
    for n_, q_ in ((48, q), (0, q), (64, 13)):
        for build in (ntt.ntt_plan, jntt.ntt_plan):
            with pytest.raises(ValueError):
                build(n_, q_)
    # a composite q with 2n | q - 1: no canonical root, so both refuse psi=None
    # and both build the plan of a given root
    qc = 129 * 128 + 1
    assert not nt.is_prime(qc) and (qc - 1) % 128 == 0
    for build in (ntt.ntt_plan, jntt.ntt_plan):
        with pytest.raises(ValueError):
            build(64, qc)
    mine, ref = ntt.ntt_plan(64, qc, psi=5), jntt.ntt_plan(64, qc, psi=5)
    np.testing.assert_array_equal(mine.ipsi_rev, ref.ipsi_rev)
    with pytest.raises(ValueError, match="out of range"):
        ntt.ntt_plan(64, (1 << 30) + 129)


@pytest.mark.parametrize("n", [64, 1024])
@pytest.mark.parametrize("route", ["forward", "redigit", "gs", "dit"])
def test_ntt_cm_at_a_non_canonical_root_matches_pallas_interpret(n, route, rng):
    canon, plan, q = _plans(n)
    jplan = jntt.ntt_plan(n, q, psi=plan.psi)
    a = _res(rng, q, (n, 128))  # the Pallas kernel's 128 lanes
    kw = {"forward": {}, "redigit": {"pre_digit_q": 12289}, "gs": {"inverse": True},
          "dit": {"inverse": True, "alg": "dit"}}[route]
    if route == "redigit":
        a %= 12289
    got = tk.ntt_cm(_t(a), plan, **kw)
    want = pk.ntt_cm(jnp.asarray(a), jplan, interpret=True, **kw)
    np.testing.assert_array_equal(_u32(got), np.asarray(want))
    assert not torch.equal(got, tk.ntt_cm(_t(a), canon, **kw))
    if route == "forward":
        np.testing.assert_array_equal(_u32(got), jntt.np_ntt_forward(a.T, jplan).T)
        assert torch.equal(tk.ntt_cm(got, plan, inverse=True), _t(a))
        # forward(a)[i] = a(psi'^e(i)), evaluated exactly on the host
        e = ntt.crt_output_exponents(n)
        for col in range(3):
            coeffs = [int(c) for c in a[:, col]]
            for i in range(0, n, max(1, n // 16)):
                z = pow(plan.psi, int(e[i]), q)
                assert int(got[i, col]) == sum(c * pow(z, j, q) for j, c in enumerate(coeffs)) % q


def test_ring_sharded_at_a_non_canonical_root_matches_ntt_cm(rng):
    n, D = 1024, 2
    _, plan, q = _plans(n)
    x = _t(_res(rng, q, (n, 8)))
    mesh = sh.make_mesh({"ring": D}, ["cpu"] * D)
    shards = sh.ring_shard(x, mesh)
    fwd = tk.ntt_cm(x, plan)
    for overlap in (False, True):
        assert torch.equal(sh.ring_unshard(rn.ntt_ring_sharded_cm(mesh, shards, plan,
                                                                  overlap=overlap)), fwd)
        back = rn.intt_ring_sharded_cm(mesh, sh.ring_shard(fwd, mesh), plan, overlap=overlap)
        assert torch.equal(sh.ring_unshard(back), x)
    assert torch.equal(sh.ring_unshard(sh.ntt_ring_sharded(mesh, shards, plan)), fwd)


def test_cpp_backend_ntt_at_a_non_canonical_root(rng):
    n = 1024
    _, plan, q = _plans(n)
    x = _t(_res(rng, q, (3, n)))
    fwd = cpp.ntt_forward(x, plan)
    assert torch.equal(fwd, tk.ntt_cm(x.t().contiguous(), plan).t())
    assert torch.equal(cpp.ntt_inverse(x, plan),
                       tk.ntt_cm(x.t().contiguous(), plan, inverse=True).t())
    assert torch.equal(cpp.ntt_inverse(fwd, plan), x)


@pytest.mark.parametrize("dec_basis", [False, True])
def test_rescale_drop_last_takes_dec_basis(dec_basis, rng):
    qs = tuple(nt.ntt_primes(128, 30, 3))
    a = np.stack([_res(rng, q, (2, 64)) for q in qs], axis=-2)  # (2, nrns, n)
    got = rns.rns_basis(qs).rescale_drop_last(_t(a), dec_basis=dec_basis)
    want = jrns.rns_basis(qs).rescale_drop_last(jnp.asarray(a), dec_basis=dec_basis)
    np.testing.assert_array_equal(_u32(got), np.asarray(want))


@pytest.mark.parametrize("q", [3, nt.ntt_primes(2, 15, 1)[0], nt.ntt_primes(2048, 30, 1)[0]])
@pytest.mark.parametrize("mu", ["none", "barrett", "barrett-1", "random"])
def test_mul_mod_takes_the_reference_mu(q, mu, rng):
    """Every u32 mu gives the reference's u32 Barrett words: the exact
    product at None and barrett_mu(q), whatever the steps give elsewhere."""
    assert q.bit_length() in (2, 15, 30)
    mu_v = {"none": None, "barrett": zq.barrett_mu(q), "barrett-1": zq.barrett_mu(q) - 1,
            "random": int(rng.integers(0, 1 << 32))}[mu]
    a, b = _res(rng, q, 4096), _res(rng, q, 4096)
    a[3:6], b[3:6] = q - 1, [q - 1, 1, 0]
    got = zq.mul_mod(_t(a), _t(b), q, mu=mu_v)
    want = jzq.mul_mod(jnp.asarray(a), jnp.asarray(b), q, mu=mu_v)
    np.testing.assert_array_equal(_u32(got), np.asarray(want))
    if mu in ("none", "barrett"):
        np.testing.assert_array_equal(_u32(got), a.astype(np.int64) * b % q)
    with pytest.raises(OverflowError):
        zq.mul_mod(_t(a), _t(b), q, mu=1 << 32)


def test_gaussian_ints_np_takes_ctx_or_n():
    import jax

    m, qs = 64, tuple(nt.ntt_primes(64, 30, 2))
    got = sampling.gaussian_ints_np(ctx_or_n=ring_context(m, qs), key=prng.PRNGKey(7), var=2.0,
                                    device="cpu")
    want = jsampling.gaussian_ints_np(ctx_or_n=j_ring_context(m, qs), key=jax.random.PRNGKey(7),
                                      var=2.0)
    np.testing.assert_array_equal(got, np.asarray(want).astype(np.int64))
    with pytest.raises(TypeError):
        sampling.gaussian_ints_np(32, prng.PRNGKey(7), 2.0, "cpu")
    with pytest.raises(TypeError):
        jsampling.gaussian_ints_np(32, jax.random.PRNGKey(7), 2.0)
