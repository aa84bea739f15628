"""The port's fused ct-mult (`ops/cuda/pointwise.py`) against the JAX package.

On the CPU `ct_mul_cm` runs its plain int64 version; it must equal the
Pallas `ct_mul_cm` in interpret mode (and the JAX `zq` channel math where
the Pallas kernel's `128 | B` restriction excludes the shape), bit for
bit, at the largest 30-bit primes with the extremal residues 0, 1 and
q - 1 in every operand.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lol_tpu import zq as jzq
from lol_tpu.ops.pallas import pointwise as jpw
from lol_tpu_torch import numtheory as nt, she
from lol_tpu_torch import she_batched
from lol_tpu_torch.ops.cuda import pointwise as pw

torch.set_num_threads(2)


def _operands(rng, q, n, B):
    ops = [rng.integers(0, q, (n, B), dtype=np.uint64).astype(np.uint32)
           for _ in range(4)]
    ext = np.array([0, 1, q - 1], dtype=np.uint32)
    k = min(81, n * B)
    for j, a in enumerate(ops):  # every combination of 0, 1, q - 1
        a.reshape(-1)[:k] = ext[(np.arange(k) // 3 ** j) % 3]
    return ops


def _torch(a):
    return torch.from_numpy(a.astype(np.int32))


@pytest.mark.parametrize("B", [128, 256])
@pytest.mark.parametrize("q_index", [0, 1])
def test_ct_mul_matches_pallas_interpret(B, q_index, rng):
    n = 512
    q = nt.ntt_primes(2 ** 15, 30, 2)[q_index]  # the largest 30-bit NTT primes
    ops = _operands(rng, q, n, B)
    got = pw.ct_mul_cm(*(_torch(a) for a in ops), q)
    want = jpw.ct_mul_cm(*(jnp.asarray(a) for a in ops), q, interpret=True)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32 and g.shape == (n, B)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w).astype(np.int32))


def test_ct_mul_ragged_batch_matches_zq_channel_math(rng):
    n, B = 64, 100  # 128 does not divide B: the reference kernel refuses it
    q = nt.ntt_primes(2 ** 15, 30, 1)[0]
    c0, c1, d0, d1 = _operands(rng, q, n, B)
    j = [jnp.asarray(a) for a in (c0, c1, d0, d1)]
    want = (jzq.mul_mod(j[0], j[2], q),
            jzq.add_mod(jzq.mul_mod(j[0], j[3], q), jzq.mul_mod(j[1], j[2], q), q),
            jzq.mul_mod(j[1], j[3], q))
    got = pw.ct_mul_cm(*(_torch(a) for a in (c0, c1, d0, d1)), q)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w).astype(np.int32))


def test_ct_mul_writes_into_out(rng):
    q = 12289
    ops = [_torch(a) for a in _operands(rng, q, 16, 5)]
    out = tuple(torch.full((16, 5), -1, dtype=torch.int32) for _ in range(3))
    got = pw.ct_mul_cm(*ops, q, out=out)
    assert all(g is o for g, o in zip(got, out))
    for o, w in zip(out, pw.ct_mul_cm_ref(*ops, q)):
        assert torch.equal(o, w)


def test_ct_mul_rejects_bad_arguments():
    x = torch.zeros((8, 4), dtype=torch.int32)
    before = pw.LAUNCHES["ct_mul"]
    with pytest.raises(ValueError, match="int32"):
        pw.ct_mul_cm(x, x, x, x.long(), 12289)
    with pytest.raises(ValueError, match="one shape"):
        pw.ct_mul_cm(x, x, x, x[:4], 12289)
    with pytest.raises(ValueError, match="out of range"):
        pw.ct_mul_cm(x, x, x, x, 1 << 30)
    with pytest.raises(ValueError, match="three"):
        pw.ct_mul_cm(x, x, x, x, 12289, out=(x, x))
    pw.ct_mul_cm(x, x, x, x, 12289)
    assert pw.LAUNCHES["ct_mul"] == before  # a CPU tensor never reaches the kernel


def test_step_computes_its_ct_mult_through_ct_mul_cm(monkeypatch):
    """BGVStep.forward runs one ct_mul_cm per channel, and its ct_mul
    stacks equal the plain Hadamards."""
    m = 64
    params = she.SHEParams(m=m, p=257, qs=tuple(nt.ntt_primes(m, 30, 3)), var=2.0)
    g = torch.Generator().manual_seed(3)
    bb = she_batched.BatchedBGV(params, "cpu")
    step = bb.build_step(bb.gen_ks_quad_hint(she.gen_sk(params, g), g))
    enc = bb.build_encrypt(she.gen_sk(params, g))
    cts = (*enc(she.pt_random(params, g, (6,)), g), *enc(she.pt_random(params, g, (6,)), g))
    calls = []

    def counting(*args, **kw):
        calls.append(args[4])
        return pw.ct_mul_cm(*args, **kw)

    monkeypatch.setattr(she_batched, "ct_mul_cm", counting)
    step(*cts)
    assert calls == list(params.qs)
    qv = torch.tensor(params.qs).view(-1, 1, 1)
    c0, c1, d0, d1 = (t.long() for t in cts)
    want = (c0 * d0 % qv, (c0 * d1 + c1 * d0) % qv, c1 * d1 % qv)
    for e, w in zip(step.ct_mul(*cts), want):
        assert e.dtype == torch.int32 and torch.equal(e.long(), w)
