"""The port's fused ct-mult and key-switch inner products
(`ops/cuda/pointwise.py`) against the JAX package.

On the CPU `ct_mul_cm` runs its plain int64 version; it must equal the
Pallas `ct_mul_cm` in interpret mode (and the JAX `zq` channel math where
the Pallas kernel's `128 | B` restriction excludes the shape), bit for
bit, at the largest 30-bit primes with the extremal residues 0, 1 and
q - 1 in every operand.  `ks_inner_cm`'s plain version must equal the
step's former per-digit int64 chain, the reference's Shoup chain
(`_addmod_ch(e, _mulmod_sh_ch(d_i, h_i, hs_i))`) and the kernel's own u32
steps run plainly.  The rescale through `rescale_out` (p^-1 folded into
the inverse, the correction re-expanded by the forward prologue) must
equal the rescale's former int64 formula, and `rescale_out_ref` the
kernel's u32 steps run plainly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lol_tpu import she_batched as jsb
from lol_tpu import zq as jzq
from lol_tpu.ops.pallas import pointwise as jpw
from lol_tpu_torch import prng
from lol_tpu_torch import numtheory as nt, she, zq
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
    g, rng = prng.KeyChain(3), np.random.default_rng(3)
    bb = she_batched.BatchedBGV(params, "cpu")
    step = bb.build_step(bb.gen_ks_quad_hint(she.gen_sk(params, g(), "cpu"), g()))
    enc = bb.build_encrypt(she.gen_sk(params, g(), "cpu"))
    cts = (*enc(she.pt_random(params, rng, (6,), "cpu"), g()), *enc(she.pt_random(params, rng, (6,), "cpu"), g()))
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


# --- the key switch's hint inner products (ks_inner_cm) ----------------------


def _ks_operands(rng, qs, nrns, n, B, with_e1=True):
    """(e0, e1, digits, h0, h1) over the channels qs: uniform residues with
    0 and q - 1 planted in every operand and in both hints."""
    def res(shape, plant):  # channels on axis -3
        qv = torch.tensor(qs).view(-1, 1, 1)
        x = torch.from_numpy(rng.integers(0, 1 << 40, shape)) % qv
        x[..., plant % shape[-1]] = (qv - 1)[..., 0]
        x[..., (plant + 1) % shape[-1]] = 0
        return x

    e0, e1 = res((len(qs), n, B), 0), res((len(qs), n, B), 1) if with_e1 else None
    ds = [res((len(qs), n, B), i + 2) for i in range(nrns)]
    hq = torch.tensor(qs).view(1, -1, 1)
    h0, h1 = (torch.from_numpy(rng.integers(0, 1 << 40, (nrns, len(qs), n))) % hq
              for _ in range(2))
    h0[..., 0], h1[..., 1] = (hq - 1)[..., 0], (hq - 1)[..., 0]
    h0[..., 1], h1[..., 0] = 0, 0
    return (e0.to(torch.int32), None if e1 is None else e1.to(torch.int32),
            [d.to(torch.int32) for d in ds], h0, h1)


def _kernel_words(e0, e1, ds, hint, qs):
    """csrc/keyswitch.cu's u32 steps, plainly: lazy Shoup products added
    into accumulators kept in [0, 2q), then one subtraction of q."""
    qv = torch.tensor(qs).view(-1, 1, 1)
    a0, a1 = e0.long(), torch.zeros_like(e0, dtype=torch.int64) if e1 is None else e1.long()
    u = hint.long() & 0xFFFFFFFF
    for i, d in enumerate(ds):
        for p, a in ((0, a0), (2, a1)):
            w, wsh = u[p, i, ..., None], u[p + 1, i, ..., None]
            r = zq.mul_shoup_lazy(d, w, wsh >> 16, wsh & 0xFFFF, qv)
            assert bool((r < 2 * qv).all())
            s = a + r
            assert bool((s < 1 << 32).all())
            a.copy_(torch.where(s >= 2 * qv, s - 2 * qv, s))
    return tuple(torch.where(a >= qv, a - qv, a).to(torch.int32) for a in (a0, a1))


KS_CASES = {  # name -> (nrns, channels of the chain, n, B, e1 given)
    "nrns1": (1, slice(None), 8, 8, True),
    "nrns3": (3, slice(None), 16, 12, True),
    "nrns7": (7, slice(None), 8, 4, True),
    "channel_subset": (3, slice(1, 3), 16, 8, True),  # a mesh block's channels
    "ragged_B": (3, slice(None), 8, 5, True),
    "no_e1": (3, slice(None), 8, 8, False),
}


@pytest.mark.parametrize("case", sorted(KS_CASES))
def test_ks_inner_ref_matches_the_chain_and_the_reference(case, rng):
    nrns, chans, n, B, with_e1 = KS_CASES[case]
    qs = tuple(nt.ntt_primes(2 ** 15, 30, nrns))[chans]
    e0, e1, ds, h0, h1 = _ks_operands(rng, qs, nrns, n, B, with_e1)
    hint = pw.ks_hint(h0, h1, qs)
    keep = [t.clone() for t in (e0, *ds)]
    got = pw.ks_inner_cm(e0, e1, ds, hint, qs)
    assert all(torch.equal(a, b) for a, b in zip(keep, (e0, *ds)))  # inputs untouched
    assert all(g.dtype == torch.int32 and g.shape == e0.shape for g in got)
    assert all(g is not e0 for g in got)
    assert all(torch.equal(a, b) for a, b in zip(got, pw.ks_inner_cm_ref(e0, e1, ds, hint, qs)))
    # the per-digit int64 chain the step ran before
    qv = torch.tensor(qs).view(-1, 1, 1)
    c0, c1 = e0.long(), torch.zeros_like(e0, dtype=torch.int64) if e1 is None else e1.long()
    for i, d in enumerate(ds):
        c0 = (c0 + d.long() * h0[i, ..., None]) % qv
        c1 = (c1 + d.long() * h1[i, ..., None]) % qv
    assert torch.equal(got[0].long(), c0) and torch.equal(got[1].long(), c1)
    # the reference: _addmod_ch(e, _mulmod_sh_ch(d_i, h_i, hs_i)) over u32
    j = lambda t: jnp.asarray(t.numpy().astype(np.uint32))  # noqa: E731
    r0, r1 = j(e0), j(torch.zeros_like(e0) if e1 is None else e1)

    def sh(h):  # the companions of one digit's (k, n) hint, as _hint_const_sh makes them
        return [jnp.asarray(jzq.shoup_np(h.numpy()[k], q))[:, None] for k, q in enumerate(qs)]

    for i, d in enumerate(ds):
        r0 = jsb._addmod_ch(qs, r0, jsb._mulmod_sh_ch(qs, j(d), j(h0[i])[..., None], sh(h0[i])))
        r1 = jsb._addmod_ch(qs, r1, jsb._mulmod_sh_ch(qs, j(d), j(h1[i])[..., None], sh(h1[i])))
    for g, r in zip(got, (r0, r1)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r).astype(np.int32))
    # the kernel's own u32 steps give the same words
    assert all(torch.equal(a, b) for a, b in zip(got, _kernel_words(e0, e1, ds, hint, qs)))


def test_ks_hint_is_the_hint_and_its_shoup_companions(rng):
    qs = tuple(nt.ntt_primes(2 ** 15, 30, 3))
    *_, h0, h1 = _ks_operands(rng, qs, 3, 8, 1)
    hint = pw.ks_hint(h0, h1, qs)
    assert hint.dtype == torch.int32 and hint.shape == (4, 3, 3, 8)
    for p, h in ((0, h0), (2, h1)):
        assert torch.equal(hint[p].long(), h)
        for k, q in enumerate(qs):
            want = jzq.shoup_np(h[:, k].numpy().astype(np.uint32), q)
            np.testing.assert_array_equal(hint[p + 1, :, k].numpy().view(np.uint32), want)
    with pytest.raises(ValueError, match="channels"):
        pw.ks_hint(h0, h1, qs[:2])


def test_ks_inner_rejects_bad_arguments(rng):
    qs = tuple(nt.ntt_primes(2 ** 15, 30, 3))
    e0, e1, ds, h0, h1 = _ks_operands(rng, qs, 3, 8, 4)
    hint = pw.ks_hint(h0, h1, qs)
    before = pw.LAUNCHES["ks_inner"]
    with pytest.raises(ValueError, match="int32"):
        pw.ks_inner_cm(e0, e1.long(), ds, hint, qs)
    with pytest.raises(ValueError, match="one shape"):
        pw.ks_inner_cm(e0, e1, [*ds[:2], ds[2][:, :4]], hint, qs)
    with pytest.raises(ValueError, match=r"\(k, n, B\)"):
        pw.ks_inner_cm(e0[0], e1[0], [d[0] for d in ds], hint, qs)
    with pytest.raises(ValueError, match="no digit"):
        pw.ks_inner_cm(e0, e1, [], hint[:, :0], qs)
    with pytest.raises(ValueError, match="hint of shape"):
        pw.ks_inner_cm(e0, e1, ds[:2], hint, qs)  # three digits' hint, two digits
    with pytest.raises(ValueError, match="hint of shape"):
        pw.ks_inner_cm(e0, e1, ds, hint.long(), qs)
    with pytest.raises(ValueError, match="moduli"):
        pw.ks_inner_cm(e0, e1, ds, hint, qs[:2])
    with pytest.raises(ValueError, match="out of range"):
        pw.ks_inner_cm(e0, e1, ds, hint, (*qs[:2], 1 << 30))
    with pytest.raises(ValueError, match="out of range"):
        pw.ks_inner_cm(e0, e1, ds, hint, (*qs[:2], 1))
    pw.ks_inner_cm(e0, e1, ds, hint, qs)
    assert pw.LAUNCHES["ks_inner"] == before  # a CPU tensor never reaches the kernel


# --- the exact rescale's epilogue (rescale_out) ------------------------------


def _former_rescale(bb, comp, encoding):
    """The rescale's int64 formula before `rescale_out`: v = iNTT(c_l)
    (times p^-1 mod ql for LSD), delta = (p) centered v mod q_j, forward
    transformed, subtracted, times ql^-1."""
    ql, p = bb.qs[-1], bb.params.p
    v = bb._crt_one(comp[-1], len(bb.qs) - 1, inverse=True).long()
    if encoding == "lsd":
        v = v * nt.modinv(p % ql, ql) % ql
    surv = bb.qs[:-1]
    qv = torch.tensor(surv).view(-1, 1, 1)
    centered = torch.where(v >= (ql + 1) // 2, v - ql, v)
    delta = centered[None] % qv
    if encoding == "lsd":
        delta = delta * (p % qv) % qv
    nd = torch.stack([bb._crt_one(delta[t].to(torch.int32), t) for t in range(len(surv))])
    inv = torch.tensor([nt.modinv(ql % q, q) for q in surv]).view(-1, 1, 1)
    return ((comp[:-1].long() - nd.long()) % qv * inv % qv).to(torch.int32)


def _rescale_kernel_words(comp, nd, qs, a, b):
    """csrc/rescale.cu's u32 steps, plainly: two lazy Shoup products in
    [0, 2q), their difference plus 2q in (0, 4q), two conditional
    subtractions."""
    k = len(qs)
    qv = torch.tensor(qs).view(-1, 1, 1)
    av, bv = (torch.tensor(list(v)).view(-1, 1, 1) for v in (a, b))
    ash, bsh = (torch.tensor([zq.shoup(w, q) for w, q in zip(v, qs)]).view(-1, 1, 1)
                for v in (a, b))
    x = zq.mul_shoup_lazy(comp[:k], av, ash >> 16, ash & 0xFFFF, qv)
    y = zq.mul_shoup_lazy(torch.stack(list(nd)), bv, bsh >> 16, bsh & 0xFFFF, qv)
    assert bool((x < 2 * qv).all()) and bool((y < 2 * qv).all())
    r = x + 2 * qv - y
    assert bool((r > 0).all()) and bool((r < 4 * qv).all()) and bool((r < 1 << 32).all())
    r = torch.where(r >= 2 * qv, r - 2 * qv, r)
    return torch.where(r >= qv, r - qv, r).to(torch.int32)


RESCALE_CASES = {  # name -> (m, p, chain order of the three largest primes, encoding)
    "lsd_ql_below": (64, 17, (0, 1, 2), "lsd"),
    "lsd_ql_above": (64, 17, (2, 1, 0), "lsd"),
    "lsd_ql_between": (64, 17, (0, 2, 1), "lsd"),
    "msd_ql_below": (64, 17, (0, 1, 2), "msd"),
    "msd_ql_above": (64, 17, (2, 1, 0), "msd"),
    "lsd_general_m72": (72, 5, (2, 0, 1), "lsd"),
    "msd_general_m72": (72, 5, (0, 1, 2), "msd"),
}


@pytest.mark.parametrize("case", sorted(RESCALE_CASES))
def test_rescale_out_matches_the_former_int64_rescale(case, rng):
    """`_rescale_crt` (the inverse times p^-1 through its n^-1, the
    correction's centering as the forward prologue, `rescale_out`) == the
    rescale's former int64 formula bit for bit, LSD and MSD, with ql above,
    below and between the surviving moduli, at 2-power and general m; a
    mesh block's view of the surviving channels (and of the dropped one
    alone, k = 0) gives its rows of it; `rescale_out_ref` == the kernel's
    u32 steps run plainly."""
    m, p, order, enc = RESCALE_CASES[case]
    primes = nt.ntt_primes(m, 30, 3)
    qs = tuple(primes[i] for i in order)
    params = she.SHEParams(m=m, p=p, qs=qs, var=2.0)
    bb = she_batched.BatchedBGV(params, "cpu")
    n, B = params.ctx.n, 6
    qv = torch.tensor(qs).view(-1, 1, 1)
    comp = torch.from_numpy(rng.integers(0, 1 << 40, (3, n, B))) % qv
    comp[:, 0, 0], comp[:, 1, 0] = (qv - 1)[:, 0, 0], 0
    comp[-1, 2, :2] = torch.tensor([(qs[-1] - 1) // 2, (qs[-1] + 1) // 2])  # the centering edge
    comp = comp.to(torch.int32)
    want = _former_rescale(bb, comp, enc)
    got = bb._rescale_crt(comp, enc)
    assert got.dtype == torch.int32 and got.shape == (2, n, B)
    assert torch.equal(got, want)
    v = bb._rescale_v(comp[-1], enc)
    assert v.dtype == torch.int32 and bool((v >= 0).all()) and bool((v < qs[-1]).all())
    for chans, rows in ((range(1, 3), slice(1, 2)), (range(2, 3), slice(0, 0))):
        view = bb._view(chans, "cpu")
        assert torch.equal(view._rescale_apply(comp[chans.start:], v, enc), want[rows])
    surv, inv, p_ql_inv = bb._rescale_consts()
    assert surv == qs[:-1] and inv == tuple(nt.modinv(qs[-1] % q, q) for q in surv)
    assert p_ql_inv == tuple(p * a % q for a, q in zip(inv, surv))
    nd = [bb._crt_one(v, t, pre_digit_q=qs[-1]) for t in range(2)]
    for k in (1, 2):
        b = (inv if enc == "msd" else p_ql_inv)[:k]
        ref = pw.rescale_out_ref(comp, nd[:k], surv[:k], inv[:k], b)
        assert torch.equal(ref, want[:k])
        assert torch.equal(_rescale_kernel_words(comp, nd[:k], surv[:k], inv[:k], b), ref)


def test_rescale_out_ref_at_the_extremes(rng):
    """Every combination of 0, 1 and q - 1 in comp and the transform, with
    constants 0, 1, q - 1 and random: `rescale_out` on the CPU ==
    `rescale_out_ref` == the kernel's u32 steps == exact int64."""
    qs = tuple(nt.ntt_primes(2 ** 15, 30, 2))
    ext = torch.tensor([0, 1])
    comp = torch.stack([torch.cat([ext, torch.tensor([q - 1])]).repeat_interleave(3)
                        for q in qs]).view(2, 9, 1).to(torch.int32)
    nd = [torch.cat([ext, torch.tensor([q - 1])]).repeat(3).view(9, 1).to(torch.int32)
          for q in qs]
    for a, b in ((0, 1), (1, 0), (qs[1] - 1, qs[1] - 1), tuple(int(x) for x in rng.integers(2, qs[1], 2))):
        got = pw.rescale_out(comp, nd, qs, (a, a), (b, b))
        exact = ((comp.long() * a - torch.stack(nd).long() * b) % torch.tensor(qs).view(-1, 1, 1))
        assert torch.equal(got.long(), exact)
        assert torch.equal(_rescale_kernel_words(comp, nd, qs, (a, a), (b, b)), got)


def test_rescale_out_rejects_bad_arguments(rng):
    qs = tuple(nt.ntt_primes(2 ** 15, 30, 3))[:2]
    comp = torch.zeros((3, 8, 4), dtype=torch.int32)
    nd = [torch.zeros((8, 4), dtype=torch.int32) for _ in qs]
    a = b = (1, 1)
    before = pw.LAUNCHES["rescale_out"]
    with pytest.raises(ValueError, match="int32"):
        pw.rescale_out(comp.long(), nd, qs, a, b)
    with pytest.raises(ValueError, match=r"\(>= 2, n, B\)"):
        pw.rescale_out(comp[:1], nd, qs, a, b)
    with pytest.raises(ValueError, match="transforms"):
        pw.rescale_out(comp, nd[:1], qs, a, b)
    with pytest.raises(ValueError, match="constants"):
        pw.rescale_out(comp, nd, qs, a[:1], b)
    with pytest.raises(ValueError, match=r"\(n, B\) transforms"):
        pw.rescale_out(comp, [nd[0], nd[1][:4]], qs, a, b)
    with pytest.raises(ValueError, match=r"\(n, B\) transforms"):
        pw.rescale_out(comp, [nd[0], nd[1].long()], qs, a, b)
    with pytest.raises(ValueError, match="out of range"):
        pw.rescale_out(comp, nd, (qs[0], 1 << 30), a, b)
    with pytest.raises(ValueError, match="not residues"):
        pw.rescale_out(comp, nd, qs, (1, qs[1]), b)
    with pytest.raises(ValueError, match="transforms"):
        pw.rescale_out(comp, [], (), (), ())
    pw.rescale_out(comp, nd, qs, a, b)
    assert pw.LAUNCHES["rescale_out"] == before  # a CPU tensor never reaches the kernel
