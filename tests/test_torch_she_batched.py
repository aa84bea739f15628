"""The port's batched BGV slice against the JAX package, bit for bit.

The JAX package makes the keys, the hint and the ciphertexts (m = 64,
three 30-bit primes, B = 4, as tests/test_she_batched.py does); they are
carried across as numpy arrays through `lol_tpu_torch.convert`, and the
port's step and decrypt must reproduce the JAX package's
`BatchedBGV(params, use_pallas=False)` exactly.
"""

import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lol_tpu import gadget as jgd
from lol_tpu import numtheory as jnt
from lol_tpu import she as jshe
from lol_tpu.she_batched import BatchedBGV as JBatchedBGV, _hint_const_sh
from lol_tpu_torch import prng
from lol_tpu_torch import convert, numtheory as nt, she
from lol_tpu_torch.she_batched import BatchedBGV

torch.set_num_threads(2)

M = 64
QS = tuple(nt.ntt_primes(M, 30, 3))
J_PARAMS = jshe.SHEParams(m=M, p=257, qs=QS, var=2.0)
PARAMS = she.SHEParams(m=M, p=257, qs=QS, var=2.0)
B = 4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jax_state():
    """Keys, hint and packed ciphertexts made by the JAX package."""
    rng = np.random.default_rng(0)
    ks, kh, *kes = jax.random.split(jax.random.PRNGKey(0), 2 + 2 * B)
    sk = jshe.gen_sk(J_PARAMS, ks)
    hint = jshe.ks_quad_circ_hint(sk, jgd.RnsGad(), kh)
    msgs = [(jshe.pt_random(J_PARAMS, rng), jshe.pt_random(J_PARAMS, rng))
            for _ in range(B)]
    cts_a = [jshe.encrypt(sk, m1, kes[2 * b]) for b, (m1, _) in enumerate(msgs)]
    cts_b = [jshe.encrypt(sk, m2, kes[2 * b + 1]) for b, (_, m2) in enumerate(msgs)]
    jbb = JBatchedBGV(J_PARAMS, use_pallas=False)
    return dict(sk=sk, hint=hint, msgs=msgs, jbb=jbb, cts_a=cts_a,
                c=jbb.pack(cts_a), d=jbb.pack(cts_b))


def _carry(state):
    sk = convert.sk_from_numpy(PARAMS, state["sk"].s_ints)
    h = state["hint"]
    hint = convert.hint_from_numpy(
        PARAMS, np.stack([np.asarray(c.data) for c in h.h0]),
        np.stack([np.asarray(c.data) for c in h.h1]), device="cpu")
    c0, c1 = convert.cts_from_numpy(*(np.asarray(a) for a in state["c"]), device="cpu")
    d0, d1 = convert.cts_from_numpy(*(np.asarray(a) for a in state["d"]), device="cpu")
    return sk, hint, (c0, c1, d0, d1)


def _dropped(params):
    return params.__class__(m=M, p=params.p, qs=QS[:-1], var=params.var)


def test_step_matches_jax_pipeline(jax_state):
    sk, hint, cts = _carry(jax_state)
    e0, e1 = BatchedBGV(PARAMS, "cpu").build_step(hint)(*cts)
    assert e0.dtype == torch.int32 and e0.shape == (len(QS) - 1, M // 2, B)
    j0, j1 = jax_state["jbb"].build_step(jax_state["hint"])(
        *jax_state["c"], *jax_state["d"])
    np.testing.assert_array_equal(e0.numpy(), np.asarray(j0).astype(np.int32))
    np.testing.assert_array_equal(e1.numpy(), np.asarray(j1).astype(np.int32))


@pytest.mark.parametrize("after_step", [False, True])
def test_decrypt_matches_jax_pipeline(jax_state, after_step):
    sk, hint, (c0, c1, d0, d1) = _carry(jax_state)
    jsk = jax_state["sk"]
    if not after_step:
        got = BatchedBGV(PARAMS, "cpu").build_decrypt(sk)(c0, c1)
        want = jax_state["jbb"].build_decrypt(jsk)(*jax_state["c"])
        np.testing.assert_array_equal(
            got.numpy(), np.array([m1 for m1, _ in jax_state["msgs"]]).T)
    else:
        bb = BatchedBGV(PARAMS, "cpu")
        e0, e1 = bb.build_step(hint)(c0, c1, d0, d1)
        f = bb.step_f()
        got = BatchedBGV(_dropped(PARAMS), "cpu").build_decrypt(
            she.SK(_dropped(PARAMS), sk.s_ints, sk.var), f=f)(e0, e1)
        jp2 = _dropped(J_PARAMS)
        want = JBatchedBGV(jp2, use_pallas=False).build_decrypt(
            jshe.SK(jp2, jsk.s_ints, jsk.var), f=f)(
                jnp.asarray(e0.numpy().astype(np.uint32)),
                jnp.asarray(e1.numpy().astype(np.uint32)))
        for b, (m1, m2) in enumerate(jax_state["msgs"]):
            np.testing.assert_array_equal(got[:, b].numpy(),
                                          she.pt_mul(PARAMS, m1, m2))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_port_encryption_decrypts_in_jax_package():
    """Ciphertexts the port encrypts (its own sampler) are valid for the
    JAX package's decrypt under the same key."""
    g, rng = prng.KeyChain(5), np.random.default_rng(5)
    sk = she.gen_sk(PARAMS, g(), "cpu")
    msgs = she.pt_random(PARAMS, rng, (B,), "cpu")
    c0, c1 = BatchedBGV(PARAMS, "cpu").build_encrypt(sk)(msgs, g())
    jsk = jshe.SK(J_PARAMS, sk.s_ints.numpy(), sk.var)
    got = JBatchedBGV(J_PARAMS, use_pallas=False).build_decrypt(jsk)(
        jnp.asarray(c0.numpy().astype(np.uint32)),
        jnp.asarray(c1.numpy().astype(np.uint32)))
    np.testing.assert_array_equal(np.asarray(got), msgs.numpy())


@pytest.mark.parametrize("seed", [1, 2])
def test_port_keygen_encrypt_step_decrypt_round_trip(seed):
    g, rng = prng.KeyChain(seed), np.random.default_rng(seed)
    sk = she.gen_sk(PARAMS, g(), "cpu")
    bb = BatchedBGV(PARAMS, "cpu")
    hint = bb.gen_ks_quad_hint(sk, g())
    assert hint.h0.shape == hint.h1.shape == (len(QS), len(QS), M // 2)
    enc = bb.build_encrypt(sk)
    m1, m2 = she.pt_random(PARAMS, rng, (B,), "cpu"), she.pt_random(PARAMS, rng, (B,), "cpu")
    e0, e1 = bb.build_step(hint)(*enc(m1, g()), *enc(m2, g()))
    p2 = _dropped(PARAMS)
    got = BatchedBGV(p2, "cpu").build_decrypt(
        she.SK(p2, sk.s_ints, sk.var), f=bb.step_f())(e0, e1)
    for b in range(B):
        np.testing.assert_array_equal(
            got[:, b].numpy(), she.pt_mul(PARAMS, m1[:, b].numpy(), m2[:, b].numpy()))


def test_pt_mul_and_gadget_match_reference(rng):
    a = rng.integers(0, PARAMS.p, M // 2)
    b = rng.integers(0, PARAMS.p, M // 2)
    np.testing.assert_array_equal(she.pt_mul(PARAMS, a, b),
                                  jshe.pt_mul(J_PARAMS, a, b))
    from lol_tpu_torch import gadget
    from lol_tpu.rns import rns_basis as j_rns_basis
    assert gadget.gadget_ints(gadget.RnsGad(), PARAMS.ctx.basis) == jgd.gadget_ints(
        jgd.RnsGad(), j_rns_basis(QS))
    np.testing.assert_array_equal(gadget.gadget_rns(gadget.RnsGad(), PARAMS.ctx.basis),
                                  jgd.gadget_rns(jgd.RnsGad(), j_rns_basis(QS)))


def test_lifts_match_reference(rng):
    from lol_tpu.rns import rns_basis as j_rns_basis
    r = np.stack([rng.integers(0, q, (16, 3)) for q in QS]).astype(np.uint32)
    r[:, 0, 0] = [(PARAMS.ctx.basis.modulus + 1) // 2 % q for q in QS]  # x == T
    jb = j_rns_basis(QS)
    mine = PARAMS.ctx.basis
    np.testing.assert_array_equal(mine.lift_centered(r), jb.lift_centered(r))
    got = mine.lift_mod(torch.from_numpy(r.astype(np.int32)), 257)
    want = jb.lift_mod_jnp(jnp.moveaxis(jnp.asarray(r), 0, 1), 257)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_unported_paths_raise():
    """`prf.make_eval_hints(maps="slots")` raises where the reference's
    slot map cannot be built (p = 8 is not coprime to the 2-power ring
    indices), before it makes any hint, with the reference's ValueError;
    where it can (p = 257), its maps equal the JAX package's (the slot
    maps, which raised NotImplementedError here before, are ported; the
    full comparison is test_torch_crtset.py)."""
    from lol_tpu import linear as jlinear
    from lol_tpu.cyc import Rep as JRep
    from lol_tpu.ring import ring_context as j_ring_context
    from lol_tpu_torch import gadget, prf
    from lol_tpu_torch.ring import ring_context
    qs = tuple(nt.ntt_primes(16, 30, 2))
    g = prng.KeyChain(0)
    sks = [she.gen_sk(she.SHEParams(m=m, p=8, qs=qs, var=2.0), g(), "cpu") for m in (16, 8)]
    fam = prf.PRFFamily.random(ring_context(16, (8,)), gadget.BaseBGad(2), prf.balanced(2), g(), "cpu")
    with pytest.raises(ValueError, match="coprime"):
        prf.make_eval_hints(fam, sks, [16, 8], [8], gadget.RnsGad(), g(), maps="slots",
                            device="cpu")
    sks = [she.gen_sk(she.SHEParams(m=m, p=257, qs=qs, var=2.0), g(), "cpu") for m in (16, 8)]
    hints, _ = prf.make_eval_hints(None, sks, [16, 8], [8], gadget.RnsGad(), g(), maps="slots",
                                   device="cpu")
    want = jlinear.slot_projection(j_ring_context(16, qs), j_ring_context(8, qs), 257)
    np.testing.assert_array_equal(np.stack(hints.tunnels[0].lin.ys),
                                  np.stack([y.lift_ints(rep=JRep.POW) for y in want.ys]))


def test_pack_matches_jax_pack(jax_state):
    cts = [convert.ct_from_numpy(PARAMS, [(c.rep.value, np.asarray(c.data)) for c in ct.cs],
                                 ct.f, ct.encoding, "cpu") for ct in jax_state["cts_a"]]
    packed = BatchedBGV(PARAMS, "cpu").pack(cts)
    for mine, ref in zip(packed, convert.cts_from_numpy(*jax_state["c"], device="cpu")):
        assert mine.dtype == torch.int32 and torch.equal(mine, ref)


def test_step_module_moves_with_its_buffers(jax_state):
    sk, hint, cts = _carry(jax_state)
    step = BatchedBGV(PARAMS, "cpu").build_step(hint)
    assert {name for name, _ in step.named_buffers()} == {"qv", "hint_sh"}
    assert all(b.device.type == "cpu" for b in step.buffers())
    assert torch.equal(step.hint_sh[0], hint.h0) and torch.equal(step.hint_sh[2], hint.h1)
    # the Shoup form: the JAX package's constant-hint values and companions
    for plane, h in ((0, jax_state["hint"].h0), (2, jax_state["hint"].h1)):
        w, wsh = (np.asarray(a)[..., 0] for a in _hint_const_sh(h, QS))
        np.testing.assert_array_equal(step.hint_sh[plane].numpy(), w.astype(np.int32))
        np.testing.assert_array_equal(step.hint_sh[plane + 1].numpy().view(np.uint32), wsh)


def test_port_never_imports_jax():
    """In a fresh interpreter where importing jax, lol_tpu,
    google.protobuf, the JAX tree's examples or __graft_entry__ fails,
    every module of the port imports (the package
    walked with pkgutil), and the port still builds a pipeline and runs a
    step, a tunnel, a pt_round, a general-m step, a Galois rotation, a
    slot map and a step over an rns x data mesh on the CPU, the README's
    Quick start on the object path at m = 8192, an io round trip of a
    hint bundle, and the challenges' generate -> suppress -> verify at
    m = 64."""
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        sys.modules["jax"] = None
        sys.modules["lol_tpu"] = None
        sys.modules["google.protobuf"] = None
        sys.modules["examples"] = None
        sys.modules["__graft_entry__"] = None
        import numpy as np
        import torch
        torch.set_num_threads(1)
        import lol_tpu_torch
        mods = [m.name for m in pkgutil.walk_packages(lol_tpu_torch.__path__, "lol_tpu_torch.")]
        for name in mods:
            importlib.import_module(name)
        assert {"lol_tpu_torch.parallel.sharding", "lol_tpu_torch.ops.cuda.remote_ntt",
                "lol_tpu_torch.bench.roofline", "lol_tpu_torch.ops.cuda.pointwise",
                "lol_tpu_torch.linear", "lol_tpu_torch.ops.general",
                "lol_tpu_torch.serving", "lol_tpu_torch.prf",
                "lol_tpu_torch.factored", "lol_tpu_torch.zmstar",
                "lol_tpu_torch.crtset", "lol_tpu_torch.gf", "lol_tpu_torch.cyc",
                "lol_tpu_torch.rlwe", "lol_tpu_torch.rrq",
                "lol_tpu_torch.complexfield", "lol_tpu_torch.io",
                "lol_tpu_torch.proto.wire", "lol_tpu_torch.ops.debug",
                "lol_tpu_torch.challenges.driver", "lol_tpu_torch.challenges.beacon",
                "lol_tpu_torch.parallel.multihost", "lol_tpu_torch.prng",
                "lol_tpu_torch.ops.cuda.prng", "lol_tpu_torch.entry",
                "lol_tpu_torch.examples.she_demo", "lol_tpu_torch.examples.khprf_demo",
                "lol_tpu_torch.examples.tunnel_demo", "lol_tpu_torch.examples.homomprf_demo",
                "lol_tpu_torch.examples.serving_demo"} <= set(mods)
        from lol_tpu_torch import gadget as gd, linear, numtheory as nt, prng, serving, she
        from lol_tpu_torch.ring import ring_context
        from lol_tpu_torch.she_batched import BatchedBGV
        qs = tuple(nt.ntt_primes(32, 30, 2))
        params = she.SHEParams(m=32, p=17, qs=qs, var=2.0)
        g, rng = prng.KeyChain(0), np.random.default_rng(0)
        sk = she.gen_sk(params, g(), "cpu")
        bb = BatchedBGV(params, "cpu")
        enc = bb.build_encrypt(sk)
        m1, m2 = she.pt_random(params, rng, (2,), "cpu"), she.pt_random(params, rng, (2,), "cpu")
        e0, e1 = bb.build_step(bb.gen_ks_quad_hint(sk, g()))(*enc(m1, g()), *enc(m2, g()))
        assert e0.shape == (1, 16, 2)
        # a tunnel m = 32 -> 16 (E = S), decrypted against eval_lin
        ps = she.SHEParams(m=16, p=17, qs=qs, var=2.0)
        sk_s = she.gen_sk(ps, g(), "cpu")
        S = ring_context(16, qs)
        f = linear.linear_pow(S, params.ctx, S, [[1] + [0] * 7, [0, 2] + [0] * 6])
        th = bb.gen_tunnel_hint(f, sk_s, sk, g())
        t0, t1 = bb.build_tunnel(th)(*enc(m1, g()))
        got = bb.target_pipeline(th).build_decrypt(sk_s)(t0, t1)
        for b in range(2):
            assert (got[:, b].numpy() == linear.eval_lin_ints(f, m1[:, b].numpy(), 17)).all()
        # a pt_round Z_4 -> Z_2 (one squaring) on its own hints
        p4 = she.SHEParams(m=16, p=4, qs=tuple(nt.ntt_primes(32, 30, 3)), var=2.0)
        sk4 = she.gen_sk(p4, g(), "cpu")
        bb4 = BatchedBGV(p4, "cpu")
        run, bb_out, f_out = serving.build_pt_round(bb4, she.pt_round_hints(sk4, gd.RnsGad(), g(), "cpu"))
        msgs = torch.zeros((8, 4), dtype=torch.int32)
        msgs[0] = torch.arange(4)
        r = bb_out.build_decrypt(she.SK(bb_out.params, sk4.s_ints, 2.0), f=f_out)(
            *run(*bb4.build_encrypt(sk4)(msgs, g())))
        assert r[0].tolist() == [0, 1, 1, 0] and not r[1:].any()  # round-half-up(v / 2) mod 2
        # a general-m step (m = 36 = 2^2 3^2) and a Galois rotation there
        q36 = tuple(nt.ntt_primes(36, 30, 3))
        p36 = she.SHEParams(m=36, p=5, qs=q36, var=2.0)
        sk36 = she.gen_sk(p36, g(), "cpu")
        bb36 = BatchedBGV(p36, "cpu")
        a, b = she.pt_random(p36, rng, (2,), "cpu"), she.pt_random(p36, rng, (2,), "cpu")
        enc36 = bb36.build_encrypt(sk36)
        y = bb36.build_step(bb36.gen_ks_quad_hint(sk36, g()))(*enc36(a, g()), *enc36(b, g()))
        p36d = she.SHEParams(m=36, p=5, qs=q36[:2], var=2.0)
        got = BatchedBGV(p36d, "cpu").build_decrypt(she.SK(p36d, sk36.s_ints, 2.0),
                                                     f=bb36.step_f())(*y)
        assert (got[:, 0].numpy() == she.pt_mul(p36, a[:, 0].numpy(), b[:, 0].numpy())).all()
        rot = bb36.build_galois(bb36.gen_galois_hint(5, sk36, g()), 5)(*enc36(a, g()))
        got = bb36.build_decrypt(sk36)(*rot)
        assert (got[:, 1].numpy() == she.galois_ints(36, a[:, 1].numpy(), 5, 5)).all()
        # a slot map 32 -> 16 at p = 257, and the m = 32 step over a mesh
        f = linear.slot_projection(params.ctx, ring_context(16, qs), 257)
        assert f.d == 2 and max(abs(int(v)) for y in f.ys for v in y) <= 128
        from lol_tpu_torch.parallel import sharding as sh
        mesh = sh.make_mesh({"rns": 2, "data": 2}, ["cpu"] * 4)
        cs = (*enc(m1, g()), *enc(m2, g()))
        hint = bb.gen_ks_quad_hint(sk, g())
        got = bb.build_step(hint, mesh=mesh)(*(sh.shard_batch_rns(mesh, c) for c in cs))
        want = bb.build_step(hint)(*cs)
        assert all(torch.equal(sh.unshard_batch_rns(x), y) for x, y in zip(got, want))
        # the Quick start on the object path, m = 8192
        qs = tuple(nt.ntt_primes(8192, 30, 3))
        params = she.SHEParams(m=8192, p=257, qs=qs)
        sk = she.gen_sk(params, prng.PRNGKey(0), "cpu")
        m1 = she.pt_random(params, np.random.default_rng(1), device="cpu").numpy()
        ct = she.encrypt(sk, m1, prng.PRNGKey(2), device="cpu")
        assert (she.decrypt(sk, ct) == m1).all()
        hint = she.ks_quad_circ_hint(sk, gd.RnsGad(), prng.PRNGKey(3),
                                     device="cpu")
        prod = she.mod_switch(she.key_switch_quad_circ(hint, she.ct_mul(ct, ct)))
        assert (she.decrypt(she.SK(prod.params, sk.s_ints, sk.var), prod)
                == she.pt_mul(params, m1, m1)).all()
        # an io round trip of a rounding-hint bundle, and the challenges at m = 64
        from lol_tpu_torch import io
        from lol_tpu_torch.proto import wire as pb
        rh = she.pt_round_hints(sk4, gd.RnsGad(), g(), "cpu")
        back = io.pt_round_hints_from_proto(pb.PTRoundHints.FromString(
            io.pt_round_hints_to_proto(rh).SerializeToString()), device="cpu")
        assert all(torch.equal(a.h0, b.h0) and torch.equal(a.h1, b.h1)
                   for a, b in zip(rh.hints, back.hints))
        import tempfile
        from lol_tpu_torch.challenges import ChallengeParams, generate, suppress, verify
        q64 = nt.ntt_primes(64, 30, 1)[0]
        with tempfile.TemporaryDirectory() as root:
            generate(root, [ChallengeParams(0, 64, q64, 4.0, 2, "disc"),
                            ChallengeParams(1, 64, q64, 4.0, 2, "cont", beacon_epoch=3)],
                     seed=1, device="cpu")
            suppress(root)
            assert verify(root, device="cpu")
        assert not any(k in ("jax", "google.protobuf")
                       or k.startswith(("jax.", "lol_tpu.", "google.protobuf."))
                       for k, v in sys.modules.items() if v is not None)
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
