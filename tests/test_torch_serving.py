"""The port's serving layer against the JAX package, bit for bit.

The rounding schedule's pieces (`she.pt_round_mults`, `_pt_round_base`,
`_lsb_squarings`), the base-b gadget's digits, the KH-PRF's public family
and clear PRF, `serving.build_pt_round` (m = 16, p in {8, 9}, LSD and
MSD) and `serving.batched_homom_prf_component` (m = 32 -> 2 in one hop,
E = 2, with the rounding and with the MSD reinterpretation), each against
`lol_tpu.serving` over `BatchedBGV(params, use_pallas=False)` on the JAX
package's keys, hints and public parameters carried across through
`lol_tpu_torch.convert`.  The JAX serving builders run with jit
disabled: the same jnp integer operations, op by op, which at these
sizes costs less than compiling each stage (its keygen, once per shape,
stays jitted).  Then the port's own hints (`pt_round_hints`,
`make_eval_hints`) through the port's pipeline, down to the m = 2 ring
(n = 1), against the round-half-up oracle and the clear PRF.  Every
comparison is exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lol_tpu import gadget as jgd
from lol_tpu import linear as jlinear
from lol_tpu import prf as jprf
from lol_tpu import serving as jserving
from lol_tpu import she as jshe
from lol_tpu.cyc import Cyc as JCyc, Rep as JRep
from lol_tpu.ring import ring_context as j_ring_context
from lol_tpu.rns import rns_basis as j_rns_basis
from lol_tpu.she_batched import BatchedBGV as JBatchedBGV
from lol_tpu_torch import prng
from lol_tpu_torch import convert, gadget, numtheory as nt, prf, serving, she
from lol_tpu_torch.ring import ring_context
from lol_tpu_torch.rns import rns_basis as port_rns_basis
from lol_tpu_torch.she_batched import BatchedBGV

torch.set_num_threads(2)

B = 3


def _np(x) -> np.ndarray:
    return np.asarray(x).astype(np.int64)


def _hint_arrays(hint):
    return (np.stack([np.asarray(c.data) for c in hint.h0]),
            np.stack([np.asarray(c.data) for c in hint.h1]))


def _same(port_pair, jax_pair):
    for got, want in zip(port_pair, jax_pair):
        np.testing.assert_array_equal(got.numpy().astype(np.int64), _np(want))


def _round_half_up(v, p, pr):
    return (2 * np.asarray(v) * pr + p) // (2 * p) % pr


# --- the schedule's pieces and the base-b gadget ---------------------------


@pytest.mark.parametrize("p", [2, 4, 8, 16, 3, 9, 27])
def test_pt_round_schedule_matches_jax(p):
    assert she._pt_round_base(p) == jshe._pt_round_base(p)
    assert she.pt_round_mults(p) == jshe.pt_round_mults(p)
    assert [she._lsb_squarings(j) for j in range(2, 8)] == \
        [jshe._lsb_squarings(j) for j in range(2, 8)]


@pytest.mark.parametrize("p", [1, 5, 6, 12, 25])
def test_pt_round_refuses_other_moduli(p):
    for mod in (she, jshe):
        with pytest.raises(ValueError, match="not 2\\^k or 3\\^k"):
            mod.pt_round_mults(p)


def test_pt_round_hints_refuse_a_short_chain():
    params = she.SHEParams(m=16, p=8, qs=tuple(nt.ntt_primes(32, 30, 3)), var=2.0)
    sk = she.gen_sk(params, prng.PRNGKey(0), "cpu")
    with pytest.raises(ValueError, match="needs >= 4 RNS primes"):
        she.pt_round_hints(sk, gadget.RnsGad(), prng.PRNGKey(1), "cpu")


@pytest.mark.parametrize("q,b", [(257, 2), (257, 3), (12289, 16), (8, 2), (9, 3)])
def test_base_b_digits_match_jax(rng, q, b):
    """num_digits, decompose_host_mod (where no lift overflows its ell
    digits; both raise where one does) and the KH-PRF's `decompose_mod`
    (the reference's decompose_base_jnp, no overflow check)."""
    spec, jspec, jbasis = gadget.BaseBGad(b), jgd.BaseBGad(b), j_rns_basis((q,))
    ell = gadget.num_digits(spec, port_rns_basis((q,)))
    assert ell == jgd.num_digits(jspec, jbasis)
    a = rng.integers(0, q, (2, 64)).astype(np.uint32)
    got = gadget.decompose_mod(spec, q, a)
    want = np.asarray(jgd.decompose(jspec, jbasis, jnp.asarray(a)[:, None, :]))[:, :, 0]
    np.testing.assert_array_equal(got, want.astype(np.int64))
    lifted = np.where(a >= (q + 1) // 2, a.astype(np.int64) - q, a)
    fits = np.ones(a.shape, dtype=bool)
    for idx, v in np.ndenumerate(lifted):
        try:
            want = jgd._signed_digits(int(v), b, ell)
        except ValueError:
            fits[idx] = False
            with pytest.raises(ValueError, match="digit overflow"):
                gadget._signed_digits(int(v), b, ell)
            with pytest.raises(ValueError, match="digit overflow"):
                gadget.decompose_host_mod(spec, q, np.array([int(v) % q]))
        else:
            assert gadget._signed_digits(int(v), b, ell) == want
    ok = a[:, fits.all(0)]
    assert ok.shape[1] > 0
    got = gadget.decompose_host_mod(spec, q, ok)
    want = jgd.decompose_host(jspec, jbasis, ok[:, None, :])[:, :, 0]
    np.testing.assert_array_equal(got, want.astype(np.int64))
    with pytest.raises(ValueError, match="b >= 2"):
        gadget.BaseBGad(1)


# --- the KH-PRF's public family and the clear PRF --------------------------


def _jax_family(m, tree, seed):
    fam_j = jprf.PRFFamily.random(j_ring_context(m, (8,)), jgd.BaseBGad(2), getattr(jprf, tree)(3),
                                  jax.random.PRNGKey(seed))
    fam = convert.prf_family_from_numpy(
        m, 8, 2, getattr(prf, tree)(3),
        *([a.lift_ints(rep=JRep.POW) for a in getattr(fam_j, k)] for k in ("a0", "a1")))
    return fam_j, fam


@pytest.mark.parametrize("m", [32, 64])
def test_prf_family_and_prf_match_jax(rng, prf_state, m):
    """A_T(x) and the clear PRF on one family, carried across: m = 32
    (HomomPRF's family below, balanced(3)) and m = 64 (left_spine(3))."""
    fam_j, fam = ((prf_state["fam_j"], prf_state["fam"]) if m == 32
                  else _jax_family(m, "left_spine", m))
    s = rng.integers(-3, 4, m // 2)
    s_j = JCyc.from_ints(fam_j.ctx, s)
    bits = (1, 0, 1)
    got = fam.a_t(bits)
    want = np.stack([a.lift_ints(rep=JRep.POW) for a in fam_j.a_t(bits)]) % 8
    np.testing.assert_array_equal(got, want)
    assert fam.a_t(bits) is got  # the per-node cache
    np.testing.assert_array_equal(prf.prf_ints(fam, s, bits, 2), jprf.prf(fam_j, s_j, bits, 2))
    with pytest.raises(ValueError, match="needs 3 bits"):
        fam.a_t((1, 0))


def test_make_eval_hints_auto_is_project_at_even_p(monkeypatch):
    """At 2-power m and even p the reference's "auto" map selection falls
    back to the coefficient projection at every hop (its slot map needs p
    coprime to the ring indices): the maps the JAX make_eval_hints hands
    its hint generator (stubbed here, the maps are the point) are the
    port's "auto" and "project" maps.  "slots" refuses there as the JAX
    package does, and at odd p "auto" takes the JAX package's maps."""
    rings, e_rings = [16, 8, 2], [8, 2]
    qs = tuple(nt.ntt_primes(32, 30, 2))
    jsks = [jshe.SK(jshe.SHEParams(m=m, p=8, qs=qs, var=2.0), np.zeros(m // 2, np.int64), 2.0)
            for m in rings]
    monkeypatch.setattr(jshe, "tunnel_hint", lambda lin, *args: lin)
    auto, _ = jprf.make_eval_hints(None, jsks, rings, e_rings, jgd.RnsGad(),
                                   jax.random.PRNGKey(2), maps="auto")
    sks = [convert.sk_from_numpy(she.SHEParams(m=m, p=8, qs=qs, var=2.0), np.zeros(m // 2))
           for m in rings]
    g = prng.KeyChain(3)
    def same_maps(port, ref):
        assert len(port.tunnels) == len(ref.tunnels)
        for th, lin in zip(port.tunnels, ref.tunnels):
            assert (th.lin.e_ctx.m, th.lin.r_ctx.m, th.lin.s_ctx.m) == \
                (lin.e_ctx.m, lin.r_ctx.m, lin.s_ctx.m)
            np.testing.assert_array_equal(np.stack(th.lin.ys),
                                          np.stack([y.lift_ints(rep=JRep.POW) for y in lin.ys]))

    for maps in ("auto", "project"):
        same_maps(prf.make_eval_hints(None, sks, rings, e_rings, gadget.RnsGad(), g(), maps=maps, device="cpu")[0],
                  auto)
    for mk in (lambda: jprf.make_eval_hints(None, jsks, rings, e_rings, jgd.RnsGad(),
                                            jax.random.PRNGKey(2), maps="slots"),
               lambda: prf.make_eval_hints(None, sks, rings, e_rings, gadget.RnsGad(), g(), maps="slots",
                                           device="cpu")):
        with pytest.raises(ValueError, match="coprime"):
            mk()
    odd = [convert.sk_from_numpy(she.SHEParams(m=m, p=257, qs=qs, var=2.0), np.zeros(m // 2))
           for m in rings]
    jodd = [jshe.SK(jshe.SHEParams(m=m, p=257, qs=qs, var=2.0), np.zeros(m // 2, np.int64), 2.0)
            for m in rings]
    same_maps(prf.make_eval_hints(None, odd, rings, e_rings, gadget.RnsGad(), g(), maps="auto", device="cpu")[0],
              jprf.make_eval_hints(None, jodd, rings, e_rings, jgd.RnsGad(),
                                   jax.random.PRNGKey(2), maps="auto")[0])
    # where e_rings[i] != rings[i+1] both take the projection, as the reference does
    prf.make_eval_hints(None, odd, [16, 8], [4], gadget.RnsGad(), g(), maps="auto", device="cpu")
    with pytest.raises(ValueError, match="maps must be"):
        prf.make_eval_hints(None, sks, rings, e_rings, gadget.RnsGad(), g(), maps="dense", device="cpu")


# --- build_pt_round against the JAX package --------------------------------


@pytest.fixture(scope="module")
def pt_state():
    """Per p in {8, 9}: m = 16 over six primes (pt_round_mults(9) + 2; one
    chain, so the two share the JAX package's per-shape compiles), the JAX
    package's key and rounding hints (its device keygen, one per chain
    prefix) and LSD / MSD encryptions of the scalars 1, p - 2, p // 2."""
    out = {}
    qs = tuple(nt.ntt_primes(32, 30, 6))
    for p in (8, 9):
        jparams = jshe.SHEParams(m=16, p=p, qs=qs, var=2.0)
        jsk = jshe.gen_sk(jparams, jax.random.PRNGKey(70 + p))
        jhints = []
        for i in range(jshe.pt_round_mults(p)):
            pi = jshe.SHEParams(m=16, p=p, qs=qs[: len(qs) - i], var=2.0)
            jhints.append(JBatchedBGV(pi, use_pallas=False).gen_ks_quad_hint(
                jshe.SK(pi, jsk.s_ints, jsk.var), jax.random.PRNGKey(80 + i)))
        jbb = JBatchedBGV(jparams, use_pallas=False)
        vals = [1, p - 2, p // 2]
        msgs = np.zeros((8, B), dtype=np.int32)
        msgs[0] = vals
        cts = {e: tuple(map(_np, jbb.build_encrypt(jsk, encoding=e)(
            jnp.asarray(msgs), jax.random.PRNGKey(90)))) for e in ("lsd", "msd")}
        params = she.SHEParams(m=16, p=p, qs=qs, var=2.0)
        out[p] = dict(
            jbb=jbb, jrh=jshe.PTRoundHints(tuple(jhints)), cts=cts, vals=vals,
            params=params, sk=convert.sk_from_numpy(params, jsk.s_ints),
            rh=convert.pt_round_hints_from_numpy(
                params, [_hint_arrays(h) for h in jhints], device="cpu"))
    return out


@pytest.mark.parametrize("p", [8, 9])
@pytest.mark.parametrize("encoding", ["lsd", "msd"])
def test_build_pt_round_matches_jax(pt_state, p, encoding):
    st = pt_state[p]
    bb = BatchedBGV(st["params"], "cpu")
    run, bb_out, f_out = serving.build_pt_round(bb, st["rh"], encoding=encoding)
    c0, c1 = convert.cts_from_numpy(*st["cts"][encoding], device="cpu")
    e0, e1 = run(c0, c1)
    with jax.disable_jit():
        jrun, jbb_out, jf_out = jserving.build_pt_round(st["jbb"], st["jrh"], encoding=encoding)
        want = jrun(*(jnp.asarray(c.astype(np.uint32)) for c in st["cts"][encoding]))
    _same((e0, e1), want)
    pr = 2 if p == 8 else 3
    assert bb_out.params == she.SHEParams(m=16, p=pr, qs=jbb_out.params.qs, var=2.0)
    assert bb_out.params.p == jbb_out.params.p == pr and f_out == jf_out
    # reusable: a second call on the reversed batch gives the same columns
    r0, _ = run(c0.flip(-1), c1.flip(-1))
    assert torch.equal(r0.flip(-1), e0)
    got = bb_out.build_decrypt(she.SK(bb_out.params, st["sk"].s_ints, 2.0), f=f_out,
                               encoding=encoding)(e0, e1).numpy()
    np.testing.assert_array_equal(got[0], _round_half_up(st["vals"], p, pr))
    assert not got[1:].any()


def test_batched_pt_round_is_build_then_run(pt_state):
    st = pt_state[9]
    bb = BatchedBGV(st["params"], "cpu")
    c0, c1 = convert.cts_from_numpy(*st["cts"]["lsd"], device="cpu")
    bb_out, f_out, (e0, e1) = serving.batched_pt_round(bb, st["rh"], c0, c1)
    run, bb_ref, f_ref = serving.build_pt_round(bb, st["rh"])
    assert bb_out.params == bb_ref.params and f_out == f_ref
    for a, b in zip((e0, e1), run(c0, c1)):
        assert torch.equal(a, b)


# --- HomomPRF against the JAX package --------------------------------------


@pytest.fixture(scope="module")
def prf_state():
    """m = 32 -> 2 in one hop (E = 2, d = 16, the project map) over six
    primes, p = 8, BaseBGad(2), balanced(3): the JAX package's family,
    keys, tunnel hint (its device keygen) and rounding hints, and LSD / MSD
    encryptions of random keys over R."""
    p, qs = 8, tuple(nt.ntt_primes(64, 30, 6))
    jpr, jps = (jshe.SHEParams(m=m, p=p, qs=qs, var=2.0) for m in (32, 2))
    rng = np.random.default_rng(81)
    fam_j, fam = _jax_family(32, "balanced", 80)
    jsk_r, jsk_s = jshe.gen_sk(jpr, jax.random.PRNGKey(82)), jshe.gen_sk(jps, jax.random.PRNGKey(83))
    R, S, E = (j_ring_context(m, qs) for m in (32, 2, 2))
    ys = [JCyc.zero(S) for _ in range(16)]
    ys[0] = JCyc.scalar(S, 1)
    lin = jlinear.linear_pow(E, R, S, ys)
    jth = JBatchedBGV(jpr, use_pallas=False).gen_tunnel_hint(lin, jsk_s, jsk_r,
                                                             jax.random.PRNGKey(84))
    jrh = []
    for i in range(jshe.pt_round_mults(p)):
        pi = jshe.SHEParams(m=2, p=p, qs=qs[: len(qs) - i], var=2.0)
        jrh.append(JBatchedBGV(pi, use_pallas=False).gen_ks_quad_hint(
            jshe.SK(pi, jsk_s.s_ints, jsk_s.var), jax.random.PRNGKey(85 + i)))
    jbb = JBatchedBGV(jpr, use_pallas=False)
    msgs = rng.integers(0, p, (16, 2)).astype(np.int32)
    cts = {e: tuple(map(_np, jbb.build_encrypt(jsk_r, encoding=e)(
        jnp.asarray(msgs), jax.random.PRNGKey(86)))) for e in ("lsd", "msd")}
    jrh = jshe.PTRoundHints(tuple(jrh))
    params = she.SHEParams(m=32, p=p, qs=qs, var=2.0)
    tun = (2, 32, 2, [y.lift_ints(rep=JRep.POW) for y in ys],
           *(np.stack([[np.asarray(c.data) for c in getattr(h, k)] for h in jth.hints])
             for k in ("h0", "h1")))
    return dict(
        jbb=jbb, fam_j=fam_j, jsk_s=jsk_s, msgs=msgs, cts=cts,
        jhints={"round": jprf.EvalHints((jth,), 2, jrh), "reinterpret": jprf.EvalHints((jth,), 2)},
        hints={"round": convert.eval_hints_from_numpy(
                   params, [tun], 2, rounds=[_hint_arrays(h) for h in jrh.hints], device="cpu"),
               "reinterpret": convert.eval_hints_from_numpy(params, [tun], 2, device="cpu")},
        bb=BatchedBGV(params, "cpu"), fam=fam)


@pytest.mark.parametrize("mode,encoding", [("round", "lsd"), ("reinterpret", "msd")])
def test_homom_prf_component_matches_jax(prf_state, mode, encoding):
    st = prf_state
    bits = (1, 0, 1)
    c0, c1 = convert.cts_from_numpy(*st["cts"][encoding], device="cpu")
    bb_out, f_out, (e0, e1) = serving.batched_homom_prf_component(
        st["fam"], st["hints"][mode], st["bb"], c0, c1, bits, 0, encoding=encoding)
    with jax.disable_jit():
        jbb_out, jf_out, want = jserving.batched_homom_prf_component(
            st["fam_j"], st["jhints"][mode], st["jbb"],
            *(jnp.asarray(c.astype(np.uint32)) for c in st["cts"][encoding]), bits, 0,
            encoding=encoding)
    _same((e0, e1), want)
    assert bb_out.params.p == jbb_out.params.p == 2 and f_out == jf_out
    assert bb_out.params.qs == jbb_out.params.qs and bb_out.params.m == 2
    if mode == "round":  # decrypts to the clear PRF's coefficient 0, column by column
        sk_out = convert.sk_from_numpy(bb_out.params, st["jsk_s"].s_ints)
        got = bb_out.build_decrypt(sk_out, f=f_out, encoding=encoding)(e0, e1).numpy()
        for b in range(2):
            assert got[0, b] == prf.prf_ints(st["fam"], st["msgs"][:, b], bits, 2)[0][0]


# --- the port's own hints through the port's pipeline ----------------------


@pytest.mark.parametrize("p", [8, 9])
def test_port_pt_round_hints_round_to_nearest(p):
    """pt_round_hints (the port's keygen, per chain prefix) through
    build_pt_round, LSD and MSD: decrypt == round-half-up of v pr / p on
    every scalar v."""
    qs = tuple(nt.ntt_primes(32, 30, she.pt_round_mults(p) + 2))
    params = she.SHEParams(m=16, p=p, qs=qs, var=2.0)
    g = prng.KeyChain(p)
    sk = she.gen_sk(params, g(), "cpu")
    rh = she.pt_round_hints(sk, gadget.RnsGad(), g(), "cpu")
    assert [h.params.qs for h in rh.hints] == [qs[: len(qs) - i] for i in range(len(rh.hints))]
    bb = BatchedBGV(params, "cpu")
    vals = torch.arange(p)
    msgs = torch.zeros((8, p), dtype=torch.int32)
    msgs[0] = vals
    pr = she._pt_round_base(p)[0]
    for encoding in ("lsd", "msd"):
        run, bb_out, f_out = serving.build_pt_round(bb, rh, encoding=encoding)
        out = run(*bb.build_encrypt(sk, encoding)(msgs, g()))
        got = bb_out.build_decrypt(she.SK(bb_out.params, sk.s_ints, 2.0), f=f_out,
                                   encoding=encoding)(*out).numpy()
        np.testing.assert_array_equal(got[0], _round_half_up(vals.numpy(), p, pr))
        assert not got[1:].any()


def test_port_homom_prf_down_a_halving_tower_to_n1():
    """make_eval_hints (the port's keygen) down 16 -> 8 -> 4 -> 2 with the
    project maps and the rounding: the last hop and the rounding run the
    m = 2 ring (n = 1) on the CPU, and column b decrypts to coefficient 0
    of the clear PRF of key b."""
    p, rings = 8, [16, 8, 4, 2]
    qs = tuple(nt.ntt_primes(32, 30, she.pt_round_mults(p) + 4))
    g, rng = prng.KeyChain(11), np.random.default_rng(11)
    sks = [she.gen_sk(she.SHEParams(m=m, p=p, qs=qs, var=2.0), g(), "cpu") for m in rings]
    fam = prf.PRFFamily.random(ring_context(16, (p,)), gadget.BaseBGad(2), prf.balanced(2), g(), "cpu")
    hints, sk_out = prf.make_eval_hints(fam, sks, rings, rings[1:], gadget.RnsGad(), g(), homomorphic_round=True,
                                        maps="project", device="cpu")
    assert len(hints.tunnels) == 3 and len(hints.rounds.hints) == she.pt_round_mults(p)
    bb = BatchedBGV(sks[0].params, "cpu")
    keys = torch.from_numpy(rng.integers(0, p, (8, 4)).astype(np.int32))
    bits = (0, 1)
    bb_out, f_out, out = serving.batched_homom_prf_component(
        fam, hints, bb, *bb.build_encrypt(sks[0])(keys, g()), bits, 0)
    assert bb_out.params.m == 2 and bb_out.params.p == 2 and out[0].shape[1] == 1
    got = bb_out.build_decrypt(she.SK(bb_out.params, sk_out.s_ints, 2.0), f=f_out)(*out)
    want = [prf.prf_ints(fam, keys[:, b].numpy(), bits, 2)[0][0] for b in range(4)]
    np.testing.assert_array_equal(got[0].numpy(), want)
    with pytest.raises(ValueError, match="targets Z_2"):
        prf.make_eval_hints(fam, sks, rings, rings[1:], gadget.RnsGad(), g(), p_final=4, homomorphic_round=True,
                            maps="project", device="cpu")
