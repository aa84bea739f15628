"""The port's serving builders against the JAX package's, bit for bit (the
schedule's pieces, the base-b digits and the port's own hints:
test_torch_serving.py): the KH-PRF's family and clear PRF,
`serving.build_pt_round` (m = 16, p in {8, 9}, LSD and MSD) and
`serving.batched_homom_prf_component` (m = 32 -> 2 in one hop, E = 2, with
the rounding and with the MSD reinterpretation) against `lol_tpu.serving`
over `BatchedBGV(params, use_pallas=False)` on the JAX package's keys,
hints and public parameters carried across; the JAX serving builders run
with jit disabled, their keygen jitted."""

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

from test_torch_serving import B, _hint_arrays, _jax_family, _np, _round_half_up, _same

torch.set_num_threads(2)


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
