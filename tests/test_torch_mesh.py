"""The port's mesh-aware builders against their unsharded runs and the JAX package.

The dry run's shapes (`__graft_entry__.dryrun_multichip`: m = 32, two
30-bit primes, p = 257, B = 8) on a one-process mesh of "cpu" entries,
{"rns": 2, "data": 4}: the port makes the keys, hints and ciphertexts,
the JAX package's `BatchedBGV(params, use_pallas=False)` runs on the same
ones carried across (its builders with jit disabled: jnp integer
operations op by op, cheaper than compiling at this size).  For every
mesh builder of `BatchedBGV` (the step LSD and MSD, the modulus switch,
both linear key switches, the ext step, Galois single and hoisted, the
tunnel m = 32 -> 16) and for `serving.build_pt_round` the unsharded port
output equals the JAX package's bit for bit, and `unshard_batch_rns` of
the mesh output equals the unsharded port output.  The general-m step at
m = 36 (the dry run's leg) and HomomPRF m = 32 -> 2 with `mesh=` equal
the port's unsharded runs, which tests/test_torch_general.py and
tests/test_torch_serving.py hold against the JAX package, and decrypt to
`pt_mul` and the clear PRF.  Also: the layout rule for
channel counts that R does not divide (the rescale's output, the
extended chain), the gather / scatter / relayout round trips, the
refusal of blocks in another layout, and the data-only mesh view.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lol_tpu import gadget as jgd
from lol_tpu import linear as jlinear
from lol_tpu import serving as jserving
from lol_tpu import she as jshe
from lol_tpu.cyc import Cyc as JCyc, Rep as JRep
from lol_tpu.ring import ring_context as j_ring_context
from lol_tpu.she_batched import BatchedBGV as JBatchedBGV
from lol_tpu_torch import prng
from lol_tpu_torch import gadget, linear, numtheory as nt, prf, serving, she
from lol_tpu_torch.parallel import sharding as sh
from lol_tpu_torch.ring import ring_context
from lol_tpu_torch.she_batched import BatchedBGV

torch.set_num_threads(2)

B = 8
MESH = sh.make_mesh({"rns": 2, "data": 4}, ["cpu"] * 8)


def _jhint(params, h):
    """A port KSHint (or one of a tunnel's) as the JAX package's."""
    jp = jshe.SHEParams(m=params.m, p=params.p, qs=params.qs, var=params.var)
    return jshe.KSHint(jp, jp.ctx, jgd.RnsGad(), *(
        tuple(JCyc(jp.ctx, JRep.CRT, jnp.asarray(t[j].numpy().astype(np.uint32)))
              for j in range(t.shape[0])) for t in (h.h0, h.h1)))


def _u32(*ts):
    return [jnp.asarray(t.numpy().astype(np.uint32)) for t in ts]


def _same(got, want):
    """Port tensors (or dicts / tuples of them) == JAX arrays, exactly."""
    if isinstance(got, dict):
        assert sorted(got) == sorted(want)
        for k in got:
            _same(got[k], want[k])
        return
    for a, b in zip(got, want):
        assert a.dtype == torch.int32
        np.testing.assert_array_equal(a.numpy().astype(np.int64), np.asarray(b).astype(np.int64))


def _shard(*ts, mesh=MESH):
    return [sh.shard_batch_rns(mesh, t) for t in ts]


def _unsharded(out):
    if isinstance(out, dict):
        return {k: _unsharded(v) for k, v in out.items()}
    return tuple(sh.unshard_batch_rns(b) for b in out)


def _equal(a, b):
    if isinstance(a, dict):
        return sorted(a) == sorted(b) and all(_equal(a[k], b[k]) for k in a)
    return all(torch.equal(x, y) for x, y in zip(a, b))


def _state(m, p):
    """At m, two primes and two special ones: the port's key, a second
    key, the quad and linear hints, two LSD and two MSD encryptions of B
    random messages, and the JAX package's pipeline."""
    all4 = tuple(nt.ntt_primes(m, 30, 4))
    params = she.SHEParams(m=m, p=p, qs=all4[:2], var=2.0)
    g, rng = prng.KeyChain(m), np.random.default_rng(m)
    bb = BatchedBGV(params, "cpu")
    sk, sk_new = she.gen_sk(params, g(), "cpu"), she.gen_sk(params, g(), "cpu")
    cts = {e: [bb.build_encrypt(sk, e)(she.pt_random(params, rng, (B,), "cpu"), g()) for _ in range(2)]
           for e in ("lsd", "msd")}
    return dict(params=params, bb=bb, sk=sk, special=all4[2:], cts=cts, g=g,
                jbb=JBatchedBGV(jshe.SHEParams(m=m, p=p, qs=all4[:2], var=2.0),
                                use_pallas=False),
                quad=bb.gen_ks_quad_hint(sk, g()), lin=bb.gen_ks_linear_hint(sk_new, sk, g()))


@pytest.fixture(scope="module")
def st():
    return _state(32, 257)


def _check(port, mesh_fn, jax_fn, *ts):
    """port(*ts) == jax_fn(*ts as JAX arrays) and unshard(mesh_fn(blocks))
    == port(*ts)."""
    want = port(*ts)
    with jax.disable_jit():
        _same(want, jax_fn(*_u32(*ts)))
    got = mesh_fn(*_shard(*ts))
    assert _equal(_unsharded(got), want)
    return got


@pytest.mark.parametrize("encoding", ["lsd", "msd"])
def test_step_and_mod_switch_on_the_mesh(st, encoding):
    bb, jbb = st["bb"], st["jbb"]
    (c0, c1), (d0, d1) = st["cts"][encoding]
    jq = _jhint(st["params"], st["quad"])
    out = _check(bb.build_step(st["quad"], encoding), bb.build_step(st["quad"], encoding, MESH),
                 jbb.build_step(jq, encoding=encoding), c0, c1, d0, d1)
    assert out[0].shape == (1, 4)  # one channel left: data-only blocks
    _check(bb.build_mod_switch(encoding), bb.build_mod_switch(encoding, MESH),
           jbb.build_mod_switch(encoding), c0, c1)


def test_general_m_step_on_the_mesh():
    """The dry run's general-m leg: the step at m = 36 = 2^2 3^2 (p = 5),
    LSD and MSD, whose transforms run `crt_cm`'s odd axis per block: the
    mesh run == the unsharded one (which test_torch_general.py holds
    against the JAX package), and it decrypts to `pt_mul`."""
    s36 = _state(36, 5)
    bb, params = s36["bb"], s36["params"]
    dropped = she.SHEParams(m=36, p=5, qs=params.qs[:1], var=2.0)
    g, rng = prng.KeyChain(7), np.random.default_rng(7)
    for e in ("lsd", "msd"):
        a, b = she.pt_random(params, rng, (B,), "cpu"), she.pt_random(params, rng, (B,), "cpu")
        enc = bb.build_encrypt(s36["sk"], e)
        c = (*enc(a, g()), *enc(b, g()))
        want = bb.build_step(s36["quad"], e)(*c)
        got = bb.build_step(s36["quad"], e, MESH)(*_shard(*c))
        assert _equal(_unsharded(got), want)
        dec = BatchedBGV(dropped, "cpu").build_decrypt(
            she.SK(dropped, s36["sk"].s_ints, 2.0), f=bb.step_f(1, 1, e), encoding=e)(*want)
        for k in range(B):
            np.testing.assert_array_equal(dec[:, k].numpy(),
                                          she.pt_mul(params, a[:, k].numpy(), b[:, k].numpy()))


def test_key_switches_on_the_mesh(st):
    bb, jbb = st["bb"], st["jbb"]
    (c0, c1), (d0, d1) = st["cts"]["lsd"]
    _check(bb.build_key_switch_linear(st["lin"]), bb.build_key_switch_linear(st["lin"], MESH),
           jbb.build_key_switch_linear(_jhint(st["params"], st["lin"])), c0, c1)
    special = st["special"]
    g = st["g"]
    for hint, build, jbuild, args in (
            (bb.gen_ks_quad_hint_ext(st["sk"], special, g()), "build_step_ext",
             "build_step_ext", (c0, c1, d0, d1)),
            (bb.gen_ks_linear_hint_ext(st["sk"], st["sk"], special, g()),
             "build_key_switch_linear_ext", "build_key_switch_linear_ext", (c0, c1))):
        jp = st["jbb"].params
        ctx_ext = j_ring_context(jp.m, hint.ext_qs)
        jh = jshe.KSHintExt(jp, ctx_ext, hint.n_special, jgd.RnsGad(), *(
            tuple(JCyc(ctx_ext, JRep.CRT, jnp.asarray(t[j].numpy().astype(np.uint32)))
                  for j in range(t.shape[0])) for t in (hint.h0, hint.h1)))
        _check(getattr(bb, build)(hint), getattr(bb, build)(hint, mesh=MESH),
               getattr(jbb, jbuild)(jh), *args)


def test_galois_on_the_mesh(st):
    bb, jbb = st["bb"], st["jbb"]
    c0, c1 = st["cts"]["lsd"][0]
    hints = {k: bb.gen_galois_hint(k, st["sk"], st["g"]()) for k in (3, 5)}
    jhints = {k: _jhint(st["params"], h) for k, h in hints.items()}
    k = 3
    _check(bb.build_galois(hints[k], k), bb.build_galois(hints[k], k, MESH),
           jbb.build_galois(jhints[k], k), c0, c1)
    _check(bb.build_galois_many(hints), bb.build_galois_many(hints, MESH),
           jbb.build_galois_many(jhints), c0, c1)


def test_tunnel_on_the_mesh(st):
    """The tunnel m -> m/2 (E = S, ys = [1, 0, ...]) on the rns x data
    mesh and on its data-only view."""
    bb, jbb, params = st["bb"], st["jbb"], st["params"]
    ps = she.SHEParams(m=params.m // 2, p=params.p, qs=params.qs, var=2.0)
    S = ps.ctx
    ys = [np.zeros(S.n, dtype=np.int64) for _ in range(params.ctx.n // S.n)]
    ys[0][0] = 1
    f = linear.linear_pow(S, params.ctx, S, ys)
    th = bb.gen_tunnel_hint(f, she.gen_sk(ps, st["g"](), "cpu"), st["sk"], st["g"]())
    jS, jR = (j_ring_context(m, params.qs) for m in (ps.m, params.m))
    jf = jlinear.linear_pow(jS, jR, jS, [JCyc.from_ints(jS, y) for y in ys])
    jth = jshe.TunnelHint(jf, jgd.RnsGad(), tuple(_jhint(ps, h) for h in th.hints))
    c0, c1 = st["cts"]["lsd"][0]
    out = _check(bb.build_tunnel(th), bb.build_tunnel(th, MESH), jbb.build_tunnel(jth), c0, c1)
    assert out[0].shape == (2, 4)
    data = sh.data_mesh(MESH)
    got = bb.build_tunnel(th, data)(*_shard(c0, c1, mesh=data))
    assert got[0].shape == (1, 4) and _equal(_unsharded(got), bb.build_tunnel(th)(c0, c1))


def test_elementwise_builders_on_the_mesh(st):
    """The serving layer's per-block stages (add / sub at unequal scales,
    public add and multiply with (n, B) and (n, 1) plaintexts, the
    encoding switches, the exact divide) == their unsharded runs."""
    bb = st["bb"]
    (c0, c1), (d0, d1) = st["cts"]["lsd"]
    pub = she.pt_random(st["params"], np.random.default_rng(B), (B,), "cpu")
    for name, args, extra in (("build_add", (1, 3, True), (c0, c1, d0, d1)),
                              ("build_add_public", (5, "msd"), (c0, c1, pub)),
                              ("build_mul_public", (), (c0, c1, pub[:, :1])),
                              ("build_to_msd", (), (c0, c1)), ("build_to_lsd", (), (c0, c1))):
        want = getattr(bb, name)(*args)(*extra)
        blocks = [sh.shard_batch_rns(MESH, t) if t.dim() == 3 else t for t in extra]
        assert _equal(_unsharded(getattr(bb, name)(*args, mesh=MESH)(*blocks)), want), name


def test_pt_round_on_the_mesh():
    """build_pt_round Z_9 -> Z_3 at m = 32 over three primes (the cube's
    squaring runs data-only blocks at three primes, its product split over
    rns = 2 at two, the divide data-only at one) == the JAX package's
    `batched_pt_round` on the port's hints, and the mesh run == the
    unsharded one, LSD and MSD."""
    params = she.SHEParams(m=32, p=9, qs=tuple(nt.ntt_primes(32, 30, 3)), var=2.0)
    g = prng.KeyChain(5)
    sk = she.gen_sk(params, g(), "cpu")
    rh = she.pt_round_hints(sk, gadget.RnsGad(), g(), "cpu")
    L0 = len(params.qs)
    jrh = jshe.PTRoundHints(tuple(
        _jhint(she.SHEParams(m=32, p=9, qs=params.qs[:L0 - i], var=2.0), h)
        for i, h in enumerate(rh.hints)))
    bb = BatchedBGV(params, "cpu")
    jbb = JBatchedBGV(jshe.SHEParams(m=32, p=9, qs=params.qs, var=2.0), use_pallas=False)
    msgs = torch.zeros((16, B), dtype=torch.int32)
    msgs[0] = torch.arange(B) % 9
    for e in ("lsd", "msd"):
        c = bb.build_encrypt(sk, e)(msgs, g())
        _check(serving.build_pt_round(bb, rh, encoding=e)[0],
               serving.build_pt_round(bb, rh, encoding=e, mesh=MESH)[0],
               lambda c0, c1: jserving.batched_pt_round(jbb, jrh, c0, c1, encoding=e)[2], *c)


def test_homom_prf_on_the_mesh():
    """HomomPRF component 0 down 32 -> 16 -> 8 -> 4 -> 2 (project maps,
    p = 8, seven primes, with the rounding) with mesh= == the unsharded
    run, and it decrypts to the clear PRF."""
    qs = tuple(nt.ntt_primes(32, 30, she.pt_round_mults(8) + 4))
    rings = [32, 16, 8, 4, 2]
    g, rng = prng.KeyChain(6), np.random.default_rng(6)
    sks = [she.gen_sk(she.SHEParams(m=r, p=8, qs=qs, var=2.0), g(), "cpu") for r in rings]
    fam = prf.PRFFamily.random(ring_context(32, (8,)), gadget.BaseBGad(2), prf.balanced(2), g(), "cpu")
    hints, sk_out = prf.make_eval_hints(fam, sks, rings, rings[1:], gadget.RnsGad(), g(), homomorphic_round=True,
                                        maps="project", device="cpu")
    bb = BatchedBGV(sks[0].params, "cpu")
    s = torch.from_numpy(rng.integers(0, 8, (16, 1)).astype(np.int32))
    c = bb.build_encrypt(sks[0])(s.expand(16, B), g())
    bb_out, f_out, want = serving.batched_homom_prf_component(fam, hints, bb, *c, (1, 0), 0)
    *_, got = serving.batched_homom_prf_component(fam, hints, bb, *_shard(*c), (1, 0), 0,
                                                  mesh=MESH)
    assert _equal(_unsharded(got), want)
    dec = bb_out.build_decrypt(she.SK(bb_out.params, sk_out.s_ints, 2.0), f=f_out)(*want)
    assert dec[0].tolist() == [int(prf.prf_ints(fam, s[:, 0].numpy(), (1, 0), 2)[0][0])] * B


@pytest.mark.parametrize("R,nrns", [(2, 4), (2, 3), (3, 3), (3, 5), (4, 2), (1, 3)])
def test_layout_rule_and_its_copies(R, nrns):
    """shard_batch_rns splits the channels over rns where R divides them,
    else data-only (1, Dd) blocks on rns row 0; rns_gather replicates a
    column's full stack on each of its devices, rns_scatter inverts it,
    and rns_relayout takes uneven rows (a rescale's output) into the
    rule's layout."""
    mesh = sh.make_mesh({"rns": R, "data": 2}, ["cpu"] * (2 * R))
    x = torch.arange(nrns * 3 * 4, dtype=torch.int32).view(nrns, 3, 4)
    blocks = sh.shard_batch_rns(mesh, x)
    rows = R if nrns % R == 0 else 1
    assert blocks.shape == (rows, 2) == (sh.rns_rows(mesh, nrns), 2)
    grid = sh.rns_data_grid(mesh)
    for (i, j), b in np.ndenumerate(blocks):
        assert b.device == grid[i, j] and b.shape == (nrns // rows, 3, 2)
    assert torch.equal(sh.unshard_batch_rns(blocks), x)
    full = sh.rns_gather(mesh, blocks)
    assert full.shape == (R, 2)
    for (i, j), f in np.ndenumerate(full):
        assert f.device == grid[i, j] and torch.equal(f, x[..., 2 * j:2 * j + 2])
    back = sh.rns_scatter(mesh, full)
    assert back.shape == blocks.shape and all(
        torch.equal(a, b) and a.device == b.device for a, b in zip(back.flat, blocks.flat))
    parts = np.empty((R, 2), dtype=object)  # the last row one channel short
    cuts = [0] + [min(nrns - 1, (r + 1) * -(-nrns // R)) for r in range(R)]
    for (r, j), _ in np.ndenumerate(parts):
        parts[r, j] = x[cuts[r]:cuts[r + 1], :, 2 * j:2 * j + 2].to(grid[r, j])
    moved = sh.rns_relayout(mesh, parts)
    assert torch.equal(sh.unshard_batch_rns(moved), x[:-1])
    assert moved.shape == (sh.rns_rows(mesh, nrns - 1), 2)
    assert sh.rns_relayout(mesh, blocks) is blocks


def test_mesh_inputs_are_checked(st):
    """A mesh module refuses unsharded tensors and blocks of another
    layout; a mesh builder takes the whole chain's pipeline."""
    bb = st["bb"]
    (c0, c1), _ = st["cts"]["lsd"]
    ksl = bb.build_key_switch_linear(st["lin"], MESH)
    with pytest.raises(ValueError, match="object array of blocks"):
        ksl(c0, c1)
    data = sh.data_mesh(MESH)
    with pytest.raises(ValueError, match="object array of blocks"):
        ksl(*_shard(c0, c1, mesh=data))
    with pytest.raises(ValueError, match="whole chain"):
        bb._view(range(1), "cpu").build_mod_switch(mesh=MESH)
    assert sh.data_mesh(MESH).shape == {"rns": 1, "data": 4}
