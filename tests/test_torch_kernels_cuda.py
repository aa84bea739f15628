"""The Hopper kernels against their plain torch versions on the card.

Marked `cuda`: every test takes the `cuda` fixture, which skips without a
CUDA device.  On a machine with an H100 and nvcc, run
`python -m pytest tests/test_torch_kernels_cuda.py -q`.
"""

import numpy as np
import pytest
import torch

from lol_tpu_torch import gadget, numtheory as nt, prf, prng, serving, she
from lol_tpu_torch.bench import mxu_ntt as mx, steptime
from lol_tpu_torch.ops import ntt
from lol_tpu_torch.ops.cuda import ntt_kernel as tk, pointwise as pw, prng as pk
from lol_tpu_torch.ops.cuda import remote_ntt as rn
from lol_tpu_torch.parallel import sharding as sh
from lol_tpu_torch.ring import ring_context
from lol_tpu_torch.she_batched import BatchedBGV

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("n", [1 << k for k in range(0, 17)])
@pytest.mark.parametrize("B", [1, 1000, 1024])
def test_kernels_match_plain(cuda, n, B):
    """Every pass length the forward / GS kernels are built for: one pass
    of L = n up to 4096 (L = 1, the m = 2 ring, a round of no stages), a
    cross pass of L = n/512 and the L = 512 block pass above."""
    q_src, q = nt.ntt_primes(max(2 * n, 4), 30, 2)
    plan = ntt.ntt_plan(n, q)
    g = torch.Generator(device=cuda).manual_seed(n + B)
    x = torch.randint(0, q, (n, B), generator=g, device=cuda, dtype=torch.int32)
    x[0] = q - 1
    for inverse in (False, True):
        assert torch.equal(tk.ntt_cm(x, plan, inverse=inverse),
                           tk.ntt_cm_ref(x, plan, inverse=inverse))
    for src in (q_src, 12289):
        xs = torch.randint(0, src, (n, B), generator=g, device=cuda, dtype=torch.int32)
        xs[0] = src - 1
        assert torch.equal(tk.ntt_cm(xs, plan, pre_digit_q=src),
                           tk.ntt_cm_ref(xs, plan, pre_digit_q=src))
    assert torch.equal(tk.ntt_cm(tk.ntt_cm(x, plan), plan, inverse=True), x)


@pytest.mark.parametrize("n", [256, 2048])
def test_digit_prologue_at_a_small_q(cuda, n):
    """The prologue's two kernel paths at q = 12289: a 30-bit source
    (pre_q > 2q, reduced exactly) and sources below 2q (left lazy, below
    4q, for the first stage to fold), each against the plain version."""
    plan = ntt.ntt_plan(n, 12289)
    g = torch.Generator(device=cuda).manual_seed(n)
    for src in (nt.ntt_primes(2 * n, 30, 1)[0], 7681, 2 * 12289 - 1):
        for B in (1, 1000):
            xs = torch.randint(0, src, (n, B), generator=g, device=cuda, dtype=torch.int32)
            xs[0], xs[-1] = src - 1, (src + 1) // 2
            assert torch.equal(tk.ntt_cm(xs, plan, pre_digit_q=src),
                               tk.ntt_cm_ref(xs, plan, pre_digit_q=src))


@pytest.mark.parametrize("n,B", [(1 << k, B) for k in range(1, 17) for B in (1, 1000, 1024)]
                         + [(4096, 16384)])
def test_route_b_inverse_matches_plain_and_gs(cuda, n, B):
    """Route B at every n 2-65536: each pass of `dit_schedule`, one pass
    up to 4096, a cluster pass at 16384, block and cross passes at 8192
    and above 16384."""
    for q in nt.ntt_primes(2 * n, 30, 2):
        plan = ntt.ntt_plan(n, q)
        g = torch.Generator(device=cuda).manual_seed(n * B + q % 97)
        x = torch.randint(0, q, (n, B), generator=g, device=cuda, dtype=torch.int32)
        x[0] = q - 1
        if n > 2:
            x[1], x[2] = 0, 1
        got = tk.ntt_cm(x, plan, inverse=True, alg="dit")
        assert torch.equal(got, tk.ntt_cm_ref(x, plan, inverse=True, alg="dit"))
        assert torch.equal(got, tk.ntt_cm(x, plan, inverse=True))


@pytest.mark.parametrize("n", [8192, 16384, 65536])
@pytest.mark.parametrize("last", [False, True])
def test_route_b_cross_pass_takes_lazy_words(cuda, n, last):
    """The cross pass of the WINDOW-row factoring alone, on words in
    [0, 2q) as the twist leaves them (0, 1, q - 1, q and 2q - 1 planted):
    the DFT over P = n / 512 rows 512 apart and the scale, equal mod q to
    the plain ones on the words mod q; folded to [0, q) when last, else
    below 2q."""
    q = nt.ntt_primes(2 * n, 30, 1)[0]
    plan = ntt.ntt_plan(n, q)
    cross = tk.schedule(n)[0]
    P, tS = cross.L, n // cross.L
    tab = plan.dit_tables(tS, cuda)
    g = torch.Generator(device=cuda).manual_seed(n + last)
    for B in (1, 1000, 1024):
        x = _words(g, cuda, (n, B), 0, 2 * q, [0, 1, q - 1, q, 2 * q - 1])
        y = torch.empty_like(x)
        tk.invb_pass(x, y, plan, cross, tab, "cross", "scale", last)
        v = ntt._dit_bitrev_net((rn._u32(x) % q).view(P, tS * B), tab["cross"].long(), q)
        want = (v.view(P, tS, B) * tab["scale"].long().view(P, tS, 1) % q).view(n, B)
        got = rn._u32(y)
        assert bool((got < (q if last else 2 * q)).all())
        assert torch.equal(got % q, want)


@pytest.mark.parametrize("cluster", [1, 4])
def test_route_b_refuses_a_geometry_without_an_instance(cuda, cluster):
    """A pass no ntt_invb_pass instance is built for (8192 rows in one
    CTA, or over the 4-CTA cluster that only `ntt_cm` runs): the C entry
    refuses it, the wrapper raises, nothing launches."""
    n = 8192
    plan = ntt.ntt_plan(n, nt.ntt_primes(2 * n, 30, 1)[0])
    x = torch.zeros((n, 8), dtype=torch.int32, device=cuda)
    before = dict(tk.LAUNCHES)
    with pytest.raises(RuntimeError, match="invalid argument"):
        tk.invb_pass(x, x, plan, tk.Pass(n, 1, 1, 0, 1, 0, 1, 8, cluster),
                     plan.dit_tables(n, cuda), "blk", "scale", True)
    assert tk.LAUNCHES == before


@pytest.mark.parametrize("shape", [(1, 1), (3, 5), (256, 100), (512, 1024), (4096, 1000)])
def test_ct_mul_matches_plain(cuda, shape):
    for q in nt.ntt_primes(2 ** 15, 30, 3) + [12289]:
        g = torch.Generator(device=cuda).manual_seed(q % 1009 + shape[1])
        ops = [torch.randint(0, q, shape, generator=g, device=cuda, dtype=torch.int32)
               for _ in range(4)]
        ext = torch.tensor([0, 1, q - 1], device=cuda, dtype=torch.int32)
        flat = [o.view(-1) for o in ops]
        k = min(flat[0].numel(), 81)
        for j, f in enumerate(flat):  # every combination of 0, 1, q-1
            f[:k] = ext[(torch.arange(k, device=cuda) // 3 ** j) % 3]
        got = pw.ct_mul_cm(*ops, q)
        want = pw.ct_mul_cm_ref(*ops, q)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    # an operand offset by one element: the unaligned (scalar) kernel
    big = torch.randint(0, q, (4, 4097), generator=g, device=cuda, dtype=torch.int32)
    ops = [big[i, 1:] for i in range(4)]
    for a, b in zip(pw.ct_mul_cm(*ops, q), pw.ct_mul_cm_ref(*ops, q)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("shape,iters", [((1,), 0), ((33, 7), 5), ((512, 512), 64),
                                         ((mx.GRID * mx.ROWS, mx.LANES), mx.ITERS)])
def test_chain_matches_plain(cuda, shape, iters):
    g = torch.Generator(device=cuda).manual_seed(iters)
    x = torch.randint(-(1 << 31), 1 << 31, shape, generator=g, device=cuda,
                      dtype=torch.int32)
    assert torch.equal(mx.chain(x, iters), mx.chain_ref(x, iters))


@pytest.mark.parametrize("n", [4096, 8192, 16384, 65536])
def test_launch_counter_counts_each_pass(cuda, n):
    """ntt_cm launches one forward / GS kernel per pass of `cm_schedule`
    (one cluster pass at n = 8192 and 16384), and route B one
    ntt_invb_pass per pass of `dit_schedule`: the block pass, then a cross
    pass except at n <= 4096 and 2^14."""
    plan = ntt.ntt_plan(n, nt.ntt_primes(2 * n, 30, 1)[0])
    x = torch.zeros((n, 8), dtype=torch.int32, device=cuda)
    before = dict(tk.LAUNCHES)
    tk.ntt_cm(x, plan)
    tk.ntt_cm(x, plan, inverse=True)
    passes = len(tk.cm_schedule(n))
    assert passes == (1 if n <= 4096 or n in tk.CLUSTER else 2)
    assert tk.LAUNCHES["ntt_fwd"] - before["ntt_fwd"] == passes
    assert tk.LAUNCHES["ntt_inv"] - before["ntt_inv"] == passes
    tk.ntt_cm(x, plan, inverse=True, alg="dit")
    assert tk.LAUNCHES["ntt_invb_block"] - before["ntt_invb_block"] == 1
    cross = n not in (4096, 16384)
    assert tk.LAUNCHES["ntt_invb_cross"] - before["ntt_invb_cross"] == cross
    assert len(tk.dit_schedule(n)) == 1 + cross


@pytest.mark.parametrize("n", [2, 16, 256, 2048, 4096, 8192, 16384, 65536])
@pytest.mark.parametrize("inverse", [False, True])
def test_lazy_passes_match_plain_after_a_fold(cuda, n, inverse):
    """run_passes(..., last=False) on lazy words, as ring phase A hands
    them on (below 4q forward, 2q inverse, 0, 1 and the top planted):
    the output stays lazy (below 4q / 2q) and equals, mod q, the plain
    network on the words mod q (no n^-1: that is the last pass's)."""
    q = nt.ntt_primes(2 * n, 30, 1)[0]
    plan = ntt.ntt_plan(n, q)
    hi = (2 if inverse else 4) * q
    g = torch.Generator(device=cuda).manual_seed(n + inverse)
    w = plan.tables(cuda)[2 if inverse else 0].long()
    net = ntt.gs_net_cm if inverse else ntt.dit_net_cm
    for B in (1, 1000, 1024):
        x = _words(g, cuda, (n, B), 0, hi, [0, 1, hi - 1, q - 1, q])
        want = net(rn._u32(x) % q, w, q)
        for passes in (tk.schedule(n), tk.cm_schedule(n)):
            got = rn._u32(tk.run_passes(x, plan, passes[::-1] if inverse else passes,
                                        inverse, last=False))
            assert bool((got < hi).all())
            assert torch.equal(got % q, want)


@pytest.mark.parametrize("n", [1, 2, 4])
def test_tower_tail_transforms_launch_once(cuda, n):
    """The HomomPRF tower's last rings (m = 8, 4, 2): forward with and
    without the digit prologue and the GS inverse, kernel == plain bit for
    bit, one launch each; route B at n = 1 is x itself, as in the JAX
    package."""
    q_src, q = nt.ntt_primes(8, 30, 2)
    plan = ntt.ntt_plan(n, q)
    g = torch.Generator(device=cuda).manual_seed(n)
    x = torch.randint(0, q, (n, 1024), generator=g, device=cuda, dtype=torch.int32)
    x[0, :3] = torch.tensor([q - 1, 0, 1], device=cuda)
    for kw in ({}, {"pre_digit_q": q_src}, {"inverse": True}):
        before = dict(tk.LAUNCHES)
        got = tk.ntt_cm(x, plan, **kw)
        name = "ntt_inv" if kw.get("inverse") else "ntt_fwd"
        assert {k: tk.LAUNCHES[k] - before[k] for k in before} == dict.fromkeys(before, 0) | {name: 1}
        assert torch.equal(got, tk.ntt_cm_ref(x, plan, **kw))
    if n == 1:
        assert torch.equal(tk.ntt_cm(x, plan, inverse=True, alg="dit"), x)


@pytest.mark.parametrize("B", [1, 7, 1024])
def test_route_b_at_n1_runs_the_length1_pass(cuda, B):
    """Route B at n = 1 returns x (the reference's `if n == 1: return x`)
    through the length-1 pass of the GS inverse: one kernel launch, no
    route-B pass, no plain version."""
    q = nt.ntt_primes(2, 30, 1)[0]
    plan = ntt.ntt_plan(1, q)
    x = torch.randint(0, q, (1, B), device=cuda, dtype=torch.int32)
    x[0, :3] = torch.tensor([q - 1, 0, 1], device=cuda)[:B]
    before = dict(tk.LAUNCHES)
    got = tk.ntt_cm(x, plan, inverse=True, alg="dit")
    assert {k: tk.LAUNCHES[k] - before[k] for k in before} == dict.fromkeys(before, 0) | {"ntt_inv": 1}
    assert got.device == x.device and torch.equal(got, x)
    assert torch.equal(got.cpu(), tk.ntt_cm_ref(x.cpu(), plan, inverse=True, alg="dit"))


def test_step_on_card_equals_step_on_cpu(cuda):
    m = 512
    params = she.SHEParams(m=m, p=257, qs=tuple(nt.ntt_primes(m, 30, 3)), var=2.0)
    g, rng = prng.KeyChain(0), np.random.default_rng(0)
    sk = she.gen_sk(params, g())
    bb = BatchedBGV(params, cuda)
    hint = bb.gen_ks_quad_hint(sk, g())
    enc = bb.build_encrypt(sk)
    cts = (*enc(she.pt_random(params, rng, (40,), cuda), g()),
           *enc(she.pt_random(params, rng, (40,), cuda), g()))
    before = pw.LAUNCHES["ct_mul"]
    e_gpu = bb.build_step(hint)(*cts)
    assert pw.LAUNCHES["ct_mul"] - before == len(params.qs)
    e_cpu = BatchedBGV(params, "cpu").build_step(hint)(*(c.cpu() for c in cts))
    for a, b in zip(e_gpu, e_cpu):
        assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("B", [1, 1000, 1024])
def test_prologue_on_the_tunnel_ring(cuda, B):
    """The forward at n = 8192 (one 4-CTA cluster pass), the target ring
    of the tunnel m = 32768 -> 16384, with the prologue from every prime
    of its chain into every channel: q itself included, which the tunnel
    passes and the kernel runs as no prologue."""
    qs = nt.ntt_primes(32768, 30, 3)
    g = torch.Generator(device=cuda).manual_seed(B)
    for q in qs:
        plan = ntt.ntt_plan(8192, q)
        for src in qs:
            xs = torch.randint(0, src, (8192, B), generator=g, device=cuda, dtype=torch.int32)
            xs[0], xs[-1] = src - 1, (src + 1) // 2
            assert torch.equal(tk.ntt_cm(xs, plan, pre_digit_q=src),
                               tk.ntt_cm_ref(xs, plan, pre_digit_q=src))


def _pipelines(cuda, m, seed):
    params = she.SHEParams(m=m, p=257, qs=tuple(nt.ntt_primes(m, 30, 3)), var=2.0)
    g, rng = prng.KeyChain(seed), np.random.default_rng(seed)
    return params, g, rng, BatchedBGV(params, cuda), BatchedBGV(params, "cpu")


def _same(gpu_out, cpu_out):
    for a, b in zip(gpu_out, cpu_out):
        assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("builder", ["step_msd", "mod_switch_lsd", "mod_switch_msd",
                                     "key_switch_linear", "add_public_n1", "mul_public_n1",
                                     "error_term"])
def test_builders_on_card_equal_cpu(cuda, builder):
    """Each standalone builder at m = 4096 on the card == on the CPU;
    the public plaintexts at (n, 1) take ntt_cm at B = 1."""
    params, g, rng, bb, bb_cpu = _pipelines(cuda, 4096, 1)
    sk, sk_new = she.gen_sk(params, g()), she.gen_sk(params, g())
    enc = "msd" if builder.endswith("msd") else "lsd"
    e = bb.build_encrypt(sk, enc)
    cts = e(she.pt_random(params, rng, (40,), cuda), g())
    pub = she.pt_random(params, rng, (1,), cuda)
    make = {
        "step_msd": lambda b: (lambda c0, c1: b.build_step(hint, "msd")(c0, c1, c0, c1)),
        "mod_switch_lsd": lambda b: b.build_mod_switch("lsd"),
        "mod_switch_msd": lambda b: b.build_mod_switch("msd"),
        "key_switch_linear": lambda b: b.build_key_switch_linear(hint),
        "add_public_n1": lambda b: (lambda c0, c1: b.build_add_public(3)(c0, c1, pub)),
        "mul_public_n1": lambda b: (lambda c0, c1: b.build_mul_public()(c0, c1, pub)),
        "error_term": lambda b: (lambda c0, c1: (b.build_error_term(sk)(c0, c1),)),
    }[builder]
    hint = (bb.gen_ks_linear_hint(sk_new, sk, g()) if builder == "key_switch_linear"
            else bb.gen_ks_quad_hint(sk, g()))
    _same(make(bb)(*cts), make(bb_cpu)(*(c.cpu() for c in cts)))


def test_tunnel_on_card_equals_cpu(cuda):
    """The tunnel m = 4096 -> 2048 (E = S, random ys), hints made on the
    card: one GS inverse a channel and component, d nrns + d nrns^2
    forwards, and the CPU's output."""
    from lol_tpu_torch import linear

    params, g, rng, bb, bb_cpu = _pipelines(cuda, 4096, 2)
    ps = she.SHEParams(m=2048, p=257, qs=params.qs, var=2.0)
    sk, sk_s = she.gen_sk(params, g()), she.gen_sk(ps, g())
    ys = [np.random.default_rng(i).integers(-2, 3, 1024) for i in range(2)]
    f = linear.linear_pow(ps.ctx, params.ctx, ps.ctx, ys)
    th = bb.gen_tunnel_hint(f, sk_s, sk, g())
    cts = bb.build_encrypt(sk)(she.pt_random(params, rng, (40,), cuda), g())
    before = dict(tk.LAUNCHES)
    out = bb.build_tunnel(th)(*cts)
    nrns = len(params.qs)
    assert tk.LAUNCHES["ntt_inv"] - before["ntt_inv"] == 2 * nrns
    assert tk.LAUNCHES["ntt_fwd"] - before["ntt_fwd"] == 2 * nrns + 2 * nrns ** 2
    _same(out, bb_cpu.build_tunnel(th)(*(c.cpu() for c in cts)))


def _words(g, dev, shape, lo, hi, plant):
    """int32 tensor of u32 words uniform in [lo, hi), `plant` in its first
    elements."""
    x = torch.randint(lo, hi, shape, generator=g, device=dev, dtype=torch.int64)
    k = min(len(plant), x.numel())
    x.view(-1)[:k] = torch.tensor(plant[:k], device=dev)
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


@pytest.mark.parametrize("D,n", [(D, n) for D in (2, 4, 8)
                                 for n in (256, 4096, 16384, 32768, 65536) if n % (D * D) == 0])
@pytest.mark.parametrize("B", [1, 1000, 1024])
def test_ring_kernels_match_plain(cuda, D, n, B):
    """a2a_chunks on raw words, the gather pass on phase A's lazy words
    (below 4q), the scatter pass on residues (its lazy [0, 2q) output
    equal mod q), each against its plain version, 0, 1 and q - 1 planted."""
    q = nt.ntt_primes(2 * n, 30, 1)[0]
    plan = ntt.ntt_plan(n, q)
    tS = n // D
    g = torch.Generator(device=cuda).manual_seed(D * n + B)
    ext = [0, 1, q - 1]
    raw = [_words(g, cuda, (tS, B), 0, 1 << 32, ext) for _ in range(D)]
    for a, b in zip(rn.a2a_chunks(raw), rn.a2a_chunks_ref(raw)):
        assert torch.equal(a, b)
    lazy = [_words(g, cuda, (tS, B), 0, 4 * q, ext + [4 * q - 1]) for _ in range(D)]
    for a, b in zip(rn.ntt_fwd_gather(lazy, plan), rn.ntt_fwd_gather_ref(lazy, plan)):
        assert torch.equal(a, b)
    res = [_words(g, cuda, (tS, B), 0, q, ext) for _ in range(D)]
    for a, b in zip(rn.ntt_inv_scatter(res, plan), rn.ntt_inv_scatter_ref(res, plan)):
        assert bool((a >= 0).all()) and bool((a < 2 * q).all())
        assert torch.equal(a % q, b)


@pytest.mark.parametrize("scatter", [False, True])
def test_ring_pass_refuses_a_first_round_narrower_than_log2_d(cuda, scatter, monkeypatch):
    """A phase-B pass whose first round has fewer than log2 D stages (here
    a length-4 cross pass over D = 8 shards: rounds [2]) has no static
    shard map; the C entry refuses it, the wrapper raises and nothing
    else is launched in its place."""
    D, n = 8, 16384
    plan = ntt.ntt_plan(n, nt.ntt_primes(2 * n, 30, 1)[0])
    tS = n // D
    monkeypatch.setattr(rn, "phase_b_passes",
                        lambda tS_, D_, d: [tk.cross_pass(4, tS_ // 4, D_ + d)])
    assert tk.rounds(4)[0] < 3
    xs = [torch.zeros((tS, 8), dtype=torch.int32, device=cuda) for _ in range(D)]
    before = {**tk.LAUNCHES, **rn.LAUNCHES}
    fn = rn.ntt_inv_scatter if scatter else rn.ntt_fwd_gather
    with pytest.raises(RuntimeError, match="invalid argument"):
        fn(xs, plan)
    assert {**tk.LAUNCHES, **rn.LAUNCHES} == before


def _ring_vs_single_card(mesh, plan, x):
    shards = sh.ring_shard(x, mesh)
    want_f, want_i = tk.ntt_cm(x, plan), tk.ntt_cm(x, plan, inverse=True)
    for overlap in (False, True):
        fwd = rn.ntt_ring_sharded_cm(mesh, shards, plan, overlap=overlap)
        assert torch.equal(sh.ring_unshard(fwd).to(x.device), want_f)
        inv = rn.intt_ring_sharded_cm(mesh, shards, plan, overlap=overlap)
        assert torch.equal(sh.ring_unshard(inv).to(x.device), want_i)
        back = rn.intt_ring_sharded_cm(mesh, fwd, plan, overlap=overlap)
        assert torch.equal(sh.ring_unshard(back).to(x.device), x)


@pytest.mark.parametrize("D,n,B", [(2, 256, 3), (4, 4096, 1000), (8, 16384, 1024),
                                   (4, 16384, 1024), (2, 65536, 64), (4, 65536, 1024)])
def test_ring_transforms_match_single_card(cuda, D, n, B):
    """Both routes, forward and inverse, on D shards of one card == the
    single-card `ntt_cm` on the gathered array; round trips."""
    q = nt.ntt_primes(2 * n, 30, 1)[0]
    plan = ntt.ntt_plan(n, q)
    g = torch.Generator(device=cuda).manual_seed(n + D)
    x = torch.randint(0, q, (n, B), generator=g, device=cuda, dtype=torch.int32)
    x[0] = q - 1
    _ring_vs_single_card(sh.make_mesh({"ring": D}, [cuda] * D), plan, x)


@pytest.mark.parametrize("tS", [4096, 16384])
def test_ring_launch_counts(cuda, tS):
    D = 4
    n = D * tS
    plan = ntt.ntt_plan(n, nt.ntt_primes(2 * n, 30, 1)[0])
    mesh = sh.make_mesh({"ring": D}, [cuda] * D)
    shards = sh.ring_shard(torch.zeros((n, 8), dtype=torch.int32, device=cuda), mesh)
    pb = len(rn.phase_b_passes(tS, D, 0))
    for overlap, inverse, want in [
            (False, False, dict(a2a=2 * D, ntt_fwd=D * (1 + pb))),
            (True, False, dict(a2a=D, ntt_fwd=D * pb, ntt_fwd_gather=D)),
            (False, True, dict(a2a=2 * D, ntt_inv=D * (1 + pb))),
            (True, True, dict(a2a=D, ntt_inv=D * pb, ntt_inv_scatter=D))]:
        before = {**tk.LAUNCHES, **rn.LAUNCHES}
        fn = rn.intt_ring_sharded_cm if inverse else rn.ntt_ring_sharded_cm
        fn(mesh, shards, plan, overlap=overlap)
        after = {**tk.LAUNCHES, **rn.LAUNCHES}
        assert {k: after[k] - before[k] for k in after if after[k] != before[k]} == want


def test_ring_across_two_cards():
    """The shards on two cards (round-robin over cuda:0 and cuda:1, peer
    access enabled by the wrappers): both routes == single-card ntt_cm."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    n, B = 16384, 1024
    plan = ntt.ntt_plan(n, nt.ntt_primes(2 * n, 30, 1)[0])
    g = torch.Generator(device="cuda:0").manual_seed(2)
    x = torch.randint(0, plan.q, (n, B), generator=g, device="cuda:0", dtype=torch.int32)
    for D in (2, 4):
        devices = [torch.device("cuda", d % 2) for d in range(D)]
        _ring_vs_single_card(sh.make_mesh({"ring": D}, devices), plan, x)
    torch.cuda.synchronize("cuda:1")


def test_pt_round_on_card_equals_cpu(cuda):
    """build_pt_round Z_8 -> Z_2 at m = 512 over five primes, hints made on
    the card: the CPU's output bit for bit, and the rounded scalars."""
    params = she.SHEParams(m=512, p=8, qs=tuple(nt.ntt_primes(512, 30, 5)), var=2.0)
    g, rng = prng.KeyChain(3), np.random.default_rng(3)
    sk = she.gen_sk(params, g())
    rh = she.pt_round_hints(sk, gadget.RnsGad(), g(), cuda)
    bb = BatchedBGV(params, cuda)
    vals = torch.from_numpy(rng.integers(0, 8, (40,)).astype(np.int32)).to(cuda)
    msgs = torch.zeros((256, 40), dtype=torch.int32, device=cuda)
    msgs[0] = vals
    cts = bb.build_encrypt(sk)(msgs, g())
    run, bb_out, f_out = serving.build_pt_round(bb, rh)
    out = run(*cts)
    run_cpu = serving.build_pt_round(BatchedBGV(params, "cpu"), rh)[0]  # hints move with it
    _same(out, run_cpu(*(c.cpu() for c in cts)))
    got = bb_out.build_decrypt(she.SK(bb_out.params, sk.s_ints, 2.0), f=f_out)(*out)
    assert got[0].tolist() == ((2 * vals * 2 + 8) // 16 % 2).tolist() and not got[1:].any()


def test_homom_prf_tower_on_card_equals_cpu(cuda):
    """HomomPRF component 0 down the halving tower m = 64 -> 2 (hints made
    on the card; the tail runs n = 4, 2, 1): the CPU's output bit for bit,
    and the clear PRF."""
    fam, hints, bb, sk_out, s, cts = steptime.homom_prf_inputs(64, 8, 40, 4, cuda)
    before = dict(tk.LAUNCHES)
    bb_out, f_out, out = serving.batched_homom_prf_component(fam, hints, bb, *cts, (1, 0), 0)
    assert tk.LAUNCHES["ntt_fwd"] > before["ntt_fwd"] and tk.LAUNCHES["ntt_inv"] > before["ntt_inv"]
    _, _, ref = serving.batched_homom_prf_component(fam, hints, BatchedBGV(bb.params, "cpu"),
                                                    *(c.cpu() for c in cts), (1, 0), 0)
    _same(out, ref)
    got = bb_out.build_decrypt(she.SK(bb_out.params, sk_out.s_ints, 2.0), f=f_out)(*out)
    assert got.cpu().tolist() == [[prf.prf_ints(fam, s[:, 0].cpu().numpy(), (1, 0), 2)[0][0]] * 40]


@pytest.mark.parametrize("encoding", ["lsd", "msd"])
def test_ext_builders_on_card_equal_cpu(cuda, encoding):
    """build_step_ext and build_key_switch_linear_ext at m = 4096 with two
    special primes, hints made on the card: the CPU's outputs."""
    all5 = tuple(nt.ntt_primes(4096, 30, 5))
    params = she.SHEParams(m=4096, p=257, qs=all5[:3], var=2.0)
    g, rng = prng.KeyChain(5), np.random.default_rng(5)
    bb, bb_cpu = BatchedBGV(params, cuda), BatchedBGV(params, "cpu")
    sk, sk_new = she.gen_sk(params, g()), she.gen_sk(params, g())
    quad = bb.gen_ks_quad_hint_ext(sk, all5[3:], g())
    lin = bb.gen_ks_linear_hint_ext(sk_new, sk, all5[3:], g())
    e = bb.build_encrypt(sk, encoding)
    a = e(she.pt_random(params, rng, (40,), cuda), g())
    b = e(she.pt_random(params, rng, (40,), cuda), g())
    _same(bb.build_step_ext(quad, encoding)(*a, *b),
          bb_cpu.build_step_ext(quad, encoding)(*(c.cpu() for c in (*a, *b))))
    _same(bb.build_key_switch_linear_ext(lin)(*a),
          bb_cpu.build_key_switch_linear_ext(lin)(*(c.cpu() for c in a)))


@pytest.mark.parametrize("m", [18432, 9216])
def test_general_axis_plans_match_plain(cuda, m):
    """ntt_cm on the 2-power axis of a general ring (n2 = 1024 and 512,
    the plan `axis_plan` gives it) over B' = 6 * 1024 columns: forward with
    and without the prologue and the GS inverse, one launch each."""
    from lol_tpu_torch.ops import general as gen

    q = nt.ntt_primes(18432, 30, 1)[0]
    plan = gen.general_plan(m, q).axes[0].ntt2
    g = torch.Generator(device=cuda).manual_seed(m)
    x = torch.randint(0, q, (plan.n, 6 * 1024), generator=g, device=cuda, dtype=torch.int32)
    xs = torch.randint(0, 12289, x.shape, generator=g, device=cuda, dtype=torch.int32)
    before = dict(tk.LAUNCHES)
    got = [tk.ntt_cm(x, plan), tk.ntt_cm(x, plan, inverse=True),
           tk.ntt_cm(xs, plan, pre_digit_q=12289)]
    assert tk.LAUNCHES["ntt_fwd"] - before["ntt_fwd"] == 2
    assert tk.LAUNCHES["ntt_inv"] - before["ntt_inv"] == 1
    want = [tk.ntt_cm_ref(x, plan), tk.ntt_cm_ref(x, plan, inverse=True),
            tk.ntt_cm_ref(xs, plan, pre_digit_q=12289)]
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("encoding", ["lsd", "msd"])
def test_general_m_step_and_tunnel_on_card_equal_cpu(cuda, encoding):
    """At m = 2304 = 2^8 3^2 (n2 = 128), p = 7, hints made on the card: the
    step (one ct_mul a channel, every transform one launch) and the tunnel
    2304 -> 1152 equal the CPU's."""
    from lol_tpu_torch import linear

    params = she.SHEParams(m=2304, p=7, qs=tuple(nt.ntt_primes(2304, 30, 3)), var=2.0)
    ps = she.SHEParams(m=1152, p=7, qs=params.qs, var=2.0)
    g, rng = prng.KeyChain(9), np.random.default_rng(9)
    bb, bb_cpu = BatchedBGV(params, cuda), BatchedBGV(params, "cpu")
    sk, sk_s = she.gen_sk(params, g()), she.gen_sk(ps, g())
    hint = bb.gen_ks_quad_hint(sk, g())
    e = bb.build_encrypt(sk, encoding)
    a, b = (e(she.pt_random(params, rng, (40,), cuda), g()) for _ in range(2))
    before = dict(tk.LAUNCHES, **pw.LAUNCHES)
    out = bb.build_step(hint, encoding)(*a, *b)
    assert pw.LAUNCHES["ct_mul"] - before["ct_mul"] == 3
    assert tk.LAUNCHES["ntt_inv"] - before["ntt_inv"] == 5
    _same(out, bb_cpu.build_step(hint, encoding)(*(c.cpu() for c in (*a, *b))))
    f = linear.linear_pow(ps.ctx, params.ctx, ps.ctx,
                          [np.random.default_rng(i).integers(-2, 3, ps.ctx.n) for i in range(2)])
    th = bb.gen_tunnel_hint(f, sk_s, sk, g())
    _same(bb.build_tunnel(th)(*a), bb_cpu.build_tunnel(th)(*(c.cpu() for c in a)))


@pytest.mark.parametrize("m", [4096, 2304])
def test_galois_on_card_equals_cpu(cuda, m):
    """build_galois and build_galois_many (k = 5, 7) on the card == on the
    CPU; at the 2-power m the hoisted outputs equal the separate ones."""
    params = she.SHEParams(m=m, p=7, qs=tuple(nt.ntt_primes(m, 30, 3)), var=2.0)
    g, rng = prng.KeyChain(m), np.random.default_rng(m)
    bb, bb_cpu = BatchedBGV(params, cuda), BatchedBGV(params, "cpu")
    sk = she.gen_sk(params, g())
    hints = {k: bb.gen_galois_hint(k, sk, g()) for k in (5, 7)}
    cts = bb.build_encrypt(sk)(she.pt_random(params, rng, (40,), cuda), g())
    many = bb.build_galois_many(hints)(*cts)
    ref = bb_cpu.build_galois_many(hints)(*(c.cpu() for c in cts))
    for k in hints:
        one = bb.build_galois(hints[k], k)(*cts)
        _same(one, bb_cpu.build_galois(hints[k], k)(*(c.cpu() for c in cts)))
        _same(many[k], ref[k])
        if m == 4096:
            _same(many[k], tuple(t.cpu() for t in one))


def _mesh_setup(cuda, m=256, p=257):
    """Three primes and two special ones at m, hints made on the card, two
    LSD encryptions of 40 messages; the mesh {"rns": 3, "data": 2} over the
    visible cards (one card: six entries of it)."""
    from lol_tpu_torch import linear

    all5 = tuple(nt.ntt_primes(m, 30, 5))
    params = she.SHEParams(m=m, p=p, qs=all5[:3], var=2.0)
    g, rng = prng.KeyChain(m), np.random.default_rng(m)
    bb = BatchedBGV(params, cuda)
    sk, sk_new = she.gen_sk(params, g()), she.gen_sk(params, g())
    enc = bb.build_encrypt(sk)
    cts = [enc(she.pt_random(params, rng, (40,), cuda), g()) for _ in range(2)]
    ps = she.SHEParams(m=m // 2, p=p, qs=params.qs, var=2.0)
    ys = [np.zeros(ps.ctx.n, dtype=np.int64), np.zeros(ps.ctx.n, dtype=np.int64)]
    ys[0][0] = 1
    th = bb.gen_tunnel_hint(linear.linear_pow(ps.ctx, params.ctx, ps.ctx, ys),
                            she.gen_sk(ps, g()), sk, g())
    hints = dict(quad=bb.gen_ks_quad_hint(sk, g()), lin=bb.gen_ks_linear_hint(sk_new, sk, g()),
                 quad_ext=bb.gen_ks_quad_hint_ext(sk, all5[3:], g()),
                 lin_ext=bb.gen_ks_linear_hint_ext(sk_new, sk, all5[3:], g()), tunnel=th,
                 galois={k: bb.gen_galois_hint(k, sk, g()) for k in (3, 5)})
    return bb, hints, cts


def _mesh_builders(bb, hints):
    """name -> (builder taking mesh=, number of ciphertexts it takes)."""
    return {
        "step_lsd": (lambda mesh: bb.build_step(hints["quad"], "lsd", mesh), 2),
        "step_msd": (lambda mesh: bb.build_step(hints["quad"], "msd", mesh), 2),
        "mod_switch": (lambda mesh: bb.build_mod_switch("lsd", mesh), 1),
        "key_switch_linear": (lambda mesh: bb.build_key_switch_linear(hints["lin"], mesh), 1),
        "step_ext": (lambda mesh: bb.build_step_ext(hints["quad_ext"], "lsd", mesh), 2),
        "key_switch_linear_ext": (lambda mesh: bb.build_key_switch_linear_ext(
            hints["lin_ext"], mesh), 1),
        "galois": (lambda mesh: bb.build_galois(hints["galois"][3], 3, mesh), 1),
        "galois_many": (lambda mesh: bb.build_galois_many(hints["galois"], mesh), 1),
        "tunnel": (lambda mesh: bb.build_tunnel(hints["tunnel"], mesh), 1),
        "pt_ops": (lambda mesh: bb.build_add(1, 3, True, mesh), 2),
    }


def _unshard_all(out):
    if isinstance(out, dict):
        return {k: _unshard_all(v) for k, v in out.items()}
    return tuple(sh.unshard_batch_rns(b) for b in out)


def _same_any(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _same_any(a[k], b[k])
    else:
        assert all(torch.equal(x.cpu(), y.cpu()) for x, y in zip(a, b))


@pytest.mark.parametrize("builder", ["step_lsd", "step_msd", "mod_switch", "key_switch_linear",
                                     "step_ext", "key_switch_linear_ext", "galois",
                                     "galois_many", "tunnel", "pt_ops"])
def test_mesh_builders_on_card_equal_unsharded(cuda, builder):
    """Each mesh builder over make_mesh({"rns": 3, "data": 2}) at m = 256,
    three primes, B = 40: unsharded, the card's unsharded output, its
    launches exactly twice the unsharded call's (one per data column)."""
    bb, hints, cts = _mesh_setup(cuda)
    mesh = sh.make_mesh({"rns": 3, "data": 2})
    make, k = _mesh_builders(bb, hints)[builder]
    args = [t for c in cts[:k] for t in c]
    before = dict(tk.LAUNCHES, **pw.LAUNCHES)
    want = make(None)(*args)
    one = {key: v - before[key] for key, v in dict(tk.LAUNCHES, **pw.LAUNCHES).items()}
    blocks = [sh.shard_batch_rns(mesh, t) for t in args]
    torch.cuda.synchronize()
    before = dict(tk.LAUNCHES, **pw.LAUNCHES)
    got = make(mesh)(*blocks)
    mesh_launches = {key: v - before[key] for key, v in dict(tk.LAUNCHES, **pw.LAUNCHES).items()}
    assert mesh_launches == {key: 2 * v for key, v in one.items()}
    _same_any(_unshard_all(got), want)


def test_mesh_blocks_stay_on_their_cards():
    """A mesh whose rns rows sit on two cards (row 0 on cuda:0, row 1 on
    cuda:1): every block of the step's, the key switch's and the tunnel's
    output, and every part's buffers, on its block's card; the outputs
    unsharded == the single-card run."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    c0_, c1_ = torch.device("cuda", 0), torch.device("cuda", 1)
    mesh = sh.make_mesh({"rns": 3, "data": 2}, [c0_, c0_, c1_, c1_, c0_, c1_])
    bb, hints, cts = _mesh_setup(c0_)
    grid = sh.rns_data_grid(mesh)
    for name in ("step_lsd", "key_switch_linear", "step_ext", "tunnel", "galois_many"):
        make, k = _mesh_builders(bb, hints)[name]
        args = [t for c in cts[:k] for t in c]
        mod = make(mesh)
        for (i, j), part in np.ndenumerate(mod.grid):
            assert all(b.device == grid[i, j] for b in part.buffers()), (name, i, j)
        got = mod(*[sh.shard_batch_rns(mesh, t) for t in args])
        outs = got.values() if isinstance(got, dict) else [got]
        for out in outs:
            for comp in out:
                for (i, j), blk in np.ndenumerate(comp):
                    assert blk.device == grid[i, j], (name, i, j)
        _same_any(_unshard_all(got), make(None)(*args))
    torch.cuda.synchronize(c1_)


def test_slot_map_homom_prf_on_card_equals_cpu(cuda):
    """HomomPRF at p = 257 down 32 -> 16 with maps="slots" (BaseBGad(16),
    balanced(2)), hints made on the card, 40 key ciphertexts: every
    component equals the CPU's and decrypts to the slot map applied to the
    clear s * A_T(x)."""
    from lol_tpu_torch import gadget, linear

    qs = tuple(nt.ntt_primes(64, 30, 3))
    g, rng = prng.KeyChain(32), np.random.default_rng(32)
    sks = [she.gen_sk(she.SHEParams(m=r, p=257, qs=qs, var=2.0), g()) for r in (32, 16)]
    fam = prf.PRFFamily.random(ring_context(32, (257,)), gadget.BaseBGad(16), prf.balanced(2), g(), cuda)
    hints, sk_out = prf.make_eval_hints(fam, sks, [32, 16], [16], gadget.RnsGad(), g(),
                                        p_final=257, maps="slots",
                                        device=cuda)
    bb = BatchedBGV(sks[0].params, cuda)
    keys = torch.from_numpy(rng.integers(0, 257, (16, 40)).astype(np.int32)).to(cuda)
    cts = bb.build_encrypt(sks[0])(keys, g())
    lin = hints.tunnels[0].lin
    for i in range(gadget.num_digits(fam.spec, fam.ctx.basis)):
        bb_out, f_out, out = serving.batched_homom_prf_component(fam, hints, bb, *cts, (0, 1), i)
        _same(out, serving.batched_homom_prf_component(
            fam, hints, BatchedBGV(bb.params, "cpu"), *(c.cpu() for c in cts), (0, 1), i)[2])
        got = bb_out.build_decrypt(sk_out, f=f_out)(*out).cpu().numpy()
        for k in range(40):
            want = linear.eval_lin_ints(lin, prf.prf_pre_round_ints(fam, keys[:, k].cpu().numpy(),
                                                          (0, 1))[i], 257)
            np.testing.assert_array_equal(got[:, k], want)


def test_io_reads_onto_the_card_and_writes_the_cpu_bytes(cuda):
    """A hint and a ciphertext written from the card are the bytes written
    from their CPU copies; read back (io's default device) they land on
    the card, and a row in the powerful basis converts through the
    kernels to the CRT stack."""
    from lol_tpu_torch import gadget, io
    from lol_tpu_torch.cyc import Cyc, Rep
    from lol_tpu_torch.proto import wire as pb

    params = she.SHEParams(m=64, p=257, qs=tuple(nt.ntt_primes(64, 30, 3)), var=2.0)
    g, rng = prng.KeyChain(3), np.random.default_rng(3)
    sk = she.gen_sk(params, g())
    hint = she.ks_quad_circ_hint(sk, gadget.RnsGad(), g(), cuda)
    ct = she.encrypt(sk, she.pt_random(params, rng, device="cpu").numpy(), g(), cuda)
    data = io.ks_hint_to_proto(hint).SerializeToString()
    cpu = she.KSHint(hint.params, hint.h0.cpu(), hint.h1.cpu(), hint.spec)
    assert io.ks_hint_to_proto(cpu).SerializeToString() == data
    back = io.ks_hint_from_proto(pb.KSHint.FromString(data))
    assert back.h0.device.type == "cuda" and torch.equal(back.h0, hint.h0)
    msg = io.ks_hint_to_proto(hint)
    msg.h0 = [io.cyc_to_proto(Cyc(params.ctx, Rep.CRT, hint.h0[j]).to_pow())
              for j in range(hint.h0.shape[0])]
    assert torch.equal(io.ks_hint_from_proto(msg).h0, hint.h0)
    ct2 = io.ct_from_proto(pb.SHECiphertext.FromString(io.ct_to_proto(ct).SerializeToString()))
    assert all(torch.equal(a.data, b.data) for a, b in zip(ct2.cs, ct.cs))


def test_challenges_on_card_equal_cpu_bytes(cuda, tmp_path):
    """generate on the card writes the CPU's bytes for the same seed; the
    card's verify passes after suppress."""
    from lol_tpu_torch.challenges import ChallengeParams, generate, suppress, verify

    q = nt.ntt_primes(1024, 30, 1)[0]
    params = [ChallengeParams(0, 1024, q, 4.0, 3, "disc"),
              ChallengeParams(1, 1024, q, 4.0, 2, "cont", beacon_epoch=5),
              ChallengeParams(2, 1024, q, 4.0, 2, "rlwr", qprime=257)]
    generate(tmp_path / "card", params, seed=4, device=cuda)
    generate(tmp_path / "cpu", params, seed=4, device="cpu")
    files = sorted(p.relative_to(tmp_path / "card") for p in (tmp_path / "card").rglob("*.*"))
    assert files and all((tmp_path / "card" / f).read_bytes() == (tmp_path / "cpu" / f).read_bytes()
                         for f in files)
    suppress(tmp_path / "card")
    assert verify(tmp_path / "card", device=cuda) is True


def test_ntt_cm_checked_on_card(cuda):
    from lol_tpu_torch.ops import debug as dbg

    q = nt.ntt_primes(2 * 4096, 30, 1)[0]
    plan = ntt.ntt_plan(4096, q)
    x = torch.randint(0, q, (4096, 64), device=cuda, dtype=torch.int32)
    for kw in ({}, {"inverse": True}, {"inverse": True, "alg": "dit"}):
        assert torch.equal(dbg.ntt_cm_checked(x, plan, **kw), tk.ntt_cm_ref(x, plan, **kw))
    for word in (q, -(1 << 31)):
        bad = x.clone()
        bad[1, 2] = word
        with pytest.raises(dbg.ReductionError):
            dbg.ntt_cm_checked(bad, plan)


@pytest.mark.parametrize("count", [1, 7, 1000, 4097, 1 << 20])
def test_prng_kernel_matches_plain(cuda, count):
    """Every mode of the draw kernel == its plain version, over one to
    three channels and ragged counts, and one launch a draw."""
    keys = list(prng.split(prng.PRNGKey(count), 3))
    for mode, kw in (("bits", {}), ("randint", {"qs": [1073479681, 257, 2]}),
                     ("randint", {"qs": nt.ntt_primes(32768, 30, 3)}),
                     ("float", {"pre": prng.SQRT2}), ("round", {"scale": prng.folded_scale(9.0)})):
        before = pk.LAUNCHES["prng"]
        got = pk.draw(keys, count, mode, device=cuda, **kw)
        assert pk.LAUNCHES["prng"] == before + 1
        want = pk.draw_ref(keys, count, mode, **kw)
        assert got.dtype == want.dtype and torch.equal(got.cpu(), want), mode
    got = prng.uniform(keys[0], (count,), -0.3, 2.7)  # on the card by default
    assert got.device.type == "cuda"
    assert torch.equal(got.cpu().view(torch.int32),
                       prng.uniform(keys[0], (count,), -0.3, 2.7, device="cpu").view(torch.int32))


def test_prng_draws_default_to_the_card(cuda):
    """random_bits / randint / uniform / normal with no device: on the
    card, through the kernel (one launch each), == the CPU's draws."""
    key = prng.PRNGKey(3)
    for fn, args in ((prng.random_bits, ((5, 7),)), (prng.randint, ((5, 7), 0, 1073479681)),
                     (prng.uniform, ((5, 7),)), (prng.normal, ((5, 7),))):
        before = pk.LAUNCHES["prng"]
        got = fn(key, *args)
        assert got.device.type == "cuda" and pk.LAUNCHES["prng"] == before + 1, fn.__name__
        want = fn(key, *args, device="cpu")
        if want.dtype == torch.float32:
            got, want = got.view(torch.int32), want.view(torch.int32)
        assert torch.equal(got.cpu().long(), want.long()), fn.__name__


def test_prng_normals_match_plain_on_every_input(cuda):
    """The kernel's erf_inv epilogue == the plain twin's on all 2^23 inputs
    (the words i << 9), raw and rounded at var 2, 4 and 9."""
    words = (torch.arange(1 << 23, dtype=torch.int64) << 9).to(torch.int32)
    for mode, pre, scale in (("float", 1.0, 1.0), ("float", prng.SQRT2, 1.0),
                             *(("round", 1.0, prng.folded_scale(v)) for v in (2.0, 4.0, 9.0))):
        got = pk.map_words(words.to(cuda), mode, pre, scale).cpu()
        want = pk.map_words(words, mode, pre, scale)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32)), (mode, scale)
