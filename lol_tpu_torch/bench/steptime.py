"""Where the BGV step's time goes (counterpart of `lol_tpu/bench/steptime.py`).

Times the step's components on the same inputs (m = 32768, so n = 2^14,
nrns = 3, B = 1024 by default), with the reference's legs:

  intt      the key switch's per-channel inverse stack (nrns GS inverses)
  digits    the RNS-digit forward transforms with the re-expansion
            prologue (nrns digits x (nrns - 1) forward NTTs)
  hadamard  ct_mul (nrns `ct_mul_cm` launches) and the hint inner
            products of every digit (one `ks_inner_cm` call)
  rescale   the exact CRT-domain drop-last rescale of both components
  step      the whole step

The legs run interleaved round-robin, one CUDA-event window each per
round, so drift on the card hits every leg alike.  PyTorch runs eagerly,
so the parts should add up to the step: `overlap_dividend_pct` (1 -
step / sum of parts) near 0 says the breakdown accounts for the step.

Run on the card: python -m lol_tpu_torch.bench.steptime [--m 32768]
[--rns 3] [--batch 1024] [--trace DIR].  Prints one JSON line; with
--trace, a second one: the device time by kernel over five steps under
torch.profiler (`roofline.trace`, whose Chrome trace lands in DIR).
With --tunnel it times the fused ring tunnel m -> m/2 instead (E = S,
ys = [1, 0], the reference bench's tunnel leg) as its caller sees it,
and with --trace profiles five tunnels the same way.  --pt-round times
the homomorphic rounding chain Z_p -> Z_2 at m (p = 8, pt_round_mults(p)
+ 2 primes, scalar plaintexts: `bench.py`'s leg), --homom-prf component
0 of HomomPRF down the halving tower m -> 2 (project maps, p = 8,
pt_round_mults(p) + 4 primes, BaseBGad(2), balanced(2), bits (1, 0):
`lol_tpu/bench/she_bench.py`'s leg), each built once and timed as its
caller sees it; --trace profiles five calls.  The general-m legs
(`bench.py`'s config 3): --general-m breaks the step down as above at
m = 18432 = 2^11 3^2 (n = 6144, p = 7), --tunnel-general times the tunnel
18432 -> 9216 (p = 7); --galois times hoisted rotations (`build_galois_many`)
against separate ones (`build_galois` per k) at m = 32768, k in {3, 5, 9},
in interleaved windows (`galois_ab`), and --trace profiles five calls of
each arm.  The two general legs also print the odd axes' share
(`odd_axis`): the device time of the program's `crt.odd` spans inside
the call (`lol_tpu_torch.trace`), and alone on one channel
(`use_mxu=False`: on the short-axis kernel `modmat_small`; `mxu_route`
puts any call on either).  --mesh times the step at m and the tunnel m -> m/2 over
`make_mesh({"rns": 3, "data": 4})` (the cards round-robin; on one card,
twelve entries of it; the tunnel on the mesh's data-only view) against
their unsharded runs on the same inputs, in interleaved windows
(`ab`), with the device time of the layout copies (`copies`: the
gathers and the rescale's relayout); with --trace it profiles five calls
of each of the four arms.  --m overrides each leg's ring.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import statistics

import numpy as np
import torch

from .. import gadget, linear, numtheory as nt, prf, prng, sampling, serving, she
from ..ops import general as gen
from ..ops.cuda.ntt_kernel import ntt_cm
from ..parallel import sharding as sh
from ..ring import ring_context
from ..she_batched import BatchedBGV, BGVStep
from . import SPIN_CYCLES, require_cuda, time_ms

PARTS = ("intt", "digits", "hadamard", "rescale")


def build_legs(step: BGVStep, c0, c1, d0, d1) -> dict:
    """The zero-argument callables of each leg, on the inputs' device,
    with every leg's inputs made up front."""
    bb, nrns = step.bb, len(step.bb.qs)
    c1c = bb._ntt(c1, inverse=True)
    ds = bb._ks_digits(c1c, c1, nrns)

    def hadamard():
        e0, e1, _ = step.ct_mul(c0, c1, d0, d1)
        return step.inner_product(e0, e1, ds)

    he0, he1 = hadamard()
    return {
        "intt": lambda: bb._ntt(c1, inverse=True),
        "digits": lambda: bb._ks_digits(c1c, c1, nrns),
        "hadamard": hadamard,
        "rescale": lambda: (bb._rescale_crt(he0, step.encoding),
                            bb._rescale_crt(he1, step.encoding)),
        "step": lambda: step(c0, c1, d0, d1),
    }


def measure(legs: dict, iters: int, windows: int) -> dict[str, list[float]]:
    """ms per call of each leg in each of `windows` round-robin rounds."""
    times = {k: [] for k in legs}
    for _ in range(windows):
        for name, fn in legs.items():
            times[name].append(time_ms(fn, iters, windows=1)[0])
    return times


def summarize(times: dict[str, list[float]], n: int, nrns: int, B: int,
              device: str) -> dict:
    """The JSON line: medians, windows, each part's share and the step."""
    med = {k: statistics.median(v) for k, v in times.items()}
    parts = sum(med[k] for k in PARTS)
    return {
        "metric": f"BGV step by component, n={n}, {nrns}x30-bit, B={B}",
        "device": device,
        "ms_per_call": med,
        "ms_windows": times,
        "pct_of_parts": {k: 100 * med[k] / parts for k in PARTS},
        "parts_sum_ms": parts,
        "overlap_dividend_pct": 100 * (1 - med["step"] / parts),
        "step_ops_per_sec": B / (med["step"] / 1e3),
    }


def breakdown(step: BGVStep, c0, c1, d0, d1, iters: int = 5, windows: int = 5) -> dict:
    """The JSON line of `step` on these (nrns, n, B) inputs on the card."""
    require_cuda()
    nrns, n, B = c0.shape
    times = measure(build_legs(step, c0, c1, d0, d1), iters, windows)
    return summarize(times, n, nrns, B, torch.cuda.get_device_name(c0.device))


def by_kernel(fn, args, trace_dir: str, steps: int = 5) -> dict:
    """Device time by kernel name over `steps` calls of fn(*args) (the
    step, or the tunnel) under torch.profiler: total, per call, each
    name's share (largest first) and launches."""
    from . import roofline

    fn(*args)
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    with roofline.trace(trace_dir) as prof:
        t0.record()
        for _ in range(steps):
            fn(*args)
        t1.record()
        torch.cuda.synchronize()
    rows = []
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0)
        if us > 0 and ev.device_type.name == "CUDA" and not ev.is_user_annotation:
            rows.append((ev.key, us / 1e3, ev.count))
    total = sum(ms for _, ms, _ in rows)
    rows.sort(key=lambda r: -r[1])
    return {
        "device_ms_per_step": total / steps,
        "span_ms_per_step": t0.elapsed_time(t1) / steps,
        "kernels": [{"name": k, "ms_per_step": ms / steps, "pct": 100 * ms / total,
                     "launches_per_step": cnt / steps} for k, ms, cnt in rows],
    }


@contextlib.contextmanager
def mxu_route(use_mxu: bool | None):
    """Every `ops.general.matvec_mod` call inside the block takes the given
    route (True: the int8-limb kernel, False: the short-axis kernel
    `modmat_small`, int64 torch on the CPU; None: by the axis, the
    default)."""
    inner = gen.matvec_mod
    gen.matvec_mod = functools.partial(inner, use_mxu=use_mxu)
    try:
        yield
    finally:
        gen.matvec_mod = inner


def odd_axis(fn, args, plan: gen.GeneralPlan, calls: int = 5, iters: int = 5,
             windows: int = 5, use_mxu: bool | None = None) -> dict:
    """The general-m transforms' odd axes on the card, device time only.
    In the call: `calls` calls of fn(*args) under a profile of the host and
    the device; the device time of the operations launched inside the
    program's `crt.odd` spans (`lol_tpu_torch.trace`, one span an odd
    axis) against that of every operation of the calls.  Alone, on one
    (n, B) channel of `plan`'s ring: the forward `crt_cm`, its 2-power
    axis (`ntt_cm` on the (n2, rest B) reshape) and its odd axes
    (`matvec_mod`).  use_mxu: the odd axes' route (`mxu_route`)."""
    dev = require_cuda()
    from torch.profiler import ProfilerActivity, profile

    with mxu_route(use_mxu):
        fn(*args)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn(*args)
            torch.cuda.synchronize()
    n_odd, odd_us, all_us = 0, 0.0, 0.0
    for ev in prof.key_averages():
        if ev.key == "crt.odd" and ev.device_type.name == "CPU":
            n_odd, odd_us = ev.count, ev.device_time_total
        elif ev.device_type.name == "CUDA" and not ev.is_user_annotation:
            all_us += ev.self_device_time_total
    odd, span = odd_us / 1e3 / calls, all_us / 1e3 / calls
    inner = functools.partial(gen.matvec_mod, use_mxu=use_mxu)
    shape, B = plan.phi_shape, args[0].shape[-1]
    n, n2 = plan.fm.phi, shape[0]
    x = sampling.uniform_residues((plan.q,), (n, B), prng.PRNGKey(0), dev)[0]
    odd_axes = [i for i, ax in enumerate(plan.axes) if ax.ntt2 is None and ax.phi > 1]

    def odd_alone():
        y = x
        for i in odd_axes:
            y = inner(plan.axes[i].M, y.reshape(*shape, B), plan.q, axis=i).view(n, B)
        return y

    def crt_alone():
        with mxu_route(use_mxu):
            return gen.crt_cm(plan, x)

    alone = {"crt_cm": crt_alone,
             "axis2": lambda: ntt_cm(x.reshape(n2, (n // n2) * B).contiguous(),
                                     plan.axes[0].ntt2),
             "odd_axes": odd_alone}
    return {"metric": f"odd axes of m={plan.fm.m}, phi_shape={shape}, B={B}",
            "matvec_mod_calls_per_call": n_odd / calls,
            "matvec_mod_device_ms_per_call": odd, "span_device_ms_per_call": span,
            "matvec_mod_pct_of_span": 100 * odd / span,
            "alone_device_ms": {k: time_ms(f, iters, windows, device_only=True)[0]
                                for k, f in alone.items()}}


def _inputs(m: int, nrns: int, B: int, seed: int, p: int = 257):
    dev = require_cuda()
    params = she.SHEParams(m=m, p=p, qs=tuple(nt.ntt_primes(m, 30, nrns)), var=2.0)
    nk = prng.KeyChain(seed)
    bb = BatchedBGV(params, dev)
    step = bb.build_step(bb.gen_ks_quad_hint(she.gen_sk(params, nk(), dev), nk()))
    cts = [sampling.uniform_residues(params.qs, (params.ctx.n, B), nk(), dev) for _ in range(4)]
    return step, cts


def _halving_map(params: she.SHEParams, ps: she.SHEParams) -> linear.Linear:
    """The reference bench's tunnel map R -> S = E: ys = [1, 0]."""
    n_s = ps.ctx.n
    return linear.linear_pow(ps.ctx, params.ctx, ps.ctx, [np.eye(1, n_s, dtype=np.int64)[0],
                                                          np.zeros(n_s, dtype=np.int64)])


def _tunnel_inputs(m: int, nrns: int, B: int, seed: int, p: int = 257):
    """The tunnel m -> m/2 (E = S, ys = [1, 0]) with hints made on the
    card, and an encrypted (c0, c1) batch over m."""
    dev = require_cuda()
    params = she.SHEParams(m=m, p=p, qs=tuple(nt.ntt_primes(m, 30, nrns)), var=2.0)
    ps = she.SHEParams(m=m // 2, p=p, qs=params.qs, var=2.0)
    nk, rng = prng.KeyChain(seed), np.random.default_rng(seed)
    bb = BatchedBGV(params, dev)
    sk = she.gen_sk(params, nk(), dev)
    tun = bb.build_tunnel(bb.gen_tunnel_hint(_halving_map(params, ps), she.gen_sk(ps, nk(), dev),
                                             sk, nk()))
    return tun, bb.build_encrypt(sk)(she.pt_random(params, rng, (B,), dev), nk())


def pt_round_inputs(m: int, p: int, B: int, seed: int, device="cuda"):
    """The rounding chain Z_p -> Z_pr at m over pt_round_mults(p) + 2
    primes (hints made on the device), and an encrypted batch of scalar
    plaintexts: (run, bb_out, f_out, sk, vals, (c0, c1))."""
    qs = tuple(nt.ntt_primes(m, 30, she.pt_round_mults(p) + 2))
    params = she.SHEParams(m=m, p=p, qs=qs, var=2.0)
    nk, rng = prng.KeyChain(seed), np.random.default_rng(seed)
    sk = she.gen_sk(params, nk(), device)
    bb = BatchedBGV(params, device)
    run, bb_out, f_out = serving.build_pt_round(
        bb, she.pt_round_hints(sk, gadget.RnsGad(), nk(), device))
    vals = torch.from_numpy(rng.integers(0, p, B).astype(np.int32)).to(device)
    msgs = torch.zeros((params.ctx.n, B), dtype=torch.int32, device=device)
    msgs[0] = vals
    return run, bb_out, f_out, sk, vals, bb.build_encrypt(sk)(msgs, nk())


def homom_prf_run(fam: prf.PRFFamily, hints: prf.EvalHints, bb: BatchedBGV, bits, i: int):
    """`serving.batched_homom_prf_component`'s stages built once, as the
    reference bench builds its serving program: (run, bb_out, f_out),
    run: (c0, c1) -> (c0', c1')."""
    a = fam.a_t(bits)[i]
    a = np.where(a >= (fam.p + 1) // 2, a - fam.p, a) % bb.params.p
    a_pt = torch.from_numpy(a.astype(np.int32)[:, None]).to(bb.device)
    mulp = bb.build_mul_public()
    tuns, cur = [], bb
    for th in hints.tunnels:
        tuns.append(cur.build_tunnel(th))
        cur = cur.target_pipeline(th)
    rnd, bb_out, f_out = serving.build_pt_round(cur, hints.rounds)

    def run(c0, c1):
        c0, c1 = mulp(c0, c1, a_pt)
        for tun in tuns:
            c0, c1 = tun(c0, c1)
        return rnd(c0, c1)

    return run, bb_out, f_out


def homom_prf_inputs(m_top: int, p: int, B: int, seed: int, device="cuda"):
    """HomomPRF's tower m_top -> m_top/2 -> ... -> 2 (E = S, the project
    maps) over pt_round_mults(p) + 4 primes, with hints made on the device,
    the family (BaseBGad(2), balanced(2)) and B encryptions of one key s
    over m_top: (fam, hints, bb, sk_out, s, (c0, c1))."""
    qs = tuple(nt.ntt_primes(m_top, 30, she.pt_round_mults(p) + 4))
    rings = [m_top >> k for k in range(m_top.bit_length() - 1)]
    nk, rng = prng.KeyChain(seed), np.random.default_rng(seed)
    sks = [she.gen_sk(she.SHEParams(m=m, p=p, qs=qs, var=2.0), nk(), device) for m in rings]
    fam = prf.PRFFamily.random(ring_context(m_top, (p,)), gadget.BaseBGad(2), prf.balanced(2),
                               nk(), device)
    hints, sk_out = prf.make_eval_hints(fam, sks, rings, rings[1:], gadget.RnsGad(), nk(),
                                        homomorphic_round=True, maps="project", device=device)
    bb = BatchedBGV(sks[0].params, device)
    s = torch.from_numpy(rng.integers(0, p, (bb.ctx.n, 1)).astype(np.int32)).to(device)
    return fam, hints, bb, sk_out, s, bb.build_encrypt(sks[0])(s.expand(-1, B), nk())


GALOIS_KS = (3, 5, 9)


def galois_inputs(m: int, nrns: int, B: int, seed: int, ks=GALOIS_KS, device="cuda"):
    """The rotations of `bench.py`'s galois leg: sigma_k hints made on the
    device (p = 257), the hoisted module over all ks, one `build_galois`
    per k, and uniform (c0, c1): (many, singles, sk, (c0, c1))."""
    params = she.SHEParams(m=m, p=257, qs=tuple(nt.ntt_primes(m, 30, nrns)), var=2.0)
    nk = prng.KeyChain(seed)
    sk = she.gen_sk(params, nk(), device)
    bb = BatchedBGV(params, device)
    hints = {k: bb.gen_galois_hint(k, sk, nk()) for k in ks}
    cts = tuple(sampling.uniform_residues(params.qs, (params.ctx.n, B), nk(), device)
                for _ in range(2))
    return (bb.build_galois_many(hints), {k: bb.build_galois(hints[k], k) for k in ks},
            sk, cts)


def ab(arms: dict, iters: int = 5, windows: int = 5) -> tuple[dict, dict]:
    """The arms (zero-argument callables) on the card as their caller sees
    them, in interleaved windows (one window of each arm a round): the
    median ms per call of each, and every window."""
    require_cuda()
    wins = {k: [] for k in arms}
    for _ in range(windows):
        for k, fn in arms.items():
            wins[k].append(time_ms(fn, iters, windows=1)[0])
    return {k: statistics.median(v) for k, v in wins.items()}, wins


def galois_ab(many, singles: dict, c0, c1, iters: int = 5, windows: int = 5) -> dict:
    """Hoisted against separate rotations on the card, as their caller
    sees them, in interleaved windows (`ab`): the rotations per second of
    each and the speedup (the ratio of the median windows), with every
    window."""
    nrns, n, B = c0.shape
    med, wins = ab({"hoisted": lambda: many(c0, c1),
                    "separate": lambda: [fn(c0, c1) for fn in singles.values()]},
                   iters, windows)
    rot = len(singles) * B
    return {"metric": f"Galois rotations k={sorted(singles)}, n={n}, {nrns}x30-bit, B={B}",
            "device": torch.cuda.get_device_name(c0.device), "ms_per_call": med,
            "ms_windows": wins,
            "galois_hoisted_rot_per_sec": rot / (med["hoisted"] / 1e3),
            "galois_separate_rot_per_sec": rot / (med["separate"] / 1e3),
            "galois_hoisted_speedup": med["separate"] / med["hoisted"]}


MESH_SHAPE = {"rns": 3, "data": 4}


def mesh_inputs(m: int, nrns: int, B: int, seed: int, p: int = 257) -> dict:
    """The step at m and the tunnel m -> m/2 (E = S, ys = [1, 0]) with
    hints made on the card, each unsharded and over `make_mesh(MESH_SHAPE)`
    (the tunnel over its data-only view), with uniform step inputs and an
    encrypted tunnel batch, unsharded and as the meshes' blocks."""
    dev = require_cuda()
    mesh = sh.make_mesh(MESH_SHAPE)
    dmesh = sh.data_mesh(mesh)
    params = she.SHEParams(m=m, p=p, qs=tuple(nt.ntt_primes(m, 30, nrns)), var=2.0)
    nk, rng = prng.KeyChain(seed), np.random.default_rng(seed)
    bb = BatchedBGV(params, dev)
    sk = she.gen_sk(params, nk(), dev)
    hint = bb.gen_ks_quad_hint(sk, nk())
    cts = [sampling.uniform_residues(params.qs, (params.ctx.n, B), nk(), dev) for _ in range(4)]
    ps = she.SHEParams(m=m // 2, p=p, qs=params.qs, var=2.0)
    th = bb.gen_tunnel_hint(_halving_map(params, ps), she.gen_sk(ps, nk(), dev), sk, nk())
    tcts = bb.build_encrypt(sk)(she.pt_random(params, rng, (B,), dev), nk())
    return dict(mesh=mesh, step=bb.build_step(hint), step_mesh=bb.build_step(hint, mesh=mesh),
                cts=cts, blocks=[sh.shard_batch_rns(mesh, c) for c in cts],
                tun=bb.build_tunnel(th), tun_mesh=bb.build_tunnel(th, dmesh), tcts=tcts,
                tblocks=[sh.shard_batch_rns(dmesh, c) for c in tcts])


def mesh_ab(step, step_mesh, cts, blocks, tun, tun_mesh, tcts, tblocks,
            iters: int = 5, windows: int = 5) -> dict:
    """The step and the tunnel unsharded and over the mesh, on the same
    inputs, as their caller sees them, in interleaved windows (`ab`): the
    ops/s of each (B / median ms) and every window."""
    med, wins = ab({"step": lambda: step(*cts), "mesh_step": lambda: step_mesh(*blocks),
                    "tunnel": lambda: tun(*tcts), "mesh_tunnel": lambda: tun_mesh(*tblocks)},
                   iters, windows)
    B = cts[0].shape[-1]
    return {"metric": f"step and tunnel over the mesh {MESH_SHAPE} vs unsharded, B={B}",
            "device": torch.cuda.get_device_name(cts[0].device), "ms_per_call": med,
            "ms_windows": wins,
            **{f"{k}_ops_per_sec": B / (v / 1e3) for k, v in med.items()}}


def copies(fn, args, calls: int = 5) -> dict:
    """The device time and bytes of a mesh call's layout copies
    (`sharding.rns_gather` / `rns_relayout`, each piece an `_assemble`):
    a CUDA-event pair around every `_assemble` over `calls` calls of
    fn(*args), each call queued behind a device spin; their sum against
    the calls' spans."""
    require_cuda()
    inner, pairs, spans, nbytes = sh._assemble, [], [], []

    def timed(pieces, device):
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0.record()
        out = inner(pieces, device)
        t1.record()
        pairs.append((t0, t1))
        nbytes.append(out.numel() * out.element_size())
        return out

    fn(*args)
    torch.cuda.synchronize()
    sh._assemble = timed
    try:
        for _ in range(calls):
            s0, s1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(SPIN_CYCLES)
            s0.record()
            fn(*args)
            s1.record()
            spans.append((s0, s1))
        torch.cuda.synchronize()
    finally:
        sh._assemble = inner
    ms = sum(a.elapsed_time(b) for a, b in pairs) / calls
    span = sum(a.elapsed_time(b) for a, b in spans) / calls
    return {"copies_per_call": len(pairs) / calls, "copy_bytes_per_call": sum(nbytes) / calls,
            "copy_device_ms_per_call": ms, "span_device_ms_per_call": span,
            "copy_pct_of_span": 100 * ms / span}


def call_time(fn, c0, c1, what: str, key: str, iters: int = 5, windows: int = 5) -> dict:
    """The JSON line of fn(c0, c1) on the card: ms per call as its caller
    sees it (median and windows), and ops/s under `key`."""
    require_cuda()
    nrns, n, B = c0.shape
    ms, wins = time_ms(lambda: fn(c0, c1), iters, windows)
    return {"metric": f"{what}, n={n}, {nrns}x30-bit, B={B}",
            "device": torch.cuda.get_device_name(c0.device), "ms_per_call": ms,
            "ms_windows": wins, key: B / (ms / 1e3)}



def run(m: int = 32768, nrns: int = 3, B: int = 1024, iters: int = 5,
        windows: int = 5, seed: int = 0) -> dict:
    step, cts = _inputs(m, nrns, B, seed)
    return breakdown(step, *cts, iters=iters, windows=windows)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--m", type=int, default=None,
                    help="the ring (default 32768; 18432 for the general-m legs)")
    ap.add_argument("--rns", type=int, default=3)
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--windows", type=int, default=5)
    ap.add_argument("--trace", default=None, help="also profile five calls, trace to this dir")
    ap.add_argument("--tunnel", action="store_true", help="the tunnel m -> m/2, not the step")
    ap.add_argument("--pt-round", action="store_true",
                    help="the rounding chain Z_8 -> Z_2 at m, not the step")
    ap.add_argument("--homom-prf", action="store_true",
                    help="HomomPRF component 0 down the tower m -> 2, not the step")
    ap.add_argument("--general-m", action="store_true",
                    help="the step at the general m = 18432, p = 7")
    ap.add_argument("--tunnel-general", action="store_true",
                    help="the tunnel 18432 -> 9216, p = 7, not the step")
    ap.add_argument("--galois", action="store_true",
                    help="hoisted against separate rotations k = 3, 5, 9, not the step")
    ap.add_argument("--mesh", action="store_true",
                    help="the step and the tunnel over an rns 3 x data 4 mesh vs unsharded")
    args = ap.parse_args()
    general = args.general_m or args.tunnel_general
    if args.m is None:
        args.m = 18432 if general else 32768
    p = 7 if general else 257
    if args.mesh:
        require_cuda()
        x = mesh_inputs(args.m, args.rns, args.batch, 0)
        print(json.dumps(mesh_ab(*(x[k] for k in ("step", "step_mesh", "cts", "blocks", "tun",
                                                 "tun_mesh", "tcts", "tblocks")),
                                 args.iters, args.windows)))
        for arm, fn, a in (("mesh_step", x["step_mesh"], x["blocks"]),
                           ("mesh_tunnel", x["tun_mesh"], x["tblocks"])):
            print(json.dumps({"arm": arm, **copies(fn, a)}))
        if args.trace:
            for arm, fn, a in (("step", x["step"], x["cts"]),
                               ("mesh_step", x["step_mesh"], x["blocks"]),
                               ("tunnel", x["tun"], x["tcts"]),
                               ("mesh_tunnel", x["tun_mesh"], x["tblocks"])):
                print(json.dumps({"arm": arm, **by_kernel(fn, a, f"{args.trace}/{arm}")}))
        return
    if args.galois:
        require_cuda()
        fn, singles, _, cts = galois_inputs(args.m, args.rns, args.batch, 0)
        print(json.dumps(galois_ab(fn, singles, *cts, args.iters, args.windows)))
    elif args.tunnel or args.tunnel_general:
        fn, cts = _tunnel_inputs(args.m, args.rns, args.batch, 0, p)
        key = "tunnel_general_m_ops_per_sec" if general else "tunnel_ops_per_sec"
        print(json.dumps(call_time(fn, *cts, f"tunnel m={args.m} -> {args.m // 2}", key,
                                   args.iters, args.windows)))
    elif args.pt_round:
        require_cuda()
        fn, *_, cts = pt_round_inputs(args.m, 8, args.batch, 0)
        print(json.dumps(call_time(fn, *cts, "pt_round Z_8 -> Z_2", "pt_round_ops_per_sec",
                                   args.iters, args.windows)))
    elif args.homom_prf:
        require_cuda()
        fam, hints, bb, _, _, cts = homom_prf_inputs(args.m, 8, args.batch, 0)
        fn = homom_prf_run(fam, hints, bb, (1, 0), 0)[0]
        print(json.dumps(call_time(fn, *cts, f"HomomPRF component, tower m={args.m} -> 2",
                                   "homom_prf_ops_per_sec", args.iters, args.windows)))
    else:
        fn, cts = _inputs(args.m, args.rns, args.batch, 0, p)
        print(json.dumps(breakdown(fn, *cts, iters=args.iters, windows=args.windows)))
    if general:
        qs = nt.ntt_primes(args.m, 30, args.rns)
        print(json.dumps(odd_axis(fn, cts, gen.general_plan(args.m, qs[0]),
                                  iters=args.iters, windows=args.windows)))
    if args.trace and args.galois:
        for arm, f in (("hoisted", fn), ("separate",
                                         lambda c0, c1: [g(c0, c1) for g in singles.values()])):
            print(json.dumps({"arm": arm, **by_kernel(f, cts, f"{args.trace}/{arm}")}))
    elif args.trace:
        print(json.dumps(by_kernel(fn, cts, args.trace)))


if __name__ == "__main__":
    main()
