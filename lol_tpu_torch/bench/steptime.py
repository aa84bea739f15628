"""Where the BGV step's time goes (counterpart of `lol_tpu/bench/steptime.py`).

Times the step's components on the same inputs (m = 32768, so n = 2^14,
nrns = 3, B = 1024 by default), with the reference's legs:

  intt      the key switch's per-channel inverse stack (nrns GS inverses)
  digits    the RNS-digit forward transforms with the re-expansion
            prologue (nrns digits x (nrns - 1) forward NTTs)
  hadamard  ct_mul (nrns `ct_mul_cm` launches) and the 2*nrns^2 hint
            inner-product multiply-accumulates (plain int64 torch)
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
caller sees it; --trace profiles five calls.
"""

from __future__ import annotations

import argparse
import json
import statistics

import numpy as np
import torch

from .. import gadget, linear, numtheory as nt, prf, sampling, serving, she
from ..she_batched import BatchedBGV, BGVStep
from . import require_cuda, time_ms

PARTS = ("intt", "digits", "hadamard", "rescale")


def build_legs(step: BGVStep, c0, c1, d0, d1) -> dict:
    """The zero-argument callables of each leg, on the inputs' device,
    with every leg's inputs made up front."""
    bb, nrns = step.bb, len(step.bb.qs)
    c1c = bb._ntt(c1, inverse=True)
    ds = [bb._digit_crt(c1c[i], i, c1) for i in range(nrns)]

    def hadamard():
        e0, e1, _ = step.ct_mul(c0, c1, d0, d1)
        for i, di in enumerate(ds):
            e0, e1 = step.inner_product(e0, e1, di, i)
        return e0, e1

    he0, he1 = (e.to(torch.int32) for e in hadamard())
    return {
        "intt": lambda: bb._ntt(c1, inverse=True),
        "digits": lambda: [bb._digit_crt(c1c[i], i, c1) for i in range(nrns)],
        "hadamard": hadamard,
        "rescale": lambda: (bb._rescale_crt(he0, step.qv),
                            bb._rescale_crt(he1, step.qv)),
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
        if us > 0 and ev.device_type.name == "CUDA":
            rows.append((ev.key, us / 1e3, ev.count))
    total = sum(ms for _, ms, _ in rows)
    rows.sort(key=lambda r: -r[1])
    return {
        "device_ms_per_step": total / steps,
        "span_ms_per_step": t0.elapsed_time(t1) / steps,
        "kernels": [{"name": k, "ms_per_step": ms / steps, "pct": 100 * ms / total,
                     "launches_per_step": cnt / steps} for k, ms, cnt in rows],
    }


def _inputs(m: int, nrns: int, B: int, seed: int):
    dev = require_cuda()
    params = she.SHEParams(m=m, p=257, qs=tuple(nt.ntt_primes(m, 30, nrns)), var=2.0)
    g = torch.Generator(device=dev).manual_seed(seed)
    bb = BatchedBGV(params, dev)
    step = bb.build_step(bb.gen_ks_quad_hint(she.gen_sk(params, g), g))
    cts = [sampling.uniform_residues(params.qs, (params.ctx.n, B), g) for _ in range(4)]
    return step, cts


def _tunnel_inputs(m: int, nrns: int, B: int, seed: int):
    """The tunnel m -> m/2 (E = S, ys = [1, 0]) with hints made on the
    card, and an encrypted (c0, c1) batch over m."""
    dev = require_cuda()
    params = she.SHEParams(m=m, p=257, qs=tuple(nt.ntt_primes(m, 30, nrns)), var=2.0)
    ps = she.SHEParams(m=m // 2, p=257, qs=params.qs, var=2.0)
    g = torch.Generator(device=dev).manual_seed(seed)
    bb = BatchedBGV(params, dev)
    sk = she.gen_sk(params, g)
    n_s = ps.ctx.n
    f = linear.linear_pow(ps.ctx, params.ctx, ps.ctx, [np.eye(1, n_s, dtype=np.int64)[0],
                                                       np.zeros(n_s, dtype=np.int64)])
    tun = bb.build_tunnel(bb.gen_tunnel_hint(f, she.gen_sk(ps, g), sk, g))
    return tun, bb.build_encrypt(sk)(she.pt_random(params, g, (B,)), g)


def pt_round_inputs(m: int, p: int, B: int, seed: int, device="cuda"):
    """The rounding chain Z_p -> Z_pr at m over pt_round_mults(p) + 2
    primes (hints made on the device), and an encrypted batch of scalar
    plaintexts: (run, bb_out, f_out, sk, vals, (c0, c1))."""
    qs = tuple(nt.ntt_primes(m, 30, she.pt_round_mults(p) + 2))
    params = she.SHEParams(m=m, p=p, qs=qs, var=2.0)
    g = torch.Generator(device=device).manual_seed(seed)
    sk = she.gen_sk(params, g)
    bb = BatchedBGV(params, device)
    run, bb_out, f_out = serving.build_pt_round(bb, she.pt_round_hints(sk, g, device))
    vals = torch.randint(0, p, (B,), generator=g, device=device, dtype=torch.int32)
    msgs = torch.zeros((params.ctx.n, B), dtype=torch.int32, device=device)
    msgs[0] = vals
    return run, bb_out, f_out, sk, vals, bb.build_encrypt(sk)(msgs, g)


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
    g = torch.Generator(device=device).manual_seed(seed)
    sks = [she.gen_sk(she.SHEParams(m=m, p=p, qs=qs, var=2.0), g) for m in rings]
    fam = prf.PRFFamily.random(m_top, p, gadget.BaseBGad(2), prf.balanced(2), g)
    hints, sk_out = prf.make_eval_hints(fam, sks, rings, rings[1:], g, homomorphic_round=True,
                                        maps="project", device=device)
    bb = BatchedBGV(sks[0].params, device)
    s = torch.randint(0, p, (bb.ctx.n, 1), generator=g, device=device, dtype=torch.int32)
    return fam, hints, bb, sk_out, s, bb.build_encrypt(sks[0])(s.expand(-1, B), g)


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
    ap.add_argument("--m", type=int, default=32768)
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
    args = ap.parse_args()
    if args.tunnel:
        fn, cts = _tunnel_inputs(args.m, args.rns, args.batch, 0)
        print(json.dumps(call_time(fn, *cts, "tunnel to n/2", "tunnel_ops_per_sec",
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
        fn, cts = _inputs(args.m, args.rns, args.batch, 0)
        print(json.dumps(breakdown(fn, *cts, iters=args.iters, windows=args.windows)))
    if args.trace:
        print(json.dumps(by_kernel(fn, cts, args.trace)))


if __name__ == "__main__":
    main()
