"""BGV pipeline benchmark: ct-mult + key switch + rescale ops/s, and HomomPRF
(counterpart of `lol_tpu/bench/she_bench.py`).

`run` times the step at (m, nrns, batch, p) on the card, after a decrypt
guard (columns 0-7 of a step on encryptions against `pt_mul`), and beside
it the modulus switch, the linear key switch and the ext step (two special
primes) on the same inputs; `homom_prf` times component 0 of HomomPRF down
the halving tower m_top -> 2 (the stages built once, `steptime.homom_prf_run`)
after its guard (columns 0-7 against the clear `prf`).  Each prints one
JSON line with the reference's keys, the card's name and power limit
beside them; times are CUDA-event medians as the caller sees them
(`bench.time_ms`).  A measuring tool; it defines no benchmark cell.

Run on the card: python -m lol_tpu_torch.bench.she_bench [--m 8192]
[--rns 3] [--batch 2048] [--homom-prf]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from .. import numtheory as nt, prf, prng, sampling, she
from ..she_batched import BatchedBGV
from . import card_line, require_cuda, steptime, time_ms


def run(m: int = 8192, nrns: int = 3, batch: int = 2048, p: int = 257, iters: int = 20,
        seed: int = 0) -> dict:
    dev = require_cuda()
    qs = tuple(nt.ntt_primes(m, 30, nrns))
    params = she.SHEParams(m=m, p=p, qs=qs, var=2.0)
    nk, rng = prng.KeyChain(seed), np.random.default_rng(seed)
    sk = she.gen_sk(params, nk(), dev)
    bb = BatchedBGV(params, dev)
    step = bb.build_step(bb.gen_ks_quad_hint(sk, nk()))
    n = params.ctx.n

    # the guard: a step on encryptions decrypts to the plaintext product
    enc = bb.build_encrypt(sk)
    m1, m2 = (she.pt_random(params, rng, (batch,), dev) for _ in range(2))
    e0, e1 = step(*enc(m1, nk()), *enc(m2, nk()))
    p2 = she.SHEParams(m=m, p=p, qs=qs[:-1], var=params.var)
    got = BatchedBGV(p2, dev).build_decrypt(she.SK(p2, sk.s_ints, sk.var), f=bb.step_f())(e0, e1)
    for b in range(8):
        want = she.pt_mul(params, m1[:, b].cpu().numpy(), m2[:, b].cpu().numpy())
        if not np.array_equal(got[:, b].cpu().numpy(), want):
            raise AssertionError(f"she_bench: column {b} of the step does not decrypt to pt_mul")

    arrs = [sampling.uniform_residues(qs, (n, batch), nk(), dev) for _ in range(4)]

    def rate(fn, its):
        return batch / (time_ms(fn, its)[0] / 1e3)

    step_rate = rate(lambda: step(*arrs), iters)
    ms_rate = rate(lambda: bb.build_mod_switch()(*arrs[:2]), max(iters // 2, 2))
    sk2 = she.gen_sk(params, nk(), dev)
    ksl = bb.build_key_switch_linear(bb.gen_ks_linear_hint(sk2, sk, nk()))
    ksl_rate = rate(lambda: ksl(*arrs[:2]), max(iters // 2, 2))
    specials = tuple(nt.ntt_primes(m, 30, nrns + 2))[nrns:]
    ext = bb.build_step_ext(bb.gen_ks_quad_hint_ext(sk, specials, nk()))
    ext_rate = rate(lambda: ext(*arrs), max(iters // 2, 2))
    out = {
        "metric": f"BGV ct-mult+keyswitch+rescale ops/sec, n={n}, {nrns}x30-bit RNS, "
                  f"{torch.cuda.get_device_name(0)}",
        "card": card_line(),
        "value": step_rate,
        "unit": "ct-op/s",
        "vs_baseline": None,
        "mod_switch_ops_per_sec": ms_rate,
        "ks_linear_ops_per_sec": ksl_rate,
        "step_ext_ops_per_sec": ext_rate,
        "step_ext_specials": len(specials),
    }
    print(json.dumps(out), flush=True)
    return out


def homom_prf(m_top: int = 32768, batch: int = 1024, iters: int = 10, p: int = 8,
              bits=(1, 0), seed: int = 0) -> dict:
    """Component 0 of HomomPRF over a batch of key ciphertexts: mul_public,
    the halving tunnel tower m_top -> 2 (project maps), the rounding
    Z_p -> Z_2 at m = 2, each stage built once; the guard decrypts columns
    0-7 against the clear PRF's coefficient 0."""
    dev = require_cuda()
    fam, hints, bb, sk_out, s, cts = steptime.homom_prf_inputs(m_top, p, batch, seed, dev)
    fn, bb_out, f_out = steptime.homom_prf_run(fam, hints, bb, tuple(bits), 0)
    y0, y1 = fn(*cts)
    got = bb_out.build_decrypt(she.SK(bb_out.params, sk_out.s_ints, sk_out.var), f=f_out)(y0, y1)
    want = int(prf.prf_ints(fam, s[:, 0].cpu().numpy(), tuple(bits), 2)[0][0])
    if got[0, :8].tolist() != [want] * 8:
        raise AssertionError(f"she_bench.homom_prf: decrypt {got[0, :8].tolist()}, want {want}")
    rate = batch / (time_ms(lambda: fn(*cts), iters)[0] / 1e3)
    out = {
        "metric": f"HomomPRF component, m={m_top} -> 2 tower ({len(hints.tunnels)} tunnels + "
                  f"Z_{p}->Z_2 rounding), {torch.cuda.get_device_name(0)}",
        "card": card_line(),
        "value": rate,
        "unit": "prf-op/s",
        "vs_baseline": None,
        "homom_prf_ops_per_sec": rate,
        "homom_prf_batch": batch,
    }
    print(json.dumps(out), flush=True)
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--m", type=int, default=8192)
    ap.add_argument("--rns", type=int, default=3)
    ap.add_argument("--batch", type=int, default=2048)
    ap.add_argument("--homom-prf", action="store_true",
                    help="run the end-to-end HomomPRF tower bench instead")
    args = ap.parse_args()
    if args.homom_prf:
        homom_prf(args.m if args.m != 8192 else 32768, batch=args.batch // 2)
    else:
        run(args.m, args.rns, args.batch)


if __name__ == "__main__":
    main()
