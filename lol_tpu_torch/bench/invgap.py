"""Where does the inverse NTT's time go? (counterpart of
`lol_tpu/bench/invgap.py`)

The reference's question asked of the port's kernels at (n, B): the
forward (`ntt_fwd_pass`), the GS inverse (`ntt_inv_pass`, 1/n folded into
its stage 0) and the route-B inverse (`ntt_invb_pass`), both primes of a
2 x 30-bit chain a call, each first checked equal to the plain version
over 64 columns, then timed on the device alone in interleaved windows
(one window of each a round), beside the least time the card could take
for it (`roofline.bound`).  The reference's two wrong-result legs
(`inv_noscale`, `inv_exact`: instances of its Pallas kernel without the
1/n scale or the lazy butterflies) have no counterpart: the port builds
no timing-only instance of its kernels.

Usage: python -m lol_tpu_torch.bench.invgap [B] [n]
"""

from __future__ import annotations

import json
import statistics
import sys

import torch

from .. import numtheory as nt
from ..ops import ntt
from ..ops.cuda import ntt_kernel as tk
from . import card_line, require_cuda, roofline, time_ms

LEGS = {"fwd": ("ntt_fwd", {}), "inv": ("ntt_inv_gs", {"inverse": True}),
        "inv_dit": ("ntt_inv_dit", {"inverse": True, "alg": "dit"})}


def run(B: int = 32768, n: int = 4096, iters: int = 10, windows: int = 5) -> dict:
    dev = require_cuda()
    plans = [ntt.ntt_plan(n, q) for q in nt.ntt_primes(2 * n, 30, 2)]
    g = torch.Generator(device=dev).manual_seed(0)
    xs = [torch.randint(0, p.q, (n, B), generator=g, device=dev, dtype=torch.int32)
          for p in plans]
    calls = {}
    for tag, (_, kw) in LEGS.items():
        def call(kw=kw):
            return [tk.ntt_cm(x, p, **kw) for x, p in zip(xs, plans)]

        for x, p, y in zip(xs, plans, call()):
            if not torch.equal(y[:, :64], tk.ntt_cm_ref(x[:, :64], p, **kw)):
                raise AssertionError(f"invgap: {tag} != the plain NTT at n={n}, B={B}")
        calls[tag] = call
    wins = {k: [] for k in calls}
    for _ in range(windows):
        for k, fn in calls.items():
            wins[k].append(time_ms(fn, iters, windows=1, device_only=True)[0])
    results = {}
    for tag, (op, _) in LEGS.items():
        ms = statistics.median(wins[tag])
        bound_ms, by = roofline.bound(*roofline.work(op, n, B))
        results[tag] = {"ntt_per_s": B / (ms / 1e3), "ms": ms, "windows_ms": wins[tag],
                        "bound_ms": 2 * bound_ms, "bound_by": by,
                        "pct_of_bound": 100 * 2 * bound_ms / ms}
        print(f"{tag}: {results[tag]['ntt_per_s']:,.0f} NTT/s, {ms:.4f} ms for both primes, "
              f"{results[tag]['pct_of_bound']:.1f}% of the bound ({by})", file=sys.stderr)
    f = results["fwd"]["ntt_per_s"]
    out = {"B": B, "n": n, "card": card_line(), "results": results,
           "inv_over_fwd": results["inv"]["ntt_per_s"] / f,
           "inv_dit_over_fwd": results["inv_dit"]["ntt_per_s"] / f}
    print(json.dumps(out), flush=True)
    return out


def main() -> None:
    B = int(sys.argv[1]) if len(sys.argv) > 1 else 32768
    n = int(sys.argv[2]) if len(sys.argv) > 2 else 4096
    run(B, n)


if __name__ == "__main__":
    main()
