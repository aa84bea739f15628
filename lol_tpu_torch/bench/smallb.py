"""Small-batch NTT sweep at n = 4096 over the port's schedule choices
(counterpart of `lol_tpu/bench/smallb.py`).

The reference sweeps its Pallas kernel's TPU knobs (lane tile, window,
radix) at small B.  The port's choices at n = 4096 are the pass schedule
and the inverse's route: `cm_schedule` (one pass over the whole column
tile, the default), or two passes, the cross pass over P = n / tS rows
apart then the block pass over tS-row blocks (`schedule`'s shape, tS in
{512, 1024, 2048}), each forward and GS inverse (`run_passes`), and
route B (`alg="dit"`, its own `dit_schedule`).  Each combination's first
call is checked equal to the plain version (`ntt_cm_ref`) over 64 columns
before it is timed; then every combination runs in interleaved windows on
the device alone (`time_ms(device_only=True)`, one window a round).  Both
primes of a 2 x 30-bit chain a call, so NTT/s = B / time.

Run on the card: python -m lol_tpu_torch.bench.smallb [B ...]
"""

from __future__ import annotations

import json
import statistics
import sys

import torch

from .. import numtheory as nt
from ..ops import ntt
from ..ops.cuda import ntt_kernel as tk
from . import card_line, require_cuda, time_ms

N = 4096
BATCHES = (1024, 2048, 4096, 8192, 16384, 32768)
SPLITS = (512, 1024, 2048)  # tS of the two-pass schedules


def two_pass(n: int, tS: int) -> list[tk.Pass]:
    """The cross pass over P = n / tS then the block pass over tS rows."""
    P = n // tS
    return [tk.cross_pass(P, tS, 1),
            tk.Pass(tS, P, 1, tS, P, 1, 1, tk._cols(tS, tk.TILE_ELEMS))]


def combos(n: int = N) -> dict:
    """name -> (passes in forward order or None for route B, inverse)."""
    out = {}
    for name, passes in [("one pass", tk.cm_schedule(n))] + [
            (f"two pass tS={tS}", two_pass(n, tS)) for tS in SPLITS if tS < n]:
        out[f"fwd, {name}"] = (passes, False)
        out[f"inv gs, {name}"] = (passes[::-1], True)
    out["inv dit (route B)"] = (None, True)
    return out


def run(batches=BATCHES, n: int = N, iters: int = 10, windows: int = 5) -> dict:
    dev = require_cuda()
    plans = [ntt.ntt_plan(n, q) for q in nt.ntt_primes(2 * n, 30, 2)]
    g = torch.Generator(device=dev).manual_seed(0)
    results = {}
    for B in batches:
        xs = [torch.randint(0, p.q, (n, B), generator=g, device=dev, dtype=torch.int32)
              for p in plans]
        calls = {}
        for name, (passes, inverse) in combos(n).items():
            def call(passes=passes, inverse=inverse):
                if passes is None:
                    return [tk.ntt_cm(x, p, inverse=True, alg="dit") for x, p in zip(xs, plans)]
                return [tk.run_passes(x, p, passes, inverse) for x, p in zip(xs, plans)]

            for x, p, y in zip(xs, plans, call()):
                if not torch.equal(y[:, :64], tk.ntt_cm_ref(x[:, :64], p, inverse=inverse)):
                    raise AssertionError(f"smallb: {name} at B={B} != the plain NTT")
            calls[name] = call
        wins = {k: [] for k in calls}
        for _ in range(windows):
            for k, fn in calls.items():
                wins[k].append(time_ms(fn, iters, windows=1, device_only=True)[0])
        results[B] = {k: B / (statistics.median(v) / 1e3) for k, v in wins.items()}
        for k, rate in results[B].items():
            print(f"B={B} {k}: {rate:,.0f} NTT/s (windows {min(wins[k]):.4f}-"
                  f"{max(wins[k]):.4f} ms)", file=sys.stderr, flush=True)
    out = {"n": n, "card": card_line(), "results": results}
    print(json.dumps(out), flush=True)
    return out


def main() -> None:
    run(tuple(int(b) for b in sys.argv[1:]) or BATCHES)


if __name__ == "__main__":
    main()
