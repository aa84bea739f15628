"""Scaling over cards: NTT and BGV-step ops/s on 1, 2, 4, ... cards
(counterpart of `lol_tpu/bench/scaling.py`).

`run` splits a batch of (nrns, n, batch_per_card) per card over a
data-only mesh of the first 1, 2, 4, ... of `torch.cuda.device_count()`
cards (`parallel.sharding.make_mesh`, one block a card) and times the
forward NTT of every channel (`batched_ntt_sharded`); `run_bgv` does the
same for the BGV step built over that mesh (`build_step(hint, mesh=)`,
one process, its blocks on their cards).  Across cards one stream's
events do not see the others, so each size is timed on the host clock
around a synchronize of every card in the mesh (`bench.host_ms`: median
of 5 windows after a warm-up).  One JSON line per size, with the efficiency rate / (rate on
one card x cards), and the card's name and power limit; on one card the
one-card line.

Run on the card(s): python -m lol_tpu_torch.bench.scaling [--devices N]
[--n 2048] [--bgv]
"""

from __future__ import annotations

import argparse
import json

import torch

from .. import numtheory as nt, prng, sampling, she
from ..ops import ntt
from ..parallel import sharding as sh
from ..she_batched import BatchedBGV
from . import card_line, host_ms, require_cuda

SIZES = (1, 2, 4, 8, 16, 32)


def _cards(max_devices: int | None) -> list[torch.device]:
    require_cuda()
    count = torch.cuda.device_count()
    return [torch.device("cuda", i) for i in range(min(count, max_devices or count))]


def _report(what: str, unit: str, rows: list[tuple[int, float]]) -> list[dict]:
    base, out = rows[0][1], []
    for nd, rate in rows:
        line = {"metric": f"{what}, {nd} cards", "card": card_line(), "value": rate,
                "unit": unit, "vs_baseline": rate / (base * nd)}
        print(json.dumps(line), flush=True)
        out.append(line)
    return out


def run(n: int = 2048, nrns: int = 4, batch_per_dev: int = 64, max_devices: int | None = None,
        iters: int = 10) -> list[dict]:
    cards = _cards(max_devices)
    qs = nt.ntt_primes(2 * n, 30, nrns)
    plans = [ntt.ntt_plan(n, q) for q in qs]
    rows = []
    for nd in (d for d in SIZES if d <= len(cards)):
        mesh = sh.make_mesh({"rns": 1, "data": nd}, cards[:nd])
        B = batch_per_dev * nd
        x = sampling.uniform_residues(tuple(qs), (n, B), prng.PRNGKey(nd), cards[0])
        blocks = sh.shard_batch_rns(mesh, x)
        ms = host_ms(lambda: sh.batched_ntt_sharded(mesh, blocks, plans), iters, cards=cards[:nd])
        rows.append((nd, B / (ms / 1e3)))
    return _report(f"batched NTT polys/sec, n={n}, {nrns}-prime RNS", "poly/s", rows)


def run_bgv(m: int = 4096, nrns: int = 3, batch_per_dev: int = 64,
            max_devices: int | None = None, iters: int = 5) -> list[dict]:
    """The BGV step (ct-mult + key switch + rescale) over a data-only mesh
    of 1, 2, 4, ... cards, its hint made on the first."""
    cards = _cards(max_devices)
    params = she.SHEParams(m=m, p=257, qs=tuple(nt.ntt_primes(m, 30, nrns)), var=2.0)
    nk = prng.KeyChain(0)
    bb = BatchedBGV(params, cards[0])
    hint = bb.gen_ks_quad_hint(she.gen_sk(params, nk(), cards[0]), nk())
    rows = []
    for nd in (d for d in SIZES if d <= len(cards)):
        mesh = sh.make_mesh({"rns": 1, "data": nd}, cards[:nd])
        B = batch_per_dev * nd
        step = bb.build_step(hint, mesh=mesh)
        blocks = [sh.shard_batch_rns(mesh, sampling.uniform_residues(
            params.qs, (params.ctx.n, B), nk(), cards[0])) for _ in range(4)]
        ms = host_ms(lambda: step(*blocks), iters, cards=cards[:nd])
        rows.append((nd, B / (ms / 1e3)))
    return _report(f"BGV mul+keyswitch+rescale ct-ops/sec, n={params.ctx.n}, {nrns}x30-bit RNS",
                   "ct-op/s", rows)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, default=None)
    ap.add_argument("--n", type=int, default=2048)
    ap.add_argument("--bgv", action="store_true",
                    help="report the BGV pipeline scaling instead of NTT")
    args = ap.parse_args()
    if args.bgv:
        run_bgv(max_devices=args.devices)
    else:
        run(n=args.n, max_devices=args.devices)


if __name__ == "__main__":
    main()
