"""A mesh that spans processes, checked: the port's counterpart of the
reference's two-process worker (`tests/multihost_worker.py`).

`spawn(world, ...)` starts `world` processes of this module, which form
one process group (`multihost.initialize` over localhost) and one mesh
over all of them, `global_mesh({"data": -1, "rns": 3})` with three
entries each; each process then checks its own part against the unsharded run
over every column, which it also makes (every process draws the same
keys, hints and ciphertexts from one seed's `prng` keys):

1. a data-sharded forward NTT (`sharding.batched_ntt_sharded`) == the
   plain transform of its columns;
2. one cross-process `all_reduce` (of the columns' sums) == the sum of
   every column;
3. the BGV step over the mesh == the unsharded step's columns, bit for
   bit, at m over three 30-bit primes;
4. the extended-modulus step (two special primes) at `ext_m` likewise.

On a card each process also counts its kernel launches, which must be
exact: its data blocks times the unsharded call's closed form (on the CPU
nothing is launched, and the counts are 0).  With `time_iters` the
processes then run the mesh step in step with one another, and process 0
reports the columns of every process per second.

    python -m lol_tpu_torch.parallel.multihost_check --world 2 --device cuda --backend gloo

`backend="gloo"` with every process on `cuda:0` is how one card runs it
(NCCL refuses two ranks on one card: the collective then goes through
gloo on a CPU copy); `card_per_rank` puts process r on `cuda:r` (NCCL,
one process a card).  Each process prints one line, `MULTIHOST_RESULT`
and a JSON object; `spawn` returns those objects, or raises with the
processes' output.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from . import multihost, sharding

TAG = "MULTIHOST_RESULT"
PRIMES = 3  # the chain: 3 x 30-bit, the mesh's 'rns' axis one entry a prime
SEED = 20261017


def step_launches(L: int, n: int) -> dict[str, int]:
    """Launches of one BGV step at L primes over one data column of the
    mesh (`cm_schedule` passes per transform): L (L - 1) + 2 (L - 1)
    forwards, L + 2 GS inverses, L ct_mul, L `ks_inner` and 2 (L - 1)
    `rescale_out`: the mesh's rns axis has one row a prime, each block
    makes one inner-product launch, and each block that keeps a surviving
    channel one epilogue launch a rescaled component."""
    from ..ops.cuda import ntt_kernel as tk

    passes = len(tk.cm_schedule(n))
    return {"ntt_fwd": (L * (L - 1) + 2 * (L - 1)) * passes, "ntt_inv": (L + 2) * passes,
            "ct_mul": L, "ks_inner": L, "rescale_out": 2 * (L - 1)}


def ext_step_launches(Lb: int, nsp: int, n: int) -> dict[str, int]:
    """Launches of one extended-modulus step over one data column of the
    mesh (one rns row a base prime, the special primes on the last): the
    digits into every extended channel but their own, a rescale pair per
    special prime, and the step's own rescale.  The transforms are the
    unsharded step's; `ks_inner` runs once a block (its view of the
    extended chain's one inner product), Lb in all; `rescale_out` once a
    block that keeps a surviving channel: Lb blocks a special prime's
    drop, Lb - 1 the step's own, each for both components."""
    from ..ops.cuda import ntt_kernel as tk

    passes, Lx = len(tk.cm_schedule(n)), Lb + nsp
    fwd = Lb * (Lx - 1) + sum(2 * (Lb + k - 1) for k in range(1, nsp + 1)) + 2 * (Lb - 1)
    return {"ntt_fwd": fwd * passes, "ntt_inv": (Lb + 2 * nsp + 2) * passes, "ct_mul": Lb,
            "ks_inner": Lb, "rescale_out": 2 * nsp * Lb + 2 * (Lb - 1)}


def _counters():
    from ..ops.cuda import ntt_kernel as tk
    from ..ops.cuda import pointwise as pw

    return tk.LAUNCHES, pw.LAUNCHES


def _reset() -> None:
    for c in _counters():
        for k in c:
            c[k] = 0


def _counts(dev: torch.device) -> dict[str, int]:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return {k: v for c in _counters() for k, v in c.items() if v}


def _want(closed: dict[str, int], times: int, dev: torch.device) -> dict[str, int]:
    return {k: times * v for k, v in closed.items() if v} if dev.type == "cuda" else {}


def run_rank(rank: int, world: int, port: int, device: str = "cuda", backend: str | None = None,
             m: int = 32768, batch: int = 1024, ext_m: int = 8192, card_per_rank: bool = False,
             time_iters: int = 0) -> dict:
    """One process's part (see the module's docstring); returns its report."""
    from .. import numtheory as nt
    from .. import prng, sampling, she
    from ..ops.cuda import ntt_kernel as tk
    from ..she_batched import BatchedBGV

    multihost.initialize(f"localhost:{port}", world, rank, backend)
    try:
        dev = torch.device("cpu") if device == "cpu" else torch.device(
            "cuda", rank if card_per_rank else 0)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        gm = multihost.global_mesh({"data": -1, "rns": PRIMES}, [dev] * PRIMES)
        blocks_here = gm.local().shape["data"]
        cols = sharding.local_columns(gm, batch)
        nk, rng = prng.KeyChain(SEED), np.random.default_rng(SEED)
        report = {"rank": rank, "world": world, "device": str(dev),
                  "backend": dist.get_backend(), "mesh": gm.shape,
                  "columns": [cols.start, cols.stop], "launches": {}}
        # 1. the data-sharded NTT of one channel (data-only blocks)
        params = she.SHEParams(m=m, p=257, qs=tuple(nt.ntt_primes(m, 30, PRIMES)), var=2.0)
        n, plan = params.ctx.n, params.ctx.ntt_plans()[0]
        x = sampling.uniform_residues((plan.q,), (n, batch), nk(), dev).cpu()
        _reset()
        y = sharding.batched_ntt_sharded(gm, sharding.shard_batch_rns(gm, x), [plan])
        report["launches"]["ntt"] = got = _counts(dev)
        if got != _want({"ntt_fwd": len(tk.cm_schedule(n))}, blocks_here, dev):
            raise AssertionError(f"rank {rank}: NTT launches {got}")
        if not torch.equal(sharding.unshard_batch_rns(y)[0].cpu(),
                           tk.ntt_cm_ref(x[0, :, cols].contiguous(), plan)):
            raise AssertionError(f"rank {rank}: the data-sharded NTT != the plain transform")
        # 2. one cross-process reduction, on a CPU copy under gloo
        total = x[0, :, cols].long().sum().view(1)
        total = total.to(dev) if report["backend"] == "nccl" else total
        dist.all_reduce(total)
        if int(total.item()) != int(x.long().sum()):
            raise AssertionError(f"rank {rank}: all_reduce {int(total.item())} != "
                                 f"{int(x.long().sum())}")
        # 3. the BGV step over the mesh against the unsharded step
        sk = she.gen_sk(params, nk(), dev)
        bb = BatchedBGV(params, dev)
        hint = bb.gen_ks_quad_hint(sk, nk())
        enc = bb.build_encrypt(sk)
        cts = (*enc(she.pt_random(params, rng, (batch,), dev), nk()),
               *enc(she.pt_random(params, rng, (batch,), dev), nk()))
        step_mesh = bb.build_step(hint, mesh=gm)
        blocks = [sharding.shard_batch_rns(gm, c) for c in cts]
        _reset()
        out = step_mesh(*blocks)
        report["launches"]["step"] = got = _counts(dev)
        if got != _want(step_launches(PRIMES, n), blocks_here, dev):
            raise AssertionError(f"rank {rank}: mesh step launches {got}")
        ref = bb.build_step(hint)(*cts)
        for o, r in zip(out, ref):
            if not torch.equal(sharding.unshard_batch_rns(o), r[..., cols]):
                raise AssertionError(f"rank {rank}: mesh step != the unsharded step's columns")
        # 4. the extended-modulus step, two special primes
        all_qs = tuple(nt.ntt_primes(ext_m, 30, PRIMES + 2))
        px = she.SHEParams(m=ext_m, p=257, qs=all_qs[:PRIMES], var=2.0)
        skx = she.gen_sk(px, nk(), dev)
        bbx = BatchedBGV(px, dev)
        hx = bbx.gen_ks_quad_hint_ext(skx, all_qs[PRIMES:], nk())
        encx = bbx.build_encrypt(skx)
        ctx_ = (*encx(she.pt_random(px, rng, (batch,), dev), nk()),
                *encx(she.pt_random(px, rng, (batch,), dev), nk()))
        _reset()
        out = bbx.build_step_ext(hx, mesh=gm)(*(sharding.shard_batch_rns(gm, c) for c in ctx_))
        report["launches"]["ext"] = got = _counts(dev)
        if got != _want(ext_step_launches(PRIMES, 2, px.ctx.n), blocks_here, dev):
            raise AssertionError(f"rank {rank}: mesh ext step launches {got}")
        ref = bbx.build_step_ext(hx)(*ctx_)
        for o, r in zip(out, ref):
            if not torch.equal(sharding.unshard_batch_rns(o), r[..., cols]):
                raise AssertionError(f"rank {rank}: mesh ext step != the unsharded columns")
        if time_iters:
            report.update(_time_step(step_mesh, blocks, dev, batch, time_iters))
        return report
    finally:
        dist.destroy_process_group()


def _time_step(step, blocks, dev: torch.device, batch: int, iters: int) -> dict:
    """The mesh step run in step across the processes: each window starts
    and ends at a barrier, after every process's device has finished;
    every column of every process per second over the window."""
    step(*blocks)
    windows = []
    for _ in range(3):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dist.barrier()
        t0 = time.perf_counter()
        for _ in range(iters):
            step(*blocks)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dist.barrier()
        windows.append((time.perf_counter() - t0) * 1e3 / iters)
    ms = sorted(windows)[1]
    return {"step_ms_windows": windows, "step_ms": ms, "step_ops_per_sec": batch / (ms / 1e3)}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn(world: int, timeout: float = 600.0, **kw) -> list[dict]:
    """Start `world` processes of `run_rank(rank, world, port, **kw)` over a
    free localhost port; their reports, rank by rank.  Raises, after
    stopping every process, if one fails or outlasts `timeout` seconds."""
    root = str(Path(__file__).resolve().parents[2])
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    port = _free_port()
    args = [f"--{k.replace('_', '-')}={v}" for k, v in kw.items()
            if v is not None and not isinstance(v, bool)]
    args += [f"--{k.replace('_', '-')}" for k, v in kw.items() if v is True]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "lol_tpu_torch.parallel.multihost_check", f"--rank={r}",
         f"--world={world}", f"--port={port}", *args],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env, cwd=root)
        for r in range(world)]
    deadline = time.time() + timeout
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=max(1.0, deadline - time.time()))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    reports = []
    for r, (p, out) in enumerate(zip(procs, outs)):
        lines = [ln for ln in out.splitlines() if ln.startswith(TAG)]
        if p.returncode != 0 or not lines:
            raise RuntimeError(f"process {r} of {world} failed (exit {p.returncode}):\n{out}")
        reports.append(json.loads(lines[-1][len(TAG):]))
    return reports


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--world", type=int, default=2)
    ap.add_argument("--rank", type=int, default=None,
                    help="run one process of the group (without it: spawn all of them)")
    ap.add_argument("--port", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default=None)
    ap.add_argument("--m", type=int, default=32768)
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--ext-m", type=int, default=8192)
    ap.add_argument("--card-per-rank", action="store_true")
    ap.add_argument("--time-iters", type=int, default=0)
    a = ap.parse_args(argv)
    kw = dict(device=a.device, backend=a.backend, m=a.m, batch=a.batch, ext_m=a.ext_m,
              card_per_rank=a.card_per_rank, time_iters=a.time_iters)
    if a.rank is None:
        for rep in spawn(a.world, **kw):
            print(json.dumps(rep), flush=True)
        return 0
    print(TAG + json.dumps(run_rank(a.rank, a.world, a.port, **kw)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
