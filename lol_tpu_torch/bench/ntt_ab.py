"""Time the forward / GS NTT kernels and the BGV step of one tree of the port.

An A/B of two trees runs this script once per tree, in turns (parent,
change, change, parent), in one process each, on one card:

    python lol_tpu_torch/bench/ntt_ab.py --tree DIR [--label NAME]

It imports `lol_tpu_torch` from DIR (so a tree that predates the script
can be timed by the script of another), builds that tree's kernels,
checks kernel == plain on every input it times, and prints one JSON line:

- per transform at one channel of the n = 2^14, B = 1024 step (its first
  30-bit prime): the forward with the digit prologue (source: the second
  prime), the GS inverse and the forward without the prologue; and the
  forward and GS inverse at n = 8192, B = 1024;
- per transform at n = 4096, B = 16384 (the mean over the two largest
  30-bit primes) and the NTT/s there (B over the time of both primes),
  and at n = 4096, B = 1024 (the largest prime);
- each beside `roofline.bound` of its work;
- the step's ct-ops/s at n = 2^14 and 4096 (m = 32768 and 8192, three
  30-bit primes, B = 1024);
- the card's name and power limit (nvidia-smi).

Times are `bench.time_ms` medians of 5 CUDA-event windows.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import subprocess
import sys


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def run(tree: str, label: str) -> dict:
    root = os.path.abspath(tree)
    sys.path.insert(0, root)
    import torch

    port = importlib.import_module("lol_tpu_torch")
    if not os.path.abspath(port.__file__).startswith(root + os.sep):
        raise RuntimeError(f"lol_tpu_torch came from {port.__file__}, not {root}")
    nt = importlib.import_module("lol_tpu_torch.numtheory")
    she = importlib.import_module("lol_tpu_torch.she")
    ntt = importlib.import_module("lol_tpu_torch.ops.ntt")
    tk = importlib.import_module("lol_tpu_torch.ops.cuda.ntt_kernel")
    bench = importlib.import_module("lol_tpu_torch.bench")
    roofline = importlib.import_module("lol_tpu_torch.bench.roofline")
    BatchedBGV = importlib.import_module("lol_tpu_torch.she_batched").BatchedBGV
    dev = bench.require_cuda()
    g = torch.Generator(device=dev).manual_seed(4)
    out = {"label": label, "tree": root, "card": card_line()}

    def bound(op, n, B):
        return roofline.bound(*roofline.work(op, n, B))[0]

    def checked(fn, ref):
        if not torch.equal(fn(), ref()):
            raise AssertionError(f"{label}: kernel != plain")
        return bench.time_ms(fn, 20)[0]

    # one channel of the n = 2^14 step
    n, B = 16384, 1024
    q0, q1 = nt.ntt_primes(2 * n, 30, 2)
    plan = ntt.ntt_plan(n, q0)
    xd = torch.randint(0, q1, (n, B), generator=g, device=dev, dtype=torch.int32)
    x = torch.randint(0, q0, (n, B), generator=g, device=dev, dtype=torch.int32)
    out["fwd_pre_ms_n16384_B1024"] = checked(
        lambda: tk.ntt_cm(xd, plan, pre_digit_q=q1),
        lambda: tk.ntt_cm_ref(xd, plan, pre_digit_q=q1))
    out["inv_ms_n16384_B1024"] = checked(lambda: tk.ntt_cm(x, plan, inverse=True),
                                         lambda: tk.ntt_cm_ref(x, plan, inverse=True))
    out["fwd_ms_n16384_B1024"] = checked(lambda: tk.ntt_cm(x, plan),
                                         lambda: tk.ntt_cm_ref(x, plan))
    out["bound_ms_n16384_B1024"] = bound("ntt_fwd", n, B)
    del xd, x
    # n = 8192, B = 1024
    plan8 = ntt.ntt_plan(8192, nt.ntt_primes(2 * 8192, 30, 1)[0])
    x8 = torch.randint(0, plan8.q, (8192, B), generator=g, device=dev, dtype=torch.int32)
    for inverse, key in ((False, "fwd"), (True, "inv")):
        out[f"{key}_ms_n8192_B1024"] = checked(
            lambda: tk.ntt_cm(x8, plan8, inverse=inverse),
            lambda: tk.ntt_cm_ref(x8, plan8, inverse=inverse))
    del x8
    # n = 4096, B = 16384, two primes
    n4, B4 = 4096, 16384
    plans = [ntt.ntt_plan(n4, q) for q in nt.ntt_primes(2 * n4, 30, 2)]
    xs = [torch.randint(0, p.q, (n4, B4), generator=g, device=dev, dtype=torch.int32)
          for p in plans]
    for inverse, key in ((False, "fwd"), (True, "inv")):
        def both():
            return [tk.ntt_cm(v, p, inverse=inverse) for v, p in zip(xs, plans)]
        for got, v, p in zip(both(), xs, plans):
            if not torch.equal(got, tk.ntt_cm_ref(v, p, inverse=inverse)):
                raise AssertionError(f"{label}: kernel != plain")
        ms = bench.time_ms(both, 20)[0]
        out[f"{key}_ms_n4096_B16384"] = ms / 2
        out[f"{key}_ntt_per_s_n4096_B16384"] = B4 / (ms / 1e3)
    out["bound_ms_n4096_B16384"] = bound("ntt_fwd", n4, B4)
    del xs
    # n = 4096 at the n = 4096 step's B = 1024, one prime
    x4 = torch.randint(0, plans[0].q, (n4, B), generator=g, device=dev, dtype=torch.int32)
    for inverse, key in ((False, "fwd"), (True, "inv")):
        out[f"{key}_ms_n4096_B1024"] = checked(
            lambda: tk.ntt_cm(x4, plans[0], inverse=inverse),
            lambda: tk.ntt_cm_ref(x4, plans[0], inverse=inverse))
    del x4
    # the step at n = 2^14 and 4096
    for m in (32768, 8192):
        params = she.SHEParams(m=m, p=257, qs=tuple(nt.ntt_primes(m, 30, 3)), var=2.0)
        bb = BatchedBGV(params, dev)
        sk = she.gen_sk(params, g)
        enc = bb.build_encrypt(sk)
        step = bb.build_step(bb.gen_ks_quad_hint(sk, g))
        cts = (*enc(she.pt_random(params, g, (1024,)), g),
               *enc(she.pt_random(params, g, (1024,)), g))
        ms, wins = bench.time_ms(lambda: step(*cts), 5)
        out[f"step_ops_per_s_n{params.ctx.n}"] = 1024 / (ms / 1e3)
        out[f"step_ms_windows_n{params.ctx.n}"] = wins
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", required=True, help="root of the tree whose port is timed")
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    print(json.dumps(run(args.tree, args.label or args.tree)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
