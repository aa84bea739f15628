"""Time the NTT kernels and the BGV step of one tree of the port.

An A/B of two trees runs this script once per tree, in turns (parent,
change, change, parent), in one process each, on one card:

    python lol_tpu_torch/bench/ntt_ab.py --tree DIR [--label NAME]

It imports `lol_tpu_torch` from DIR (so a tree that predates the script
can be timed by the script of another), builds that tree's kernels,
checks kernel == plain on every input it times, and prints one JSON line:

- per transform at one channel of the n = 2^14, B = 1024 step (its first
  30-bit prime): the forward with the digit prologue (source: the second
  prime), the GS inverse, the route-B inverse (`dit_`) and the forward
  without the prologue; and the forward and both inverses at n = 8192 and
  65536, B = 1024;
- per transform at n = 4096, B = 16384 (the mean over the two largest
  30-bit primes) and the NTT/s there (B over the time of both primes),
  and at n = 4096, B = 1024 (the largest prime), route B included;
- the B = 1024 times both as the caller sees them and on the device alone
  (`_dev_ms_`), where the host's issue cannot hide short kernels; bounds
  by `roofline.bound` of the work;
- the step's ct-ops/s at n = 2^14 and 4096 (m = 32768 and 8192, three
  30-bit primes, B = 1024);
- the ring-sharded NTT at n = 2^14 and 2^16, B = 1024, one prime, D = 4
  shards on the card: phase B of all four shards, fused with the block
  exchange (`ntt_fwd_gather`, `ntt_inv_scatter`) and unfused (the pass
  kernels on the exchange's output: B, and B' before it), on the device
  alone (`time_ms(device_only=True)`); and each route's forward and
  inverse transform, as its caller sees it (host included) and on the
  device alone (`_dev_`);
- the card's name and power limit (nvidia-smi).

With `--keygen` it times keygen and encryption instead, as their caller
sees them (each call ends in a synchronize): `gen_sk`, `build_encrypt`'s
`enc` at B = 1024 and `gen_ks_quad_hint`, at m = 32768 over three 30-bit
primes, from `prng` keys where the tree has them and from a
`torch.Generator` in a tree that predates them; and, where the tree has
the draw kernel (`ops/cuda/prng`), its legs at (16384, 1024) on the
device alone, each checked == its plain version on the card first: the
rounded normal at var 2 (`round`), randint over the three primes
(`randint`), the words (`bits`) and randint over three spans up to 2^16
(`randint2`), and the number of the epilogue's words that differ from
the plain version's over all 2^23 inputs (`prng_map_differ`).

Times are `bench.time_ms` medians of 5 CUDA-event windows.  `ring_phase_b`
builds the ring's timed phase-B calls for this script and `chip_smoke.py`.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import subprocess
import sys


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def ring_phase_b(rn, tk, plan, shards) -> dict:
    """Phase B of every shard of `shards` (D shards of one ring on one card),
    fused with the block exchange and unfused, as {name: (kernel call, plain
    call)}: `gather`, `phase_b` (the pass kernels on the exchange's output),
    `scatter` and `phase_b_inv` (B' before it).  Every kernel call is checked
    == its plain call first; the inverse ones' lazy words after one fold.
    `rn` and `tk` are the remote_ntt and ntt_kernel modules of the tree
    under test."""
    import torch

    D = len(shards)
    xa = [rn.phase_a(v, plan, D, False) for v in rn.a2a_chunks(shards)]  # lazy words
    xb = rn.a2a_chunks(xa)
    passes = [rn.phase_b_passes(plan.n // D, D, d) for d in range(D)]
    ops = {  # name: (kernel call, plain call, lazy output)
        "gather": (lambda: rn.ntt_fwd_gather(xa, plan),
                   lambda: rn.ntt_fwd_gather_ref(xa, plan), False),
        "phase_b": (lambda: [tk.run_passes(v, plan, ps, False) for v, ps in zip(xb, passes)],
                    lambda: [rn.phase_b_ref(v, plan, D, d, False) for d, v in enumerate(xb)],
                    False),
        "scatter": (lambda: rn.ntt_inv_scatter(shards, plan),
                    lambda: rn.ntt_inv_scatter_ref(shards, plan), True),
        "phase_b_inv": (lambda: [tk.run_passes(v, plan, ps[::-1], True, last=False)
                                 for v, ps in zip(shards, passes)],
                        lambda: [rn.phase_b_ref(v, plan, D, d, True)
                                 for d, v in enumerate(shards)], True),
    }
    for name, (fn, ref, lazy) in ops.items():
        for a, b in zip(fn(), ref()):
            if not torch.equal(a % plan.q if lazy else a, b):
                raise AssertionError(f"ring {name} != plain at n={plan.n}")
    return {name: (fn, ref) for name, (fn, ref, _) in ops.items()}


def ring(rn, tk, sh, ntt, nt, bench, dev, g, out: dict) -> None:
    """The ring timings into out (see the module docstring)."""
    import torch

    D, B = 4, 1024
    mesh = sh.make_mesh({"ring": D}, [dev] * D)
    for n in (16384, 65536):
        plan = ntt.ntt_plan(n, nt.ntt_primes(2 * n, 30, 1)[0])
        x = torch.randint(0, plan.q, (n, B), generator=g, device=dev, dtype=torch.int32)
        shards = sh.ring_shard(x, mesh)
        for name, (fn, _) in ring_phase_b(rn, tk, plan, shards).items():
            out[f"ring_{name}_ms_n{n}"] = bench.time_ms(fn, 20, device_only=True)[0]
        want = {False: tk.ntt_cm(x, plan), True: tk.ntt_cm(x, plan, inverse=True)}
        for overlap, route in ((False, "two_call"), (True, "fused")):
            for inverse, key in ((False, "ntt"), (True, "intt")):
                fn = rn.intt_ring_sharded_cm if inverse else rn.ntt_ring_sharded_cm
                if not torch.equal(sh.ring_unshard(fn(mesh, shards, plan, overlap=overlap)),
                                   want[inverse]):
                    raise AssertionError(f"ring {route} {key} != ntt_cm at n={n}")

                def call():
                    return fn(mesh, shards, plan, overlap=overlap)
                out[f"ring_{key}_ms_{route}_n{n}"] = bench.time_ms(call, 10)[0]
                out[f"ring_{key}_dev_ms_{route}_n{n}"] = bench.time_ms(
                    call, 10, device_only=True)[0]
        out[f"ring_phase_b_passes_n{n}"] = len(rn.phase_b_passes(n // D, D, 0))
        del x, shards, want


def draws(she, dev, seed: int):
    """(gen_sk(params), key(), pt(params, B), what): the tree's keygen from
    `prng` keys where it has them, else from a `torch.Generator` (a tree
    that predates them)."""
    import numpy as np
    import torch

    try:
        prng = importlib.import_module("lol_tpu_torch.prng")
    except ImportError:
        g = torch.Generator(device=dev).manual_seed(seed)
        return (lambda params: she.gen_sk(params, g), lambda: g,
                lambda params, B: she.pt_random(params, g, (B,)), "torch.Generator")
    keys, rng = prng.KeyChain(seed), np.random.default_rng(seed)
    return (lambda params: she.gen_sk(params, keys(), dev), keys,
            lambda params, B: she.pt_random(params, rng, (B,), dev), "prng keys")


def keygen(she, BatchedBGV, nt, bench, dev, out: dict) -> None:
    """The keygen timings into out (see the module docstring)."""
    import torch

    gen_sk, key, pt, out["keygen_randomness"] = draws(she, dev, 1)
    m, B = 32768, 1024
    params = she.SHEParams(m=m, p=257, qs=tuple(nt.ntt_primes(m, 30, 3)), var=2.0)
    bb = BatchedBGV(params, dev)
    sk = gen_sk(params)
    enc = bb.build_encrypt(sk)
    msgs = pt(params, B)

    def synced(fn):
        def call():
            fn()
            torch.cuda.synchronize()
        return call

    for name, fn in (("gen_sk", lambda: gen_sk(params)), ("encrypt_B1024", lambda: enc(msgs, key())),
                     ("gen_ks_quad_hint", lambda: bb.gen_ks_quad_hint(sk, key()))):
        out[f"{name}_ms_m{m}"] = bench.time_ms(synced(fn), 5)[0]
    if importlib.util.find_spec("lol_tpu_torch.ops.cuda.prng"):
        prng_legs(nt, bench, dev, out)


def prng_legs(nt, bench, dev, out: dict, n: int = 16384, B: int = 1024) -> None:
    """The draw kernel's legs at (n, B) into out (see the module
    docstring), and `prng_map_differ`: the words of the epilogue that
    differ from the plain version's over all 2^23 inputs, raw, as
    jax.random.normal and rounded at var 2, 4, 9 (0 for a right kernel)."""
    import torch

    pk = importlib.import_module("lol_tpu_torch.ops.cuda.prng")
    prng = importlib.import_module("lol_tpu_torch.prng")
    keys3 = list(prng.split(prng.PRNGKey(13), 3))
    legs = {"round": ([prng.PRNGKey(31)], "round", {"scale": prng.folded_scale(2.0)}),
            "randint": (keys3, "randint", {"qs": tuple(nt.ntt_primes(2 * n, 30, 3))}),
            "bits": ([prng.PRNGKey(31)], "bits", {}),
            "randint2": (keys3, "randint", {"qs": (257, 12289, 65535)})}
    for leg, (kk, mode, kw) in legs.items():
        if not torch.equal(pk.draw(kk, n * B, mode, device=dev, **kw),
                           pk.draw_ref(kk, n * B, mode, device=dev, **kw)):
            raise AssertionError(f"prng {leg} != plain")
        out[f"prng_{leg}_dev_ms_n{n}_B{B}"] = bench.time_ms(
            lambda: pk.draw(kk, n * B, mode, device=dev, **kw), 10, device_only=True)[0]
    words = (torch.arange(1 << 23, dtype=torch.int64) << 9).to(torch.int32)
    out["prng_map_differ"] = 0
    for mode, pre, scale in (("float", 1.0, 1.0), ("float", prng.SQRT2, 1.0),
                             *(("round", 1.0, prng.folded_scale(v)) for v in (2.0, 4.0, 9.0))):
        got = pk.map_words(words.to(dev), mode, pre, scale).cpu()
        want = pk.map_words(words, mode, pre, scale)
        out["prng_map_differ"] += int((got.view(torch.int32) != want.view(torch.int32)).sum())


def run(tree: str, label: str, keygen_only: bool = False) -> dict:
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
    rn = importlib.import_module("lol_tpu_torch.ops.cuda.remote_ntt")
    sh = importlib.import_module("lol_tpu_torch.parallel.sharding")
    dev = bench.require_cuda()
    g = torch.Generator(device=dev).manual_seed(4)
    out = {"label": label, "tree": root, "card": card_line()}
    if keygen_only:
        keygen(she, BatchedBGV, nt, bench, dev, out)
        return out
    ring(rn, tk, sh, ntt, nt, bench, dev, g, out)

    def bound(op, n, B):
        return roofline.bound(*roofline.work(op, n, B))[0]

    def checked(key, fn, ref):
        """out[key]: fn's time as its caller sees it; the same key with
        `_dev_ms_` for it on the device alone, after one check == ref."""
        if not torch.equal(fn(), ref()):
            raise AssertionError(f"{label}: kernel != plain")
        out[key] = bench.time_ms(fn, 20)[0]
        out[key.replace("_ms_", "_dev_ms_")] = bench.time_ms(fn, 20, device_only=True)[0]

    # one channel of the n = 2^14 step
    n, B = 16384, 1024
    q0, q1 = nt.ntt_primes(2 * n, 30, 2)
    plan = ntt.ntt_plan(n, q0)
    xd = torch.randint(0, q1, (n, B), generator=g, device=dev, dtype=torch.int32)
    x = torch.randint(0, q0, (n, B), generator=g, device=dev, dtype=torch.int32)
    checked("fwd_pre_ms_n16384_B1024", lambda: tk.ntt_cm(xd, plan, pre_digit_q=q1),
            lambda: tk.ntt_cm_ref(xd, plan, pre_digit_q=q1))
    checked("inv_ms_n16384_B1024", lambda: tk.ntt_cm(x, plan, inverse=True),
            lambda: tk.ntt_cm_ref(x, plan, inverse=True))
    checked("fwd_ms_n16384_B1024", lambda: tk.ntt_cm(x, plan), lambda: tk.ntt_cm_ref(x, plan))
    checked("dit_ms_n16384_B1024", lambda: tk.ntt_cm(x, plan, inverse=True, alg="dit"),
            lambda: tk.ntt_cm_ref(x, plan, inverse=True, alg="dit"))
    out["bound_ms_n16384_B1024"] = bound("ntt_fwd", n, B)
    out["dit_bound_ms_n16384_B1024"] = bound("ntt_inv_dit", n, B)
    del xd, x
    # n = 8192 and 65536, B = 1024
    for n_ in (8192, 65536):
        plan_ = ntt.ntt_plan(n_, nt.ntt_primes(2 * n_, 30, 1)[0])
        x_ = torch.randint(0, plan_.q, (n_, B), generator=g, device=dev, dtype=torch.int32)
        for inverse, alg, key in ((False, "gs", "fwd"), (True, "gs", "inv"), (True, "dit", "dit")):
            checked(f"{key}_ms_n{n_}_B1024",
                    lambda: tk.ntt_cm(x_, plan_, inverse=inverse, alg=alg),
                    lambda: tk.ntt_cm_ref(x_, plan_, inverse=inverse, alg=alg))
        del x_
    # n = 4096, B = 16384, two primes
    n4, B4 = 4096, 16384
    plans = [ntt.ntt_plan(n4, q) for q in nt.ntt_primes(2 * n4, 30, 2)]
    xs = [torch.randint(0, p.q, (n4, B4), generator=g, device=dev, dtype=torch.int32)
          for p in plans]
    for inverse, alg, key in ((False, "gs", "fwd"), (True, "gs", "inv"), (True, "dit", "dit")):
        def both():
            return [tk.ntt_cm(v, p, inverse=inverse, alg=alg) for v, p in zip(xs, plans)]
        for got, v, p in zip(both(), xs, plans):
            if not torch.equal(got, tk.ntt_cm_ref(v, p, inverse=inverse, alg=alg)):
                raise AssertionError(f"{label}: kernel != plain")
        ms = bench.time_ms(both, 20)[0]
        out[f"{key}_ms_n4096_B16384"] = ms / 2
        out[f"{key}_ntt_per_s_n4096_B16384"] = B4 / (ms / 1e3)
    out["bound_ms_n4096_B16384"] = bound("ntt_fwd", n4, B4)
    del xs
    # n = 4096 at the n = 4096 step's B = 1024, one prime
    x4 = torch.randint(0, plans[0].q, (n4, B), generator=g, device=dev, dtype=torch.int32)
    for inverse, alg, key in ((False, "gs", "fwd"), (True, "gs", "inv"), (True, "dit", "dit")):
        checked(f"{key}_ms_n4096_B1024",
                lambda: tk.ntt_cm(x4, plans[0], inverse=inverse, alg=alg),
                lambda: tk.ntt_cm_ref(x4, plans[0], inverse=inverse, alg=alg))
    del x4
    # the step at n = 2^14 and 4096
    gen_sk, key, pt, _ = draws(she, dev, 4)
    for m in (32768, 8192):
        params = she.SHEParams(m=m, p=257, qs=tuple(nt.ntt_primes(m, 30, 3)), var=2.0)
        bb = BatchedBGV(params, dev)
        sk = gen_sk(params)
        enc = bb.build_encrypt(sk)
        step = bb.build_step(bb.gen_ks_quad_hint(sk, key()))
        cts = (*enc(pt(params, 1024), key()), *enc(pt(params, 1024), key()))
        ms, wins = bench.time_ms(lambda: step(*cts), 5)
        out[f"step_ops_per_s_n{params.ctx.n}"] = 1024 / (ms / 1e3)
        out[f"step_ms_windows_n{params.ctx.n}"] = wins
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", required=True, help="root of the tree whose port is timed")
    ap.add_argument("--label", default="")
    ap.add_argument("--keygen", action="store_true",
                    help="time keygen and encryption at m = 32768 instead, and the draws")
    args = ap.parse_args()
    print(json.dumps(run(args.tree, args.label or args.tree, args.keygen)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
