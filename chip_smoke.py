#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port's main path once on an NVIDIA GPU and check it.

Run from the root of a checkout, with no arguments, on a machine with one
CUDA card and nvcc:

    python3 chip_smoke.py

It builds the Hopper kernels from lol_tpu_torch/csrc (nvcc, first use),
then runs four phases and exits non-zero on the first failure:

1. the card's name and power limit (nvidia-smi), and the kernel build;
2. every kernel against its plain torch version on the card, bit-exact, at
   n in {256, 4096, 16384} with the largest 30-bit NTT primes and
   B in {1000, 1024}: forward, forward with the digit prologue (source
   modulus above and below q), inverse, and the forward->inverse round trip;
3. the batched BGV slice at full width (m = 32768 so n = 2^14, three
   30-bit primes, p = 257, var = 2.0, B = 1024): keygen, encrypt, the
   ct-mult + key-switch + rescale step, decrypt.  It checks the kernels'
   launch counts over that run, decrypts columns 0-7 against the exact
   plaintext product, and reruns the step on the CPU over columns 0-63,
   which must equal the card's output bit for bit;
4. timings with CUDA events (warm-up, then the median of 5 windows):
   NTT/s at n = 4096 over 2x30-bit primes, kernel against plain at the
   step's shapes, and BGV step ops/s at n = 2^14 and n = 4096.

The last three lines of standard output are the card line, a JSON object
describing each kernel, and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 20261016
WINDOWS = 5
T0 = time.time()


def mark(msg: str) -> None:
    print(f"[chip_smoke {time.time() - T0:7.1f}s] {msg}", file=sys.stderr, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int) -> tuple[float, list[float]]:
    """Median milliseconds per call of fn over WINDOWS CUDA-event windows of
    `iters` calls each, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(WINDOWS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        per_call.append(start.elapsed_time(end) / iters)
    return statistics.median(per_call), per_call


def import_port():
    """The port from this checkout (and only from here)."""
    sys.path.insert(0, ROOT)
    import lol_tpu_torch

    if os.path.dirname(os.path.dirname(os.path.abspath(lol_tpu_torch.__file__))) != ROOT:
        raise RuntimeError(f"lol_tpu_torch imported from {lol_tpu_torch.__file__}, not {ROOT}")
    from lol_tpu_torch import numtheory as nt, she
    from lol_tpu_torch.ops import ntt
    from lol_tpu_torch.ops.cuda import build, ntt_kernel as tk
    from lol_tpu_torch.she_batched import BatchedBGV

    return nt, she, ntt, build, tk, BatchedBGV


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; nothing was run",
              file=sys.stderr)
        return 2
    nt, she, ntt, build, tk, BatchedBGV = import_port()
    dev = torch.device("cuda")
    if "jax" in sys.modules or any(k.startswith("lol_tpu.") for k in sys.modules):
        raise RuntimeError("the port imported jax or the JAX package")

    # -- phase 1: card and build ----------------------------------------
    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    t = time.time()
    lib = build.build()
    mark(f"kernels built in {time.time() - t:.1f}s: {lib}")
    log = (lib.parent / "build.log").read_text()
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print("ptxas:", line.strip(), flush=True)

    # -- phase 2: kernel vs plain, bit-exact ----------------------------
    g = torch.Generator(device=dev).manual_seed(SEED)
    err = {"ntt_fwd": 0, "ntt_inv": 0}
    checks = 0
    for n in (256, 4096, 16384):
        q_src, q = nt.ntt_primes(2 * n, 30, 2)  # the largest two
        plan = ntt.ntt_plan(n, q)
        for B in (1000, 1024):
            x = torch.randint(0, q, (n, B), generator=g, device=dev, dtype=torch.int32)
            x[0] = q - 1  # extremal residues stress the lazy [0, 4q) range
            for inverse, name in ((False, "ntt_fwd"), (True, "ntt_inv")):
                got = tk.ntt_cm(x, plan, inverse=inverse)
                want = tk.ntt_cm_ref(x, plan, inverse=inverse)
                err[name] = max(err[name], (got.long() - want.long()).abs().max().item())
                checks += 1
            for src in (q_src, 12289):  # source modulus above and below q
                xs = torch.randint(0, src, (n, B), generator=g, device=dev,
                                   dtype=torch.int32)
                xs[0] = src - 1
                xs[1] = (src + 1) // 2
                got = tk.ntt_cm(xs, plan, pre_digit_q=src)
                want = tk.ntt_cm_ref(xs, plan, pre_digit_q=src)
                err["ntt_fwd"] = max(err["ntt_fwd"],
                                     (got.long() - want.long()).abs().max().item())
                checks += 1
            back = tk.ntt_cm(tk.ntt_cm(x, plan), plan, inverse=True)
            if not torch.equal(back, x):
                raise AssertionError(f"round trip failed at n={n}, B={B}")
    torch.cuda.synchronize()
    if any(err.values()):
        raise AssertionError(f"kernel != plain: max abs err {err}")
    mark(f"phase 2: {checks} kernel-vs-plain checks bit-exact")

    # -- phase 3: the slice at full width -------------------------------
    m, B, p = 32768, 1024, 257
    params = she.SHEParams(m=m, p=p, qs=tuple(nt.ntt_primes(m, 30, 3)), var=2.0)
    n, nrns = params.ctx.n, len(params.qs)
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    sk = she.gen_sk(params, g)
    bb = BatchedBGV(params, dev)
    hint = bb.gen_ks_quad_hint(sk, g)
    enc = bb.build_encrypt(sk)
    step = bb.build_step(hint)
    p2 = she.SHEParams(m=m, p=p, qs=params.qs[:-1], var=params.var)
    dec = BatchedBGV(p2, dev).build_decrypt(she.SK(p2, sk.s_ints, sk.var),
                                            f=bb.step_f())
    m1 = she.pt_random(params, g, (B,))
    m2 = she.pt_random(params, g, (B,))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in tk.LAUNCHES:
        tk.LAUNCHES[k] = 0
    c0, c1 = enc(m1, g)
    d0, d1 = enc(m2, g)
    before_step = dict(tk.LAUNCHES)
    e0, e1 = step(c0, c1, d0, d1)
    after_step = dict(tk.LAUNCHES)
    got = dec(e0, e1)
    torch.cuda.synchronize()
    launches = dict(tk.LAUNCHES)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    passes = len(tk._schedule(n))
    step_calls = {"ntt_fwd": nrns * (nrns - 1) + 2 * (nrns - 1), "ntt_inv": nrns + 2}
    path_calls = {"ntt_fwd": step_calls["ntt_fwd"] + 2 * nrns,
                  "ntt_inv": step_calls["ntt_inv"] + nrns - 1}
    for k in tk.LAUNCHES:
        in_step = after_step[k] - before_step[k]
        if in_step != step_calls[k] * passes or launches[k] != path_calls[k] * passes:
            raise AssertionError(f"{k}: {in_step} launches in the step, {launches[k]} "
                                 f"on the path; want {step_calls[k] * passes}, "
                                 f"{path_calls[k] * passes}")
    in_bytes = sum(t.numel() * t.element_size() for t in (c0, c1, d0, d1))
    mark(f"phase 3: step ran; launches {launches}; inputs {in_bytes / 1e6:.0f} MB; "
         f"peak {peak_gib:.2f} GiB")
    qv = torch.tensor(params.qs[:-1], device=dev).view(-1, 1, 1)
    for e in (e0, e1):
        if e.shape != (nrns - 1, n, B) or e.dtype != torch.int32:
            raise AssertionError(f"step output {e.dtype} {tuple(e.shape)}")
        if bool((e < 0).any()) or bool((e.long() >= qv).any()):
            raise AssertionError("step output residues out of [0, q)")
    for b in range(8):
        want = she.pt_mul(params, m1[:, b].cpu().numpy(), m2[:, b].cpu().numpy())
        np.testing.assert_array_equal(got[:, b].cpu().numpy(), want)
    cols = 64
    cpu_in = [t[:, :, :cols].cpu().contiguous() for t in (c0, c1, d0, d1)]
    cpu_out = BatchedBGV(params, "cpu").build_step(hint)(*cpu_in)
    for gpu_e, cpu_e in zip((e0, e1), cpu_out):
        if not torch.equal(gpu_e[:, :, :cols].cpu(), cpu_e):
            raise AssertionError("GPU step != CPU step over columns 0-63")
    mark("phase 3: decrypt of columns 0-7 == pt_mul; GPU == CPU over columns 0-63")

    # -- phase 4: timings -----------------------------------------------
    timings = {}
    # NTT/s at n = 4096 over 2x30-bit primes: one NTT = one column through both
    n4 = 4096
    plans4 = [ntt.ntt_plan(n4, q) for q in nt.ntt_primes(2 * n4, 30, 2)]
    for B4 in (1024, 16384):
        xs = [torch.randint(0, pl.q, (n4, B4), generator=g, device=dev,
                            dtype=torch.int32) for pl in plans4]
        for inverse, key in ((False, "ntt"), (True, "intt")):
            ms, wins = time_ms(lambda: [tk.ntt_cm(x, pl, inverse=inverse)
                                        for x, pl in zip(xs, plans4)], 20)
            timings[f"{key}_per_s_n4096_B{B4}"] = B4 / (ms / 1e3)
            timings[f"{key}_ms_windows_n4096_B{B4}"] = wins
        del xs
    # kernel vs plain at the step's shapes (one channel, n = 2^14, B = 1024)
    plan = bb.plans()[0]
    x = e0[0].contiguous()
    xd = (e0[1] % params.qs[1]).contiguous()
    legs = {
        "ntt_fwd": (lambda: tk.ntt_cm(xd, plan, pre_digit_q=params.qs[1]),
                    lambda: tk.ntt_cm_ref(xd, plan, pre_digit_q=params.qs[1])),
        "ntt_inv": (lambda: tk.ntt_cm(x, plan, inverse=True),
                    lambda: tk.ntt_cm_ref(x, plan, inverse=True)),
    }
    for name, (kern, plain) in legs.items():
        timings[f"{name}_ms"], _ = time_ms(kern, 20)
        timings[f"{name}_plain_ms"], _ = time_ms(plain, 3)
    # BGV step ops/s
    step_ms, wins = time_ms(lambda: step(c0, c1, d0, d1), 3)
    timings["bgv_ops_per_s_n16384"] = B / (step_ms / 1e3)
    timings["bgv_step_ms_windows_n16384"] = wins
    ntt_ms = (step_calls["ntt_fwd"] * timings["ntt_fwd_ms"]
              + step_calls["ntt_inv"] * timings["ntt_inv_ms"])
    timings["bgv_step_ntt_share_n16384"] = ntt_ms / step_ms
    del c0, c1, d0, d1, e0, e1, x, xd
    m8 = 8192
    params8 = she.SHEParams(m=m8, p=p, qs=tuple(nt.ntt_primes(m8, 30, 3)), var=2.0)
    bb8 = BatchedBGV(params8, dev)
    sk8 = she.gen_sk(params8, g)
    enc8 = bb8.build_encrypt(sk8)
    step8 = bb8.build_step(bb8.gen_ks_quad_hint(sk8, g))
    cts8 = (*enc8(she.pt_random(params8, g, (B,)), g),
            *enc8(she.pt_random(params8, g, (B,)), g))
    step8_ms, wins8 = time_ms(lambda: step8(*cts8), 5)
    timings["bgv_ops_per_s_n4096"] = B / (step8_ms / 1e3)
    timings["bgv_step_ms_windows_n4096"] = wins8
    for k, v in timings.items():
        print(f"timing {k} = {v}", flush=True)
    mark("phase 4: timings done")

    src = "lol_tpu_torch/csrc/ntt.cu"
    kernels = [
        {"name": "ntt_fwd_pass", "route": "cuda", "source": src,
         "replaces": "lol_tpu/ops/pallas/ntt_kernel.py:539",
         "also_replaces": "lol_tpu/ops/pallas/ntt_kernel.py:593",
         "launches": launches["ntt_fwd"], "max_abs_err": err["ntt_fwd"],
         "ms": timings["ntt_fwd_ms"], "plain_ms": timings["ntt_fwd_plain_ms"]},
        {"name": "ntt_inv_pass", "route": "cuda", "source": src,
         "replaces": "lol_tpu/ops/pallas/ntt_kernel.py:593",
         "also_replaces": "lol_tpu/ops/pallas/ntt_kernel.py:539",
         "launches": launches["ntt_inv"], "max_abs_err": err["ntt_inv"],
         "ms": timings["ntt_inv_ms"], "plain_ms": timings["ntt_inv_plain_ms"]},
    ]
    print(card_line(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
