"""Measurement instruments of the port (counterpart of `lol_tpu/bench`).

`roofline` (per-kernel throughput against measured ceilings), `steptime`
(the BGV step's time by component), `mxu_ntt` (the four-step NTT on the
int8 tensor cores, and the integer ceiling), `ntt_ab` (one tree's NTT
kernels and step, for an A/B by tree), and the reference's tools
`she_bench` (the BGV pipeline and HomomPRF ops/s), `micro` (the per-op
table over the torch, C++ and CUDA backends), `scaling` (ops/s over 1, 2,
4, ... cards), `invgap` (the inverse NTT against the forward) and `smallb`
(the NTT's schedule choices at small batch) time on a CUDA card with CUDA
events and refuse to run without one: a CPU run gives no device number.
Each tool prints the card's name and power limit (`card_line`).  Their
work counts and their legs are plain functions that the CPU tests reach.
"""

from __future__ import annotations

import statistics
import subprocess
import time

import torch


def card_line() -> str:
    """The card's name and power limit, as
    `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` gives
    them (the first card)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def require_cuda() -> torch.device:
    """The card to measure on; raises when there is none."""
    if not torch.cuda.is_available():
        raise RuntimeError("this measurement needs a CUDA device; none is available")
    return torch.device("cuda")


SPIN_CYCLES = 10 ** 8  # ~50 ms of device clock: time for the host to queue a window


def time_ms(fn, iters: int, windows: int = 5,
            device_only: bool = False) -> tuple[float, list[float]]:
    """Median milliseconds per call of fn over `windows` CUDA-event windows
    of `iters` calls each, after one warm-up call; and the windows.

    device_only: each window starts behind a spin on the device
    (`torch.cuda._sleep`) while the host queues all its calls, so the
    events time the device's work alone; otherwise a call whose host side
    outlasts its kernels is timed at the host's issue rate, as a caller
    sees it."""
    fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if device_only:
            torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        per_call.append(start.elapsed_time(end) / iters)
    return statistics.median(per_call), per_call


def host_ms(fn, iters: int, windows: int = 5, cards=()) -> float:
    """Median host-clock milliseconds per call of fn over `windows` windows
    of `iters` calls, after one warm-up call, each window closed by a
    synchronize of every card in `cards`: the host backends, and work
    spread over several cards, which one stream's events do not see."""
    def sync():
        for c in cards:
            torch.cuda.synchronize(c)

    fn()
    sync()
    per = []
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        sync()
        per.append((time.perf_counter() - t0) * 1e3 / iters)
    return statistics.median(per)
