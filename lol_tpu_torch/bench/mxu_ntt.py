"""The u32 integer ceiling (counterpart of `lol_tpu/bench/mxu_ntt.py:164-208`).

`u32_ceiling` times the hand-written chain kernel of `csrc/chain.cu`
(replacing `_chain_kernel`): every element runs `y = y * x + 1` in u32
`iters` times in registers, so its rate is the card's u32 multiply-add
ceiling, the denominator `roofline` divides by.  `chain` dispatches like
the port's other wrappers (a CUDA tensor launches the kernel, a CPU
tensor runs the plain version `chain_ref`, anything else raises).

The reference module's MXU four-step NTT (`mxu_ntt`, `stage_matrices`,
`mxu_modmat_apply`) is int8 matmuls through XLA, with no Pallas kernel; it
waits for the int8 tensor-core work of general m (ROADMAP queue A item 12).

Run on the card: python -m lol_tpu_torch.bench.mxu_ntt [--iters 512]
"""

from __future__ import annotations

import argparse
import ctypes
import json

import torch

from ..ops.cuda import build
from . import require_cuda, time_ms

# One per kernel launch.  Reset by callers that check which kernels a path ran.
LAUNCHES = {"chain": 0}
THREADS = 256
ITERS, ROWS, LANES, GRID = 512, 512, 512, 64  # the ceiling's default run
_MASK = 0xFFFFFFFF


def _lib() -> ctypes.CDLL:
    lib = build.load()
    if lib.lol_u32_chain.argtypes is None:
        lib.lol_u32_chain.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                      ctypes.c_longlong, ctypes.c_int,
                                      ctypes.c_int, ctypes.c_void_p]
        lib.lol_u32_chain.restype = ctypes.c_int
    return lib


def chain_ref(x: torch.Tensor, iters: int) -> torch.Tensor:
    """Plain version: int64 arithmetic masked to 32 bits each iteration
    (the CPU has no u32 multiply); x and the result are int32 holding
    u32 bits.  The product is split at 16 bits so no int64 overflows."""
    x64 = x.long() & _MASK
    x_lo, x_hi = x64 & 0xFFFF, x64 >> 16
    y = x64
    for _ in range(iters):
        y = (y * x_lo + (((y * x_hi) & 0xFFFF) << 16) + 1) & _MASK
    return torch.where(y >= 1 << 31, y - (1 << 32), y).to(torch.int32)


def chain(x: torch.Tensor, iters: int) -> torch.Tensor:
    """`y = y * x + 1` (u32, from y = x) `iters` times for every element of
    an int32 tensor holding u32 bits."""
    if x.dtype != torch.int32 or x.numel() < 1 or iters < 0:
        raise ValueError(f"chain: need a non-empty int32 tensor and iters >= 0, "
                         f"got {x.dtype} {tuple(x.shape)}, iters={iters}")
    if x.device.type == "cpu":
        return chain_ref(x, iters)
    if x.device.type != "cuda":
        raise ValueError(f"chain: unsupported device {x.device}")
    if not x.is_contiguous():
        raise ValueError("chain: the CUDA kernel needs a contiguous tensor")
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = _lib().lol_u32_chain(
            x.data_ptr(), y.data_ptr(), x.numel(), iters, THREADS,
            torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, f"u32_chain ({x.numel()} elements, iters={iters})")
    LAUNCHES["chain"] += 1
    return y


def ceiling_input(rows: int = ROWS, lanes: int = LANES, grid: int = GRID) -> torch.Tensor:
    """The (grid*rows, lanes) int32 array `u32_ceiling` chains, on the
    card, from a fixed seed: the same array on every call."""
    dev = require_cuda()
    g = torch.Generator(device=dev).manual_seed(0)
    return torch.randint(-(1 << 31), 1 << 31, (grid * rows, lanes), generator=g,
                         device=dev, dtype=torch.int32)


def u32_ceiling(iters: int = ITERS, rows: int = ROWS, lanes: int = LANES,
                grid: int = GRID) -> float:
    """Achieved u32 (mul+add)/s of the chain kernel over
    `ceiling_input(rows, lanes, grid)`, each element chained `iters`
    times: CUDA-event median of 5 windows on the device alone.  One
    (mul+add) is one IMAD on the card."""
    x = ceiling_input(rows, lanes, grid)
    ms, _ = time_ms(lambda: chain(x, iters), 5, device_only=True)
    return x.numel() * iters / (ms / 1e3)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=ITERS)
    ap.add_argument("--rows", type=int, default=ROWS)
    ap.add_argument("--lanes", type=int, default=LANES)
    ap.add_argument("--grid", type=int, default=GRID)
    args = ap.parse_args()
    rate = u32_ceiling(args.iters, args.rows, args.lanes, args.grid)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "u32_mul_add_per_s": rate}))


if __name__ == "__main__":
    main()
