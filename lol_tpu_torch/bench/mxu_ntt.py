"""The four-step NTT as two exact int8 tensor-core matmuls, and the u32
integer ceiling (counterpart of `lol_tpu/bench/mxu_ntt.py`).

`mxu_ntt(x, plan, P)` computes the forward negacyclic NTT of a
coefficient-major (n, B) tensor, bit for bit `ntt_cm`'s, with n = P tS as
two modular matrix products: stage A, the first log2(P) DIT stages, is one
(P, P) matrix on the (P, tS B) reshape; stage B, the remaining stages inside
each of the P blocks, is a stack of P (tS, tS) matrices, one a block.
`stage_matrices` extracts both exactly by feeding the identity through the
numpy staged network (`np_ntt_forward`) over the plan's twiddle prefix and
the per-block DIT tables (`block_twiddles`, the port's copy of the JAX
package's `_block_twiddles`).  `mxu_modmat_apply` runs one stage: the
hand-written int8 tensor-core kernel `modmat_s8` (`ops/cuda/modmat.py`)
on a CUDA tensor, M_A shared and M_B one matrix a block, its plain version
on a CPU tensor.  `run` checks it against `ntt_cm` and times both.

`u32_ceiling` times the hand-written chain kernel of `csrc/chain.cu`
(replacing `_chain_kernel`): every element runs `y = y * x + 1` in u32
`iters` times in registers, so its rate is the card's u32 multiply-add
ceiling, the denominator `roofline` divides by.  `chain` dispatches like
the port's other wrappers (a CUDA tensor launches the kernel, a CPU
tensor runs the plain version `chain_ref`, anything else raises).

Run on the card: python -m lol_tpu_torch.bench.mxu_ntt [--n 4096]
[--batch 8192] [--P 64] [--iters 512]
"""

from __future__ import annotations

import argparse
import ctypes
import json
from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from .. import numtheory as nt
from ..ops import ntt
from ..ops.cuda import build
from ..ops.cuda.modmat import modmat_s8
from ..ops.cuda.ntt_kernel import ntt_cm, ntt_cm_ref
from . import card_line, require_cuda, time_ms

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


# ---------------------------------------------------------------------------
# the four-step NTT as two modular matmuls
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class _MiniPlan:
    """Just enough plan for `np_ntt_forward`'s stage loop."""

    n: int
    q: int
    psi_rev: np.ndarray


def block_twiddles(plan: ntt.NTTPlan, S: int, tS: int) -> np.ndarray:
    """(n / tS, tS) per-block forward tables for the stages after the first
    S: block b's rows [2^s', 2^(s'+1)) hold local stage s''s group
    twiddles, psi_rev[2^(S+s') + b 2^s' + i]."""
    k = plan.n.bit_length() - 1
    T = np.zeros((plan.n // tS, tS), dtype=np.uint32)
    for sp in range(k - S):
        mp, base = 1 << sp, 1 << (S + sp)
        for b in range(plan.n // tS):
            T[b, mp:2 * mp] = plan.psi_rev[base + b * mp:base + (b + 1) * mp]
    return T


@lru_cache(maxsize=32)
def stage_matrices(plan: ntt.NTTPlan, P: int) -> tuple[np.ndarray, np.ndarray]:
    """(M_A (P, P), M_B (n / tS, tS, tS)) u32, read-only, with
    np_ntt_forward(x) == M_B[b] @ (M_A @ x.reshape(P, tS))[b]: M_A the
    size-P NTT over the twiddle prefix psi_rev[:P], M_B[b] block b's
    size-tS DIT network over its table."""
    n, q = plan.n, plan.q
    tS = n // P
    M_A = np.ascontiguousarray(
        ntt.np_ntt_forward(np.eye(P, dtype=np.uint32), _MiniPlan(P, q, plan.psi_rev[:P])).T)
    TB = block_twiddles(plan, P.bit_length() - 1, tS)
    eye_t = np.eye(tS, dtype=np.uint32)
    M_B = np.stack([ntt.np_ntt_forward(eye_t, _MiniPlan(tS, q, TB[b])).T for b in range(n // tS)])
    for M in (M_A, M_B):
        M.flags.writeable = False
    return M_A, M_B


def mxu_modmat_apply(M: np.ndarray, x: torch.Tensor, q: int, batched: bool) -> torch.Tensor:
    """Y = M @ x mod q, int32: batched=False, M (a, b) and x (b, N);
    batched=True, M (G, a, b) and x (G, b, N), one matrix a leading
    index (`modmat_s8`)."""
    return modmat_s8(M, x, q, axis=1 if batched else 0)


def mxu_ntt(x: torch.Tensor, plan: ntt.NTTPlan, P: int = 64) -> torch.Tensor:
    """The forward negacyclic NTT of a coefficient-major (n, B) tensor by
    the two stage matrices, equal to `ntt_cm`'s bit for bit."""
    n, B = x.shape
    tS = n // P
    M_A, M_B = stage_matrices(plan, P)
    a = mxu_modmat_apply(M_A, x.reshape(P, tS * B), plan.q, batched=False)
    return mxu_modmat_apply(M_B, a.view(P, tS, B), plan.q, batched=True).view(n, B)


def run(n: int = 4096, batch: int = 8192, P: int = 64) -> dict:
    """`mxu_ntt` against `ntt_cm` at (n, batch) on the card: checked equal
    to the plain transform on 256 columns, then each timed on the device
    alone (CUDA-event median of 5 windows); one JSON line."""
    dev = require_cuda()
    q = nt.ntt_primes(2 * n, 30, 1)[0]
    plan = ntt.ntt_plan(n, q)
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randint(0, q, (n, batch), generator=g, device=dev, dtype=torch.int32)
    got = mxu_ntt(x, plan, P)
    if not torch.equal(got[:, :256], ntt_cm_ref(x[:, :256].cpu(), plan).to(dev)):
        raise AssertionError(f"mxu_ntt != the plain NTT at n={n}, P={P}")
    t_mxu = time_ms(lambda: mxu_ntt(x, plan, P), 10, device_only=True)[0]
    t_ntt = time_ms(lambda: ntt_cm(x, plan), 10, device_only=True)[0]
    out = {"metric": f"forward NTT/s, n={n}, B={batch}, one 30-bit prime",
           "card": card_line(), "mxu_ntt_P": P, "mxu_ntt_ms": t_mxu, "ntt_cm_ms": t_ntt,
           "mxu_ntt_per_s": batch / t_mxu * 1e3, "ntt_cm_per_s": batch / t_ntt * 1e3}
    print(json.dumps(out), flush=True)
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--batch", type=int, default=8192)
    ap.add_argument("--P", type=int, default=64)
    ap.add_argument("--iters", type=int, default=ITERS)
    ap.add_argument("--rows", type=int, default=ROWS)
    ap.add_argument("--lanes", type=int, default=LANES)
    ap.add_argument("--grid", type=int, default=GRID)
    args = ap.parse_args()
    run(args.n, args.batch, args.P)
    rate = u32_ceiling(args.iters, args.rows, args.lanes, args.grid)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "u32_mul_add_per_s": rate}))


if __name__ == "__main__":
    main()
