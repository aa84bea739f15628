"""Fused negacyclic NTT over axis 0 of a coefficient-major (n, B) tensor.

Counterpart of `lol_tpu/ops/pallas/ntt_kernel.py`.  `ntt_cm` keeps the
contract of the Pallas `ntt_cm` (`ntt_kernel.py:899-971` there): the
input's n must match the plan, `pre_digit_q` is a forward-only prologue,
and `alg` picks the inverse's route, "gs" (Gentleman-Sande, the default
and the BGV step's) or "dit" (route B: DIT-bitrev-input DFTs with a
twist and a per-row n^-1 psi^-j scale, `ops/ntt.py`), with the
reference's checks.  The TPU-only knobs (lanes, window, radix,
full_tables, scale=False, interpret) have no counterpart here.

For a CUDA tensor `ntt_cm` launches the hand-written Hopper kernels of
`csrc/ntt.cu` (`ntt_fwd_pass`, replacing `_kernel_cross` + `_kernel_block`
forward; `ntt_inv_pass`, replacing them inverse; `ntt_invb_pass`,
replacing `_kernel_block_invb` + `_kernel_cross_invb`) and raises on any
build or launch error.  For a CPU tensor, and only then, it runs the
plain int64 torch version `ntt_cm_ref`.

Bound on the H100: every pass reads and writes the (n, B) array once,
8*n*B bytes; `schedule` keeps all stages of a pass on chip so there is
one such pass for n <= 4096 and two above (see the note at the top of
`csrc/ntt.cu`).  `ntt_cm` runs `cm_schedule`, which makes n = 8192 and
2^14 (the BGV step's ring) one pass over a cluster of CLUSTER[n] thread
blocks of 2048 rows each, which hold the column tile together; the ring's
phase B (`ops/cuda/remote_ntt.py`) runs it too, and route B at 2^14
(`dit_schedule`).  All three kernels run a pass's stages in register rounds of at
most MAX_ROUND stages (`rounds`), one template instance per (L, TB) in
KERNEL_TILES and per cluster pass.  Route B runs its passes in the GS
inverse's order: the block DFT and the twist (the scale when it is the
only pass), then the cross DFT and the scale.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from ... import zq
from ..ntt import NTTPlan, ntt_forward_cm, ntt_inverse_cm, ntt_inverse_dit_cm
from . import build

# Launch counts of the kernels, one per kernel launch (a pass of
# `cm_schedule` or `schedule`; a cluster pass is one launch); route B
# counts its block passes (`_kernel_block_invb`'s counterpart) and its cross passes
# (`_kernel_cross_invb`'s) apart.  Reset by callers that check which
# kernels a path ran.
LAUNCHES = {"ntt_fwd": 0, "ntt_inv": 0, "ntt_invb_block": 0, "ntt_invb_cross": 0}
ALGS = ("gs", "dit")

SINGLE_PASS_MAX_N = 4096  # whole (n, 8) column tile in 128 KiB of shared memory
SINGLE_TILE_ELEMS = 32768  # 128 KiB
WINDOW = 512  # tS: rows of one block-pass sequence when n > SINGLE_PASS_MAX_N
TILE_ELEMS = 16384  # 64 KiB per thread block in the two-pass schedule
MAX_TILE_ELEMS = 232448 // 4  # the H100's per-block shared memory limit
THREADS = 1024  # measured on the H100: ~23% faster than 512 at n = 4096
MIN_COLS = 8  # 8 u32 = one 32-byte sector per row segment
MAX_COLS = 32
MAX_ROUND = 4  # csrc/ntt_rounds.cuh: stages per register round (16-word units)
# n whose `ntt_cm` is one pass over a thread-block cluster: its CTAs, each
# holding (2048, MIN_COLS) of the column tile in shared memory (measured on
# the H100 against two passes; at n = 4096 a cluster of 2 lost to one CTA at
# B = 1024: PERF.md)
CLUSTER = {8192: 4, 16384: 8}
UNIT_WORDS = 16  # words per thread per round that fix a pass's threads
# the (L, TB) of every one-CTA pass-kernel instance (csrc/ntt_rounds.cuh
# `with_pass_tile`); L = 1 is the m = 2 ring's transform (no stages)
KERNEL_TILES = frozenset([(1 << k, 32) for k in range(0, 11)]
                         + [(1024, 16), (2048, 16), (2048, 8), (4096, 8)])


@dataclass(frozen=True)
class Pass:
    """One kernel launch's geometry (see csrc/ntt.cu)."""

    L: int
    nseq: int
    elem_stride: int
    seq_stride: int
    base0: int
    base_step: int
    G: int
    TB: int
    cluster: int = 1  # CTAs that share the tile (csrc/ntt.cu's cluster pass)


def rounds(L: int) -> list[int]:
    """The stages of each register round of a length-L pass of the pass
    kernels, in forward order (`Rounds` in csrc/ntt_rounds.cuh):
    ceil(log2 L / MAX_ROUND) rounds as even as possible, larger first; a
    length-1 pass is one round of no stages (its loads, the prologue, the
    inverse's n^-1 and the fold)."""
    k = L.bit_length() - 1
    N = max(1, -(-k // MAX_ROUND))
    return [k // N + (i < k % N) for i in range(N)]


def kernel_threads(p: Pass) -> int:
    """Threads of each CTA of a pass kernel: one per UNIT_WORDS
    words of its part of the tile, within [32, THREADS]."""
    words = p.L * p.G * p.TB // p.cluster
    if p.cluster > 1:  # 32 words a thread: two CTAs of the cluster share an SM
        words //= 2
    return min(THREADS, max(32, -(-(words // UNIT_WORDS) // 32) * 32))


def kernel_smem_bytes(p: Pass) -> int:
    """Dynamic shared memory of each CTA of a pass kernel (`Tile` in
    csrc/ntt_rounds.cuh): none for a one-round pass; else its [g][row][c]
    part of the tile (L / cluster rows), with one padding row every 2^t
    rows when TB < 32 (t: the last round's stages)."""
    plan = rounds(p.L)
    if len(plan) == 1:
        return 0
    rows = p.L // p.cluster
    rows += rows >> plan[-1] if p.TB < 32 else 0
    return 4 * p.G * rows * p.TB


def _cols(L: int, budget: int) -> int:
    return max(MIN_COLS, min(MAX_COLS, budget // L))


def cross_pass(L: int, nseq: int, base: int) -> Pass:
    """A pass of nseq length-L transforms whose elements lie nseq rows
    apart (sequence sq is rows sq, sq + nseq, ...), all on the twiddle
    base `base`: the cross pass below, and phase A of the ring-sharded
    transform (ops/cuda/remote_ntt.py)."""
    tb = _cols(L, TILE_ELEMS)
    G = max(1, min(nseq, TILE_ELEMS // (L * tb)))
    if L * tb * G > MAX_TILE_ELEMS:
        raise NotImplementedError(f"ntt_cm: a length-{L} cross pass exceeds the shared memory")
    return Pass(L, nseq, nseq, 1, base, 0, G, tb)


def cm_schedule(n: int, base: int = 1) -> list[Pass]:
    """The forward pass sequence of `ntt_cm` and of the ring's phase B
    (the inverse runs it reversed): one pass over a cluster of CLUSTER[n]
    CTAs, for the n that have one, else `schedule(n, base)`.  base: as
    `schedule`'s.  Route B takes it at 2^14 only (`dit_schedule`)."""
    if n in CLUSTER:
        return [Pass(n, 1, 1, 0, base, 0, 1, MIN_COLS, CLUSTER[n])]
    return schedule(n, base)


def schedule(n: int, base: int = 1) -> list[Pass]:
    """The forward pass sequence for length n (the inverse runs it
    reversed).  One pass up to SINGLE_PASS_MAX_N; above, the cross pass
    (first log2(n/WINDOW) stages, rows WINDOW apart) then the block pass
    (the rest, inside contiguous WINDOW-row blocks).  base: the network's
    twiddle base (`ops/ntt.dit_net_cm`): 1 for the transform, D + d for
    block d of a ring sharded over D."""
    if n <= SINGLE_PASS_MAX_N:
        return [Pass(n, 1, 1, 0, base, 0, 1, _cols(n, SINGLE_TILE_ELEMS))]
    tS = WINDOW
    P = n // tS
    block = Pass(tS, P, 1, tS, base * P, 1, 1, _cols(tS, TILE_ELEMS))
    return [cross_pass(P, tS, base), block]


_ARGTYPES = (
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 13 + [ctypes.c_uint32]
    + [ctypes.c_int] + [ctypes.c_uint32] * 8 + [ctypes.c_void_p]
)


_INVB_ARGTYPES = (
    [ctypes.c_void_p] * 6 + [ctypes.c_int] * 10 + [ctypes.c_uint32, ctypes.c_void_p]
)


def _lib() -> ctypes.CDLL:
    lib = build.load()
    if lib.lol_ntt_pass.argtypes is None:
        lib.lol_ntt_pass.argtypes = _ARGTYPES
        lib.lol_ntt_pass.restype = ctypes.c_int
        lib.lol_ntt_invb_pass.argtypes = _INVB_ARGTYPES
        lib.lol_ntt_invb_pass.restype = ctypes.c_int
    return lib


def dit_schedule(n: int) -> list[Pass]:
    """Route B's pass sequence in forward order (it runs it reversed):
    `cm_schedule` at n = 2^14 (one block DFT over all n rows, launched over
    an 8-CTA cluster), else `schedule`.  Measured on the H100 against
    `schedule`'s two passes, the 8-CTA pass won at 2^14 and the 4-CTA pass
    lost at 8192 (PERF.md), so csrc/ntt.cu builds no route-B 4-CTA pass."""
    return cm_schedule(n) if n == 16384 else schedule(n)


def _dit_block_rows(n: int) -> int:
    """tS of the route-B split: the rows of the block pass, so the plain
    version and the kernels factor n the same way."""
    return dit_schedule(n)[-1].L


def redigit(x: torch.Tensor, q_src: int, q: int) -> torch.Tensor:
    """RNS-gadget digit re-expansion (plain form of the kernel prologue,
    `_redigit` of the Pallas module): x holds residues in [0, q_src);
    returns the centered representative's residue mod q, in x's dtype.
    Identity when q_src == q."""
    if q_src == q:
        return x
    x64 = x.long()
    r = x64 % q if q_src > q else x64
    r = torch.where(x64 >= (q_src + 1) // 2, (r - q_src % q) % q, r)
    return r.to(x.dtype)


def ntt_cm_ref(x: torch.Tensor, plan: NTTPlan, inverse: bool = False,
               pre_digit_q: int | None = None, alg: str = "gs") -> torch.Tensor:
    """Plain torch version of `ntt_cm` (int64 stages), int32 out."""
    _check_alg(inverse, alg)
    if inverse and alg == "dit":
        return ntt_inverse_dit_cm(x, plan, _dit_block_rows(plan.n)).to(torch.int32)
    if inverse:
        return ntt_inverse_cm(x, plan).to(torch.int32)
    if pre_digit_q is not None:
        x = redigit(x, pre_digit_q, plan.q)
    return ntt_forward_cm(x, plan).to(torch.int32)


def _check_alg(inverse, alg):
    if alg not in ALGS:
        raise ValueError(f"ntt_cm: unknown alg {alg!r}")
    if alg == "dit" and not inverse:
        raise ValueError("ntt_cm: alg='dit' is an inverse-only route")


def _check_args(x, plan, inverse, pre_digit_q):
    if x.dim() != 2 or x.dtype != torch.int32:
        raise ValueError(f"ntt_cm: need an (n, B) int32 tensor, got {x.dtype} {tuple(x.shape)}")
    n, B = x.shape
    if n != plan.n:
        raise ValueError(f"ntt_cm: x has n={n}, plan has n={plan.n}")
    if B < 1:
        raise ValueError("ntt_cm: empty batch")
    if pre_digit_q is not None:
        if inverse:
            raise ValueError("ntt_cm: pre_digit_q is a forward-only prologue")
        if not (2 <= pre_digit_q < (1 << zq.MAX_MODULUS_BITS)):
            raise ValueError(f"ntt_cm: pre_digit_q={pre_digit_q} out of range")


def ntt_cm(x: torch.Tensor, plan: NTTPlan, inverse: bool = False,
           pre_digit_q: int | None = None, alg: str = "gs") -> torch.Tensor:
    """Negacyclic NTT over axis 0 of a coefficient-major (n, B) int32
    tensor of residues in [0, q).

    Forward: natural order in, bit-reversed-exponent order out.  Inverse:
    the reverse, 1/n applied once.  pre_digit_q: the input holds residues
    mod pre_digit_q, re-expanded (centered) into Z_q before the forward
    transform (`redigit`).  alg: the inverse's route, "gs" or "dit"
    (inverse only); both give the same result."""
    _check_args(x, plan, inverse, pre_digit_q)
    _check_alg(inverse, alg)
    if x.device.type == "cpu":
        return ntt_cm_ref(x, plan, inverse, pre_digit_q, alg)
    if x.device.type != "cuda":
        raise ValueError(f"ntt_cm: unsupported device {x.device}")
    if not x.is_contiguous():
        raise ValueError("ntt_cm: the CUDA kernel needs a contiguous (n, B) tensor")
    if inverse and alg == "dit":
        return _ntt_invb_cuda(x, plan)
    return _ntt_cuda(x, plan, inverse, pre_digit_q)


def _ntt_invb_cuda(x, plan):
    """Route B: the block pass (DFT_tS, then the twist; at tS = n the only
    pass, then the scale), then the cross pass (DFT_P, the scale and the
    fold), in place after the first.  At n = 1 every route is the identity
    on residues (the reference returns x): the length-1 pass of the GS
    inverse, one launch, gives it."""
    n = x.shape[0]
    if n == 1:
        return _ntt_cuda(x, plan, True, None)
    passes = dit_schedule(n)[::-1]
    tab = plan.dit_tables(_dit_block_rows(n), x.device)
    y = torch.empty_like(x)
    for i, (p, stage) in enumerate(zip(passes, ("blk", "cross"))):
        last = i == len(passes) - 1
        invb_pass(x if i == 0 else y, y, plan, p, tab, stage, "scale" if last else "twist", last)
    return y


def invb_pass(x: torch.Tensor, y: torch.Tensor, plan: NTTPlan, p: Pass, tab: dict,
              stage: str, post: str, last: bool) -> None:
    """Launch one route-B pass p (`ntt_invb_pass`) from the contiguous
    (n, B) CUDA tensor x into y (x itself allowed: each block owns its
    tile): the DIT-bitrev-input DFT on the packed stage table tab[stage]
    ("blk" or "cross" of `NTTPlan.dit_tables`), then the per-row
    multiplier tab[post] ("twist" or "scale").  Inputs below 4q; last:
    the output folded to [0, q), else it stays in [0, 2q)."""
    n, B = x.shape
    with torch.cuda.device(x.device):
        err = _lib().lol_ntt_invb_pass(
            x.data_ptr(), y.data_ptr(), tab[stage].data_ptr(), tab[stage + "_sh"].data_ptr(),
            tab[post].data_ptr(), tab[post + "_sh"].data_ptr(), B, p.L, p.nseq,
            p.elem_stride, p.seq_stride, p.G, p.TB, kernel_threads(p),
            p.cluster.bit_length() - 1, int(last), plan.q,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    build.check(err, f"ntt_invb {stage} pass (n={n}, B={B}, L={p.L})")
    LAUNCHES["ntt_invb_cross" if stage == "cross" else "ntt_invb_block"] += 1


def _ntt_cuda(x, plan, inverse, pre_q):
    passes = cm_schedule(x.shape[0])
    return run_passes(x, plan, passes[::-1] if inverse else passes, inverse,
                      pre_q=pre_q)


def scale_consts(plan: NTTPlan) -> tuple[int, int, int, int]:
    """(n^-1, its Shoup word, ipsi_rev[1]*n^-1, its Shoup word): the GS
    inverse's global stage 0 with the 1/n scale folded in."""
    q = plan.q
    w0n = int(plan.ipsi_rev[1 % plan.n]) * plan.n_inv % q
    return plan.n_inv, plan.n_inv_sh, w0n, zq.shoup(w0n, q)


def run_passes(x: torch.Tensor, plan: NTTPlan, passes: list[Pass], inverse: bool,
               last: bool = True, out: torch.Tensor | None = None,
               pre_q: int | None = None) -> torch.Tensor:
    """Launch `passes` (forward or GS inverse kernels) over the contiguous
    (rows, B) CUDA tensor x: the first from x into `out` (a new tensor, or
    x itself), the rest in place there (each block owns its tile).  last:
    the final pass folds to [0, q), and an inverse one also scales its
    local stage 0 by n^-1, so it must hold global stage 0; otherwise the
    output stays lazy (forward [0, 4q), inverse [0, 2q)).  pre_q: the
    forward digit prologue on the first pass."""
    lib = _lib()
    B = x.shape[1]
    q = plan.q
    w, wsh, iw, iwsh = plan.tables(x.device)
    tw, twsh = (iw, iwsh) if inverse else (w, wsh)
    has_pre = pre_q is not None and pre_q != q
    pre_q = pre_q if has_pre else q
    name = "ntt_inv" if inverse else "ntt_fwd"
    y = torch.empty_like(x) if out is None else out
    stream = torch.cuda.current_stream(x.device).cuda_stream
    src = x
    with torch.cuda.device(x.device):
        for i, p in enumerate(passes):
            fold = last and i == len(passes) - 1
            err = lib.lol_ntt_pass(
                src.data_ptr(), y.data_ptr(), tw.data_ptr(), twsh.data_ptr(),
                B, p.L, p.nseq, p.elem_stride, p.seq_stride, p.base0,
                p.base_step, p.G, p.TB, kernel_threads(p), p.cluster.bit_length() - 1,
                int(inverse), int(fold), q,
                int(has_pre and i == 0), pre_q, (pre_q + 1) // 2, pre_q % q,
                zq.shoup(1, q), *scale_consts(plan), stream,
            )
            build.check(err, f"{name} pass {i} (rows={x.shape[0]}, B={B}, L={p.L})")
            LAUNCHES[name] += 1
            src = y  # later passes run in place: each block owns its tile
    return y
