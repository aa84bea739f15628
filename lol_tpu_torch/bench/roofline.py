"""Per-kernel roofline table and profiler hook (counterpart of
`lol_tpu/bench/roofline.py`).

One row per op at (n, B) on the card: ms (CUDA-event median on the
device alone, `time_ms(device_only=True)`), achieved u32 Gop/s and GB/s,
the op's ops/byte, and, when ceilings are given, the share of each.  The ops: the three NTT kernels (forward, GS inverse,
route-B inverse), the fused `ct_mul`, and the plain torch `mul_mod` and
`add_mod` the reference also times.

The work counts are functions of (op, n, B) only, never of the port's
pass schedule, and `work` is the one place that states them:

- u32 ops: 9 per butterfly (k*n/2 butterflies per transform, k = log2 n)
  and 9 per modmul, as the reference counts them; 2 per modadd; ct_mul
  is 4 modmuls and 1 modadd per element.  Route B (`ntt_inv_dit`) also
  multiplies every word once by its scale n^-1 psi^-j, a Shoup product
  at 5 u32 ops as the reference counts one; GS folds its n^-1 into a
  stage and has none.  The twist between the two passes of a factoring
  is a cost of that factoring, not of the function (one pass over all n
  rows has none), so it is not counted.
- bytes: the least the op must move.  A transform reads and writes the
  int32 (n, B) array once, 8*n*B, whatever its number of passes; ct_mul
  reads four arrays and writes three, 28*n*B; modmul and modadd 12*n*B.
- the ring-sharded NTT over D shards (`ops/cuda/remote_ntt`): an
  exchange (`a2a`) moves every word once, 8*n*B bytes and no op; the
  fused phase-B passes of all D shards (`ntt_fwd_gather`,
  `ntt_inv_scatter`) read and write 8*n*B bytes for log2(n/D) of the
  transform's stages, 9*log2(n/D)*n/2*B u32 ops.
- the random draws (`ops/cuda/prng`) over n*B words, each written once,
  4*n*B bytes.  No u32 op count bounds them: a threefry2x32 hash is 20
  rounds of add, rotate and xor for 4 bytes, and what binds is the pipe
  its operations and the normal's float32 epilogue must issue on.  So
  their count is the operations a word needs, by pipe (`PRNG_NEEDS`, the
  function's, not any build's: one side of each of the normal's branches,
  weighted by the share of words that take it): "alu" (rotations, logic,
  compares and selects: 64 lanes a clock an SM), "add" (integer adds,
  which issue on the ALU as IADD3 or on the FMA pipe as IMAD), "imad"
  (integer multiplies, the FMA pipe's heavy half: 64), "fp32" (float
  FMA, add, multiply and conversion, on either half: 128, the issue rate),
  "xu" (MUFU and F2I: 16), and issue over all of them (4
  warp-instructions a clock an SM: 128 lanes).  `prng_slots` puts the
  adds where they balance the ALU and the FMA pipe and takes the busiest
  pipe or issue, in 64-lane slots a word, and says which binds.
  `prng_randint` is the one-hash body (every span above 2^16, the NTT
  primes), `prng_randint2` the two-hash one (spans up to 2^16),
  `prng_normal` the rounded normal.  `sass_diff.loop_mix` reads what a
  build issues for the same words; `chip_smoke.py` prints it beside the
  bound, which it does not change.

- the int8-limb modular matrix product (`ops/cuda/modmat.modmat_s8`,
  `modmat_work`): Y (G, a, N) = M @ X (G, b, N) mod q with nl 8-bit limbs
  does 2 a b N G nl^2 int8 tensor-core operations (a multiply and an add
  each, over the real b), and reads X and M and writes Y once:
  4 G N (a + b) + 4 a b bytes (M shared; G of them when stacked).
- the short-axis modular matrix product (`ops/cuda/modmat.modmat_small`,
  `modmat_small_work`): Y (pre, a, post) = M @ X (pre, b, post) mod q
  does per (p, c) column a b wide multiply-adds (2 u32 ops each) and a
  64-bit Barrett reduction an output (7: the high product's 4, q qhat,
  the subtraction, the conditional one), and reads X and writes Y once:
  4 pre post (a + b) bytes (M, a few hundred bytes, not counted).
- the key switch's hint inner products (`ops/cuda/pointwise.ks_inner_cm`,
  `ks_inner_work`) over nd digits and k (n, B) channels: per word two
  modmuls and two modadds a digit, and e0, e1 and the nd digit stacks
  read and e0, e1 written once, 4 (4 + nd) k n B bytes (the hint, read
  once a row, not counted: 16 nd k n bytes, under 0.2% at B = 1024).
- the exact rescale's epilogue (`ops/cuda/pointwise.rescale_out`,
  `rescale_out_work`) over k surviving (n, B) channels: per word two
  modmuls and a modsub, and the component and the forward transforms
  read and the result written once, 12 k n B bytes.

`bound` turns a count into the least time the H100 could take: the
larger of the bytes over the data sheet's 3.35 TB/s and the u32 ops
over the card's integer issue peak, 132 SMs x 64 IMAD per clock x the
1.98 GHz boost clock (16.7 T/s; the chain kernel measures ~93% of it);
the draws' slots at the same 64 lanes a clock; the int8 products at the
data sheet's dense int8 tensor-core rate, 1979 TOP/s (`INT8_OPS_PER_S`).

Ceilings are measured, not assumed: `chip_smoke.py` passes the chain
kernel's u32 (mul+add)/s (`mxu_ntt.u32_ceiling`, one op per IMAD) and the
bandwidth of a large device `copy_`, and builds the rows (`row`) from the
times its own kernel-vs-plain legs took, so no op is timed twice there.

Run on the card: python -m lol_tpu_torch.bench.roofline [--n 4096]
[--batch 8192] [--peak-gops G] [--peak-gbps G]
Profiler traces: `with trace("dir"): ...` writes dir/trace.json (Chrome
trace format; open it in Perfetto or chrome://tracing).
"""

from __future__ import annotations

import argparse
import contextlib
import math
import os

import torch

from .. import numtheory as nt, zq
from ..ops import ntt
from ..ops.cuda import ntt_kernel as tk, pointwise as pw
from . import require_cuda, time_ms

OPS = ("ntt_fwd", "ntt_inv_gs", "ntt_inv_dit", "ct_mul", "mul_mod", "add_mod")
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet
U32_OPS_PER_S = 132 * 64 * 1.98e9  # SMs x IMAD per clock per SM x boost clock
INT8_OPS_PER_S = 1979e12  # dense int8 tensor-core rate, NVIDIA's data sheet
# A word's operations by pipe, as the draw functions need them (see the
# module docstring).  The hash: 20 rotations (SHF.L.W) and 21 xors (LOP3),
# the 20 round adds, 2 key adds and 10 key-injection adds.  Barrett's w mod
# q: the high product and w - t q (2 IMAD), r - q and the unsigned min of r
# and r - q (1 add, 1 ALU).  The normal (rounded) adds to the hash: u from
# the word (1 ALU, 2 FP32), -u^2 (1), log1p's side chosen (1 ALU) and taken
# (the rational, 22 FP32 and the divide's reciprocal, where |u| < sqrt(sqrt(2)
# - 1); else the log, 19 FP32, 5 ALU, 1 add), erf_inv's polynomial chosen (1
# ALU) and taken (10 FP32; 14 and the root's MUFU where |u| >= sqrt(1 -
# e^-5)), the products by u, pre and scale (3) and the rounding (1 F2I).
_P_RATIONAL = math.sqrt(math.sqrt(2) - 1)  # share of words on log1p's rational side
_P_FAR = 1 - math.sqrt(1 - math.exp(-5))  # share on erf_inv's far polynomial
PRNG_NEEDS = {
    "prng_bits": {"alu": 41, "add": 32, "imad": 0, "fp32": 0, "xu": 0},
    "prng_randint": {"alu": 41 + 1, "add": 32 + 1, "imad": 2, "fp32": 0, "xu": 0},
    "prng_randint2": {"alu": 2 * 41 + 3, "add": 2 * 32 + 3, "imad": 3 * 2 + 1, "fp32": 0,
                      "xu": 0},
    "prng_normal": {"alu": 41 + 3 + 5 * (1 - _P_RATIONAL), "add": 32 + (1 - _P_RATIONAL),
                    "imad": 0,
                    "fp32": 6 + 22 * _P_RATIONAL + 19 * (1 - _P_RATIONAL) + 10 + 4 * _P_FAR,
                    "xu": 1 + _P_RATIONAL + _P_FAR},
}


def bound(ops: float, nbytes: float, ops_per_s: float = U32_OPS_PER_S) -> tuple[float, str]:
    """(least ms on the H100, "bytes" or "operations", whichever bounds);
    ops at ops_per_s (u32 ops by default, `INT8_OPS_PER_S` for int8)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def prng_slots(need: dict) -> tuple[float, str]:
    """(64-lane issue slots a word, the pipe that binds: "alu", "imad",
    "xu" or "issue") of a draw body's needs (`PRNG_NEEDS`), its adds split
    between the ALU and the FMA pipe where the busier of the two is least.
    The float ops issue at 128 lanes a clock, the issue rate, and so weigh
    on issue alone."""
    alu, add, imad, fp32, xu = (need[k] for k in ("alu", "add", "imad", "fp32", "xu"))
    on_alu = min(add, max(0, (imad + add - alu) / 2))
    slots = {"alu": alu + on_alu, "imad": imad + add - on_alu, "xu": 4 * xu,
             "issue": (alu + add + imad + fp32 + xu) / 2}
    pipe = max(slots, key=slots.get)
    return slots[pipe], pipe


def work(op: str, n: int, B: int, D: int = 1) -> tuple[float, int]:
    """(u32 ops, least bytes moved) of one call of `op` on (n, B) int32;
    D: the ring ops' shard count."""
    k = n.bit_length() - 1
    if op == "a2a":
        return 0, 8 * n * B
    if op in ("ntt_fwd_gather", "ntt_inv_scatter"):
        return 9 * (k - (D.bit_length() - 1)) * (n // 2) * B, 8 * n * B
    if op in ("ntt_fwd", "ntt_inv_gs"):
        return 9 * (k * n // 2) * B, 8 * n * B
    if op == "ntt_inv_dit":
        return (9 * (k * n // 2) + 5 * n) * B, 8 * n * B
    if op == "ct_mul":
        return (4 * 9 + 2) * n * B, 28 * n * B
    if op in PRNG_NEEDS:
        return prng_slots(PRNG_NEEDS[op])[0] * n * B, 4 * n * B
    if op == "mul_mod":
        return 9 * n * B, 12 * n * B
    if op == "add_mod":
        return 2 * n * B, 12 * n * B
    raise ValueError(f"roofline: unknown op {op!r}")


def modmat_work(G: int, a: int, b: int, N: int, q: int, shared: bool = True) -> tuple[int, int]:
    """(int8 tensor-core ops, least bytes moved) of one `modmat_s8` call:
    Y (G, a, N) = M @ X (G, b, N) mod q, M shared or one per g."""
    nl = ((q - 1).bit_length() + 7) // 8
    return 2 * a * b * N * G * nl * nl, 4 * G * N * (a + b) + 4 * a * b * (1 if shared else G)


def modmat_small_work(pre: int, a: int, b: int, post: int) -> tuple[int, int]:
    """(u32 ops, least bytes moved) of one `modmat_small` call:
    Y (pre, a, post) = M @ X (pre, b, post) mod q."""
    return (2 * a * b + 7 * a) * pre * post, 4 * pre * post * (a + b)


def ks_inner_work(nd: int, k: int, n: int, B: int) -> tuple[int, int]:
    """(u32 ops, least bytes moved) of one key switch's inner products:
    nd digits over k (n, B) channels."""
    words = k * n * B
    return 2 * nd * (9 + 2) * words, 4 * (4 + nd) * words


def rescale_out_work(k: int, n: int, B: int) -> tuple[int, int]:
    """(u32 ops, least bytes moved) of one rescale epilogue over k
    surviving (n, B) channels."""
    words = k * n * B
    return (2 * 9 + 2) * words, 12 * words


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler trace (host and device timelines) around a block,
    written to log_dir/trace.json."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        yield prof
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def calls(c0, c1, d0, d1, plan: ntt.NTTPlan) -> dict:
    """The zero-argument call of each op of OPS on (n, B) residues mod
    plan.q."""
    q = plan.q
    return {
        "ntt_fwd": lambda: tk.ntt_cm(c0, plan),
        "ntt_inv_gs": lambda: tk.ntt_cm(c0, plan, inverse=True),
        "ntt_inv_dit": lambda: tk.ntt_cm(c0, plan, inverse=True, alg="dit"),
        "ct_mul": lambda: pw.ct_mul_cm(c0, c1, d0, d1, q),
        "mul_mod": lambda: zq.mul_mod(c0, c1, q),
        "add_mod": lambda: zq.add_mod(c0, c1, q),
    }


def row(op: str, n: int, B: int, ms: float, peak_gops: float | None = None,
        peak_gbps: float | None = None) -> dict:
    """One table row from a measured ms per call of `op` on (n, B): op,
    ms, gops, gbps, ops_per_byte, and pct_ops / pct_bw when the ceilings
    are given."""
    ops, nbytes = work(op, n, B)
    r = {"op": op, "ms": ms, "gops": ops / ms / 1e6, "gbps": nbytes / ms / 1e6,
         "ops_per_byte": ops / nbytes}
    if peak_gops:
        r["pct_ops"] = 100 * r["gops"] / peak_gops
    if peak_gbps:
        r["pct_bw"] = 100 * r["gbps"] / peak_gbps
    return r


def show(rows: list[dict], title: str) -> None:
    """Print the rows as a table under `# roofline @ title`."""
    has_ops, has_bw = "pct_ops" in rows[0], "pct_bw" in rows[0]
    print(f"# roofline @ {title}")
    hdr = f"{'op':12} {'ms':>8} {'u32 Gop/s':>10} {'GB/s':>8} {'ops/byte':>9}"
    hdr += f" {'%ceil-ops':>10}" if has_ops else ""
    hdr += f" {'%ceil-bw':>9}" if has_bw else ""
    print(hdr)
    for r in rows:
        line = (f"{r['op']:12} {r['ms']:8.3f} {r['gops']:10.1f} {r['gbps']:8.1f} "
                f"{r['ops_per_byte']:9.2f}")
        line += f" {r['pct_ops']:9.1f}%" if has_ops else ""
        line += f" {r['pct_bw']:8.1f}%" if has_bw else ""
        print(line)


def run(n: int = 4096, batch: int = 8192, peak_gops: float | None = None,
        peak_gbps: float | None = None) -> list[dict]:
    """Time every op of OPS on the card and print the table; returns the
    rows (see `row`)."""
    dev = require_cuda()
    q = nt.ntt_primes(2 * n, 30, 1)[0]
    g = torch.Generator(device=dev).manual_seed(0)
    ops = calls(*(torch.randint(0, q, (n, batch), generator=g, device=dev,
                                dtype=torch.int32) for _ in range(4)), ntt.ntt_plan(n, q))
    rows = [row(op, n, batch, time_ms(ops[op], 20, device_only=True)[0], peak_gops, peak_gbps)
            for op in OPS]
    show(rows, f"{torch.cuda.get_device_name(0)}, n={n}, batch={batch}, q={q}")
    return rows


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--batch", type=int, default=8192)
    ap.add_argument("--peak-gops", type=float, default=None)
    ap.add_argument("--peak-gbps", type=float, default=None)
    args = ap.parse_args()
    run(args.n, args.batch, args.peak_gops, args.peak_gbps)


if __name__ == "__main__":
    main()
