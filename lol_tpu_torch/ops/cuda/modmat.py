"""Exact modular matrix products through 8-bit limbs: `modmat_s8`.

Counterpart of the JAX package's MXU route, `matvec_mod_mxu`
(`lol_tpu/ops/general.py:116`) and `mxu_modmat_apply`
(`lol_tpu/bench/mxu_ntt.py:108`): XLA int8 `dot_general`s on the TPU, no
`pallas_call`.  For M (a, b) and residues x with x.shape[axis] == b, viewed
as (pre, b, post), `modmat_s8(M, x, q, axis)` computes M @ x along that axis
mod q; M may also be a (pre, a, b) stack, one matrix per leading index.

The algorithm (both versions): the reference centres its limbs to int8 for
the MXU; Hopper multiplies unsigned bytes, so the raw bytes X_j of x's
words (j < 4) are contracted against M's class tables,

    M x = sum_j (M 2^(8j) mod q) X_j = sum_{i < nl} 2^(8i) S_i  (mod q),
    S_i = A_i @ Xbytes,  A_i[r, 4c + j] = byte i of (M[r, c] 2^(8j) mod q),

nl = ceil(bitlength(q - 1) / 8) (`_prepare`'s `words`: A_i as (a, b) u32
words, byte j at bits 8j, the layout of x).  `class_sums` gives the S_i,
`fold` sum_i S_i 2^(8i) mod q.  Each S_i is at most 4 b 255^2 < 2^31 for
b <= 8256, so int32 accumulation is exact; b > 4096 is refused on both
paths, as the reference refuses it.

For a CUDA tensor `modmat_s8` launches the hand-written Hopper kernel of
`csrc/modmat.cu` (`mma.sync` m16n8k32 u8 tensor-core products, one launch
a call) on the int32 (pre, b, post) view and raises on any build or launch
error; M's tables are made on the host, once per read-only matrix and
device (`prepare`), the kernel reading them in its fragment order
(`_fragments`).  For a CPU tensor, and only then, it runs the plain torch
version `modmat_ref`, which contracts the same tables exactly in int64.

`modmat_small(M, x, q, axis)` computes the same product for the short
axes below `ops.general.MXU_MIN_AXIS` (the reference's `matvec_mod_jnp`
route there: XLA's broadcast `mul_mod` and mod-sum tree, no
`pallas_call`).  For a CUDA tensor it launches the hand-written kernel of
`csrc/modmat_small.cu` (u64 sums of at most 15 products, a 64-bit Barrett
reduction, one launch a call, a new int32 output) on the int32
(pre, b, post) view and raises on any build or launch error; M and its
Barrett constant are a device table made once per read-only matrix and
device (`small_table`).  For a CPU tensor, and only then, it runs the
plain int64 torch version `modmat_small_ref`, reduced every seven terms.
Both tag the innermost open `trace` span with the route that ran
("modmat_small" or "int64").
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass

import numpy as np
import torch

from ... import trace, zq
from . import build

# One per kernel launch.  Reset by callers that check which kernels a path ran.
LAUNCHES = {"modmat_s8": 0, "modmat_small": 0}
MAX_B = 4096  # the reference's refusal (lol_tpu/ops/general.py:130-133)
ROW_TILE, K_ROWS = 16, 8  # the instruction's m, and the rows of x in its k of 32 bytes


def limbs_needed(q: int) -> int:
    """8-bit limbs of a residue below q."""
    return ((q - 1).bit_length() + 7) // 8


def _as_u32(M) -> np.ndarray:
    if isinstance(M, torch.Tensor):
        M = M.cpu().numpy()
    return np.asarray(M).astype(np.int64).astype(np.uint32)


def _view(M_shape, x: torch.Tensor, axis: int, what: str):
    """x as (pre, b, post), and the result's shape."""
    axis %= x.dim()
    a, b = M_shape[-2:]
    if x.shape[axis] != b:
        raise ValueError(f"{what}: axis of length {x.shape[axis]}, matrix {a}x{b}")
    if b > MAX_B:
        raise ValueError(f"{what}: b = {b} > {MAX_B}, past the int32-exact range")
    pre, post = math.prod(x.shape[:axis]), math.prod(x.shape[axis + 1:])
    if len(M_shape) == 3 and M_shape[0] != pre:
        raise ValueError(f"{what}: a stack of {M_shape[0]} matrices over {pre} leading rows")
    return x.reshape(pre, b, post), (*x.shape[:axis], a, *x.shape[axis + 1:])


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------


_DOT_ELEMS = 1 << 25  # int64 products a step of `_int_dot` holds at once


def _int_dot(A: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """(G', a, b) @ (G, b, N) int64, exact (torch has no int64 matmul on
    the card): broadcast products over as many columns of A at a time as
    keep a step below _DOT_ELEMS elements, summed."""
    G, b, N = X.shape
    a = A.shape[-2]
    step = max(1, min(b, _DOT_ELEMS // (G * a * N)))
    out = None
    for j in range(0, b, step):
        t = (A[..., :, j:j + step, None] * X[..., None, j:j + step, :]).sum(-2)
        out = t if out is None else out + t
    return out


def _bytes(w: torch.Tensor, axis: int) -> torch.Tensor:
    """The 4 bytes of the u32 words w (int64) along a new axis after
    `axis`, merged into it: index 4 c + j holds byte j of word c."""
    shift = 8 * torch.arange(4, device=w.device).view(4, *[1] * (w.dim() - axis - 1))
    out = (w.unsqueeze(axis + 1) >> shift) & 0xFF
    return out.flatten(axis, axis + 1)


def class_sums(M, x3: torch.Tensor, q: int) -> list[torch.Tensor]:
    """The class sums S_i, i < nl, of M (a, b) or (G, a, b) against residues
    x3 (G, b, N), as the kernel forms them: (G, a, N) int64 each, S_i =
    A_i @ Xbytes over `_prepare`'s tables, contracted exactly."""
    prep = prepare(M, q, x3.device)
    Gm, nl, a, b = prep.words.shape
    A = _bytes(prep.words, 3).view(Gm, nl * a, 4 * b)
    X = _bytes(x3.long() & 0xFFFFFFFF, 1)
    S = _int_dot(A, X)
    return list(S.view(S.shape[0], nl, a, -1).unbind(1))


def fold(S: list[torch.Tensor], q: int) -> torch.Tensor:
    """sum_i S_i 2^(8i) mod q, int32."""
    res = 0
    for i, Si in enumerate(S):
        res = (res + Si % q * pow(2, 8 * i, q)) % q
    return res.to(torch.int32)


def modmat_ref(M, x: torch.Tensor, q: int, axis: int = -1) -> torch.Tensor:
    """Plain torch version of `modmat_s8` (the same tables, exact int64
    products), int32 residues with a at `axis`."""
    x3, out_shape = _view(_as_u32(M).shape, x, axis, "modmat_ref")
    return fold(class_sums(M, x3, q), q).view(out_shape)


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------


@dataclass(frozen=True, eq=False)
class Prepared:
    """M's tables on one device, G' = 1 for one shared matrix: `words`
    (G', nl, a, b) int64, W_i[r, c] = sum_j (byte i of (M[r, c] 2^(8j) mod
    q)) 2^(8j), the u8 matrix A_i as u32 words; `frag`, the same words
    zero-padded to (16 RT, 8 KS) and laid out as the kernel's A fragments
    (`_fragments`)."""

    M: np.ndarray
    nl: int
    a: int
    words: torch.Tensor
    frag: torch.Tensor

    @property
    def shared(self) -> bool:
        return self.M.ndim == 2


def _fragments(words: np.ndarray) -> np.ndarray:
    """(G', nl, a, b) u32 words -> (G', RT, KS, nl, 32, 4) int32: for row
    tile rt, chunk ks (x's rows 8 ks to 8 ks + 7) and class i, lane
    4 gid + tig's A fragment of mma.m16n8k32, rows 16 rt + gid (+ 8) and
    words 8 ks + tig (+ 4): (W[gid, tig], W[gid + 8, tig], W[gid, tig + 4],
    W[gid + 8, tig + 4]), zero past a and b."""
    G, nl, a, b = words.shape
    RT, KS = -(-a // ROW_TILE), -(-b // K_ROWS)
    W = np.zeros((G, nl, RT * ROW_TILE, KS * K_ROWS), np.uint32)
    W[:, :, :a, :b] = words
    # row = 16 rt + 8 h + gid, column = 8 ks + 4 kh + tig -> (.., gid, tig, kh, h)
    W = W.reshape(G, nl, RT, 2, 8, KS, 2, 4).transpose(0, 2, 5, 1, 4, 7, 6, 3)
    return np.ascontiguousarray(W).reshape(G, RT, KS, nl, 32, 4).view(np.int32)


def _prepare(M: np.ndarray, q: int, device: torch.device) -> Prepared:
    Mu = (M[None] if M.ndim == 2 else M).astype(np.int64)
    if Mu.size and int(Mu.max()) >= q:
        raise ValueError("modmat_s8: matrix entries must be residues below q")
    nl = limbs_needed(q)
    c = [(Mu << (8 * j)) % q for j in range(4)]  # M 2^(8j) mod q < 2^30
    words = np.stack([sum(((c[j] >> (8 * i)) & 0xFF) << (8 * j) for j in range(4))
                      for i in range(nl)], 1)
    return Prepared(M, nl, Mu.shape[1], torch.from_numpy(words).to(device),
                    torch.from_numpy(_fragments(words.astype(np.uint32))).to(device))


_ONCE: dict = {}


def once_per_matrix(M, tag, make):
    """make(), kept for a read-only numpy matrix M (the plans' and
    `stage_matrices`' are) under its identity and tag; made anew for any
    other M."""
    if not isinstance(M, np.ndarray) or M.flags.writeable:
        return make()
    key = (id(M), tag)
    hit = _ONCE.get(key)
    if hit is None or hit[0] is not M:
        hit = _ONCE[key] = (M, make())
    return hit[1]


def prepare(M, q: int, device) -> Prepared:
    """M's kernel tables on `device` (`once_per_matrix`)."""
    dev = torch.device(device)
    return once_per_matrix(M, ("modmat", q, dev), lambda: _prepare(_as_u32(M), q, dev))


def _lib() -> ctypes.CDLL:
    lib = build.load()
    if lib.lol_modmat_s8.argtypes is None:
        lib.lol_modmat_s8.argtypes = (
            [ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_void_p] * 2
            + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 3 + [ctypes.c_uint32, ctypes.c_void_p])
        lib.lol_modmat_s8.restype = ctypes.c_int
    return lib


def modmat_s8(M, x: torch.Tensor, q: int, axis: int = -1) -> torch.Tensor:
    """M @ x along `axis` mod q for residues x (int32 or int64) with
    x.shape[axis] == b and M (a, b), or a (pre, a, b) stack over x's
    (pre, b, post) view; int32 residues with a at `axis`."""
    q = int(q)
    if not (2 <= q < (1 << zq.MAX_MODULUS_BITS)):
        raise ValueError(f"modmat_s8: modulus {q} out of range [2, 2^30)")
    if x.device.type == "cpu":
        return modmat_ref(M, x, q, axis)
    if x.device.type != "cuda":
        raise ValueError(f"modmat_s8: unsupported device {x.device}")
    prep = prepare(M, q, x.device)
    x3, out_shape = _view(prep.M.shape, x, axis, "modmat_s8")
    x3 = x3.to(torch.int32).contiguous()
    G, b, N = x3.shape
    y = torch.empty((G, prep.a, N), dtype=torch.int32, device=x.device)
    if y.numel() == 0:
        return y.view(out_shape)
    with torch.cuda.device(x.device):
        err = _lib().lol_modmat_s8(
            prep.frag.data_ptr(), 0 if prep.shared else prep.frag[0].numel(), x3.data_ptr(),
            y.data_ptr(), G, N, prep.a, b, prep.nl, q,
            torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, f"modmat_s8 ((G, a, b, N) = ({G}, {prep.a}, {b}, {N}), q={q})")
    LAUNCHES["modmat_s8"] += 1
    return y.view(out_shape)


# ---------------------------------------------------------------------------
# the short axes: modmat_small
# ---------------------------------------------------------------------------

# products of two residues are below 2^60, so seven of them and a residue
# sum below 2^63: the int64 version reduces once per seven terms
_TERMS_PER_REDUCE = 7
SMALL_TERMS = 15  # the kernel's u64 sums: fifteen products and a residue below 2^64


def _int64_columns(M, device: torch.device) -> tuple[torch.Tensor, ...]:
    """M's columns as int64 (1, a, 1) views on `device`; a read-only numpy
    matrix's (the plans') are made there once."""
    a, b = M.shape

    def make():
        Mt = (M.to(device, torch.int64) if isinstance(M, torch.Tensor)
              else torch.from_numpy(np.asarray(M, dtype=np.int64)).to(device))
        return tuple(Mt[:, j].view(1, a, 1) for j in range(b))

    return once_per_matrix(M, ("int64 columns", device), make)


def modmat_small_ref(M, x: torch.Tensor, q: int, axis: int = -1) -> torch.Tensor:
    """Plain torch version of `modmat_small`: (a, b) @ x along `axis` mod q
    in int64, x viewed as (pre, b, post) with no data moved, accumulated
    over b in place and reduced every seven terms, from M's columns made
    once (`_int64_columns`).  int32 residues with a at `axis`."""
    a, b = M.shape
    cols = _int64_columns(M, x.device)
    axis = axis % x.dim()
    if x.shape[axis] != b:
        raise ValueError(f"modmat_small_ref: axis of length {x.shape[axis]}, matrix {a}x{b}")
    pre, post = math.prod(x.shape[:axis]), math.prod(x.shape[axis + 1:])
    xs = x.reshape(pre, b, post).long().split(1, 1)
    acc = None
    for j0 in range(0, b, _TERMS_PER_REDUCE):
        s = acc
        for j in range(j0, min(b, j0 + _TERMS_PER_REDUCE)):
            t = cols[j] * xs[j]
            s = t if s is None else s.add_(t)
        acc = s.remainder_(q)
    return acc.to(torch.int32).view(*x.shape[:axis], a, *x.shape[axis + 1:])


def small_words(M, q: int) -> np.ndarray:
    """The kernel's table as u32 words: q, mu = floor((2^64 - 1) / q) (low
    word, high word), 0, then M (a, b) row-major; M's entries must be
    residues below q."""
    Mu = _as_u32(M)
    if Mu.ndim != 2 or 0 in Mu.shape:
        raise ValueError(f"modmat_small: need one (a, b) matrix, got shape {Mu.shape}")
    if int(Mu.max()) >= q:
        raise ValueError("modmat_small: matrix entries must be residues below q")
    mu = ((1 << 64) - 1) // q
    head = np.array([q, mu & 0xFFFFFFFF, mu >> 32, 0], np.uint32)
    return np.concatenate([head, Mu.reshape(-1)])


def small_table(M, q: int, device) -> torch.Tensor:
    """`small_words` on `device` as int32 (`once_per_matrix`)."""
    dev = torch.device(device)
    return once_per_matrix(M, ("modmat_small", q, dev), lambda: torch.from_numpy(
        small_words(M, q).view(np.int32)).to(dev))


def _small_lib() -> ctypes.CDLL:
    lib = build.load()
    if lib.lol_modmat_small.argtypes is None:
        lib.lol_modmat_small.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 2
                                         + [ctypes.c_int] * 2 + [ctypes.c_void_p])
        lib.lol_modmat_small.restype = ctypes.c_int
    return lib


def modmat_small(M, x: torch.Tensor, q: int, axis: int = -1) -> torch.Tensor:
    """M (a, b) @ x along `axis` mod q for residues x (int32 or int64) in
    [0, q) with x.shape[axis] == b; a new int32 tensor of residues with a
    at `axis`, x not written.  The route of the short axes; any (a, b)
    runs (the kernel's fixed instances are the square axes below 16)."""
    q = int(q)
    if not (2 <= q < (1 << zq.MAX_MODULUS_BITS)):
        raise ValueError(f"modmat_small: modulus {q} out of range [2, 2^30)")
    if x.device.type == "cpu":
        trace.tag("int64")
        return modmat_small_ref(M, x, q, axis)
    if x.device.type != "cuda":
        raise ValueError(f"modmat_small: unsupported device {x.device}")
    a, b = M.shape
    axis %= x.dim()
    if x.shape[axis] != b:
        raise ValueError(f"modmat_small: axis of length {x.shape[axis]}, matrix {a}x{b}")
    trace.tag("modmat_small")
    table = small_table(M, q, x.device)
    pre, post = math.prod(x.shape[:axis]), math.prod(x.shape[axis + 1:])
    x3 = x.reshape(pre, b, post).to(torch.int32).contiguous()
    y = torch.empty((*x.shape[:axis], a, *x.shape[axis + 1:]), dtype=torch.int32,
                    device=x.device)
    if y.numel() == 0:
        return y
    with torch.cuda.device(x.device):
        err = _small_lib().lol_modmat_small(
            table.data_ptr(), x3.data_ptr(), y.data_ptr(), pre, post, a, b,
            torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, f"modmat_small ((pre, a, b, post) = ({pre}, {a}, {b}, {post}), q={q})")
    LAUNCHES["modmat_small"] += 1
    return y
