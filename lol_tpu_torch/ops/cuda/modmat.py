"""Exact modular matrix products through int8 limbs: `modmat_s8`.

Counterpart of the JAX package's MXU route, `matvec_mod_mxu`
(`lol_tpu/ops/general.py:116`) and `mxu_modmat_apply`
(`lol_tpu/bench/mxu_ntt.py:108`): XLA int8 `dot_general`s on the TPU, no
`pallas_call`.  For M (a, b) and residues x with x.shape[axis] == b, viewed
as (pre, b, post), `modmat_s8(M, x, q, axis)` computes M @ x along that axis
mod q; M may also be a (pre, a, b) stack, one matrix per leading index.

The algorithm (both versions, and the reference's): residues below q < 2^30
split into nl = ceil(bitlength(q - 1) / 8) limbs of 8 bits, centred to int8
(limb - 128); each limb pair's product accumulated exactly; the centring
undone with the row sums of M's centred limbs and the column sums of x's raw
limbs; the pairs of each weight class k = i + j summed into S_k
(`class_sums`, kept observable); and sum_k S_k 2^(8k) folded mod q
(`fold`).  Each S_k lies in [0, 2^31) for b <= 4096, the reference's
range proof, so b > 4096 is refused on both paths.

For a CUDA tensor `modmat_s8` launches the hand-written Hopper kernel of
`csrc/modmat.cu` (`mma.sync` m16n8k32 int8 tensor-core products, one launch
a call) on the int32 (pre, b, post) view and raises on any build or launch
error; M's centred limb planes and row corrections are made on the host,
once per read-only matrix and device (`prepare`).  For a CPU tensor, and only then,
it runs the plain torch version `modmat_ref`.
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass

import numpy as np
import torch

from ... import zq
from . import build

# One per kernel launch.  Reset by callers that check which kernels a path ran.
LAUNCHES = {"modmat_s8": 0}
MAX_B = 4096  # int32-exact classes (lol_tpu/ops/general.py:130-133)
ROW_TILE, K_CHUNK = 16, 32  # the instruction's m and k: M is padded to them


def limbs_needed(q: int) -> int:
    """8-bit limbs of a residue below q."""
    return ((q - 1).bit_length() + 7) // 8


def _class_pairs(k: int, nl: int) -> range:
    """The limbs i of M whose pairs (i, k - i) make weight class k."""
    return range(max(0, k - nl + 1), min(nl, k + 1))


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


def class_sums(M, x3: torch.Tensor, q: int) -> list[torch.Tensor]:
    """The weight-class sums S_k, k < 2 nl - 1, of M (a, b) or (G, a, b)
    against residues x3 (G, b, N), as the kernel forms them: (G, a, N)
    int64 each, S_k = sum over i + j = k of (centred limb i of M) @
    (centred limb j of x3) + 128 (row sum of M's) + 128 (column sum of
    x3's raw limb j), which is the exact product of the raw limbs."""
    nl = limbs_needed(q)
    Mu = torch.from_numpy(_as_u32(M).astype(np.int64)).to(x3.device)
    if Mu.dim() == 2:
        Mu = Mu[None]
    X = x3.long() & 0xFFFFFFFF
    m_c = [((Mu >> (8 * i)) & 0xFF) - 128 for i in range(nl)]
    m_rowsum = [c.sum(-1, keepdim=True) for c in m_c]  # (G', a, 1)
    x_raw = [(X >> (8 * j)) & 0xFF for j in range(nl)]
    x_c = [r - 128 for r in x_raw]
    x_colsum = [r.sum(-2, keepdim=True) for r in x_raw]  # (G, 1, N), raw limbs
    S = [None] * (2 * nl - 1)
    for i in range(nl):
        for j in range(nl):
            p = _int_dot(m_c[i], x_c[j]) + 128 * x_colsum[j] + 128 * m_rowsum[i]
            S[i + j] = p if S[i + j] is None else S[i + j] + p
    return S


def fold(S: list[torch.Tensor], q: int) -> torch.Tensor:
    """sum_k S_k 2^(8k) mod q, int32."""
    res = 0
    for k, Sk in enumerate(S):
        res = (res + Sk % q * pow(2, 8 * k, q)) % q
    return res.to(torch.int32)


def modmat_ref(M, x: torch.Tensor, q: int, axis: int = -1) -> torch.Tensor:
    """Plain torch version of `modmat_s8` (exact int64 limb products), int32
    residues with a at `axis`."""
    x3, out_shape = _view(_as_u32(M).shape, x, axis, "modmat_ref")
    return fold(class_sums(M, x3, q), q).view(out_shape)


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------


@dataclass(frozen=True, eq=False)
class Prepared:
    """M's tables for the kernel on one device: centred limb planes
    (G', nl, a_pad, b_pad) int8, zero-padded, and the row corrections
    (G', 2 nl - 1, a_pad) int32, 128 x the centred row sums of each class's
    limbs of M; G' = 1 for one shared matrix."""

    M: np.ndarray
    nl: int
    a: int
    planes: torch.Tensor
    rowcorr: torch.Tensor
    w: tuple[int, ...]
    wsh: tuple[int, ...]

    @property
    def shared(self) -> bool:
        return self.M.ndim == 2


def _prepare(M: np.ndarray, q: int, device: torch.device) -> Prepared:
    Mu = M[None] if M.ndim == 2 else M
    if Mu.size and int(Mu.max()) >= q:
        raise ValueError("modmat_s8: matrix entries must be residues below q")
    G, a, b = Mu.shape
    nl = limbs_needed(q)
    a_pad, b_pad = -(-a // ROW_TILE) * ROW_TILE, -(-b // K_CHUNK) * K_CHUNK
    planes = np.zeros((G, nl, a_pad, b_pad), np.int8)
    rowcorr = np.zeros((G, 2 * nl - 1, a_pad), np.int64)
    limbs = [((Mu.astype(np.int64) >> (8 * i)) & 0xFF) - 128 for i in range(nl)]
    for i, c in enumerate(limbs):
        planes[:, i, :a, :b] = c
    for k in range(2 * nl - 1):
        rowcorr[:, k, :a] = 128 * sum(limbs[i].sum(-1) for i in _class_pairs(k, nl))
    w = tuple(pow(2, 8 * k, q) for k in range(2 * nl - 1))
    return Prepared(M, nl, a, torch.from_numpy(planes).to(device),
                    torch.from_numpy(rowcorr.astype(np.int32)).to(device), w,
                    tuple(zq.shoup(v, q) for v in w))


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
            [ctypes.c_void_p] * 2 + [ctypes.c_longlong] * 2 + [ctypes.c_void_p] * 2
            + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 5
            + [ctypes.c_uint32, ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_uint32),
               ctypes.c_void_p])
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
    nk = 2 * prep.nl - 1
    a_pad, b_pad = prep.planes.shape[-2:]
    w, wsh = (ctypes.c_uint32 * nk)(*prep.w), (ctypes.c_uint32 * nk)(*prep.wsh)
    with torch.cuda.device(x.device):
        err = _lib().lol_modmat_s8(
            prep.planes.data_ptr(), prep.rowcorr.data_ptr(),
            0 if prep.shared else prep.nl * a_pad * b_pad, 0 if prep.shared else nk * a_pad,
            x3.data_ptr(), y.data_ptr(), G, N, prep.a, b, a_pad, b_pad, prep.nl, q, w, wsh,
            torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, f"modmat_s8 ((G, a, b, N) = ({G}, {prep.a}, {b}, {N}), q={q})")
    LAUNCHES["modmat_s8"] += 1
    return y.view(out_shape)
