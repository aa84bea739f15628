"""Fused elementwise ring ops: the degree-2 ciphertext product of one
channel, and the key switch's hint inner products.

Counterpart of `lol_tpu/ops/pallas/pointwise.py`.  `ct_mul_cm` keeps the
reference's signature and arithmetic; the reference's `128 | B`, `8 | n`
restriction is dropped (the kernel runs over the flat element count), and
`out=` lets a caller hand in the three result buffers (the BGV step writes
each channel straight into its (nrns, n, B) stacks).

For CUDA tensors `ct_mul_cm` launches the hand-written Hopper kernel of
`csrc/pointwise.cu` (replacing `_ct_mul_kernel`) and raises on any build
or launch error.  For CPU tensors, and only then, it runs the plain int64
torch version `ct_mul_cm_ref`.  Unlike the JAX step, the port's BGV step
calls it: eager PyTorch overlaps nothing, so the fused kernel replaces
the int64 glue that the plain Hadamards were (see PERF.md).

`ks_inner_cm` is the RNS-gadget key switch's inner products of every
digit with a constant hint (`ks_hint`: the hint and its Shoup
companions), which the reference leaves to XLA (`she_batched.py`'s
`_mulmod_sh_ch` chain); on the card one launch of `csrc/keyswitch.cu`
per `KS_MAX_DIGITS` digits, on the CPU its plain int64 version
`ks_inner_cm_ref`.  Every key switch of the port's batched pipeline
calls it (the step, the linear key switch, the Galois rotations, hoisted
or not, and the extended-modulus step and key switch, through
`she_batched.BatchedBGV._ks_inner`), except the ring tunnel, which keeps
its int64 torch products.  It tags the innermost open `trace` span with
the route that ran ("ks_inner" or "int64").

`rescale_out` is the exact BGV rescale's epilogue over the surviving
channels, (c_j q_l^-1 - nd_j p q_l^-1) mod q_j, which the reference also
leaves to XLA u32 ops (`she_batched.py`'s `_rescale_crt`); on the card
one launch of `csrc/rescale.cu` per `RESCALE_MAX_CHANNELS` channels, on
the CPU its plain int64 version `rescale_out_ref`.  It tags the
innermost open span likewise ("rescale_out" or "int64").
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ... import trace, zq
from . import build

# One per kernel launch.  Reset by callers that check which kernels a path ran.
LAUNCHES = {"ct_mul": 0, "ks_inner": 0, "rescale_out": 0}
KS_MAX_DIGITS = 8  # digits one ks_inner launch takes (csrc/keyswitch.cu)
RESCALE_MAX_CHANNELS = 16  # channels one rescale_out launch takes (csrc/rescale.cu)

_ARGTYPES = (
    [ctypes.c_void_p] * 7 + [ctypes.c_longlong, ctypes.c_uint32, ctypes.c_uint32,
                             ctypes.c_int, ctypes.c_void_p]
)


_KS_ARGTYPES = (
    [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong]
    + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
)


_RESCALE_ARGTYPES = (
    [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]
)


def _lib() -> ctypes.CDLL:
    lib = build.load()
    if lib.lol_ct_mul.argtypes is None:
        lib.lol_ct_mul.argtypes = _ARGTYPES
        lib.lol_ct_mul.restype = ctypes.c_int
        lib.lol_ks_inner.argtypes = _KS_ARGTYPES
        lib.lol_ks_inner.restype = ctypes.c_int
        lib.lol_rescale_out.argtypes = _RESCALE_ARGTYPES
        lib.lol_rescale_out.restype = ctypes.c_int
    return lib


def ct_mul_cm_ref(c0, c1, d0, d1, q: int):
    """Plain torch version of `ct_mul_cm` (int64 products), int32 out."""
    e0 = zq.mul_mod(c0, d0, q)
    e1 = zq.add_mod(zq.mul_mod(c0, d1, q), zq.mul_mod(c1, d0, q), q)
    e2 = zq.mul_mod(c1, d1, q)
    return tuple(e.to(torch.int32) for e in (e0, e1, e2))


def _check_args(ins, q, out):
    c0 = ins[0]
    for t in (*ins, *(out or ())):
        if t.dtype != torch.int32 or t.shape != c0.shape or t.device != c0.device:
            raise ValueError(
                f"ct_mul_cm: need int32 tensors of one shape on one device, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device} beside "
                f"{c0.dtype} {tuple(c0.shape)} on {c0.device}")
    if out is not None and len(out) != 3:
        raise ValueError("ct_mul_cm: out must hold three tensors")
    if c0.numel() < 1:
        raise ValueError("ct_mul_cm: empty operands")
    if not (2 <= q < (1 << zq.MAX_MODULUS_BITS)):
        raise ValueError(f"ct_mul_cm: modulus {q} out of range [2, 2^30)")


def ct_mul_cm(c0, c1, d0, d1, q: int, out=None):
    """(n, B) single-channel degree-2 ciphertext component convolution:
    -> (e0, e1, e2) = (c0 d0, c0 d1 + c1 d0, c1 d1) mod q, for int32
    residues in [0, q); one fused kernel (4 reads + 3 writes) on the card.
    out: optional three int32 tensors of the operands' shape to write."""
    ins = (c0, c1, d0, d1)
    q = int(q)
    _check_args(ins, q, out)
    if c0.device.type == "cpu":
        res = ct_mul_cm_ref(c0, c1, d0, d1, q)
        if out is None:
            return res
        for o, r in zip(out, res):
            o.copy_(r)
        return tuple(out)
    if c0.device.type != "cuda":
        raise ValueError(f"ct_mul_cm: unsupported device {c0.device}")
    if out is None:
        out = tuple(torch.empty_like(c0) for _ in range(3))
    if not all(t.is_contiguous() for t in (*ins, *out)):
        raise ValueError("ct_mul_cm: the CUDA kernel needs contiguous tensors")
    with torch.cuda.device(c0.device):
        err = _lib().lol_ct_mul(
            *(t.data_ptr() for t in (*ins, *out)), c0.numel(), q,
            zq.barrett_mu(q), q.bit_length(),
            torch.cuda.current_stream(c0.device).cuda_stream,
        )
    build.check(err, f"ct_mul (shape {tuple(c0.shape)}, q={q})")
    LAUNCHES["ct_mul"] += 1
    return tuple(out)


# --- the key switch's hint inner products ---------------------------------


def _signed32(x: torch.Tensor) -> torch.Tensor:
    """int64 u32 words -> the int32 tensor of the same bits."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def ks_hint(h0: torch.Tensor, h1: torch.Tensor, qs) -> torch.Tensor:
    """The key switch's constant hint as `ks_inner_cm` takes it: a
    (4, nrns, k, n) int32 tensor of the planes h0, floor(h0 2^32 / q_j),
    h1, floor(h1 2^32 / q_j) (u32 words, the Shoup companions), from the
    (nrns, k, n) residues h0 and h1 of k channels with the moduli qs, on
    their device."""
    if h0.shape != h1.shape or h0.dim() != 3 or h0.shape[1] != len(qs):
        raise ValueError(f"ks_hint: need two (nrns, k, n) hints over k = {len(qs)} "
                         f"channels, got {tuple(h0.shape)} and {tuple(h1.shape)}")
    qv = torch.tensor(list(qs), dtype=torch.int64, device=h0.device).view(1, -1, 1)
    h0, h1 = h0.long(), h1.long()
    return torch.stack([_signed32(p) for p in (h0, (h0 << 32) // qv, h1, (h1 << 32) // qv)])


def ks_inner_cm_ref(e0, e1, digits, hint, qs):
    """Plain torch version of `ks_inner_cm` (int64 products), int32 out:
    for each digit i in turn, e = (e + d_i h[i]) mod q."""
    qv = torch.tensor(list(qs), dtype=torch.int64, device=e0.device).view(-1, 1, 1)
    a0, a1 = e0.long(), 0 if e1 is None else e1.long()
    for i, d in enumerate(digits):
        d = d.long()
        a0 = (a0 + d * hint[0, i, ..., None].long()) % qv
        a1 = (a1 + d * hint[2, i, ..., None].long()) % qv
    return a0.to(torch.int32), a1.to(torch.int32)


def _check_ks_args(e0, e1, digits, hint, qs):
    if e0.dim() != 3:
        raise ValueError(f"ks_inner_cm: e0 must be a (k, n, B) stack, got {tuple(e0.shape)}")
    if len(digits) < 1:
        raise ValueError("ks_inner_cm: no digit stacks")
    for t in (e0, *(() if e1 is None else (e1,)), *digits):
        if t.dtype != torch.int32 or t.shape != e0.shape or t.device != e0.device:
            raise ValueError(
                f"ks_inner_cm: need int32 stacks of one shape on one device, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device} beside "
                f"{e0.dtype} {tuple(e0.shape)} on {e0.device}")
    k, n, _ = e0.shape
    want = (4, len(digits), k, n)
    if hint.dtype != torch.int32 or tuple(hint.shape) != want or hint.device != e0.device:
        raise ValueError(f"ks_inner_cm: need an int32 hint of shape {want} on {e0.device} "
                         f"(ks_hint), got {hint.dtype} {tuple(hint.shape)} on {hint.device}")
    if len(qs) != k:
        raise ValueError(f"ks_inner_cm: {len(qs)} moduli for {k} channels")
    if e0.numel() < 1:
        raise ValueError("ks_inner_cm: empty operands")
    for q in qs:
        if not (2 <= q < (1 << zq.MAX_MODULUS_BITS)):
            raise ValueError(f"ks_inner_cm: modulus {q} out of range [2, 2^30)")


@functools.lru_cache(maxsize=None)
def _moduli(qs: tuple[int, ...], device: torch.device) -> torch.Tensor:
    """The moduli as a (k,) int32 tensor on device, made once."""
    return torch.tensor(qs, dtype=torch.int32, device=device)


def ks_inner_cm(e0, e1, digits, hint, qs):
    """The key switch's hint inner products over k channels:
    (e0 + sum_i d_i h0[i], e1 + sum_i d_i h1[i]) mod q_j, for int32 (k, n, B)
    stacks e0, e1 and digits d_i with residues in [0, q_j) and the hint of
    `ks_hint` (4, len(digits), k, n).  e1 None stands for zeros.  Returns
    two new int32 stacks; the inputs are not written.  On the card one
    launch of `csrc/keyswitch.cu` per KS_MAX_DIGITS digits (later ones
    accumulate through the outputs), over contiguous copies of strided
    inputs."""
    qs = tuple(int(q) for q in qs)
    digits = tuple(digits)
    _check_ks_args(e0, e1, digits, hint, qs)
    if e0.device.type == "cpu":
        trace.tag("int64")
        return ks_inner_cm_ref(e0, e1, digits, hint, qs)
    if e0.device.type != "cuda":
        raise ValueError(f"ks_inner_cm: unsupported device {e0.device}")
    e0, hint = e0.contiguous(), hint.contiguous()  # copies only where a view is strided
    e1 = None if e1 is None else e1.contiguous()
    digits = tuple(d.contiguous() for d in digits)
    trace.tag("ks_inner")
    k, n, B = e0.shape
    o0, o1 = torch.empty_like(e0), torch.empty_like(e0)
    plane, words = hint[0].numel(), k * n
    with torch.cuda.device(e0.device):
        lib, stream = _lib(), torch.cuda.current_stream(e0.device).cuda_stream
        q_ptr = _moduli(qs, e0.device).data_ptr()
        a0, a1 = e0.data_ptr(), None if e1 is None else e1.data_ptr()
        for lo in range(0, len(digits), KS_MAX_DIGITS):
            chunk = digits[lo:lo + KS_MAX_DIGITS]
            ptrs = (ctypes.c_void_p * len(chunk))(*(d.data_ptr() for d in chunk))
            err = lib.lol_ks_inner(a0, a1, ptrs, len(chunk),
                                   hint.data_ptr() + 4 * lo * words, plane, q_ptr,
                                   o0.data_ptr(), o1.data_ptr(), k, n, B, stream)
            build.check(err, f"ks_inner (shape {tuple(e0.shape)}, digits {lo}.."
                             f"{lo + len(chunk) - 1} of {len(digits)})")
            LAUNCHES["ks_inner"] += 1
            a0, a1 = o0.data_ptr(), o1.data_ptr()
    return o0, o1


# --- the exact rescale's epilogue -------------------------------------------


def rescale_out_ref(comp, nd, qs, a, b):
    """Plain torch version of `rescale_out` (int64 products), int32 out."""
    k = len(qs)
    qv, av, bv = (torch.tensor(list(v), dtype=torch.int64, device=comp.device).view(-1, 1, 1)
                  for v in (qs, a, b))
    d = torch.stack([x.long() for x in nd])
    return ((comp[:k].long() * av - d * bv) % qv).to(torch.int32)


def _check_rescale_args(comp, nd, qs, a, b):
    k = len(qs)
    if comp.dim() != 3 or comp.dtype != torch.int32 or comp.shape[0] < k:
        raise ValueError(f"rescale_out: comp must be an int32 (>= {k}, n, B) stack, got "
                         f"{comp.dtype} {tuple(comp.shape)}")
    if k < 1 or len(nd) != k or len(a) != k or len(b) != k:
        raise ValueError(f"rescale_out: {len(nd)} transforms and {len(a)} / {len(b)} "
                         f"constants for {k} channels")
    for t in nd:
        if t.dtype != torch.int32 or t.shape != comp.shape[1:] or t.device != comp.device:
            raise ValueError(
                f"rescale_out: need int32 (n, B) transforms on {comp.device} of shape "
                f"{tuple(comp.shape[1:])}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    if comp[0].numel() < 1:
        raise ValueError("rescale_out: empty operands")
    for q, x, y in zip(qs, a, b):
        if not (2 <= q < (1 << zq.MAX_MODULUS_BITS)):
            raise ValueError(f"rescale_out: modulus {q} out of range [2, 2^30)")
        if not (0 <= x < q and 0 <= y < q):
            raise ValueError(f"rescale_out: constants {x}, {y} not residues mod {q}")


@functools.lru_cache(maxsize=None)
def _rescale_words(qs: tuple[int, ...], a: tuple[int, ...], b: tuple[int, ...]):
    """The kernel's 5 k constant words, rows (q, a, a_sh, b, b_sh), made once."""
    rows = (qs, a, [zq.shoup(x, q) for x, q in zip(a, qs)],
            b, [zq.shoup(y, q) for y, q in zip(b, qs)])
    words = [w for row in rows for w in row]
    return (ctypes.c_uint32 * len(words))(*words)


def rescale_out(comp, nd, qs, a, b):
    """The exact rescale's epilogue over k = len(qs) surviving channels:
    out_j = (comp_j a_j - nd_j b_j) mod q_j for the first k channels of
    the int32 (>= k, n, B) stack comp and the k int32 (n, B) forward
    transforms nd (residues in [0, q_j)), with constants a_j, b_j in
    [0, q_j).  Returns a new int32 (k, n, B) stack in [0, q_j); the inputs
    are not written.  On the card one launch of `csrc/rescale.cu` per
    RESCALE_MAX_CHANNELS channels, over contiguous copies of strided
    inputs, the transforms read by pointer (no stack)."""
    qs, a, b = (tuple(int(x) for x in v) for v in (qs, a, b))
    nd = tuple(nd)
    _check_rescale_args(comp, nd, qs, a, b)
    if comp.device.type == "cpu":
        trace.tag("int64")
        return rescale_out_ref(comp, nd, qs, a, b)
    if comp.device.type != "cuda":
        raise ValueError(f"rescale_out: unsupported device {comp.device}")
    k = len(qs)
    comp = comp[:k].contiguous()  # copies only where a view is strided
    nd = tuple(t.contiguous() for t in nd)
    trace.tag("rescale_out")
    out = torch.empty_like(comp)
    N = comp[0].numel()
    with torch.cuda.device(comp.device):
        lib, stream = _lib(), torch.cuda.current_stream(comp.device).cuda_stream
        for lo in range(0, k, RESCALE_MAX_CHANNELS):
            hi = min(k, lo + RESCALE_MAX_CHANNELS)
            ptrs = (ctypes.c_void_p * (hi - lo))(*(t.data_ptr() for t in nd[lo:hi]))
            err = lib.lol_rescale_out(comp[lo].data_ptr(), ptrs, out[lo].data_ptr(),
                                      _rescale_words(qs[lo:hi], a[lo:hi], b[lo:hi]),
                                      hi - lo, N, stream)
            build.check(err, f"rescale_out (shape {tuple(comp.shape)}, channels {lo}..{hi - 1})")
            LAUNCHES["rescale_out"] += 1
    return out
