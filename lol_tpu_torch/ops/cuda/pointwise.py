"""Fused elementwise ring ops: the degree-2 ciphertext product of one channel.

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
"""

from __future__ import annotations

import ctypes

import torch

from ... import zq
from . import build

# One per kernel launch.  Reset by callers that check which kernels a path ran.
LAUNCHES = {"ct_mul": 0}

_ARGTYPES = (
    [ctypes.c_void_p] * 7 + [ctypes.c_longlong, ctypes.c_uint32, ctypes.c_uint32,
                             ctypes.c_int, ctypes.c_void_p]
)


def _lib() -> ctypes.CDLL:
    lib = build.load()
    if lib.lol_ct_mul.argtypes is None:
        lib.lol_ct_mul.argtypes = _ARGTYPES
        lib.lol_ct_mul.restype = ctypes.c_int
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
