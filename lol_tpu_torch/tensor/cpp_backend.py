"""ctypes bindings for the native C++ tensor kernels (lol-cpp's role).

Counterpart of `lol_tpu/tensor/cpp_backend.py`, over torch CPU tensors:
residues are int32 holding the u32 bits, the norms float64.  The port's
own copy of the source, `native/tensor.cpp`, is built with
`g++ -O3 -shared -fPIC` at first use into
`lol_tpu_torch/_build/<hash of the source>/liblol_tensor.so` (never
beside the source), under the same file lock as the CUDA build.  Same
networks and twiddle tables as the plain torch versions and the kernels,
so the results are bit-identical.  A host backend: a CUDA tensor is
refused, not copied.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from functools import lru_cache
from pathlib import Path

import numpy as np
import torch

from .. import numtheory as nt
from ..factored import fact
from ..ops import general as gen
from ..ops.cuda import build
from ..ops.ntt import NTTPlan

_SRC = Path(__file__).resolve().parents[1] / "native" / "tensor.cpp"
GXX_FLAGS = ("-O3", "-shared", "-fPIC")

_p, _l, _u = ctypes.c_void_p, ctypes.c_long, ctypes.c_uint32
_SIGS = {
    "zq_mul": [_p, _p, _p, _l, _u],
    "zq_add": [_p, _p, _p, _l, _u],
    "zq_sub": [_p, _p, _p, _l, _u],
    "ntt_fwd": [_p, _l, _l, _u, _p],
    "ntt_inv": [_p, _l, _l, _u, _p, _u],
    "axis_matvec": [_p, _p, _p, _l, _l, _u],
    "l_fwd": [_p, _l, _l, _l, _u],
    "l_inv": [_p, _l, _l, _l, _u],
    "mul_g_pow": [_p, _p, _l, _l, _l, _u],
    "div_g_pow": [_p, _p, _l, _l, _l, _u, _u],
    "gather_idx": [_p, _p, _l, _l, _p, _l],
    "scatter_idx": [_p, _p, _l, _l, _p, _l],
    "strided_sum": [_p, _p, _l, _l, _l, _u],
    "gsq_norm_pow2": [_p, _p, _l, _l, _u],
    "gsq_norm_gram": [_p, _p, _p, _l, _l],
}


def library_path() -> Path:
    h = hashlib.sha256(_SRC.read_bytes() + " ".join(GXX_FLAGS).encode())
    return build.BUILD_ROOT / h.hexdigest()[:16] / "liblol_tensor.so"


def _compile(lib: Path) -> None:
    with tempfile.TemporaryDirectory(dir=lib.parent) as tmp:
        out = f"{tmp}/lib.so"
        proc = subprocess.run(["g++", *GXX_FLAGS, "-o", out, str(_SRC)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed:\n{proc.stdout}{proc.stderr}")
        os.replace(out, lib)  # atomic: a concurrent process never sees a partial file


@lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build.locked_build(library_path(), _compile)))
    for name, args in _SIGS.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = None
    return lib


def _ptr(a: torch.Tensor) -> int:
    return a.data_ptr()


def _c(a) -> torch.Tensor:
    """a as a contiguous int32 CPU tensor of u32 words (a copy where it is
    not one already); a CUDA tensor is refused."""
    if isinstance(a, np.ndarray) and not a.flags.writeable:
        a = a.copy()  # torch takes no read-only buffer
    t = torch.as_tensor(a)
    if t.device.type != "cpu":
        raise ValueError(f"cpp_backend: a host backend, got a tensor on {t.device}; "
                         f"copy it to the CPU first")
    if t.dtype != torch.int32:
        t = (t.long() & 0xFFFFFFFF).to(torch.int32)
    return t.contiguous()


def zq_mul(a, b, q: int) -> torch.Tensor:
    a, b = _c(a), _c(b)
    out = torch.empty_like(a)
    _lib().zq_mul(_ptr(a), _ptr(b), _ptr(out), a.numel(), q)
    return out


def zq_add(a, b, q: int) -> torch.Tensor:
    a, b = _c(a), _c(b)
    out = torch.empty_like(a)
    _lib().zq_add(_ptr(a), _ptr(b), _ptr(out), a.numel(), q)
    return out


def ntt_forward(x, plan: NTTPlan) -> torch.Tensor:
    """(..., n) forward negacyclic NTT, in the plan's canonical order."""
    x = _c(x).clone()
    tw = _c(torch.from_numpy(plan.psi_rev.astype(np.int64)))
    _lib().ntt_fwd(_ptr(x), x.numel() // plan.n, plan.n, plan.q, _ptr(tw))
    return x


def ntt_inverse(x, plan: NTTPlan) -> torch.Tensor:
    x = _c(x).clone()
    tw = _c(torch.from_numpy(plan.ipsi_rev.astype(np.int64)))
    _lib().ntt_inv(_ptr(x), x.numel() // plan.n, plan.n, plan.q, _ptr(tw), plan.n_inv)
    return x


def axis_matvec(M, x, q: int) -> torch.Tensor:
    """out[..., i] = sum_j M[i, j] x[..., j] mod q (a dense odd-prime axis)."""
    M, x = _c(M), _c(x)
    out = torch.empty_like(x)
    phi = M.shape[0]
    _lib().axis_matvec(_ptr(M), _ptr(x), _ptr(out), x.numel() // phi, phi, q)
    return out


def l_fwd(x, p: int, inner: int, q: int) -> torch.Tensor:
    x = _c(x).clone()
    _lib().l_fwd(_ptr(x), x.numel() // ((p - 1) * inner), p, inner, q)
    return x


def l_inv(x, p: int, inner: int, q: int) -> torch.Tensor:
    x = _c(x).clone()
    _lib().l_inv(_ptr(x), x.numel() // ((p - 1) * inner), p, inner, q)
    return x


def mul_g_pow(x, p: int, inner: int, q: int) -> torch.Tensor:
    x = _c(x)
    out = torch.empty_like(x)
    _lib().mul_g_pow(_ptr(x), _ptr(out), x.numel() // ((p - 1) * inner), p, inner, q)
    return out


def div_g_pow(x, p: int, inner: int, q: int) -> torch.Tensor:
    """Exact /g along an odd-prime axis in the powerful basis (g.cpp divGPow)."""
    x = _c(x)
    out = torch.empty_like(x)
    _lib().div_g_pow(_ptr(x), _ptr(out), x.numel() // ((p - 1) * inner), p, inner, q,
                     nt.modinv(p % q, q))
    return out


def mul_g_dec(x, p: int, inner: int, q: int) -> torch.Tensor:
    """Times g in the decoding basis: the L-conjugated stencil L^-1 G L."""
    return l_inv(mul_g_pow(l_fwd(x, p, inner, q), p, inner, q), p, inner, q)


def div_g_dec(x, p: int, inner: int, q: int) -> torch.Tensor:
    """Exact /g in the decoding basis (g.cpp divGDec)."""
    return l_inv(div_g_pow(l_fwd(x, p, inner, q), p, inner, q), p, inner, q)


def _i64tbl(tbl) -> torch.Tensor:
    return torch.from_numpy(np.array(tbl, dtype=np.int64))  # a copy: the tables are read-only


def _tblptr(tbl: torch.Tensor) -> int:
    return tbl.data_ptr()


def _gather(x: torch.Tensor, tbl: torch.Tensor, n_in: int) -> torch.Tensor:
    """out[b, i] = x[b, tbl[i]] over the (-1, n_in) rows of x."""
    flat = x.reshape(-1, n_in)
    out = torch.empty((flat.shape[0], tbl.numel()), dtype=torch.int32)
    _lib().gather_idx(_ptr(flat), _ptr(out), flat.shape[0], tbl.numel(), _tblptr(tbl), n_in)
    return out


def twace_pow(x, m_sub: int, m_sup: int, q: int) -> torch.Tensor:
    """Tweaked trace in the powerful / decoding basis: a coordinate gather."""
    x = _c(x)
    tbl = _i64tbl(gen.embed_pow_table(m_sub, m_sup))
    return _gather(x, tbl, x.shape[-1]).reshape(*x.shape[:-1], tbl.numel())


def embed_pow(x, m_sub: int, m_sup: int, q: int) -> torch.Tensor:
    """The embedding R_m' -> R_m in the powerful basis: a coordinate scatter."""
    x = _c(x)
    tbl = _i64tbl(gen.embed_pow_table(m_sub, m_sup))
    n_in, n_out = x.shape[-1], fact(m_sup).phi
    flat = x.reshape(-1, n_in)
    out = torch.empty((flat.shape[0], n_out), dtype=torch.int32)
    _lib().scatter_idx(_ptr(flat), _ptr(out), flat.shape[0], n_in, _tblptr(tbl), n_out)
    return out.reshape(*x.shape[:-1], n_out)


def embed_crt(x, m_sub: int, m_sup: int, q: int) -> torch.Tensor:
    """The CRT-basis embedding: a slot-replicating gather."""
    x = _c(x)
    tbl = _i64tbl(gen.crt_embed_table(m_sub, m_sup, q))
    return _gather(x, tbl, x.shape[-1]).reshape(*x.shape[:-1], tbl.numel())


def twace_crt(x, m_sub: int, m_sup: int, q: int) -> torch.Tensor:
    """The CRT-basis tweaked trace: twist, coset sum, untwist, over the
    tables of `ops.general.twace_crt`."""
    x = _c(x)
    n_sub, n_sup = fact(m_sub).phi, fact(m_sup).phi
    pre, post = (torch.from_numpy(t.astype(np.int64)) for t in gen.twace_crt_twists(m_sub, m_sup, q))
    flat = x.reshape(-1, n_sup)
    y = zq_mul(flat, pre.expand(flat.shape), q)
    order = _i64tbl(np.argsort(gen.crt_embed_table(m_sub, m_sup, q), kind="stable"))
    g = _gather(y, order, n_sup)
    s = torch.empty((flat.shape[0], n_sub), dtype=torch.int32)
    _lib().strided_sum(_ptr(g), _ptr(s), flat.shape[0], n_sub, n_sup // n_sub, q)
    return zq_mul(s, post.expand(s.shape), q).reshape(*x.shape[:-1], n_sub)


def coeffs_rel(x, m_sub: int, m_sup: int) -> torch.Tensor:
    """The relative coefficients: a (d, ..., n_sub) gather stack."""
    x = _c(x)
    tbl = gen.rel_coeff_table(m_sub, m_sup)
    d, n_sub = tbl.shape
    out = _gather(x, _i64tbl(tbl.reshape(-1)), x.shape[-1])
    return out.reshape(*x.shape[:-1], d, n_sub).movedim(-2, 0)


def gsq_norm_pow2(x, q: int) -> torch.Tensor:
    """The sum of squares of the centred lifts over the last axis, float64."""
    x = _c(x)
    flat = x.reshape(-1, x.shape[-1])
    out = torch.empty(flat.shape[0], dtype=torch.float64)
    _lib().gsq_norm_pow2(_ptr(flat), _ptr(out), flat.shape[0], flat.shape[1], q)
    return out.reshape(x.shape[:-1] or (1,))


def gsq_norm_gram(lifted, m: int) -> torch.Tensor:
    """General-m ||g x||^2 from centred int64 decoding coefficients (norm.cpp's
    general path): x^T G x with 128-bit accumulation, float64 (exact below
    2^53)."""
    G = _i64tbl(gen.gram_g_dec(m))
    x = torch.as_tensor(lifted)
    if x.device.type != "cpu":
        raise ValueError(f"cpp_backend: a host backend, got a tensor on {x.device}; "
                         f"copy it to the CPU first")
    x = x.to(torch.int64).contiguous()
    n = x.shape[-1]
    flat = x.reshape(-1, n)
    out = torch.empty(flat.shape[0], dtype=torch.float64)
    _lib().gsq_norm_gram(_ptr(flat), _ptr(G), _ptr(out), flat.shape[0], n)
    return out.reshape(x.shape[:-1] or (1,))
