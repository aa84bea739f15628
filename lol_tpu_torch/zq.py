"""Z_q arithmetic: host constants and the plain torch reference forms.

Counterpart of `lol_tpu/zq.py`.  Moduli are primes q < 2^30 held as
Python ints.  Residues cross the port's API as `torch.int32` in [0, q)
(bit-identical to the JAX package's u32, since q < 2^30); the plain
functions here compute in int64, where every product of two residues is
below 2^60 and `(a * b) % q` is exact.  The lazy [0, 2q)/[0, 4q) forms and
the Shoup multiply (`zq.py:150-182` of the JAX package) exist only inside
the CUDA kernels (`csrc/ntt.cu`), which reinterpret the buffers as
uint32_t.

`q` may be a Python int or an int64 tensor that broadcasts against the
operands (one modulus per RNS channel).
"""

from __future__ import annotations

import numpy as np
import torch

MAX_MODULUS_BITS = 30  # q < 2^30: a+b and 4q fit in u32; Barrett mu fits u32


def barrett_mu(q: int) -> int:
    """mu = floor(2^(2k) / q) for k = bitlength(q); fits u32 for k <= 30."""
    if not (2 <= q < (1 << MAX_MODULUS_BITS)):
        raise ValueError(f"modulus {q} out of range [2, 2^{MAX_MODULUS_BITS})")
    return (1 << (2 * q.bit_length())) // q


def shoup(w: int, q: int) -> int:
    """Shoup companion word for constant w in [0, q): floor(w * 2^32 / q)."""
    return (int(w) << 32) // q


def shoup_np(w: np.ndarray, q: int) -> np.ndarray:
    """Vectorized Shoup companions (u32) for an array of constants < q."""
    w64 = w.astype(np.int64)
    if w64.size and int(w64.max()) >= q:
        raise ValueError("shoup_np: entries must be < q")
    return ((w64 << 32) // q).astype(np.uint32)


def add_mod(a: torch.Tensor, b: torch.Tensor, q) -> torch.Tensor:
    return (a.long() + b.long()) % q


def sub_mod(a: torch.Tensor, b: torch.Tensor, q) -> torch.Tensor:
    return (a.long() - b.long()) % q


def neg_mod(a: torch.Tensor, q) -> torch.Tensor:
    return (-a.long()) % q


def mul_mod(a: torch.Tensor, b: torch.Tensor, q) -> torch.Tensor:
    """(a * b) mod q for residues a, b in [0, q), q < 2^30 (exact in int64)."""
    return (a.long() * b.long()) % q


def reduce_mod(x: torch.Tensor, q) -> torch.Tensor:
    """x mod q for any non-negative x below 2^63."""
    return x.long() % q
