"""Negacyclic NTT plans and the staged reference transforms.

Counterpart of `lol_tpu/ops/ntt.py` for 2-power cyclotomics: for
m = 2^(k+1), R_q = Z_q[x]/(x^n + 1) with n = 2^k, and the CRT basis
transform is the psi-twisted (negacyclic) NTT.

The forward transform is decimation-in-time (natural order in,
bit-reversed out) and the inverse is Gentleman-Sande (bit-reversed in,
natural out), so the CRT domain is bit-reversed-exponent order:
forward(a)[i] = a(psi^(2*brv_k(i)+1)), exactly as in the JAX package,
whose hints and ciphertexts are stored in that order.

`NTTPlan` keeps its tables as host numpy (u32, identical to the JAX
package's plan table for table) and hands out device copies through
`tables(device)`.  `ntt_forward_cm`/`ntt_inverse_cm` are the plain int64
torch networks along axis 0 of a coefficient-major (n, B) tensor;
`np_ntt_forward`/`np_ntt_inverse` are the numpy mirrors used for host
keygen and plaintext products.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import lru_cache

import numpy as np
import torch

from .. import numtheory as nt
from .. import zq


def _bit_reverse_perm(n: int) -> np.ndarray:
    k = n.bit_length() - 1
    idx = np.arange(n, dtype=np.int64)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(k):
        rev |= ((idx >> b) & 1) << (k - 1 - b)
    return rev


def _pow_table(base: int, exps: np.ndarray, q: int) -> np.ndarray:
    return np.array([pow(base, int(e), q) for e in exps], dtype=np.uint32)


@dataclass(frozen=True, eq=False)
class NTTPlan:
    """Twiddle tables for one (n, q).

    psi_rev[i] = psi^brv(i) and ipsi_rev[i] = psi^-brv(i), each with its
    Shoup companions (u32 numpy).  Device copies are made once per device
    and kept on the plan."""

    n: int
    q: int
    psi: int  # principal 2n-th root of unity mod q
    psi_rev: np.ndarray
    psi_rev_sh: np.ndarray
    ipsi_rev: np.ndarray
    ipsi_rev_sh: np.ndarray
    n_inv: int
    n_inv_sh: int
    _dev: dict = field(default_factory=dict, init=False, repr=False)

    def tables(self, device) -> tuple[torch.Tensor, ...]:
        """(psi_rev, psi_rev_sh, ipsi_rev, ipsi_rev_sh) as int32 tensors on
        `device`; the Shoup words keep their u32 bits (int32 view)."""
        device = torch.device(device)
        if device not in self._dev:
            self._dev[device] = tuple(
                torch.from_numpy(a.view(np.int32).copy()).to(device)
                for a in (self.psi_rev, self.psi_rev_sh,
                          self.ipsi_rev, self.ipsi_rev_sh)
            )
        return self._dev[device]


@lru_cache(maxsize=256)
def ntt_plan(n: int, q: int) -> NTTPlan:
    """The negacyclic NTT plan for x^n+1 over Z_q (q prime, 2n | q-1),
    with the canonical principal 2n-th root (from the smallest primitive
    root), so plans agree with the JAX package's."""
    if n & (n - 1) or n < 1:
        raise ValueError(f"ntt_plan: n={n} must be a power of 2")
    if (q - 1) % (2 * n) != 0:
        raise ValueError(f"ntt_plan: need 2n={2 * n} | q-1={q - 1}")
    if not (2 <= q < (1 << zq.MAX_MODULUS_BITS)):
        raise ValueError(f"ntt_plan: modulus {q} out of range [2, 2^30)")
    psi = nt.principal_root_of_unity(2 * n, q)
    rev = _bit_reverse_perm(n)
    psi_rev = _pow_table(psi, rev, q)
    ipsi_rev = _pow_table(nt.modinv(psi, q), rev, q)
    n_inv = nt.modinv(n, q)
    return NTTPlan(
        n=n,
        q=q,
        psi=psi,
        psi_rev=psi_rev,
        psi_rev_sh=zq.shoup_np(psi_rev, q),
        ipsi_rev=ipsi_rev,
        ipsi_rev_sh=zq.shoup_np(ipsi_rev, q),
        n_inv=n_inv,
        n_inv_sh=zq.shoup(n_inv, q),
    )


def crt_output_exponents(n: int) -> np.ndarray:
    """exponent e(i) with forward(a)[i] = a(psi^e(i)): e = 2*brv(i)+1."""
    return 2 * _bit_reverse_perm(n) + 1


# ---------------------------------------------------------------------------
# plain torch networks along axis 0 of (n, B), int64
# ---------------------------------------------------------------------------


def ntt_forward_cm(x: torch.Tensor, plan: NTTPlan) -> torch.Tensor:
    """Forward negacyclic NTT along axis 0 (natural in, brv out), int64."""
    n, q = plan.n, plan.q
    k = n.bit_length() - 1
    rest = x.shape[1:]
    w_all = plan.tables(x.device)[0].long()
    x = x.long() % q
    for s in range(k):
        m = 1 << s
        t = n >> (s + 1)
        w = w_all[m : 2 * m].view(m, *(1 for _ in range(len(rest) + 1)))
        xs = x.reshape(m, 2, t, *rest)
        u = xs[:, 0]
        v = xs[:, 1] * w % q
        x = torch.stack([(u + v) % q, (u - v) % q], dim=1).reshape(n, *rest)
    return x


def ntt_inverse_cm(x: torch.Tensor, plan: NTTPlan) -> torch.Tensor:
    """Inverse negacyclic NTT along axis 0 (brv in, natural out), int64."""
    n, q = plan.n, plan.q
    k = n.bit_length() - 1
    rest = x.shape[1:]
    w_all = plan.tables(x.device)[2].long()
    x = x.long() % q
    for s in reversed(range(k)):
        h = 1 << s
        t = n >> (s + 1)
        w = w_all[h : 2 * h].view(h, *(1 for _ in range(len(rest) + 1)))
        xs = x.reshape(h, 2, t, *rest)
        u, v = xs[:, 0], xs[:, 1]
        x = torch.stack([(u + v) % q, (u - v) * w % q], dim=1).reshape(n, *rest)
    return x * plan.n_inv % q


# ---------------------------------------------------------------------------
# exact numpy mirror (host keygen / plaintext products), over the last axis
# ---------------------------------------------------------------------------


def np_ntt_forward(x: np.ndarray, plan: NTTPlan) -> np.ndarray:
    n, q = plan.n, plan.q
    x = x.astype(np.int64) % q
    k = n.bit_length() - 1
    batch = x.shape[:-1]
    for s in range(k):
        m = 1 << s
        t = n >> (s + 1)
        w = plan.psi_rev[m : 2 * m].astype(np.int64)[:, None]
        x = x.reshape(*batch, m, 2, t)
        u, v = x[..., 0, :], x[..., 1, :] * w % q
        x = np.stack([(u + v) % q, (u - v) % q], axis=-2).reshape(*batch, n)
    return x.astype(np.uint32)


def np_ntt_inverse(x: np.ndarray, plan: NTTPlan) -> np.ndarray:
    n, q = plan.n, plan.q
    x = x.astype(np.int64) % q
    k = n.bit_length() - 1
    batch = x.shape[:-1]
    for s in reversed(range(k)):
        h = 1 << s
        t = n >> (s + 1)
        w = plan.ipsi_rev[h : 2 * h].astype(np.int64)[:, None]
        x = x.reshape(*batch, h, 2, t)
        u, v = x[..., 0, :], x[..., 1, :]
        x = np.stack([(u + v) % q, (u - v) * w % q], axis=-2).reshape(*batch, n)
    return (x * plan.n_inv % q).astype(np.uint32)


def np_negacyclic_mul_schoolbook(a: np.ndarray, b: np.ndarray, q: int) -> np.ndarray:
    """O(n^2) schoolbook product in Z_q[x]/(x^n+1): the independent oracle."""
    n = a.shape[-1]
    a = a.astype(np.int64)
    b = b.astype(np.int64)
    out = np.zeros(n, dtype=np.int64)
    for i in range(n):
        for j in range(n):
            k = i + j
            if k < n:
                out[k] = (out[k] + a[i] * b[j]) % q
            else:
                out[k - n] = (out[k - n] - a[i] * b[j]) % q
    return (out % q).astype(np.uint32)
