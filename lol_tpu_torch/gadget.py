"""Gadgets: encode / decompose / correct.

Counterpart of `lol_tpu/gadget.py` (Lol's `Gadget`, `Decompose`,
`Correct`): a `GadgetSpec` picks the gadget.

- `TrivGad`: g = [1], one digit, the centered lift;
- `BaseBGad(b)`: g = [1, b, b^2, ...], balanced base-b digits of the
  centered lift (the KH-PRF's, over its one modulus p);
- `RnsGad`: the CRT gadget of the key switch, g_i = (Q/q_i)
  [(Q/q_i)^-1]_{q_i}, digit i = the centered residue [x]_{q_i}.  Its
  decomposition needs no big-integer lift, and the batched pipeline
  fuses it into the forward NTT kernels (`ops.cuda.ntt_kernel.redigit`).

`decompose(spec, basis, a)` takes ring elements in the reference's layout,
(..., nrns, n) residues, and returns the (ell, ..., nrns, n) digits in
residue form, as torch on a's device: the RNS gadget and single-prime
base-b / trivial gadgets elementwise there, the others through the exact
host oracle `decompose_host`.  `decompose_mod` / `decompose_host_mod`
are the base-b digits over one modulus q of plain (..., n) residue
arrays, the host numpy form the PRF family's set-up uses.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from . import numtheory as nt
from .rns import RnsBasis, rns_basis


class GadgetSpec:
    pass


@dataclass(frozen=True)
class TrivGad(GadgetSpec):
    """g = [1]; decompose = the centered lift (one digit)."""


@dataclass(frozen=True)
class BaseBGad(GadgetSpec):
    """g = [1, b, b^2, ...] with balanced base-b digits."""

    b: int

    def __post_init__(self):
        if self.b < 2:
            raise ValueError("BaseBGad: b >= 2 required")


@dataclass(frozen=True)
class RnsGad(GadgetSpec):
    """The CRT gadget: g_i = (Q/q_i) [(Q/q_i)^-1]_{q_i}; digit_i = [x]_{q_i}."""


def num_digits(spec: GadgetSpec, basis: RnsBasis) -> int:
    """The gadget's length ell over Z_Q: 1, the least ell with b^ell >= Q,
    or nrns."""
    if isinstance(spec, TrivGad):
        return 1
    if isinstance(spec, BaseBGad):
        ell, t = 0, 1
        while t < basis.modulus:
            t *= spec.b
            ell += 1
        return ell
    if isinstance(spec, RnsGad):
        return basis.nrns
    raise TypeError(spec)


def gadget_ints(spec: GadgetSpec, basis: RnsBasis) -> list[int]:
    """The gadget vector as Python ints mod Q (Lol `gadget`)."""
    Q = basis.modulus
    if isinstance(spec, TrivGad):
        return [1]
    if isinstance(spec, BaseBGad):
        return [pow(spec.b, j, Q) for j in range(num_digits(spec, basis))]
    if isinstance(spec, RnsGad):
        return [(Q // q) * nt.modinv((Q // q) % q, q) % Q for q in basis.qs]
    raise TypeError(spec)


def gadget_rns(spec: GadgetSpec, basis: RnsBasis) -> np.ndarray:
    """(ell, nrns) uint32: the gadget entries in residue form."""
    return np.array([[g % q for q in basis.qs] for g in gadget_ints(spec, basis)],
                    dtype=np.uint32)


def encode_int(spec: GadgetSpec, basis: RnsBasis, x: int) -> list[int]:
    """x times the gadget over Z_Q (Lol `encode`)."""
    return [x * g % basis.modulus for g in gadget_ints(spec, basis)]


# ---------------------------------------------------------------------------
# decomposition
# ---------------------------------------------------------------------------


def _signed_digits(v: int, b: int, ell: int) -> list[int]:
    """Balanced base-b digits of integer v: v = sum d_j b^j, d in [-b/2, b/2)."""
    out = []
    for _ in range(ell):
        d = v % b
        if d >= (b + 1) // 2:
            d -= b
        out.append(d)
        v = (v - d) // b
    if v != 0:
        raise ValueError("digit overflow: |v| too large for ell digits")
    return out


def _digits_of(x: np.ndarray, b: int, ell: int) -> tuple[np.ndarray, np.ndarray]:
    """`_signed_digits` of every entry of an integer array (int64 or object)
    at once: the (ell, *x.shape) digits and what is left above them."""
    digs = []
    for _ in range(ell):
        d = x % b
        d = np.where(d >= (b + 1) // 2, d - b, d)
        digs.append(d)
        x = (x - d) // b
    return np.stack(digs), x


def _balanced_digits(spec: BaseBGad, q: int, a) -> tuple[np.ndarray, np.ndarray]:
    x = np.asarray(a, dtype=np.int64) % q
    return _digits_of(np.where(x >= (q + 1) // 2, x - q, x), spec.b,
                      num_digits(spec, rns_basis((q,))))


def decompose_host_mod(spec: BaseBGad, q: int, a) -> np.ndarray:
    """Host oracle over one modulus q: (..., n) residues -> (ell, ..., n)
    int64 digits in residue form, sum_j digits_j b^j = a (mod q); raises
    where a centered lift needs more than ell digits (as `_signed_digits`)."""
    digs, rest = _balanced_digits(spec, q, a)
    if rest.any():
        raise ValueError("digit overflow: |v| too large for ell digits")
    return digs % q


def decompose_mod(spec: BaseBGad, q: int, a) -> np.ndarray:
    """The KH-PRF's decomposition over one modulus q (what `decompose` is
    over a one-prime basis, on plain (..., n) host arrays): the same ell
    balanced digits in residue form, with no overflow check (a digit string
    that overflows still sums to a mod q when b^ell = 0 mod q, as for
    q = 2^k, b = 2)."""
    return _balanced_digits(spec, q, a)[0] % q


def decompose_host(spec: GadgetSpec, basis: RnsBasis, a) -> np.ndarray:
    """Host oracle: (..., nrns, n) residues -> (ell, ..., nrns, n) u32
    digits in residue form, sum_j digits_j gadget_j = a (mod Q), from the
    exact centered lift."""
    a = a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    lifted = basis.lift_centered(np.moveaxis(a, -2, 0))  # (..., n) object ints
    if isinstance(spec, TrivGad):
        digs = lifted[None]
    elif isinstance(spec, BaseBGad):
        digs, rest = _digits_of(lifted, spec.b, num_digits(spec, basis))
        if rest.any():
            raise ValueError("digit overflow: |v| too large for ell digits")
    elif isinstance(spec, RnsGad):
        digs = np.stack([np.where(lifted % q >= (q + 1) // 2, lifted % q - q, lifted % q)
                         for q in basis.qs])
    else:
        raise TypeError(spec)
    out = np.stack([basis.to_rns(d) for d in digs])  # (ell, nrns, ..., n)
    return np.moveaxis(out, 1, -2).astype(np.uint32)


def decompose_rns(basis: RnsBasis, a: torch.Tensor) -> torch.Tensor:
    """The RNS-gadget digits of (..., nrns, n) residues, elementwise on
    a's device: digit i = the centered [a]_{q_i} re-expanded into every
    channel, (nrns, ..., nrns, n) int32."""
    digs = []
    for i, qi in enumerate(basis.qs):
        xi = a[..., i, :].long()
        centered = torch.where(xi >= (qi + 1) // 2, xi - qi, xi)
        digs.append(torch.stack([xi if j == i else torch.remainder(centered, qj)
                                 for j, qj in enumerate(basis.qs)], dim=-2))
    return torch.stack(digs).to(torch.int32)


def decompose_base(spec: BaseBGad, basis: RnsBasis, a: torch.Tensor) -> torch.Tensor:
    """Base-b digits over a one-prime chain, elementwise on a's device:
    (..., 1, n) -> (ell, ..., 1, n) int32 residues of the balanced digits
    of the centered lift."""
    if basis.nrns != 1:
        raise ValueError("decompose_base: elementwise base-b decomposition needs a "
                         "single-prime chain; use RnsGad or decompose_host for RNS")
    q, b = basis.qs[0], spec.b
    x = a[..., 0, :].long()
    x = torch.where(x >= (q + 1) // 2, x - q, x)
    outs = []
    for _ in range(num_digits(spec, basis)):
        d = torch.remainder(x, b)
        d = torch.where(d >= (b + 1) // 2, d - b, d)
        outs.append(torch.remainder(d, q))
        x = torch.div(x - d, b, rounding_mode="floor")
    return torch.stack(outs)[..., None, :].to(torch.int32)


def decompose(spec: GadgetSpec, basis: RnsBasis, a: torch.Tensor) -> torch.Tensor:
    """(..., nrns, n) residues -> (ell, ..., nrns, n) int32 digits on a's
    device (Lol `decompose`)."""
    if isinstance(spec, RnsGad):
        return decompose_rns(basis, a)
    if isinstance(spec, TrivGad) and basis.nrns == 1:
        return a[None]
    if isinstance(spec, BaseBGad) and basis.nrns == 1:
        return decompose_base(spec, basis, a)
    return torch.from_numpy(decompose_host(spec, basis, a).astype(np.int32)).to(a.device)


# ---------------------------------------------------------------------------
# error correction (Lol `Correct`)
# ---------------------------------------------------------------------------


def _center(r: int, q: int) -> int:
    return r - q if r >= (q + 1) // 2 else r


def correct_host(spec: GadgetSpec, basis: RnsBasis, noisy):
    """Given noisy = x gadget + e (residue form, digit axis 0, (ell, ...,
    nrns, n)), recover x (object ints mod Q) and the errors (Lol
    `correct`).  TrivGad: the identity.  BaseBGad: the syndromes
    c_j = b w_j - w_{j+1} = b e_j - e_{j+1} lift exactly, then
    e_{ell-1} = centered(-c_{ell-2} mod b) (|e_j| < b/2) and back
    substitution.  RnsGad: digit j's off-channel residues are e_j mod q_i,
    so e_j is their centered CRT over Q / q_j; x follows by the CRT of
    noisy_j - e_j across the digits (one prime: no error information,
    e = 0)."""
    noisy = noisy.cpu().numpy() if isinstance(noisy, torch.Tensor) else np.asarray(noisy)
    if isinstance(spec, TrivGad):
        return noisy[0], np.zeros_like(noisy)
    if isinstance(spec, BaseBGad):
        b, Q = spec.b, basis.modulus
        lifted = np.stack([basis.lift_centered(np.moveaxis(d, -2, 0)) for d in noisy])
        ell = lifted.shape[0]
        flat = lifted.reshape(ell, -1)
        xs = np.empty(flat.shape[1], dtype=object)
        errs = np.empty_like(flat)
        for t in range(flat.shape[1]):
            w = [int(v) for v in flat[:, t]]
            c = [_center((b * w[j] - w[j + 1]) % Q, Q) for j in range(ell - 1)]
            e = [0] * ell
            if ell >= 2:
                e[ell - 1] = _center((-c[ell - 2]) % b, b)
                for j in range(ell - 2, -1, -1):
                    e[j] = (c[j] + e[j + 1]) // b
            errs[:, t] = e
            xs[t] = (w[0] - e[0]) % Q
        return xs.reshape(lifted.shape[1:]), errs.reshape(lifted.shape)
    if isinstance(spec, RnsGad):
        qs = basis.qs
        L = len(qs)
        shape = noisy.shape[1:-2] + noisy.shape[-1:]
        if L == 1:
            return basis.from_rns(np.moveaxis(noisy[0], -2, 0)), np.zeros((1,) + shape, dtype=object)
        errs = np.empty((L,) + shape, dtype=object)
        x_res = np.empty((L,) + shape, dtype=object)
        for j in range(L):
            others = [i for i in range(L) if i != j]
            sub = rns_basis(tuple(qs[i] for i in others))
            e_j = sub.lift_centered(np.stack([noisy[j][..., i, :].astype(np.int64) for i in others]))
            errs[j] = e_j
            x_res[j] = (noisy[j][..., j, :].astype(object) - e_j) % qs[j]
        return basis.from_rns(x_res.astype(np.int64)), errs
    raise TypeError(f"correct not supported for {spec}")
