"""Negacyclic NTT plans and the staged reference transforms.

Counterpart of `lol_tpu/ops/ntt.py` for 2-power cyclotomics: for
m = 2^(k+1), R_q = Z_q[x]/(x^n + 1) with n = 2^k, and the CRT basis
transform is the psi-twisted (negacyclic) NTT; a general-m ring runs the
same plan on its 2-power axis (`ops/general.py`).

The forward transform is decimation-in-time (natural order in,
bit-reversed out) and the inverse is Gentleman-Sande (bit-reversed in,
natural out), so the CRT domain is bit-reversed-exponent order:
forward(a)[i] = a(psi^(2*brv_k(i)+1)), exactly as in the JAX package,
whose hints and ciphertexts are stored in that order.

`NTTPlan` keeps its tables as host numpy (u32, identical to the JAX
package's plan table for table, at the canonical root or at any root
`ntt_plan(n, q, psi=)` is given) and hands out device copies through
`tables(device)` and, for the route-B inverse, `dit_tables(tS, device)`.
`ntt_forward_cm`/`ntt_inverse_cm` are the plain int64 torch networks
along axis 0 of a coefficient-major (n, B) tensor (`dit_net_cm` and
`gs_net_cm` over a twiddle base, which the ring-sharded blocks share), and
`ntt_inverse_dit_cm` is the plain route-B inverse; `ntt_forward` /
`ntt_inverse` (and their `_stages` names) run the same networks over the
last axis of the reference's row-major (..., n) layout;
`np_ntt_forward`/`np_ntt_inverse` are the numpy mirrors used for host
keygen and plaintext products.

Route B (`lol_tpu/ops/pallas/ntt_kernel.py`, the note above `_wb_f`)
evaluates the same inverse four-step over n = P*tS: storage row
i = b*tS + r holds z_k with k = rev_tS(r)*P + rev_P(b), and

    block:  per block b, DIT-bitrev-input DFT_tS at root omega^-P
    twist:  row rho of block b  *= omega^-(rho * rev_P(b))
    cross:  per rho, DIT-bitrev-input DFT_P at root omega^-tS along b
    scale:  output row j  *= n^-1 psi^-j

(omega = psi^2).  With P = 1 (S = 0) it is the block DFT and the scale.
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

    def dit_tables(self, tS: int, device) -> dict[str, torch.Tensor | None]:
        """The route-B tables for block length tS as int32 tensors on
        `device`, each beside its Shoup companions ("<name>_sh", u32 bits):
        "blk" and "cross" are the packed per-row stage tables of the block
        and cross DFTs, "twist" and "scale" the (n,) per-row multipliers
        (row b*tS + rho of `invb_tables`' (P, tS) tables).  "cross" and
        "twist" are None when tS == n."""
        device = torch.device(device)
        key = ("dit", tS, device)
        if key not in self._dev:
            _, S, _ = split(self.n, tS)
            out = {}
            for name, t in zip(("blk", "cross", "twist", "scale"),
                               invb_tables(self, S, tS)):
                if t is None:
                    out[name] = out[name + "_sh"] = None
                    continue
                for k, a in ((name, t), (name + "_sh", zq.shoup_np(t, self.q))):
                    out[k] = torch.from_numpy(a.reshape(-1).view(np.int32).copy()).to(device)
            self._dev[key] = out
        return self._dev[key]


@lru_cache(maxsize=256)
def _canonical_psi(n: int, q: int) -> int:
    """The canonical principal 2n-th root of Z_q (from the smallest
    primitive root); ValueError where q is not prime."""
    return nt.principal_root_of_unity(2 * n, q)


def ntt_plan(n: int, q: int, psi: int | None = None) -> NTTPlan:
    """The negacyclic NTT plan for x^n+1 over Z_q (q prime, 2n | q-1).

    psi: the principal 2n-th root the plan uses, kept as given; None takes
    the canonical one (from the smallest primitive root), so plans agree
    with the JAX package's.  Plans are cached, and the canonical root
    given explicitly names the same plan object as None, so its device
    tables and the caches keyed on plans are not duplicated."""
    if n & (n - 1) or n < 1:
        raise ValueError(f"ntt_plan: n={n} must be a power of 2")
    if (q - 1) % (2 * n) != 0:
        raise ValueError(f"ntt_plan: need 2n={2 * n} | q-1={q - 1}")
    if not (2 <= q < (1 << zq.MAX_MODULUS_BITS)):
        raise ValueError(f"ntt_plan: modulus {q} out of range [2, 2^30)")
    if psi is None:
        psi = _canonical_psi(n, q)
    return _plan(n, q, int(psi))  # keyed by the root: the canonical one given is None's plan


@lru_cache(maxsize=256)
def _plan(n: int, q: int, psi: int) -> NTTPlan:
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
# route-B inverse tables (host numpy, equal to the JAX package's
# `_split`, `_pow_seq`, `_stage_table_bitrev` and `_invb_tables`)
# ---------------------------------------------------------------------------


def split(n: int, window: int) -> tuple[int, int, int]:
    """-> (k, S, tS): k = log2 n, tS = min(n, window) block rows, and
    S = log2(n / tS) cross stages."""
    k = n.bit_length() - 1
    tS = min(n, window)
    return k, k - (tS.bit_length() - 1), tS


def pow_seq(base: int, count: int, q: int, start: int = 1) -> np.ndarray:
    """[start, start*base, start*base^2, ...] mod q as u32."""
    out = np.empty(count, dtype=np.uint32)
    v = start % q
    for i in range(count):
        out[i] = v
        v = v * base % q
    return out


def stage_table_bitrev(root_inv: int, nloc: int, q: int) -> np.ndarray:
    """Per-row twiddles of a DIT-bitrev-input DFT of length nloc, packed
    (kloc*nloc,): row r of stage j (half-size h = 2^j) holds
    (root_inv^(nloc/2h))^(r mod h), so the v-row of each butterfly reads
    its own entry.  Stage 0 is all ones."""
    kloc = nloc.bit_length() - 1
    T = np.empty((max(kloc, 1), nloc), dtype=np.uint32)
    T[0] = 1
    for j in range(kloc):
        h = 1 << j
        T[j] = np.tile(pow_seq(pow(root_inv, nloc // (2 * h), q), h, q), nloc // h)
    return np.ascontiguousarray(T.reshape(-1))


def invb_tables(plan: NTTPlan, S: int, tS: int):
    """(block stage table, cross stage table | None, twist (P, tS) | None,
    output scale (P, tS)) for n = P*tS, P = 2^S."""
    n, q = plan.n, plan.q
    P = n // tS
    ipsi = pow(int(plan.psi), -1, q)
    iomega = ipsi * ipsi % q
    t_blk = stage_table_bitrev(pow(iomega, P, q), tS, q)
    t_cross = stage_table_bitrev(pow(iomega, tS, q), P, q) if P > 1 else None
    twist = None
    if P > 1:
        twist = np.stack([pow_seq(pow(iomega, int(k1), q), tS, q)
                          for k1 in _bit_reverse_perm(P)])
    scale = pow_seq(ipsi, n, q, start=plan.n_inv).reshape(P, tS)
    return t_blk, t_cross, twist, scale


# ---------------------------------------------------------------------------
# plain torch networks along axis 0 of (n, B), int64
# ---------------------------------------------------------------------------


def dit_net_cm(x: torch.Tensor, w: torch.Tensor, q: int, base: int = 1) -> torch.Tensor:
    """DIT network along axis 0 of an int64 tensor of residues in [0, q)
    (natural in, brv out, the length L = x.shape[0] a power of 2): stage s,
    group g multiplies by w[(base << s) + g].  base = 1 over psi_rev is the
    plain transform; base = D + d is block d of a ring sharded over D
    (`lol_tpu/ops/pallas/ntt_kernel.py::_block_twiddles`)."""
    L, rest = x.shape[0], x.shape[1:]
    for s in range(L.bit_length() - 1):
        m = 1 << s
        t = L >> (s + 1)
        wv = w[base << s : (base << s) + m].view(m, *(1 for _ in range(len(rest) + 1)))
        xs = x.reshape(m, 2, t, *rest)
        u = xs[:, 0]
        v = xs[:, 1] * wv % q
        x = torch.stack([(u + v) % q, (u - v) % q], dim=1).reshape(L, *rest)
    return x


def gs_net_cm(x: torch.Tensor, w: torch.Tensor, q: int, base: int = 1) -> torch.Tensor:
    """The Gentleman-Sande mirror of `dit_net_cm` over the same twiddle
    indices (brv in, natural out), with no 1/n scale."""
    L, rest = x.shape[0], x.shape[1:]
    for s in reversed(range(L.bit_length() - 1)):
        h = 1 << s
        t = L >> (s + 1)
        wv = w[base << s : (base << s) + h].view(h, *(1 for _ in range(len(rest) + 1)))
        xs = x.reshape(h, 2, t, *rest)
        u, v = xs[:, 0], xs[:, 1]
        x = torch.stack([(u + v) % q, (u - v) * wv % q], dim=1).reshape(L, *rest)
    return x


def ntt_forward_cm(x: torch.Tensor, plan: NTTPlan) -> torch.Tensor:
    """Forward negacyclic NTT along axis 0 (natural in, brv out), int64."""
    return dit_net_cm(x.long() % plan.q, plan.tables(x.device)[0].long(), plan.q)


def ntt_inverse_cm(x: torch.Tensor, plan: NTTPlan) -> torch.Tensor:
    """Inverse negacyclic NTT along axis 0 (brv in, natural out), int64."""
    q = plan.q
    return gs_net_cm(x.long() % q, plan.tables(x.device)[2].long(), q) * plan.n_inv % q


def ntt_forward_stages(x: torch.Tensor, plan: NTTPlan) -> torch.Tensor:
    """Forward negacyclic NTT over the last axis of (..., n) residues, the
    reference's row-major layout (the `*_cm` forms take axis 0); int32."""
    return ntt_forward_cm(x.movedim(-1, 0), plan).movedim(0, -1).to(torch.int32)


def ntt_inverse_stages(x: torch.Tensor, plan: NTTPlan) -> torch.Tensor:
    """Inverse negacyclic NTT over the last axis of (..., n); int32."""
    return ntt_inverse_cm(x.movedim(-1, 0), plan).movedim(0, -1).to(torch.int32)


def ntt_forward(x: torch.Tensor, plan: NTTPlan) -> torch.Tensor:
    return ntt_forward_stages(x, plan)


def ntt_inverse(x: torch.Tensor, plan: NTTPlan) -> torch.Tensor:
    return ntt_inverse_stages(x, plan)


def _dit_bitrev_net(x: torch.Tensor, table: torch.Tensor, q: int) -> torch.Tensor:
    """DIT network with bit-reversed input along axis 0 of an (nloc, M)
    int64 tensor (natural order out); `table` is the packed per-row stage
    table, sliced exactly like the data."""
    nloc, M = x.shape
    for s in range(nloc.bit_length() - 1):
        h = 1 << s
        nb = nloc >> (s + 1)
        w = table[s * nloc:(s + 1) * nloc].view(nb, 2, h)[:, 1, :, None]
        xs = x.view(nb, 2, h, M)
        u, v = xs[:, 0], xs[:, 1] * w % q
        x = torch.stack([(u + v) % q, (u - v) % q], dim=1).view(nloc, M)
    return x


def ntt_inverse_dit_cm(x: torch.Tensor, plan: NTTPlan, tS: int) -> torch.Tensor:
    """Route-B inverse negacyclic NTT along axis 0 of (n, B), int64: the
    same map as `ntt_inverse_cm`, computed as block DFT, twist, cross DFT
    and scale over n = P*tS (see the module docstring)."""
    n, q = plan.n, plan.q
    B = x.shape[1]
    P = n // tS
    tab = plan.dit_tables(tS, x.device)
    x = x.long() % q
    y = x.view(P, tS, B).transpose(0, 1).reshape(tS, P * B)
    y = _dit_bitrev_net(y, tab["blk"].long(), q).view(tS, P, B).transpose(0, 1)
    if P > 1:
        y = y * tab["twist"].long().view(P, tS, 1) % q
        y = _dit_bitrev_net(y.reshape(P, tS * B), tab["cross"].long(), q)
        y = y.view(P, tS, B)
    return (y * tab["scale"].long().view(P, tS, 1) % q).reshape(n, B)


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
