"""Batched, device-resident BGV pipeline (2-power m, LSD encoding).

Counterpart of `lol_tpu/she_batched.py`.  Ciphertext components are
coefficient-major (nrns, n, B) int32 tensors (batch along the last axis,
the NTT kernels' native layout), and one `build_step` module performs

    ct_mul (CRT Hadamards) -> RNS-gadget key switch -> exact BGV rescale

on the device.  Every NTT goes through `ops.cuda.ntt_kernel.ntt_cm` and
the ct-mult Hadamards through `ops.cuda.pointwise.ct_mul_cm`, one launch
per channel, so on a CUDA device the step runs the Hopper kernels (with
the digit re-expansion fused into the forward NTT kernel as its
prologue), and on the CPU their plain torch versions.  The JAX step
leaves the Hadamards to XLA, which overlaps them with its NTT calls
(`she_batched.py:828-837` there); eager PyTorch overlaps nothing, so the
port fuses them.  The hint inner products and the rescale arithmetic are
plain torch elementwise ops.  The results are bit-identical to
`lol_tpu.she_batched.BatchedBGV(params, use_pallas=False)`.

MSD encoding and general m are not ported yet: asking for them raises
NotImplementedError.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from . import gadget as gd
from . import numtheory as nt
from . import sampling, zq
from .ops import ntt as ntt_mod
from .ops.cuda.ntt_kernel import ntt_cm
from .ops.cuda.pointwise import ct_mul_cm
from .she import KSHint, SHEParams, SK


def _check_encoding(encoding: str) -> None:
    if encoding == "msd":
        raise NotImplementedError("MSD encoding is not ported yet")
    if encoding != "lsd":
        raise ValueError(f"encoding must be 'lsd' or 'msd', got {encoding!r}")


def _q_channels(qs, device) -> torch.Tensor:
    """Per-channel moduli shaped (nrns, 1, 1) to broadcast over (nrns, n, B)."""
    return torch.tensor(qs, dtype=torch.int64, device=device).view(-1, 1, 1)


# channel-wise helpers over (nrns, n, B) stacks; qv from _q_channels; int64 out


def _mulmod_ch(qv, a, b):
    return zq.mul_mod(a, b, qv)


def _addmod_ch(qv, a, b):
    return zq.add_mod(a, b, qv)


def _submod_ch(qv, a, b):
    return zq.sub_mod(a, b, qv)


def decompose_cm(qs, x: torch.Tensor) -> torch.Tensor:
    """RNS-gadget digits of (nrns, n, B) coefficient-domain values: digit
    i = centered [x]_{q_i} re-expanded into every channel, shape
    (ell=nrns, nrns, n, B), int32.  The step does not call this: the same
    arithmetic runs as the forward NTT kernel's prologue (`redigit`); it
    remains the readable reference form."""
    x = x.long()
    digs = []
    for i, qi in enumerate(qs):
        hi = x[i] >= (qi + 1) // 2
        centered = torch.where(hi, x[i] - qi, x[i])
        digs.append(torch.stack([
            x[i] if j == i else centered % qj for j, qj in enumerate(qs)
        ]))
    return torch.stack(digs).to(torch.int32)


def _s_crt_np(params: SHEParams, s_ints: torch.Tensor) -> np.ndarray:
    """(nrns, n) u32 CRT residues of small integer coefficients (host
    numpy NTT)."""
    s = s_ints.numpy().astype(np.int64)
    return np.stack([
        ntt_mod.np_ntt_forward(np.mod(s, p.q).astype(np.uint32)[None], p)[0]
        for p in params.ctx.ntt_plans()
    ])


class BatchedBGV:
    """Batched BGV pipeline for one SHEParams on one device."""

    def __init__(self, params: SHEParams, device):
        self.params = params
        self.device = torch.device(device)
        self.ctx = params.ctx  # raises NotImplementedError for non-2-power m
        self.qs = params.qs

    def plans(self) -> list[ntt_mod.NTTPlan]:
        return self.ctx.ntt_plans()

    # --- layout ---------------------------------------------------------
    def pack(self, cts) -> tuple[torch.Tensor, torch.Tensor]:
        """List of degree-1 ciphertexts, each a pair of (nrns, n) CRT
        residue arrays, -> two (nrns, n, B) int32 tensors on the device."""
        return tuple(
            torch.from_numpy(
                np.stack([np.asarray(ct[k], dtype=np.int64) for ct in cts], axis=-1)
            ).to(device=self.device, dtype=torch.int32)
            for k in range(2)
        )

    # --- per-channel transforms -----------------------------------------
    def _crt_one(self, x2d, ch, inverse=False, pre_digit_q=None):
        """(n, B) single-channel CRT transform; pre_digit_q fuses the
        digit re-expansion into the forward kernel."""
        return ntt_cm(x2d, self.plans()[ch], inverse=inverse,
                      pre_digit_q=pre_digit_q)

    def _ntt(self, x, inverse=False):
        """(nrns, n, B) per-channel transform."""
        return torch.stack(
            [self._crt_one(x[i], i, inverse) for i in range(x.shape[0])]
        )

    def _digit_crt(self, src_i, i, known_crt):
        """Digit i's CRT stack from the coefficient-domain channel src_i =
        iNTT(x)[i]: channel j's re-expansion runs as the prologue of its
        forward NTT.  Channel i itself is known_crt[i] (the free diagonal:
        iNTT then NTT round-trips exactly)."""
        return torch.stack([
            known_crt[j] if j == i
            else self._crt_one(src_i, j, pre_digit_q=self.qs[i])
            for j in range(len(self.qs))
        ])

    def _rescale_crt(self, comp: torch.Tensor, qv: torch.Tensor) -> torch.Tensor:
        """Exact BGV drop-last rescale of one (nrns, n, B) component in the
        CRT domain (LSD): only the dropped channel is inverse-transformed;
        the correction delta = p * centered [c p^-1]_{ql} is forward-
        transformed into each surviving channel.  int32 (nrns-1, n, B)."""
        qs = self.qs
        p = self.params.p
        ql = qs[-1]
        last_c = self._crt_one(comp[-1], len(qs) - 1, inverse=True).long()
        v = last_c * nt.modinv(p % ql, ql) % ql
        centered = torch.where(v >= (ql + 1) // 2, v - ql, v)
        qv_s = qv[:-1]
        p_s = torch.tensor([p % q for q in qs[:-1]], device=qv.device).view(-1, 1, 1)
        inv_s = torch.tensor(
            [nt.modinv(ql % q, q) for q in qs[:-1]], device=qv.device
        ).view(-1, 1, 1)
        delta = (centered[None] % qv_s) * p_s % qv_s
        nd = self._ntt(delta.to(torch.int32))
        d = _submod_ch(qv_s, comp[:-1], nd)
        return (d * inv_s % qv_s).to(torch.int32)

    # --- batched encryption / decryption --------------------------------
    def _s_crt(self, sk: SK) -> torch.Tensor:
        return torch.from_numpy(_s_crt_np(self.params, sk.s_ints).astype(np.int64))

    def build_encrypt(self, sk: SK, encoding: str = "lsd"):
        """(msgs, generator) -> (c0, c1): encrypt an (n, B) batch of
        plaintext coefficients mod p.  c1 is uniform in the CRT domain and
        c0 = NTT(m + p e) - c1 * s, e rounded Gaussian of variance var."""
        _check_encoding(encoding)
        qs, p, var = self.qs, self.params.p, self.params.var
        s_crt = self._s_crt(sk).to(self.device)[..., None]
        qv = _q_channels(qs, self.device)

        def enc(msgs: torch.Tensor, generator: torch.Generator):
            e = sampling.gaussian_ints(tuple(msgs.shape), var, generator, self.device)
            me = msgs.to(self.device).long() + p * e
            me_crt = self._ntt((me[None] % qv).to(torch.int32))
            c1 = sampling.uniform_residues(qs, tuple(msgs.shape), generator,
                                           self.device)
            c0 = _submod_ch(qv, me_crt, _mulmod_ch(qv, c1, s_crt))
            return c0.to(torch.int32), c1

        return enc

    def build_decrypt(self, sk: SK, f: int = 1, encoding: str = "lsd"):
        """(c0, c1) -> (n, B) int32 messages mod p: c(s) = c0 + c1 s in
        the CRT domain, one inverse NTT per channel, then the Garner
        centered lift reduced mod p, times f^-1."""
        _check_encoding(encoding)
        p = self.params.p
        s_crt = self._s_crt(sk).to(self.device)[..., None]
        qv = _q_channels(self.qs, self.device)
        finv = nt.modinv(f % p, p)

        def dec(c0: torch.Tensor, c1: torch.Tensor) -> torch.Tensor:
            cs = _addmod_ch(qv, c0, _mulmod_ch(qv, c1, s_crt))
            coeff = self._ntt(cs.to(torch.int32), inverse=True)
            lifted = self.ctx.basis.lift_mod(coeff, p)
            return (lifted * finv % p).to(torch.int32)

        return dec

    def step_f(self, fc: int = 1, fd: int = 1) -> int:
        """Scale factor of build_step's output for input scales fc, fd:
        the LSD rescale multiplies by q_last^-1 mod p."""
        p = self.params.p
        return fc * fd * nt.modinv(self.qs[-1] % p, p) % p

    # --- keygen ---------------------------------------------------------
    def gen_ks_quad_hint(self, sk: SK, generator: torch.Generator) -> KSHint:
        """Relinearization hint for s^2: h0[j] = p e_j + g_j s^2 - a_j s,
        h1[j] = a_j, with a_j uniform and e_j rounded Gaussian, computed in
        the CRT domain on the device."""
        if sk.params.ctx != self.ctx:
            raise ValueError("gen_ks_quad_hint: SK params differ from the pipeline's")
        qs, p, n = self.qs, self.params.p, self.ctx.n
        ell = len(qs)
        qv = _q_channels(qs, self.device)
        s_crt = self._s_crt(sk).to(self.device)  # (nrns, n)
        s2 = s_crt * s_crt % qv[..., 0]
        g = torch.from_numpy(gd.gadget_rns(self.ctx.basis).astype(np.int64))
        g = g.to(self.device)[:, :, None]  # (ell, nrns, 1)
        pe = p * sampling.gaussian_ints((n, ell), self.params.var, generator,
                                        self.device)
        pe_crt = self._ntt((pe[None] % qv).to(torch.int32)).long()
        pe_crt = pe_crt.permute(2, 0, 1)  # (ell, nrns, n)
        a = torch.stack([
            sampling.uniform_residues(qs, (n,), generator, self.device)
            for _ in range(ell)
        ])  # (ell, nrns, n)
        q3 = qv[..., 0][None]  # (1, nrns, 1)
        h0 = (pe_crt + g * s2[None] % q3 - a.long() * s_crt[None] % q3) % q3
        return KSHint(self.params, h0.to(torch.int32), a)

    # --- the fused mul + keyswitch + rescale step ------------------------
    def build_step(self, hint: KSHint, encoding: str = "lsd") -> "BGVStep":
        """(c0, c1, d0, d1) -> (e0, e1) over the dropped-prime chain:
        ct_mul + keySwitchQuadCirc + modSwitch.  Track the output scale
        with `step_f`."""
        _check_encoding(encoding)
        return BGVStep(self, hint)


class BGVStep(nn.Module):
    """The compiled BGV step; the hint and the per-channel moduli are
    buffers, so `.to(device)` moves the whole step."""

    def __init__(self, bb: BatchedBGV, hint: KSHint):
        super().__init__()
        nrns = len(bb.qs)
        if hint.h0.shape != (nrns, nrns, bb.ctx.n) or hint.h1.shape != hint.h0.shape:
            raise ValueError(f"build_step: hint shape {tuple(hint.h0.shape)} "
                             f"!= (ell, nrns, n) = {(nrns, nrns, bb.ctx.n)}")
        self.bb = bb
        self.register_buffer("qv", _q_channels(bb.qs, bb.device))
        self.register_buffer("h0", hint.h0.to(bb.device, torch.int64)[..., None])
        self.register_buffer("h1", hint.h1.to(bb.device, torch.int64)[..., None])

    @torch.no_grad()
    def ct_mul(self, c0, c1, d0, d1):
        """(c0 + c1 s)(d0 + d1 s) as CRT Hadamards: (e0, e1, e2), each an
        (nrns, n, B) int32 stack, one `ct_mul_cm` per channel."""
        c0, c1, d0, d1 = (t.contiguous() for t in (c0, c1, d0, d1))
        es = tuple(torch.empty_like(c0) for _ in range(3))
        for i, q in enumerate(self.bb.qs):
            ct_mul_cm(c0[i], c1[i], d0[i], d1[i], q, out=tuple(e[i] for e in es))
        return es

    @torch.no_grad()
    def inner_product(self, e0, e1, di, i):
        """(e0 + di h0[i], e1 + di h1[i]) mod q for digit i's CRT stack
        di: the key switch's hint inner products, int64 out."""
        di = di.long()
        return (e0 + di * self.h0[i]) % self.qv, (e1 + di * self.h1[i]) % self.qv

    @torch.no_grad()
    def forward(self, c0, c1, d0, d1):
        bb = self.bb
        e0, e1, e2 = self.ct_mul(c0, c1, d0, d1)
        # key switch e2: coefficient-domain digits, each re-expanded inside
        # its channel's forward NTT, then the hint inner products
        e2c = bb._ntt(e2, inverse=True)
        for i in range(len(bb.qs)):
            e0, e1 = self.inner_product(e0, e1, bb._digit_crt(e2c[i], i, e2), i)
        return (bb._rescale_crt(e0.to(torch.int32), self.qv),
                bb._rescale_crt(e1.to(torch.int32), self.qv))
