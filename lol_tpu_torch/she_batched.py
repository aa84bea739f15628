"""Batched, device-resident BGV pipeline (any m, LSD and MSD).

Counterpart of `lol_tpu/she_batched.py`.  Ciphertext components are
coefficient-major (nrns, n, B) int32 tensors (batch along the last axis,
the NTT kernels' native layout), and one `build_step` module performs

    ct_mul (CRT Hadamards) -> RNS-gadget key switch -> exact BGV rescale

on the device.  Every CRT transform of a 2-power ring goes through
`ops.cuda.ntt_kernel.ntt_cm`, and at general m through
`ops.general.crt_cm`, whose 2-power axis is the same `ntt_cm` on a free
reshape and whose odd axes are plain int64 torch matrix products (the
reference runs them on XLA, not Pallas); messages, errors and
decryptions are decoding-basis coefficients there, turned into the
powerful basis by `ops.general.l_cm` (`_l`).  The ct-mult Hadamards go
through `ops.cuda.pointwise.ct_mul_cm`, one launch per channel, so on a
CUDA device the pipeline runs the Hopper kernels (with each RNS-gadget
digit's re-expansion fused into the forward NTT kernel as its
prologue), and on the CPU their plain torch versions.  The JAX step
leaves the Hadamards to XLA, which overlaps them with its NTT calls
(`she_batched.py:828-837` there); eager PyTorch overlaps nothing, so
the port fuses them.  The hint inner products, the rescale and the
arithmetic of every other `build_*` function are plain int64 torch
elementwise ops.

Both encodings: "lsd" keeps c(s) = f*m + p*e, "msd" c(s) = Delta*m + e
with Delta = Q // p (encrypt, the exact scaled-rounding decrypt through
`RnsBasis.pos_mod`, the step, the modulus switch, the public-plaintext
add).  Beside the step: `build_mod_switch`, `build_key_switch_linear`,
ciphertext add / sub with scale alignment, public-plaintext add and
multiply, the encoding switches, exact division by d, the batched error
term and noise budget, the fused ring tunnel R -> S of a tower
(`build_tunnel`, an `nn.Module` like the step), the batched Galois
automorphisms (`build_galois`, and `build_galois_many`, which shares one
inverse transform and one digit stack among its rotations), and
extended-modulus (hybrid) key switching (`build_step_ext`,
`build_key_switch_linear_ext`: the digits' inner products run over Q*P
with hints made over that chain, and the special primes P are dropped by
exact rescales, which divides the key-switch noise by P).  Hints for T targets come from one device pass
(`_gen_gadget_hints`).  Every result is
bit-identical to `lol_tpu.she_batched.BatchedBGV(params, use_pallas=False)`
(the noise budget, float32, to its rounding).
"""

from __future__ import annotations

import math
from dataclasses import replace

import numpy as np
import torch
from torch import nn

from . import gadget as gd
from . import numtheory as nt
from . import sampling, zmstar, zq
from .linear import Linear
from .ops import general as gen
from .ops import ntt as ntt_mod
from .ops.cuda.ntt_kernel import ntt_cm
from .ops.cuda.pointwise import ct_mul_cm
from .ring import RingContext
from .she import KSHint, KSHintExt, SHEParams, SK, TunnelHint

ENCODINGS = ("lsd", "msd")


def _check_encoding(encoding: str) -> str:
    if encoding not in ENCODINGS:
        raise ValueError(f"encoding must be 'lsd' or 'msd', got {encoding!r}")
    return encoding


def _channel_consts(values, device) -> torch.Tensor:
    """Per-channel int64 constants (the moduli qv, say) shaped (nrns, 1, 1)
    to broadcast over (nrns, n, B)."""
    return torch.tensor(list(values), dtype=torch.int64, device=device).view(-1, 1, 1)


# channel-wise helpers over (nrns, n, B) stacks; qv = _channel_consts(qs); int64 out


def _mulmod_ch(qv, a, b):
    return zq.mul_mod(a, b, qv)


def _addmod_ch(qv, a, b):
    return zq.add_mod(a, b, qv)


def _submod_ch(qv, a, b):
    return zq.sub_mod(a, b, qv)


def _scale_ch(qv, x, c):
    """x times the per-channel constants c mod q, int32 out."""
    return zq.mul_mod(x, c, qv).to(torch.int32)


def _ct_mul(qs, c0, c1, d0, d1):
    """(c0 + c1 s)(d0 + d1 s) as CRT Hadamards: (e0, e1, e2), each an
    (nrns, n, B) int32 stack, one `ct_mul_cm` per channel."""
    c0, c1, d0, d1 = (t.contiguous() for t in (c0, c1, d0, d1))
    es = tuple(torch.empty_like(c0) for _ in range(3))
    for i, q in enumerate(qs):
        ct_mul_cm(c0[i], c1[i], d0[i], d1[i], q, out=tuple(e[i] for e in es))
    return es


def _lsd_operand(qv, p, d0, d1):
    """An MSD step's second operand switched to LSD: both components times
    p, int32 out."""
    p_res = p % qv
    return _scale_ch(qv, d0, p_res), _scale_ch(qv, d1, p_res)


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


def _crt_np(ctx: RingContext, ints) -> np.ndarray:
    """(nrns, n) u32 CRT residues of (n,) integer powerful-basis
    coefficients over ctx (host numpy, `ops.general.np_crt`: at 2-power m
    the NTT)."""
    x = np.asarray(ints, dtype=np.int64)
    return np.stack([gen.np_crt(gp, np.mod(x, gp.q).astype(np.uint32)[None])[0]
                     for gp in ctx.general_plans()])


def _s_crt_np(params: SHEParams, s_ints: torch.Tensor) -> np.ndarray:
    """(nrns, n) u32 CRT residues of small integer coefficients."""
    return _crt_np(params.ctx, s_ints.numpy())


class BatchedBGV:
    """Batched BGV pipeline for one SHEParams on one device (the card
    unless the caller names another)."""

    def __init__(self, params: SHEParams, device="cuda"):
        self.params = params
        self.device = torch.device(device)
        self.ctx = params.ctx
        self.qs = params.qs

    def plans(self) -> list[ntt_mod.NTTPlan]:
        """The NTT plans of a 2-power ring (raises at general m)."""
        return self.ctx.ntt_plans()

    def _over(self, ctx: RingContext) -> "BatchedBGV":
        """The pipeline over ring ctx with this one's p, chain and device."""
        return BatchedBGV(replace(self.params, m=ctx.m), self.device)

    def _consts(self, fn) -> torch.Tensor:
        """(nrns, 1, 1) int64 constants fn(q) on the device."""
        return _channel_consts((fn(q) for q in self.qs), self.device)

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

    def unpack(self, arrs) -> list[tuple[np.ndarray, np.ndarray]]:
        """Two (nrns, n, B) component tensors -> the list of B ciphertexts
        `pack` takes, each a pair of (nrns, n) u32 CRT residue arrays (the
        port has no ring-element object; the JAX package's unpack wraps
        the same arrays)."""
        comps = [a.cpu().numpy().astype(np.uint32) for a in arrs]
        return [tuple(np.ascontiguousarray(c[..., b]) for c in comps)
                for b in range(comps[0].shape[-1])]

    # --- per-channel transforms -----------------------------------------
    def _crt_one(self, x2d, ch, inverse=False, ctx=None, pre_digit_q=None):
        """(n, B) single-channel CRT transform of ring ctx (this one's by
        default): `ntt_cm` at 2-power m, `ops.general.crt_cm` otherwise;
        pre_digit_q fuses the digit re-expansion into the forward kernel."""
        ctx = self.ctx if ctx is None else ctx
        if not ctx.fm.is_pow2():
            return gen.crt_cm(ctx.general_plans()[ch], x2d, inverse=inverse,
                              pre_digit_q=pre_digit_q)
        return ntt_cm(x2d, ctx.ntt_plans()[ch], inverse=inverse, pre_digit_q=pre_digit_q)

    def _ntt(self, x, inverse=False, ctx=None):
        """(nrns, n, B) per-channel CRT transform (named for the 2-power
        pipeline; it dispatches per ring)."""
        return torch.stack(
            [self._crt_one(x[i], i, inverse, ctx=ctx) for i in range(x.shape[0])]
        )

    def _l(self, x, inverse=False):
        """(nrns, n, B) per-channel L / L^-1 (decoding <-> powerful basis),
        int32; the identity at 2-power m, where the bases coincide."""
        if self.ctx.fm.is_pow2():
            return x
        gps = self.ctx.general_plans()
        return torch.stack([gen.l_cm(gps[i], x[i], inverse) for i in range(x.shape[0])])

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

    def _rescale_crt(self, comp: torch.Tensor, qv: torch.Tensor,
                     encoding: str = "lsd") -> torch.Tensor:
        """Exact BGV drop-last rescale of one (nrns, n, B) component in the
        CRT domain: only the dropped channel is inverse-transformed; the
        correction delta (p * centered [c p^-1]_{ql} for LSD, the plain
        centered [c]_{ql} for MSD's round-to-nearest) is forward-
        transformed into each surviving channel.  int32 (nrns-1, n, B)."""
        msd = _check_encoding(encoding) == "msd"
        qs = self.qs
        p = self.params.p
        ql = qs[-1]
        v = self._crt_one(comp[-1], len(qs) - 1, inverse=True).long()
        if not msd:
            v = v * nt.modinv(p % ql, ql) % ql
        centered = torch.where(v >= (ql + 1) // 2, v - ql, v)
        qv_s = qv[:-1]
        inv_s = _channel_consts((nt.modinv(ql % q, q) for q in qs[:-1]), qv.device)
        delta = centered[None] % qv_s
        if not msd:
            delta = delta * _channel_consts((p % q for q in qs[:-1]), qv.device) % qv_s
        nd = self._ntt(delta.to(torch.int32))
        d = _submod_ch(qv_s, comp[:-1], nd)
        return (d * inv_s % qv_s).to(torch.int32)

    # --- batched encryption / decryption --------------------------------
    def _s_crt(self, sk: SK) -> torch.Tensor:
        return torch.from_numpy(_s_crt_np(self.params, sk.s_ints).astype(np.int64))

    def build_encrypt(self, sk: SK, encoding: str = "lsd"):
        """(msgs, generator) -> (c0, c1): encrypt an (n, B) batch of
        decoding-basis plaintext coefficients mod p.  c1 is uniform in the
        CRT domain and c0 = CRT(L(m + p e)) - c1 * s (LSD) or
        CRT(L(Delta [m]_p + e)) - c1 * s
        (MSD, Delta = Q // p entering as Delta mod q_i per channel), e
        rounded Gaussian of variance var."""
        msd = _check_encoding(encoding) == "msd"
        qs, p, var = self.qs, self.params.p, self.params.var
        s_crt = self._s_crt(sk).to(self.device)[..., None]
        qv = _channel_consts(qs, self.device)
        delta = self._consts(lambda q: self.ctx.basis.modulus // p % q)

        def enc(msgs: torch.Tensor, generator: torch.Generator):
            e = sampling.gaussian_ints(tuple(msgs.shape), var, generator, self.device)
            msgs = msgs.to(self.device).long()
            if msd:
                me = ((msgs % p)[None] * delta + e[None]) % qv
            else:
                me = (msgs + p * e)[None] % qv
            me_crt = self._ntt(self._l(me.to(torch.int32)))
            c1 = sampling.uniform_residues(qs, tuple(msgs.shape), generator,
                                           self.device)
            c0 = _submod_ch(qv, me_crt, _mulmod_ch(qv, c1, s_crt))
            return c0.to(torch.int32), c1

        return enc

    def _phase(self, sk: SK):
        """(c0, c1) -> the int64 (nrns, n, B) decoding-basis coefficients of
        c(s) = c0 + c1 s (a CRT Hadamard, one inverse transform per channel,
        then L^-1)."""
        s_crt = self._s_crt(sk).to(self.device)[..., None]
        qv = _channel_consts(self.qs, self.device)

        def phase(c0, c1):
            cs = _addmod_ch(qv, c0, _mulmod_ch(qv, c1, s_crt))
            return self._l(self._ntt(cs.to(torch.int32), inverse=True), inverse=True).long()

        return phase

    def build_decrypt(self, sk: SK, f: int = 1, encoding: str = "lsd"):
        """(c0, c1) -> (n, B) int32 messages mod p, times f^-1.

        LSD: the Garner centered lift of c(s) reduced mod p.  MSD: the
        exact round-half-up of p x / Q for the canonical representative x
        of c(s), without big ints: with Q odd and u = p x + (Q-1)/2,
        round(p x / Q) = (u - [u]_Q) / Q, which mod p is
        ([(Q-1)/2]_p - [[u]_Q]_p) Q^-1, where [u]_Q has u's channel
        residues and `pos_mod` gives its residue mod p."""
        msd = _check_encoding(encoding) == "msd"
        p = self.params.p
        basis = self.ctx.basis
        Q = basis.modulus
        if msd and Q % 2 == 0:
            raise ValueError("MSD decrypt's rounding identity needs odd Q "
                             "(every NTT-prime chain is)")
        phase = self._phase(sk)
        qv = _channel_consts(self.qs, self.device)
        finv = nt.modinv(f % p, p)
        half = (Q - 1) // 2
        p_res = self._consts(lambda q: p % q)
        half_res = self._consts(lambda q: half % q)
        qinv_p = nt.modinv(Q % p, p)

        def dec(c0: torch.Tensor, c1: torch.Tensor) -> torch.Tensor:
            coeff = phase(c0, c1)
            if msd:
                rem = basis.pos_mod((coeff * p_res + half_res) % qv, p)
                m = (half % p - rem) % p * qinv_p % p
            else:
                m = basis.lift_mod(coeff, p)
            return (m * finv % p).to(torch.int32)

        return dec

    # --- batched noise --------------------------------------------------
    def build_error_term(self, sk: SK):
        """(c0, c1) -> (nrns, n, B) int32 residues of the LSD noise
        e = (lift(c(s)) - centered [c(s)]_p) / p, channel by channel:
        e_i = (d_i - [mu]_{q_i}) p^-1 mod q_i, mu the centered lift mod p."""
        p = self.params.p
        basis = self.ctx.basis
        phase = self._phase(sk)
        qv = _channel_consts(self.qs, self.device)
        pinv = self._consts(lambda q: nt.modinv(p % q, q))

        def err(c0, c1):
            d = phase(c0, c1)
            mu = basis.lift_mod(d, p)
            mu = torch.where(mu >= (p + 1) // 2, mu - p, mu)
            return ((d - mu[None]) % qv * pinv % qv).to(torch.int32)

        return err

    def build_noise_bits(self, sk: SK):
        """(c0, c1) -> (B,) float32 noise budgets, log2 of max |e| over a
        ciphertext's coefficients (0 where e = 0).  |e| = min(x, Q - x)
        for the canonical representative x of e, assembled from its Garner
        digits as the JAX package does: the digit weights binned into
        70-bit groups, each group summed at its own float32 scale, and
        log2 the max over groups of log2(mag_g + mag_{g-1} 2^-70) + 70 g."""
        qs = self.qs
        basis = self.ctx.basis
        qv = _channel_consts(qs, self.device)
        err = self.build_error_term(sk)
        GB = 70  # group span in bits: group sums stay below float32's max
        groups: dict[int, list[tuple[int, float]]] = {}
        W = 1
        for j, q in enumerate(qs):
            g = (W.bit_length() - 1) // GB
            sh = max(0, W.bit_length() - 53)  # scale in the integers first
            w = math.ldexp(float(W >> sh), sh - GB * g)
            groups.setdefault(g, []).append((j, float(np.float32(w))))
            W *= q
        low = float(np.float32(2.0 ** -GB))

        def logmag(v):  # (nrns, n, B) digits -> (n, B) float32 log2 magnitude
            mags = {}
            for g, entries in groups.items():
                acc = None
                for j, w in entries:
                    t = v[j].to(torch.float32) * w
                    acc = t if acc is None else acc + t
                mags[g] = acc
            best = torch.full(v.shape[1:], -math.inf, dtype=torch.float32, device=v.device)
            for g in sorted(groups):
                tot = mags[g]
                if g - 1 in mags:
                    tot = tot + mags[g - 1] * low
                cand = torch.where(mags[g] > 0, torch.log2(tot) + float(GB * g),
                                   torch.tensor(-math.inf, device=v.device))
                best = torch.maximum(best, cand)
            return best

        def bits(c0, c1):
            e = err(c0, c1).long()
            m_pos = logmag(basis.to_mixed_radix(e))
            m_neg = logmag(basis.to_mixed_radix((-e) % qv))
            mx = torch.minimum(m_pos, m_neg).amax(dim=0)
            return torch.where(torch.isfinite(mx), mx, torch.zeros_like(mx))

        return bits

    # --- ciphertext and public-plaintext ops ----------------------------
    def build_add(self, f_a: int = 1, f_b: int = 1, sub: bool = False):
        """(c0, c1, d0, d1) -> (e0, e1): ct_a +/- ct_b for scale factors
        f_a, f_b: the second operand is scaled by the centered
        u = f_a f_b^-1 mod p, so both carry, and the output has, scale f_a.
        Either encoding."""
        p = self.params.p
        u = f_a * nt.modinv(f_b % p, p) % p
        if u >= (p + 1) // 2:
            u -= p
        u_res = self._consts(lambda q: u % q)
        qv = _channel_consts(self.qs, self.device)
        op = _submod_ch if sub else _addmod_ch

        def addf(c0, c1, d0, d1):
            if u != 1:
                d0, d1 = _scale_ch(qv, d0, u_res), _scale_ch(qv, d1, u_res)
            return op(qv, c0, d0).to(torch.int32), op(qv, c1, d1).to(torch.int32)

        return addf

    def build_add_public(self, f: int = 1, encoding: str = "lsd"):
        """(c0, c1, m_pub) -> (c0', c1): add a public plaintext, (n, B) or
        (n, 1) int coefficients mod p (one value for the whole batch),
        encoded as f m_pub (LSD) or Delta [f m_pub]_p (MSD) and added to
        c0.  An (n, 1) plaintext is transformed at batch 1, then
        broadcast, as the JAX package does."""
        msd = _check_encoding(encoding) == "msd"
        p = self.params.p
        fc = f % p
        delta = self._consts(lambda q: self.ctx.basis.modulus // p % q)
        qv = _channel_consts(self.qs, self.device)

        def addp(c0, c1, m_pub):
            sc = m_pub.to(self.device).long() % p * fc % p
            enc = (sc[None] * delta if msd else sc[None]) % qv
            enc = self._ntt(self._l(enc.to(torch.int32)))
            return _addmod_ch(qv, c0, enc).to(torch.int32), c1

        return addp

    def build_mul_public(self):
        """(c0, c1, m_pub) -> (c0', c1'): multiply by a public plaintext
        ((n, B) or (n, 1) int coefficients mod p): both components times
        the CRT transform of its centered lift.  Either encoding."""
        p = self.params.p
        qv = _channel_consts(self.qs, self.device)

        def mulp(c0, c1, m_pub):
            m = m_pub.to(self.device).long() % p
            lifted = torch.where(m >= (p + 1) // 2, m - p, m)
            w = self._ntt(self._l((lifted[None] % qv).to(torch.int32)))
            return (_mulmod_ch(qv, c0, w).to(torch.int32),
                    _mulmod_ch(qv, c1, w).to(torch.int32))

        return mulp

    def _build_scale_components(self, c: int):
        """(c0, c1) -> both components times the integer c mod Q."""
        c_res = self._consts(lambda q: c % q)
        qv = _channel_consts(self.qs, self.device)

        def scale(c0, c1):
            return _scale_ch(qv, c0, c_res), _scale_ch(qv, c1, c_res)

        return scale

    def build_to_lsd(self):
        """MSD -> LSD: components scaled by p; track f with `to_lsd_f`."""
        return self._build_scale_components(self.params.p % self.ctx.basis.modulus)

    def build_to_msd(self):
        """LSD -> MSD: components scaled by p^-1 mod Q; track f with
        `to_msd_f`."""
        Q = self.ctx.basis.modulus
        return self._build_scale_components(nt.modinv(self.params.p % Q, Q))

    def build_div_d(self, d: int):
        """Exact homomorphic division by d of plaintexts divisible by d:
        components scaled by d^-1 mod Q.  The plaintext modulus drops to
        p/d: later builders come from a pipeline over p // d; track f with
        `div_d_f`."""
        if self.params.p % d:
            raise ValueError("build_div_d: d must divide the plaintext modulus")
        Q = self.ctx.basis.modulus
        return self._build_scale_components(nt.modinv(d % Q, Q))

    def div_d_f(self, d: int, f: int) -> int:
        """Scale factor after `build_div_d`."""
        return f % (self.params.p // d)

    def to_lsd_f(self, f: int) -> int:
        """Scale factor after `build_to_lsd`."""
        p = self.params.p
        return f * ((-self.ctx.basis.modulus) % p) % p

    def to_msd_f(self, f: int) -> int:
        """Scale factor after `build_to_msd`."""
        p = self.params.p
        return f * ((-nt.modinv(self.ctx.basis.modulus % p, p)) % p) % p

    def step_f(self, fc: int = 1, fd: int = 1, encoding: str = "lsd") -> int:
        """Scale factor of build_step's output for input scales fc, fd.
        LSD: the rescale multiplies by q_last^-1 mod p.  MSD: the second
        operand is switched to LSD inside the step (factor (-Q) mod p) and
        the MSD rescale leaves f unchanged."""
        p = self.params.p
        if _check_encoding(encoding) == "msd":
            return self.to_lsd_f(fc * fd % p)
        return fc * fd * nt.modinv(self.qs[-1] % p, p) % p

    # --- modulus switch -------------------------------------------------
    def build_mod_switch(self, encoding: str = "lsd"):
        """(c0, c1) -> (e0, e1) over the chain without its last prime: the
        standalone exact BGV modulus switch.  Track the LSD scale with
        `mod_switch_f` (MSD leaves f unchanged)."""
        _check_encoding(encoding)
        qv = _channel_consts(self.qs, self.device)

        def ms(c0, c1):
            return (self._rescale_crt(c0, qv, encoding),
                    self._rescale_crt(c1, qv, encoding))

        return ms

    def mod_switch_f(self, f: int) -> int:
        """Scale factor after the LSD `build_mod_switch`."""
        p = self.params.p
        return f * nt.modinv(self.qs[-1] % p, p) % p

    # --- keygen ---------------------------------------------------------
    def _check_sk(self, sk: SK, what: str) -> None:
        """Refuse an SK of another ring or chain."""
        if sk.params.ctx != self.ctx or sk.params.qs != self.params.qs:
            raise ValueError(
                f"{what}: SK params (m={sk.params.m}, qs={sk.params.qs}) "
                f"!= pipeline params (m={self.params.m}, qs={self.params.qs})")

    def _gen_gadget_hints(self, sk: SK, targets: torch.Tensor,
                          generator: torch.Generator,
                          gadget=None) -> tuple[torch.Tensor, torch.Tensor]:
        """Gadget hints for T targets in one pass on the device: targets is
        a (T, nrns, n) CRT-domain tensor, and for target t and digit j,
        h0[t, j] = p e + g_j target_t - a s and h1[t, j] = a, with a
        uniform and e rounded Gaussian, fresh for each (t, j).  gadget: the
        g_j as integers, by default this chain's RNS gadget (the
        extended-modulus hints pass P times the base chain's).  Returns two
        (T, ell, nrns, n) int32 tensors."""
        self._check_sk(sk, "hint generation")
        qs, p, n = self.qs, self.params.p, self.ctx.n
        g_ints = gd.gadget_ints(self.ctx.basis) if gadget is None else list(gadget)
        nrns, ell = len(qs), len(g_ints)
        T = targets.shape[0]
        L = T * ell  # column l = t * ell + j
        qv = _channel_consts(qs, self.device)
        q2 = qv[..., 0]  # (nrns, 1)
        s_crt = self._s_crt(sk).to(self.device)  # (nrns, n)
        g = torch.tensor([[gi % q for q in qs] for gi in g_ints], dtype=torch.int64,
                         device=self.device)[None, :, :, None]  # (1, ell, nrns, 1)
        pe = p * sampling.gaussian_ints((n, L), self.params.var, generator, self.device)
        pe_crt = self._ntt((pe[None] % qv).to(torch.int32)).long()  # (nrns, n, L)
        pe_crt = pe_crt.view(nrns, n, T, ell).permute(2, 3, 0, 1)
        a = torch.stack([
            sampling.uniform_residues(qs, (n,), generator, self.device) for _ in range(L)
        ]).view(T, ell, nrns, n)
        gt = g * targets.to(self.device).long()[:, None] % q2
        h0 = (pe_crt + gt - a.long() * s_crt % q2) % q2
        return h0.to(torch.int32), a

    def gen_ks_quad_hint(self, sk: SK, generator: torch.Generator) -> KSHint:
        """Relinearization hint for s^2, made on the device."""
        s_crt = self._s_crt(sk).to(self.device)
        s2 = s_crt * s_crt % _channel_consts(self.qs, self.device)[..., 0]
        h0, h1 = self._gen_gadget_hints(sk, s2[None], generator)
        return KSHint(self.params, h0[0], h1[0])

    def gen_ks_linear_hint(self, s_new: SK, s_old: SK,
                           generator: torch.Generator) -> KSHint:
        """Re-encryption hint from s_old to s_new, made on the device."""
        self._check_sk(s_old, "gen_ks_linear_hint")
        h0, h1 = self._gen_gadget_hints(s_new, self._s_crt(s_old)[None], generator)
        return KSHint(self.params, h0[0], h1[0])

    # --- extended-modulus (hybrid) hints --------------------------------
    def _gen_hint_ext(self, sk_enc: SK, tgt_crt_ext: torch.Tensor,
                      special_qs: tuple[int, ...], generator: torch.Generator) -> KSHintExt:
        """Gadget encryptions of P * target over Q*P under sk_enc, with the
        BASE chain's RNS gadget: `_gen_gadget_hints` of the pipeline over
        the extended chain, its gadget P g_j.  P*t mod Q*P depends on t mod
        Q alone (P*t = 0 mod every special prime), so the targets need only
        their (nrns_ext, n) residues over the extended chain."""
        ext_qs = self.qs + tuple(special_qs)
        params_ext = replace(self.params, qs=ext_qs)
        P = math.prod(special_qs)
        h0, h1 = BatchedBGV(params_ext, self.device)._gen_gadget_hints(
            SK(params_ext, sk_enc.s_ints, sk_enc.var), tgt_crt_ext[None], generator,
            gadget=[P * g for g in gd.gadget_ints(self.ctx.basis)])
        return KSHintExt(self.params, ext_qs, len(special_qs), h0[0], h1[0])

    def _s_crt_ext(self, sk: SK, special_qs) -> torch.Tensor:
        """(nrns_ext, n) int64 CRT residues of sk over the extended chain."""
        params_ext = replace(self.params, qs=self.qs + tuple(special_qs))
        return torch.from_numpy(_s_crt_np(params_ext, sk.s_ints).astype(np.int64))

    def gen_ks_quad_hint_ext(self, sk: SK, special_qs: tuple[int, ...],
                             generator: torch.Generator) -> KSHintExt:
        """Extended-modulus relinearization hint, made on the device: gadget
        encryptions of P * s^2 over the chain Q*P (P = prod special_qs)
        with the base chain's RNS gadget; the digit inner product then runs
        over Q*P and the P-drop divides the key-switch noise by P."""
        self._check_sk(sk, "gen_ks_quad_hint_ext")
        s = self._s_crt_ext(sk, special_qs)
        qv = _channel_consts(self.qs + tuple(special_qs), "cpu")[..., 0]
        return self._gen_hint_ext(sk, s * s % qv, special_qs, generator)

    def gen_ks_linear_hint_ext(self, s_new: SK, s_old: SK, special_qs: tuple[int, ...],
                               generator: torch.Generator) -> KSHintExt:
        """Extended-modulus re-encryption hint, made on the device: gadget
        encryptions of P * s_old over Q*P under s_new, with the base
        chain's RNS gadget."""
        self._check_sk(s_new, "gen_ks_linear_hint_ext")
        self._check_sk(s_old, "gen_ks_linear_hint_ext")
        return self._gen_hint_ext(s_new, self._s_crt_ext(s_old, special_qs), special_qs,
                                  generator)

    def _ext_hint_setup(self, hint: KSHintExt) -> tuple["BatchedBGV", list["BatchedBGV"]]:
        """Checks that the hint's chain extends this one, and returns the
        pipeline over the extended chain (the digits' transforms) and the
        pipelines of the special-prime drops, over the extended prefixes
        from the longest down (each an exact LSD rescale)."""
        qs, nrns = self.qs, len(self.qs)
        ext_qs = hint.ext_qs
        if ext_qs[:nrns] != qs or nrns + hint.n_special != len(ext_qs) or hint.n_special < 1:
            raise ValueError("extended-modulus hint's chain does not extend the "
                             f"pipeline chain (ext={ext_qs}, base={qs})")
        if hint.params.m != self.params.m or hint.params.p != self.params.p:
            raise ValueError("extended-modulus hint of another ring or plaintext modulus")
        shape = (nrns, len(ext_qs), self.ctx.n)
        if hint.h0.shape != shape or hint.h1.shape != shape:
            raise ValueError(f"extended-modulus hint of shape {tuple(hint.h0.shape)} != "
                             f"(ell, nrns_ext, n) = {shape}")
        ext = BatchedBGV(replace(self.params, qs=ext_qs), self.device)
        drops = [BatchedBGV(replace(self.params, qs=ext_qs[: nrns + k]), self.device)
                 for k in range(hint.n_special, 0, -1)]
        return ext, drops

    def _check_lin(self, lin: Linear, what: str) -> None:
        if lin.r_ctx != self.ctx:
            raise ValueError(f"{what}: pipeline ring m={self.ctx.m} != the map's "
                             f"source ring m={lin.r_ctx.m}")
        if lin.s_ctx.basis != self.ctx.basis or lin.e_ctx.basis != self.ctx.basis:
            raise ValueError(f"{what}: the map's rings are over another chain")

    def gen_tunnel_hint(self, lin: Linear, sk_s: SK, sk_r: SK,
                        generator: torch.Generator) -> TunnelHint:
        """The ring-tunneling hints of lin under sk_s: hint i encrypts
        f(b_i s_R).  The targets are exact host numpy, per channel: b_i s_R
        (a CRT Hadamard with the monomial's CRT over R, back to the
        powerful basis), then f (gather, embed scatter, CRT over S and the
        Hadamard with ys); all d ell gadget hints then come from one device
        pass."""
        self._check_lin(lin, "gen_tunnel_hint")
        self._check_sk(sk_r, "gen_tunnel_hint")
        r_ctx, s_ctx, e_ctx = lin.r_ctx, lin.s_ctx, lin.e_ctx
        coeff = gen.rel_coeff_table(e_ctx.m, r_ctx.m)  # (d, n_e)
        embed = gen.embed_pow_table(e_ctx.m, s_ctx.m)  # (n_e,)
        pos = gen.rel_pow_basis_positions(e_ctx.m, r_ctx.m)  # (d,)
        d, nrns, n_r, n_s = lin.d, len(self.qs), r_ctx.n, s_ctx.n
        ys_crt = np.stack([_crt_np(s_ctx, y) for y in lin.ys]).astype(np.int64)  # (d, nrns, n_s)
        s_r = sk_r.s_ints.numpy().astype(np.int64)
        targets = np.empty((d, nrns, n_s), dtype=np.int64)
        s_crt = _crt_np(r_ctx, s_r).astype(np.int64)  # (nrns, n_r)
        mono = np.zeros((d, n_r), dtype=np.uint32)
        mono[np.arange(d), pos] = 1
        for ch, (r_gp, s_gp) in enumerate(zip(r_ctx.general_plans(), s_ctx.general_plans())):
            q = r_gp.q
            prod = gen.np_crt(r_gp, mono).astype(np.int64) * s_crt[ch] % q
            prods = gen.np_crt(r_gp, prod.astype(np.uint32), inverse=True)  # b_i s_R, pow
            emb = np.zeros((d, d, n_s), dtype=np.uint32)
            emb[..., embed] = prods[:, coeff]
            crt = gen.np_crt(s_gp, emb.reshape(d * d, n_s)).reshape(d, d, n_s)
            targets[:, ch] = (crt.astype(np.int64) * ys_crt[None, :, ch] % q).sum(1) % q
        over_s = self._over(s_ctx)
        h0, h1 = over_s._gen_gadget_hints(sk_s, torch.from_numpy(targets), generator)
        return TunnelHint(lin, tuple(KSHint(over_s.params, h0[i], h1[i])
                                     for i in range(lin.d)))

    def gen_galois_hint(self, k: int, sk: SK, generator: torch.Generator) -> KSHint:
        """The sigma_k hint, made on the device: gadget encryptions under s
        of sigma_k(s), whose CRT residues are s's, slot-permuted."""
        self._check_sk(sk, "gen_galois_hint")
        perm = zmstar.automorphism_slot_perm(self.ctx.m, self.qs[0], k)
        target = torch.from_numpy(_s_crt_np(self.params, sk.s_ints)[:, perm].astype(np.int64))
        h0, h1 = self._gen_gadget_hints(sk, target[None], generator)
        return KSHint(self.params, h0[0], h1[0])

    # --- the key switches, the step and the tunnel ----------------------
    def build_key_switch_linear(self, hint: KSHint) -> "KeySwitchLinear":
        """(c0, c1) -> (e0, e1): re-encrypt from the hint's old key to its
        new key, e0 = c0 + sum_i d_i h0_i, e1 = sum_i d_i h1_i over the
        RNS-gadget digits d_i of c1.  Either encoding."""
        return KeySwitchLinear(self, hint)

    def build_step(self, hint: KSHint, encoding: str = "lsd") -> "BGVStep":
        """(c0, c1, d0, d1) -> (e0, e1) over the dropped-prime chain:
        ct_mul + keySwitchQuadCirc + modSwitch.  MSD: the second operand
        is switched to LSD (scaled by p) before ct_mul, so the product is
        MSD, and the rescale is MSD's.  Track the output scale with
        `step_f(fc, fd, encoding)`."""
        return BGVStep(self, hint, encoding)

    def build_key_switch_linear_ext(self, hint: KSHintExt) -> "KeySwitchLinearExt":
        """(c0, c1) -> (e0, e1): re-encryption with an extended-modulus
        hint: c1's base-chain digits inner-product with the hint over Q*P,
        the special primes are dropped by exact rescales, and the result
        rejoins c0 over Q.  Either encoding."""
        return KeySwitchLinearExt(self, hint)

    def build_step_ext(self, hint: KSHintExt, encoding: str = "lsd") -> "BGVStepExt":
        """(c0, c1, d0, d1) -> (e0, e1) over the dropped-prime chain: ct_mul,
        the extended-modulus key switch of e2 (its special primes dropped by
        exact LSD rescales in both encodings: the hint term is a
        p-multiple plus the message either way), then the encoding-aware
        rescale of the base chain's last prime.  Track the output scale
        with `step_f`, as for `build_step`."""
        return BGVStepExt(self, hint, encoding)

    def build_tunnel(self, th: TunnelHint) -> "Tunnel":
        """(c0, c1) over R -> (e0, e1) over S: the fused ring tunnel."""
        return Tunnel(self, th)

    def build_galois(self, hint: KSHint, k: int) -> "Galois":
        """(c0, c1) -> (e0, e1): sigma_k of both components (a CRT slot
        permutation), then the key switch of the permuted c1 back to s
        with the sigma_k(s) hint (`gen_galois_hint`)."""
        return Galois(self, hint, k)

    def build_galois_many(self, hints: dict) -> "GaloisMany":
        """(c0, c1) -> {k: (e0_k, e1_k)}, sorted by k: hoisted rotations,
        hints {k: sigma_k(s) hint}.  One inverse transform and one digit
        stack of c1 serve every k; each rotation then costs its hint
        Hadamards and one slot gather per output component.  At 2-power m
        the outputs equal `build_galois`'s bit for bit (sigma_k commutes with
        the centered digits there); at general m the digits of sigma_k(c1)
        differ from sigma_k of c1's, so the outputs differ by keygen-grade
        randomness and decrypt the same."""
        return GaloisMany(self, hints)

    def target_pipeline(self, th: TunnelHint) -> "BatchedBGV":
        """The pipeline over the tunnel's target ring S."""
        return self._over(th.lin.s_ctx)


class KeySwitchLinear(nn.Module):
    """The RNS-gadget key switch with a hint (`build_key_switch_linear`):
    the hint and the per-channel moduli are buffers, so `.to(device)`
    moves it.  `switch` is the digit path the step shares: an inverse NTT
    per channel, each digit's re-expansion as the prologue of its forward
    NTTs, the free diagonal, and the hint inner products."""

    def __init__(self, bb: BatchedBGV, hint: KSHint):
        super().__init__()
        nrns = len(bb.qs)
        if hint.h0.shape != (nrns, nrns, bb.ctx.n) or hint.h1.shape != hint.h0.shape:
            raise ValueError(f"key switch: hint shape {tuple(hint.h0.shape)} "
                             f"!= (ell, nrns, n) = {(nrns, nrns, bb.ctx.n)}")
        self.bb = bb
        self.register_buffer("qv", _channel_consts(bb.qs, bb.device))
        self.register_buffer("h0", hint.h0.to(bb.device, torch.int64)[..., None])
        self.register_buffer("h1", hint.h1.to(bb.device, torch.int64)[..., None])

    @torch.no_grad()
    def inner_product(self, e0, e1, di, i):
        """(e0 + di h0[i], e1 + di h1[i]) mod q for digit i's CRT stack
        di: the key switch's hint inner products, int64 out."""
        di = di.long()
        return (e0 + di * self.h0[i]) % self.qv, (e1 + di * self.h1[i]) % self.qv

    @torch.no_grad()
    def switch(self, e0, e1, x):
        """(e0, e1) plus the inner products of the digits of the
        (nrns, n, B) CRT stack x with the hint; int64 out."""
        bb = self.bb
        xc = bb._ntt(x, inverse=True)
        for i in range(len(bb.qs)):
            e0, e1 = self.inner_product(e0, e1, bb._digit_crt(xc[i], i, x), i)
        return e0, e1

    @torch.no_grad()
    def forward(self, c0, c1):
        e0, e1 = self.switch(c0.long(), torch.zeros_like(c1, dtype=torch.int64), c1)
        return e0.to(torch.int32), e1.to(torch.int32)


class BGVStep(KeySwitchLinear):
    """The compiled BGV step; the hint and the per-channel moduli are
    buffers, so `.to(device)` moves the whole step."""

    def __init__(self, bb: BatchedBGV, hint: KSHint, encoding: str = "lsd"):
        super().__init__(bb, hint)
        self.encoding = _check_encoding(encoding)

    @torch.no_grad()
    def ct_mul(self, c0, c1, d0, d1):
        """(c0 + c1 s)(d0 + d1 s) as CRT Hadamards (`_ct_mul`)."""
        return _ct_mul(self.bb.qs, c0, c1, d0, d1)

    @torch.no_grad()
    def forward(self, c0, c1, d0, d1):
        bb = self.bb
        if self.encoding == "msd":  # the second operand to LSD: times p
            d0, d1 = _lsd_operand(self.qv, bb.params.p, d0, d1)
        e0, e1, e2 = self.ct_mul(c0, c1, d0, d1)
        e0, e1 = self.switch(e0, e1, e2)  # key switch e2
        return (bb._rescale_crt(e0.to(torch.int32), self.qv, self.encoding),
                bb._rescale_crt(e1.to(torch.int32), self.qv, self.encoding))


class KeySwitchLinearExt(nn.Module):
    """The extended-modulus key switch (`build_key_switch_linear_ext`):
    the hint over Q*P and both chains' moduli are buffers.  `switch` is
    the digit path the ext step shares: an inverse NTT per base channel,
    each digit re-expanded into every channel of the extended chain as the
    prologue of its forward NTT (the free diagonal in base channel i), the
    hint inner products over Q*P, then the special primes dropped."""

    def __init__(self, bb: BatchedBGV, hint: KSHintExt):
        super().__init__()
        self.bb = bb
        self.ext, self.drops = bb._ext_hint_setup(hint)
        self.register_buffer("qv", _channel_consts(bb.qs, bb.device))
        self.register_buffer("qv_ext", _channel_consts(hint.ext_qs, bb.device))
        self.register_buffer("h0", hint.h0.to(bb.device, torch.int64)[..., None])
        self.register_buffer("h1", hint.h1.to(bb.device, torch.int64)[..., None])

    @torch.no_grad()
    def switch(self, x):
        """The inner products of the base-chain digits of the (nrns, n, B)
        CRT stack x with the hint over Q*P, the special primes dropped:
        int32 (a0, a1) over Q."""
        bb, ext = self.bb, self.ext
        xc = bb._ntt(x, inverse=True)
        a0 = a1 = 0
        for i in range(len(bb.qs)):
            di = ext._digit_crt(xc[i], i, x).long()
            a0 = (a0 + di * self.h0[i]) % self.qv_ext
            a1 = (a1 + di * self.h1[i]) % self.qv_ext
        a0, a1 = a0.to(torch.int32), a1.to(torch.int32)
        for drop in self.drops:
            qv = self.qv_ext[: len(drop.qs)]
            a0, a1 = drop._rescale_crt(a0, qv), drop._rescale_crt(a1, qv)
        return a0, a1

    @torch.no_grad()
    def forward(self, c0, c1):
        a0, a1 = self.switch(c1)
        return _addmod_ch(self.qv, c0, a0).to(torch.int32), a1


class BGVStepExt(KeySwitchLinearExt):
    """The BGV step with the extended-modulus key switch
    (`build_step_ext`); `.to(device)` moves it, as the step."""

    def __init__(self, bb: BatchedBGV, hint: KSHintExt, encoding: str = "lsd"):
        super().__init__(bb, hint)
        self.encoding = _check_encoding(encoding)

    @torch.no_grad()
    def forward(self, c0, c1, d0, d1):
        bb, qv = self.bb, self.qv
        if self.encoding == "msd":  # the second operand to LSD: times p
            d0, d1 = _lsd_operand(qv, bb.params.p, d0, d1)
        e0, e1, e2 = _ct_mul(bb.qs, c0, c1, d0, d1)
        a0, a1 = self.switch(e2)
        e0, e1 = _addmod_ch(qv, e0, a0), _addmod_ch(qv, e1, a1)
        return (bb._rescale_crt(e0.to(torch.int32), qv, self.encoding),
                bb._rescale_crt(e1.to(torch.int32), qv, self.encoding))


class Tunnel(nn.Module):
    """The fused ring tunnel R -> S (`build_tunnel`); the index tables,
    the images ys (CRT over S) and the hints are buffers:

        e0 = sum_i NTT_S(embed(a0_i)) ys_i + sum_{i,j} NTT_S(embed(digit_j(a1_i))) h0_{i,j}
        e1 = sum_{i,j} NTT_S(embed(digit_j(a1_i))) h1_{i,j}

    where a_i = gather_i(iNTT_R(c)) are the relative (powerful-basis)
    coefficients over E, and NTT_S is S's CRT transform (per-ring dispatch,
    `BatchedBGV._crt_one`).  Digit j's re-expansion into channel ch runs as
    the prologue of ch's forward transform over S, into every channel, j
    included (where it is the identity; the embed scatter keeps zeros, so
    the order commutes)."""

    def __init__(self, bb: BatchedBGV, th: TunnelHint):
        super().__init__()
        lin = th.lin
        bb._check_lin(lin, "build_tunnel")
        nrns, n_s = len(bb.qs), lin.s_ctx.n
        if len(th.hints) != lin.d or any(
                h.h0.shape != (nrns, nrns, n_s) or h.h1.shape != h.h0.shape
                for h in th.hints):
            raise ValueError(f"build_tunnel: need {lin.d} hints of shape (ell, nrns, n_s) = "
                             f"{(nrns, nrns, n_s)}")
        self.bb = bb
        self.s_ctx = lin.s_ctx
        dev = bb.device
        self.register_buffer("qv", _channel_consts(bb.qs, dev))
        self.register_buffer("coeff", torch.from_numpy(
            gen.rel_coeff_table(lin.e_ctx.m, lin.r_ctx.m).copy()).to(dev))
        self.register_buffer("embed", torch.from_numpy(
            gen.embed_pow_table(lin.e_ctx.m, lin.s_ctx.m).copy()).to(dev))
        ys = np.stack([_crt_np(lin.s_ctx, y) for y in lin.ys]).astype(np.int64)
        self.register_buffer("ys", torch.from_numpy(ys).to(dev)[..., None])
        for k in ("h0", "h1"):
            self.register_buffer(k, torch.stack([getattr(h, k) for h in th.hints]).to(
                dev, torch.int64)[..., None])  # (d, ell, nrns, n_s, 1)

    def _embed(self, a: torch.Tensor) -> torch.Tensor:
        """(..., n_e, B) coefficients over E -> (..., n_s, B) over S."""
        out = a.new_zeros((*a.shape[:-2], self.s_ctx.n, a.shape[-1]))
        out[..., self.embed, :] = a
        return out

    def _ntt_s(self, x, ch, pre_digit_q=None):
        return self.bb._crt_one(x, ch, ctx=self.s_ctx, pre_digit_q=pre_digit_q)

    @torch.no_grad()
    def forward(self, c0, c1):
        bb, qv = self.bb, self.qv
        nrns = len(bb.qs)
        c0p, c1p = bb._ntt(c0, inverse=True), bb._ntt(c1, inverse=True)
        e0 = e1 = 0
        for i, rows in enumerate(self.coeff):
            a0 = self._embed(c0p[:, rows, :])
            t0 = torch.stack([self._ntt_s(a0[ch], ch) for ch in range(nrns)])
            e0 = (e0 + t0.long() * self.ys[i]) % qv
            a1 = self._embed(c1p[:, rows, :])
            for j, qj in enumerate(bb.qs):
                dj = torch.stack([self._ntt_s(a1[j], ch, pre_digit_q=qj)
                                  for ch in range(nrns)]).long()
                e0 = (e0 + dj * self.h0[i, j]) % qv
                e1 = (e1 + dj * self.h1[i, j]) % qv
        return e0.to(torch.int32), e1.to(torch.int32)


class Galois(KeySwitchLinear):
    """The batched Galois automorphism sigma_k (`build_galois`): the
    hint, the moduli and the slot permutation are buffers.  Both
    components are gathered by the permutation, and the key switch of
    `KeySwitchLinear` takes the permuted c1 back to s."""

    def __init__(self, bb: BatchedBGV, hint: KSHint, k: int):
        super().__init__(bb, hint)
        self.register_buffer("perm", torch.from_numpy(
            zmstar.automorphism_slot_perm(bb.ctx.m, bb.qs[0], k)).to(bb.device))

    @torch.no_grad()
    def forward(self, c0, c1):
        return super().forward(c0.index_select(1, self.perm), c1.index_select(1, self.perm))


class GaloisMany(nn.Module):
    """Hoisted Galois automorphisms (`build_galois_many`): per k, the hint
    tables pre-permuted by sigma_k^-1 on the host and the slot permutation
    are buffers, so e_k = sigma_k(c + sum_i d_i sigma_k^-1(h_i)) runs on
    the digits d_i of c1, made once for all k (slot permutations commute
    with the pointwise products)."""

    def __init__(self, bb: BatchedBGV, hints: dict):
        super().__init__()
        nrns = len(bb.qs)
        self.bb = bb
        self.ks = tuple(sorted(hints))
        self.register_buffer("qv", _channel_consts(bb.qs, bb.device))
        for k in self.ks:
            h = hints[k]
            if h.h0.shape != (nrns, nrns, bb.ctx.n) or h.h1.shape != h.h0.shape:
                raise ValueError(f"galois: hint {k} of shape {tuple(h.h0.shape)} "
                                 f"!= (ell, nrns, n) = {(nrns, nrns, bb.ctx.n)}")
            perm = zmstar.automorphism_slot_perm(bb.ctx.m, bb.qs[0], k)
            inv = torch.from_numpy(np.argsort(perm))
            self.register_buffer(f"perm_{k}", torch.from_numpy(perm).to(bb.device))
            for name in ("h0", "h1"):
                self.register_buffer(f"{name}_{k}", getattr(h, name).to(torch.int64)[
                    :, :, inv].to(bb.device)[..., None])  # (ell, nrns, n, 1)

    @torch.no_grad()
    def forward(self, c0, c1):
        bb, qv = self.bb, self.qv
        xc = bb._ntt(c1, inverse=True)
        digits = [bb._digit_crt(xc[i], i, c1).long() for i in range(len(bb.qs))]
        outs = {}
        for k in self.ks:
            h0, h1 = getattr(self, f"h0_{k}"), getattr(self, f"h1_{k}")
            e0, e1 = c0.long(), 0
            for i, di in enumerate(digits):
                e0 = (e0 + di * h0[i]) % qv
                e1 = (e1 + di * h1[i]) % qv
            perm = getattr(self, f"perm_{k}")
            outs[k] = (e0.to(torch.int32).index_select(1, perm),
                       e1.to(torch.int32).index_select(1, perm))
        return outs
