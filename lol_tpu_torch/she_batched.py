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
exact rescales, which divides the key-switch noise by P).  Hints for T
targets come from one device pass (`_gen_gadget_hints`).  Every result is
bit-identical to `lol_tpu.she_batched.BatchedBGV(params, use_pallas=False)`
(the noise budget, float32, to its rounding).

Meshes: every builder that computes on ciphertexts takes `mesh=`, a
`parallel.sharding.Mesh` with axes 'rns' and 'data'.  Its inputs and
outputs are then `sharding.shard_batch_rns` blocks (np object arrays):
the channels over 'rns' where R divides the chain's length, else
data-only blocks (`sharding.rns_rows`).  A mesh module keeps one part per
block, the builder's own module over a pipeline view of the block's
channels (`BatchedBGV(..., chans=)`) on the block's device, with its
constants on that device from build time.  The parts run the same
arithmetic as the unsharded module, with the reference's placement of
the cross-channel reads: the inverse-transformed component is gathered
(`sharding.rns_gather`) before the digit re-expansion, each digit's
forward transforms and hint products run on the channel's own block, and
the rescale's dropped channel is gathered before the other channels read
it; the output is moved into the rule's layout (`rns_relayout`).  The
extended chain's special primes ride with the last rns row.  So
`unshard_batch_rns` of a mesh output equals the unsharded output bit for
bit.
"""

from __future__ import annotations

import math
from dataclasses import replace

import numpy as np
import torch
from torch import nn

from . import gadget as gd
from . import numtheory as nt
from . import prng, sampling, zmstar, zq
from .linear import Linear
from .ops import general as gen
from .ops import ntt as ntt_mod
from .ops.cuda.ntt_kernel import ntt_cm
from .ops.cuda.pointwise import ct_mul_cm
from .parallel import sharding as sh
from .ring import RingContext
from . import she
from .she import KSHint, KSHintExt, SHEParams, SK, TunnelHint

ENCODINGS = ("lsd", "msd")


def _check_encoding(encoding: str) -> str:
    if encoding not in ENCODINGS:
        raise ValueError(f"encoding must be 'lsd' or 'msd', got {encoding!r}")
    return encoding


def _check_rns_gadget(*specs) -> None:
    """The pipeline's key switches take RNS-gadget hints only (their
    digits are the forward kernels' prologue); the object path
    (`she.key_switch_*`) takes the others."""
    for spec in specs:
        if not isinstance(spec, gd.RnsGad):
            raise ValueError(f"BatchedBGV: RNS-gadget hints only, got a {spec} hint "
                             "(the object path in `she` takes any gadget)")


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
    unless the caller names another).  chans: the channels this pipeline
    holds, a range of the chain (all by default); a mesh block's view
    holds its block's, and its stacks have len(chans) channels."""

    def __init__(self, params: SHEParams, device="cuda", chans: range | None = None):
        self.params = params
        self.device = torch.device(device)
        self.ctx = params.ctx
        self.qs = params.qs
        self.chans = range(len(self.qs)) if chans is None else chans
        self.cqs = tuple(self.qs[c] for c in self.chans)
        self._rescale_k = {}  # device -> the rescale's constants

    def _view(self, chans: range, device) -> "BatchedBGV":
        """This pipeline over the channels chans on device."""
        return BatchedBGV(self.params, device, chans)

    def plans(self) -> list[ntt_mod.NTTPlan]:
        """The NTT plans of a 2-power ring (raises at general m)."""
        return self.ctx.ntt_plans()

    def _over(self, ctx: RingContext) -> "BatchedBGV":
        """The pipeline over ring ctx with this one's p, chain and device."""
        return BatchedBGV(replace(self.params, m=ctx.m), self.device)

    def _consts(self, fn) -> torch.Tensor:
        """(len(chans), 1, 1) int64 constants fn(q) of this pipeline's
        channels on the device."""
        return _channel_consts((fn(q) for q in self.cqs), self.device)

    # --- layout ---------------------------------------------------------
    def pack(self, cts: list["she.CT"]) -> tuple[torch.Tensor, torch.Tensor]:
        """List of degree-1 object-path ciphertexts -> two (nrns, n, B)
        int32 tensors of their CRT components on the device."""
        return tuple(torch.stack([ct.cs[k].to_crt().data.to(self.device) for ct in cts], dim=-1)
                     for k in range(2))

    def unpack(self, arrs, f: int = 1, encoding: str = "lsd") -> list["she.CT"]:
        """Two (nrns, n, B) component tensors -> the list of B object-path
        ciphertexts (CRT components on the tensors' device) with scale f
        and the encoding."""
        from .cyc import Cyc, Rep

        return [she.CT(self.params, self.ctx, tuple(Cyc(self.ctx, Rep.CRT, a[..., b].contiguous())
                                                    for a in arrs), f=f, encoding=encoding)
                for b in range(arrs[0].shape[-1])]

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
        """(len(chans), n, B) per-channel CRT transform (named for the
        2-power pipeline; it dispatches per ring)."""
        return torch.stack(
            [self._crt_one(x[k], self.chans[k], inverse, ctx=ctx) for k in range(x.shape[0])]
        )

    def _l(self, x, inverse=False):
        """(len(chans), n, B) per-channel L / L^-1 (decoding <-> powerful
        basis), int32; the identity at 2-power m, where the bases coincide."""
        if self.ctx.fm.is_pow2():
            return x
        gps = self.ctx.general_plans()
        return torch.stack([gen.l_cm(gps[self.chans[k]], x[k], inverse)
                            for k in range(x.shape[0])])

    def _digit_crt(self, src_i, i, known_crt):
        """Digit i's CRT stack over this pipeline's channels, from the
        coefficient-domain channel src_i = iNTT(x)[i]: channel j's
        re-expansion runs as the prologue of its forward NTT.  Channel i
        itself, where this pipeline holds it, is known_crt's (the free
        diagonal: iNTT then NTT round-trips exactly)."""
        return torch.stack([
            known_crt[k] if j == i
            else self._crt_one(src_i, j, pre_digit_q=self.qs[i])
            for k, j in enumerate(self.chans)
        ])

    def _rescale_consts(self, device):
        """The rescale's per-channel constants over this pipeline's
        surviving channels, on device, made once: the moduli, ql^-1 and p
        (for LSD), each (k, 1, 1) int64."""
        key = torch.device(device)
        if key not in self._rescale_k:
            ql = self.qs[-1]
            surv = [q for c, q in zip(self.chans, self.cqs) if c < len(self.qs) - 1]
            self._rescale_k[key] = tuple(
                _channel_consts(vals, key) for vals in (
                    surv, [nt.modinv(ql % q, q) for q in surv],
                    [self.params.p % q for q in surv]))
        return self._rescale_k[key]

    def _rescale_v(self, last: torch.Tensor, encoding: str = "lsd") -> torch.Tensor:
        """The rescale's read of the dropped channel: its (n, B) CRT
        residues inverse-transformed, times p^-1 mod ql for LSD; int32 in
        [0, ql).  On a mesh it is gathered to every block of its column."""
        ql = self.qs[-1]
        v = self._crt_one(last, len(self.qs) - 1, inverse=True)
        if _check_encoding(encoding) == "msd":
            return v
        return (v.long() * nt.modinv(self.params.p % ql, ql) % ql).to(torch.int32)

    def _rescale_apply(self, comp: torch.Tensor, v: torch.Tensor,
                       encoding: str = "lsd") -> torch.Tensor:
        """The rescale of this pipeline's channels of comp but the dropped
        one, given the dropped channel's read v (`_rescale_v`): the
        correction delta (p * centered v for LSD, centered v for MSD's
        round-to-nearest) is forward-transformed into each surviving
        channel, subtracted, and the difference times ql^-1.  int32."""
        msd = _check_encoding(encoding) == "msd"
        qv_s, inv_s, p_s = self._rescale_consts(comp.device)
        k = qv_s.shape[0]
        if k == 0:
            return comp[:0].clone()
        ql = self.qs[-1]
        v = v.long()
        centered = torch.where(v >= (ql + 1) // 2, v - ql, v)
        delta = centered[None] % qv_s
        if not msd:
            delta = delta * p_s % qv_s
        delta = delta.to(torch.int32)
        nd = torch.stack([self._crt_one(delta[t], self.chans[t]) for t in range(k)])
        d = _submod_ch(qv_s, comp[:k], nd)
        return (d * inv_s % qv_s).to(torch.int32)

    def _rescale_crt(self, comp: torch.Tensor, encoding: str = "lsd") -> torch.Tensor:
        """Exact BGV drop-last rescale of one (nrns, n, B) component in the
        CRT domain: only the dropped channel is inverse-transformed; the
        correction is forward-transformed into each surviving channel.
        int32 (nrns-1, n, B)."""
        return self._rescale_apply(comp, self._rescale_v(comp[-1], encoding), encoding)

    # --- batched encryption / decryption --------------------------------
    def _s_crt(self, sk: SK) -> torch.Tensor:
        return torch.from_numpy(_s_crt_np(self.params, sk.s_ints).astype(np.int64))

    def build_encrypt(self, sk: SK, encoding: str = "lsd"):
        """(msgs, key) -> (c0, c1): encrypt an (n, B) batch of
        decoding-basis plaintext coefficients mod p.  c1 is uniform in the
        CRT domain and c0 = CRT(L(m + p e)) - c1 * s (LSD) or
        CRT(L(Delta [m]_p + e)) - c1 * s
        (MSD, Delta = Q // p entering as Delta mod q_i per channel), e
        rounded Gaussian of variance var.  The key splits as the reference's
        does: e from the first subkey, c1's channel i from subkey i + 1."""
        msd = _check_encoding(encoding) == "msd"
        qs, p, var = self.qs, self.params.p, self.params.var
        s_crt = self._s_crt(sk).to(self.device)[..., None]
        qv = _channel_consts(qs, self.device)
        delta = self._consts(lambda q: self.ctx.basis.modulus // p % q)

        def enc(msgs: torch.Tensor, key):
            k_e, *k_u = prng.split(key, 1 + len(qs))
            e = sampling.gaussian_ints(tuple(msgs.shape), var, k_e, self.device)
            msgs = msgs.to(self.device).long()
            if msd:
                me = ((msgs % p)[None] * delta + e[None]) % qv
            else:
                me = (msgs + p * e)[None] % qv
            me_crt = self._ntt(self._l(me.to(torch.int32)))
            c1 = prng.randint_channels(k_u, qs, tuple(msgs.shape), self.device)
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
    def build_add(self, f_a: int = 1, f_b: int = 1, sub: bool = False, mesh=None):
        """(c0, c1, d0, d1) -> (e0, e1): ct_a +/- ct_b for scale factors
        f_a, f_b: the second operand is scaled by the centered
        u = f_a f_b^-1 mod p, so both carry, and the output has, scale f_a.
        Either encoding.  mesh: per block (module docstring)."""
        if mesh is not None:
            return _Blocks(mesh, self).blockwise(lambda v: v.build_add(f_a, f_b, sub))
        p = self.params.p
        u = f_a * nt.modinv(f_b % p, p) % p
        if u >= (p + 1) // 2:
            u -= p
        u_res = self._consts(lambda q: u % q)
        qv = self._consts(lambda q: q)
        op = _submod_ch if sub else _addmod_ch

        def addf(c0, c1, d0, d1):
            if u != 1:
                d0, d1 = _scale_ch(qv, d0, u_res), _scale_ch(qv, d1, u_res)
            return op(qv, c0, d0).to(torch.int32), op(qv, c1, d1).to(torch.int32)

        return addf

    def build_add_public(self, f: int = 1, encoding: str = "lsd", mesh=None):
        """(c0, c1, m_pub) -> (c0', c1): add a public plaintext, (n, B) or
        (n, 1) int coefficients mod p (one value for the whole batch),
        encoded as f m_pub (LSD) or Delta [f m_pub]_p (MSD) and added to
        c0.  An (n, 1) plaintext is transformed at batch 1, then
        broadcast, as the JAX package does.  mesh: per block, an (n, B)
        plaintext split as the batch."""
        if mesh is not None:
            return _Blocks(mesh, self).blockwise(lambda v: v.build_add_public(f, encoding))
        msd = _check_encoding(encoding) == "msd"
        p = self.params.p
        fc = f % p
        delta = self._consts(lambda q: self.ctx.basis.modulus // p % q)
        qv = self._consts(lambda q: q)

        def addp(c0, c1, m_pub):
            sc = m_pub.to(self.device).long() % p * fc % p
            enc = (sc[None] * delta if msd else sc[None]) % qv
            enc = self._ntt(self._l(enc.to(torch.int32)))
            return _addmod_ch(qv, c0, enc).to(torch.int32), c1

        return addp

    def build_mul_public(self, mesh=None):
        """(c0, c1, m_pub) -> (c0', c1'): multiply by a public plaintext
        ((n, B) or (n, 1) int coefficients mod p): both components times
        the CRT transform of its centered lift.  Either encoding.  mesh: as
        `build_add_public`."""
        if mesh is not None:
            return _Blocks(mesh, self).blockwise(lambda v: v.build_mul_public())
        p = self.params.p
        qv = self._consts(lambda q: q)

        def mulp(c0, c1, m_pub):
            m = m_pub.to(self.device).long() % p
            lifted = torch.where(m >= (p + 1) // 2, m - p, m)
            w = self._ntt(self._l((lifted[None] % qv).to(torch.int32)))
            return (_mulmod_ch(qv, c0, w).to(torch.int32),
                    _mulmod_ch(qv, c1, w).to(torch.int32))

        return mulp

    def _build_scale_components(self, c: int, mesh=None):
        """(c0, c1) -> both components times the integer c mod Q."""
        if mesh is not None:
            return _Blocks(mesh, self).blockwise(lambda v: v._build_scale_components(c))
        c_res = self._consts(lambda q: c % q)
        qv = self._consts(lambda q: q)

        def scale(c0, c1):
            return _scale_ch(qv, c0, c_res), _scale_ch(qv, c1, c_res)

        return scale

    def build_to_lsd(self, mesh=None):
        """MSD -> LSD: components scaled by p; track f with `to_lsd_f`."""
        return self._build_scale_components(self.params.p % self.ctx.basis.modulus, mesh)

    def build_to_msd(self, mesh=None):
        """LSD -> MSD: components scaled by p^-1 mod Q; track f with
        `to_msd_f`."""
        Q = self.ctx.basis.modulus
        return self._build_scale_components(nt.modinv(self.params.p % Q, Q), mesh)

    def build_div_d(self, d: int, mesh=None):
        """Exact homomorphic division by d of plaintexts divisible by d:
        components scaled by d^-1 mod Q.  The plaintext modulus drops to
        p/d: later builders come from a pipeline over p // d; track f with
        `div_d_f`."""
        if self.params.p % d:
            raise ValueError("build_div_d: d must divide the plaintext modulus")
        Q = self.ctx.basis.modulus
        return self._build_scale_components(nt.modinv(d % Q, Q), mesh)

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
    def build_mod_switch(self, encoding: str = "lsd", mesh=None):
        """(c0, c1) -> (e0, e1) over the chain without its last prime: the
        standalone exact BGV modulus switch.  Track the LSD scale with
        `mod_switch_f` (MSD leaves f unchanged).  mesh: the dropped
        channel gathered, the output in the shorter chain's layout."""
        _check_encoding(encoding)
        if mesh is not None:
            blocks = _Blocks(mesh, self)
            views = blocks.build(lambda view: view)
            for view in views.flat:
                view._rescale_consts(view.device)

            def ms_mesh(c0, c1):
                blocks.check(c0, c1)
                return blocks.rescale(views, c0, encoding), blocks.rescale(views, c1, encoding)

            return ms_mesh
        self._rescale_consts(self.device)

        def ms(c0, c1):
            return self._rescale_crt(c0, encoding), self._rescale_crt(c1, encoding)

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
                          key,
                          gadget=None) -> tuple[torch.Tensor, torch.Tensor]:
        """Gadget hints for T targets in one pass on the device: targets is
        a (T, nrns, n) CRT-domain tensor, and for target t and digit j,
        h0[t, j] = p e + g_j target_t - a s and h1[t, j] = a, with a
        uniform and e rounded Gaussian, fresh for each (t, j): as the
        reference draws them, e over (n, T ell) from the key's first
        subkey and a's channel i over (n, T ell) from subkey i + 1, column
        t ell + j holding (t, j).  gadget: the
        g_j as integers, by default this chain's RNS gadget (the
        extended-modulus hints pass P times the base chain's).  Returns two
        (T, ell, nrns, n) int32 tensors."""
        self._check_sk(sk, "hint generation")
        qs, p, n = self.qs, self.params.p, self.ctx.n
        g_ints = gd.gadget_ints(gd.RnsGad(), self.ctx.basis) if gadget is None else list(gadget)
        nrns, ell = len(qs), len(g_ints)
        T = targets.shape[0]
        L = T * ell  # column l = t * ell + j
        qv = _channel_consts(qs, self.device)
        q2 = qv[..., 0]  # (nrns, 1)
        s_crt = self._s_crt(sk).to(self.device)  # (nrns, n)
        g = torch.tensor([[gi % q for q in qs] for gi in g_ints], dtype=torch.int64,
                         device=self.device)[None, :, :, None]  # (1, ell, nrns, 1)
        k_e, *k_a = prng.split(key, 1 + nrns)
        pe = p * sampling.gaussian_ints((n, L), self.params.var, k_e, self.device, how="f64")
        pe_crt = self._ntt((pe[None] % qv).to(torch.int32)).long()  # (nrns, n, L)
        pe_crt = pe_crt.view(nrns, n, T, ell).permute(2, 3, 0, 1)
        a = prng.randint_channels(k_a, qs, (n, L), self.device)
        a = a.view(nrns, n, T, ell).permute(2, 3, 0, 1).contiguous()
        gt = g * targets.to(self.device).long()[:, None] % q2
        h0 = (pe_crt + gt - a.long() * s_crt % q2) % q2
        return h0.to(torch.int32), a

    def gen_ks_quad_hint(self, sk: SK, key) -> KSHint:
        """Relinearization hint for s^2, made on the device."""
        s_crt = self._s_crt(sk).to(self.device)
        s2 = s_crt * s_crt % _channel_consts(self.qs, self.device)[..., 0]
        h0, h1 = self._gen_gadget_hints(sk, s2[None], key)
        return KSHint(self.params, h0[0], h1[0])

    def gen_ks_linear_hint(self, s_new: SK, s_old: SK,
                           key) -> KSHint:
        """Re-encryption hint from s_old to s_new, made on the device."""
        self._check_sk(s_old, "gen_ks_linear_hint")
        h0, h1 = self._gen_gadget_hints(s_new, self._s_crt(s_old)[None], key)
        return KSHint(self.params, h0[0], h1[0])

    # --- extended-modulus (hybrid) hints --------------------------------
    def _gen_hint_ext(self, sk_enc: SK, tgt_crt_ext: torch.Tensor,
                      special_qs: tuple[int, ...], key) -> KSHintExt:
        """Gadget encryptions of P * target over Q*P under sk_enc, with the
        BASE chain's RNS gadget: `_gen_gadget_hints` of the pipeline over
        the extended chain, its gadget P g_j.  P*t mod Q*P depends on t mod
        Q alone (P*t = 0 mod every special prime), so the targets need only
        their (nrns_ext, n) residues over the extended chain."""
        ext_qs = self.qs + tuple(special_qs)
        params_ext = replace(self.params, qs=ext_qs)
        P = math.prod(special_qs)
        h0, h1 = BatchedBGV(params_ext, self.device)._gen_gadget_hints(
            SK(params_ext, sk_enc.s_ints, sk_enc.var), tgt_crt_ext[None], key,
            gadget=[P * g for g in gd.gadget_ints(gd.RnsGad(), self.ctx.basis)])
        return KSHintExt(self.params, ext_qs, len(special_qs), h0[0], h1[0])

    def _s_crt_ext(self, sk: SK, special_qs) -> torch.Tensor:
        """(nrns_ext, n) int64 CRT residues of sk over the extended chain."""
        params_ext = replace(self.params, qs=self.qs + tuple(special_qs))
        return torch.from_numpy(_s_crt_np(params_ext, sk.s_ints).astype(np.int64))

    def gen_ks_quad_hint_ext(self, sk: SK, special_qs: tuple[int, ...],
                             key) -> KSHintExt:
        """Extended-modulus relinearization hint, made on the device: gadget
        encryptions of P * s^2 over the chain Q*P (P = prod special_qs)
        with the base chain's RNS gadget; the digit inner product then runs
        over Q*P and the P-drop divides the key-switch noise by P."""
        self._check_sk(sk, "gen_ks_quad_hint_ext")
        s = self._s_crt_ext(sk, special_qs)
        qv = _channel_consts(self.qs + tuple(special_qs), "cpu")[..., 0]
        return self._gen_hint_ext(sk, s * s % qv, special_qs, key)

    def gen_ks_linear_hint_ext(self, s_new: SK, s_old: SK, special_qs: tuple[int, ...],
                               key) -> KSHintExt:
        """Extended-modulus re-encryption hint, made on the device: gadget
        encryptions of P * s_old over Q*P under s_new, with the base
        chain's RNS gadget."""
        self._check_sk(s_new, "gen_ks_linear_hint_ext")
        self._check_sk(s_old, "gen_ks_linear_hint_ext")
        return self._gen_hint_ext(s_new, self._s_crt_ext(s_old, special_qs), special_qs,
                                  key)

    def _ext_hint_setup(self, hint: KSHintExt) -> tuple["BatchedBGV", list["BatchedBGV"]]:
        """Checks that the hint's chain extends this one, and returns the
        pipeline over the extended chain (the digits' transforms) and the
        pipelines of the special-prime drops, over the extended prefixes
        from the longest down (each an exact LSD rescale).  A view that
        holds the chain's last channel also holds the special primes (on a
        mesh they ride with the last rns row); the others hold their own."""
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
        lo, hi = self.chans.start, self.chans.stop
        hi_ext = hi + hint.n_special if hi == nrns else hi
        ext = BatchedBGV(replace(self.params, qs=ext_qs), self.device, range(lo, hi_ext))
        drops = [BatchedBGV(replace(self.params, qs=ext_qs[: nrns + k]), self.device,
                            range(lo, min(hi_ext, nrns + k)))
                 for k in range(hint.n_special, 0, -1)]
        return ext, drops

    def _check_lin(self, lin: Linear, what: str) -> None:
        if lin.r_ctx != self.ctx:
            raise ValueError(f"{what}: pipeline ring m={self.ctx.m} != the map's "
                             f"source ring m={lin.r_ctx.m}")
        if lin.s_ctx.basis != self.ctx.basis or lin.e_ctx.basis != self.ctx.basis:
            raise ValueError(f"{what}: the map's rings are over another chain")

    def gen_tunnel_hint(self, lin: Linear, sk_s: SK, sk_r: SK,
                        key) -> TunnelHint:
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
        h0, h1 = over_s._gen_gadget_hints(sk_s, torch.from_numpy(targets), key)
        return TunnelHint(lin, tuple(KSHint(over_s.params, h0[i], h1[i])
                                     for i in range(lin.d)))

    def gen_galois_hint(self, k: int, sk: SK, key) -> KSHint:
        """The sigma_k hint, made on the device: gadget encryptions under s
        of sigma_k(s), whose CRT residues are s's, slot-permuted."""
        self._check_sk(sk, "gen_galois_hint")
        perm = zmstar.automorphism_slot_perm(self.ctx.m, self.qs[0], k)
        target = torch.from_numpy(_s_crt_np(self.params, sk.s_ints)[:, perm].astype(np.int64))
        h0, h1 = self._gen_gadget_hints(sk, target[None], key)
        return KSHint(self.params, h0[0], h1[0])


    # --- the key switches, the step and the tunnel ----------------------
    def _module(self, cls, mesh, *args) -> nn.Module:
        """cls(self, *args), or over a mesh a `Sharded` module of one cls
        part per block."""
        if mesh is None:
            return cls(self, *args)
        blocks = _Blocks(mesh, self)
        return Sharded(blocks, blocks.build(lambda view: cls(view, *args)))

    def build_key_switch_linear(self, hint: KSHint, mesh=None) -> nn.Module:
        """(c0, c1) -> (e0, e1): re-encrypt from the hint's old key to its
        new key, e0 = c0 + sum_i d_i h0_i, e1 = sum_i d_i h1_i over the
        RNS-gadget digits d_i of c1.  Either encoding.  mesh: a `Sharded`
        module over `shard_batch_rns` blocks (module docstring)."""
        return self._module(KeySwitchLinear, mesh, hint)

    def build_step(self, hint: KSHint, encoding: str = "lsd", mesh=None) -> nn.Module:
        """(c0, c1, d0, d1) -> (e0, e1) over the dropped-prime chain:
        ct_mul + keySwitchQuadCirc + modSwitch.  MSD: the second operand
        is switched to LSD (scaled by p) before ct_mul, so the product is
        MSD, and the rescale is MSD's.  Track the output scale with
        `step_f(fc, fd, encoding)`.  mesh: as `build_key_switch_linear`;
        the output in the shorter chain's layout."""
        return self._module(BGVStep, mesh, hint, encoding)

    def build_key_switch_linear_ext(self, hint: KSHintExt, mesh=None) -> nn.Module:
        """(c0, c1) -> (e0, e1): re-encryption with an extended-modulus
        hint: c1's base-chain digits inner-product with the hint over Q*P,
        the special primes are dropped by exact rescales, and the result
        rejoins c0 over Q.  Either encoding.  mesh: as
        `build_key_switch_linear`; the special primes with the last rns row."""
        return self._module(KeySwitchLinearExt, mesh, hint)

    def build_step_ext(self, hint: KSHintExt, encoding: str = "lsd", mesh=None) -> nn.Module:
        """(c0, c1, d0, d1) -> (e0, e1) over the dropped-prime chain: ct_mul,
        the extended-modulus key switch of e2 (its special primes dropped by
        exact LSD rescales in both encodings: the hint term is a
        p-multiple plus the message either way), then the encoding-aware
        rescale of the base chain's last prime.  Track the output scale
        with `step_f`, as for `build_step`.  mesh: as `build_step`."""
        return self._module(BGVStepExt, mesh, hint, encoding)

    def build_tunnel(self, th: TunnelHint, mesh=None) -> nn.Module:
        """(c0, c1) over R -> (e0, e1) over S: the fused ring tunnel.  mesh:
        as `build_key_switch_linear` (S has the same chain, so the same
        layout)."""
        return self._module(Tunnel, mesh, th)

    def build_galois(self, hint: KSHint, k: int, mesh=None) -> nn.Module:
        """(c0, c1) -> (e0, e1): sigma_k of both components (a CRT slot
        permutation), then the key switch of the permuted c1 back to s
        with the sigma_k(s) hint (`gen_galois_hint`).  mesh: as
        `build_key_switch_linear`."""
        return self._module(Galois, mesh, hint, k)

    def build_galois_many(self, hints: dict, mesh=None) -> nn.Module:
        """(c0, c1) -> {k: (e0_k, e1_k)}, sorted by k: hoisted rotations,
        hints {k: sigma_k(s) hint}.  One inverse transform and one digit
        stack of c1 serve every k; each rotation then costs its hint
        Hadamards and one slot gather per output component.  At 2-power m
        the outputs equal `build_galois`'s bit for bit (sigma_k commutes with
        the centered digits there); at general m the digits of sigma_k(c1)
        differ from sigma_k of c1's, so the outputs differ by keygen-grade
        randomness and decrypt the same.  mesh: as
        `build_key_switch_linear`, each output a pair of block arrays."""
        return self._module(GaloisMany, mesh, hints)

    def target_pipeline(self, th: TunnelHint) -> "BatchedBGV":
        """The pipeline over the tunnel's target ring S."""
        return self._over(th.lin.s_ctx)


def _i32(*ts) -> tuple[torch.Tensor, ...]:
    return tuple(t.to(torch.int32) for t in ts)


class _Blocks:
    """The blocks of a pipeline's stacks on an rns x data mesh, in
    `sharding.shard_batch_rns`'s layout: each block's device and channel
    range, and the steps a mesh module runs between its parts' stages
    (the gathers, the rescale)."""

    def __init__(self, mesh: sh.Mesh, bb: BatchedBGV):
        if bb.chans != range(len(bb.qs)):
            raise ValueError("a mesh builder takes the pipeline of the whole chain")
        self.mesh, self.bb = mesh, bb
        rows = sh.rns_rows(mesh, len(bb.qs))
        self.devices = sh.rns_data_grid(mesh)[:rows]
        per = len(bb.qs) // rows
        self.chans = [range(i * per, (i + 1) * per) for i in range(rows)]

    @property
    def rows(self) -> int:
        return self.devices.shape[0]

    def build(self, make) -> np.ndarray:
        """make(view) for each block's view of the pipeline (its channels,
        on its device)."""
        out = np.empty(self.devices.shape, dtype=object)
        for (i, j), dev in np.ndenumerate(self.devices):
            out[i, j] = make(self.bb._view(self.chans[i], dev))
        return out

    def check(self, *arrays) -> None:
        """Refuse inputs that are not blocks of this layout."""
        for a in arrays:
            if not isinstance(a, np.ndarray) or a.shape != self.devices.shape:
                raise ValueError(
                    f"mesh input: need a {self.devices.shape} object array of blocks "
                    f"(sharding.shard_batch_rns), got {type(a).__name__} "
                    f"{getattr(a, 'shape', '')}")
            for (i, j), t in np.ndenumerate(a):
                if t.device != self.devices[i, j] or t.shape[0] != len(self.chans[i]):
                    raise ValueError(
                        f"mesh input block ({i}, {j}): {t.shape[0]} channels on {t.device}, "
                        f"want {len(self.chans[i])} on {self.devices[i, j]}")

    def map(self, fn, *arrays):
        """fn over the blocks, out[i, j] = fn(*(a[i, j] for a in arrays));
        a tuple result gives a tuple of block arrays."""
        out = None
        for (i, j), _ in np.ndenumerate(self.devices):
            r = fn(*(a[i, j] for a in arrays))
            rs = r if isinstance(r, tuple) else (r,)
            if out is None:
                out = [np.empty(self.devices.shape, dtype=object) for _ in rs]
            for o, x in zip(out, rs):
                o[i, j] = x
        return tuple(out) if isinstance(r, tuple) else out[0]

    def gather(self, blocks: np.ndarray) -> np.ndarray:
        """Each data column's full channel stack on every block of the
        column (`sharding.rns_gather`); data-only blocks hold theirs."""
        return blocks if self.rows == 1 else sh.rns_gather(self.mesh, blocks)

    def rescale(self, views: np.ndarray, comps: np.ndarray, encoding: str,
                relayout: bool = True) -> np.ndarray:
        """The drop-last rescale of a component held as blocks, by the
        blocks' pipeline views: the dropped channel's read (`_rescale_v`)
        on the last row's block, gathered to every block of its column,
        then each block's surviving channels (`_rescale_apply`); the result
        in the shorter chain's layout (`sharding.rns_relayout`), or as it
        falls (the special-prime drops, whose rows keep their channels)."""
        last = self.rows - 1
        v = np.empty((1, self.devices.shape[1]), dtype=object)
        for j in range(v.shape[1]):
            v[0, j] = views[last, j]._rescale_v(comps[last, j][-1], encoding)[None]
        v = self.gather(v)
        out = self.map(lambda bb, c, w: bb._rescale_apply(c, w[0], encoding), views, comps, v)
        return sh.rns_relayout(self.mesh, out) if relayout else out

    def blockwise(self, make):
        """An elementwise builder made per block (make(view)): its inputs
        are blocks, or public plaintexts as (n, B) tensors (split as the
        batch) or (n, 1) ones (every block's); its outputs are blocks."""
        fns = self.build(make)

        def run(*args):
            blocks = [a for a in args if isinstance(a, np.ndarray)]
            self.check(*blocks)
            offs = np.cumsum([0] + [b.shape[-1] for b in blocks[0][0]])

            def as_blocks(a):
                if isinstance(a, np.ndarray):
                    return a
                if a.shape[-1] not in (1, offs[-1]):
                    raise ValueError(f"mesh: a plaintext of {a.shape[-1]} columns, the "
                                     f"blocks hold {offs[-1]}")
                out = np.empty(self.devices.shape, dtype=object)
                for (i, j), _ in np.ndenumerate(out):
                    out[i, j] = a if a.shape[-1] == 1 else a[..., offs[j]:offs[j + 1]]
                return out

            return self.map(lambda fn, *xs: fn(*xs), fns, *(as_blocks(a) for a in args))

        return run


class Sharded(nn.Module):
    """A builder's module over an rns x data mesh: one part per block (the
    builder's module over the block's pipeline view, its buffers on the
    block's device, made at build time) in `grid`; forward takes and gives
    `sharding.shard_batch_rns` blocks, run by the part class's `sharded`
    between the gathers.  Its parts stay on their devices: do not `.to()`
    it."""

    def __init__(self, blocks: _Blocks, parts: np.ndarray):
        super().__init__()
        self.blocks = blocks
        self.grid = parts
        self.parts = nn.ModuleList(list(parts.flat))

    @torch.no_grad()
    def forward(self, *args):
        self.blocks.check(*args)
        return type(self.grid[0, 0]).sharded(self.blocks, self.grid, *args)


class KeySwitchLinear(nn.Module):
    """The RNS-gadget key switch with a hint (`build_key_switch_linear`):
    the hint and the per-channel moduli of the pipeline's channels are
    buffers, so `.to(device)` moves it.  Its digit path, which the step
    and the rotations share: an inverse NTT per channel, then `digits`
    (on a mesh, on the gathered inverse): each digit's re-expansion as
    the prologue of its forward NTTs, the free diagonal, and the hint
    inner products."""

    def __init__(self, bb: BatchedBGV, hint: KSHint):
        super().__init__()
        _check_rns_gadget(hint.spec)
        nrns = len(bb.qs)
        if hint.h0.shape != (nrns, nrns, bb.ctx.n) or hint.h1.shape != hint.h0.shape:
            raise ValueError(f"key switch: hint shape {tuple(hint.h0.shape)} "
                             f"!= (ell, nrns, n) = {(nrns, nrns, bb.ctx.n)}")
        self.bb = bb
        lo, hi = bb.chans.start, bb.chans.stop
        self.register_buffer("qv", bb._consts(lambda q: q))
        self.register_buffer("h0", hint.h0[:, lo:hi].to(bb.device, torch.int64)[..., None])
        self.register_buffer("h1", hint.h1[:, lo:hi].to(bb.device, torch.int64)[..., None])

    @torch.no_grad()
    def inner_product(self, e0, e1, di, i):
        """(e0 + di h0[i], e1 + di h1[i]) mod q for digit i's CRT stack
        di: the key switch's hint inner products, int64 out."""
        di = di.long()
        return (e0 + di * self.h0[i]) % self.qv, (e1 + di * self.h1[i]) % self.qv

    @torch.no_grad()
    def digits(self, e0, e1, xc, x):
        """(e0, e1) plus the inner products of x's digits with the hint:
        xc is iNTT(x) over every channel of the chain (on a mesh, the
        gathered stack), x the pipeline's channels of the CRT stack; int64
        out."""
        for i in range(len(self.bb.qs)):
            e0, e1 = self.inner_product(e0, e1, self.bb._digit_crt(xc[i], i, x), i)
        return e0, e1

    @torch.no_grad()
    def forward(self, c0, c1):
        return _i32(*self.digits(c0.long(), torch.zeros_like(c1, dtype=torch.int64),
                                 self.bb._ntt(c1, inverse=True), c1))

    @staticmethod
    def sharded(blocks: _Blocks, parts: np.ndarray, c0, c1):
        xc = blocks.gather(blocks.map(lambda k, c: k.bb._ntt(c, inverse=True), parts, c1))
        return blocks.map(lambda k, a, b, f: _i32(*k.digits(
            a.long(), torch.zeros_like(b, dtype=torch.int64), f, b)), parts, c0, c1, xc)


class BGVStep(KeySwitchLinear):
    """The compiled BGV step; the hint and the per-channel moduli are
    buffers, so `.to(device)` moves the whole step."""

    def __init__(self, bb: BatchedBGV, hint: KSHint, encoding: str = "lsd"):
        super().__init__(bb, hint)
        self.encoding = _check_encoding(encoding)
        bb._rescale_consts(bb.device)

    @torch.no_grad()
    def ct_mul(self, c0, c1, d0, d1):
        """(c0 + c1 s)(d0 + d1 s) as CRT Hadamards (`_ct_mul`)."""
        return _ct_mul(self.bb.cqs, c0, c1, d0, d1)

    @torch.no_grad()
    def front(self, c0, c1, d0, d1):
        """The step up to the key switch's digits: (e0, e1, e2, iNTT(e2)).
        MSD: the second operand to LSD (times p) first."""
        if self.encoding == "msd":
            d0, d1 = _lsd_operand(self.qv, self.bb.params.p, d0, d1)
        e0, e1, e2 = self.ct_mul(c0, c1, d0, d1)
        return e0, e1, e2, self.bb._ntt(e2, inverse=True)

    @torch.no_grad()
    def forward(self, c0, c1, d0, d1):
        bb = self.bb
        e0, e1, e2, xc = self.front(c0, c1, d0, d1)
        e0, e1 = self.digits(e0, e1, xc, e2)  # key switch e2
        return (bb._rescale_crt(e0.to(torch.int32), self.encoding),
                bb._rescale_crt(e1.to(torch.int32), self.encoding))

    @staticmethod
    def sharded(blocks: _Blocks, parts: np.ndarray, c0, c1, d0, d1):
        e0, e1, e2, xc = blocks.map(lambda k, *a: k.front(*a), parts, c0, c1, d0, d1)
        e0, e1 = blocks.map(lambda k, a, b, f, x: _i32(*k.digits(a, b, f, x)),
                            parts, e0, e1, blocks.gather(xc), e2)
        views, enc = blocks.map(lambda k: k.bb, parts), parts[0, 0].encoding
        return blocks.rescale(views, e0, enc), blocks.rescale(views, e1, enc)


class KeySwitchLinearExt(nn.Module):
    """The extended-modulus key switch (`build_key_switch_linear_ext`):
    the hint over Q*P and both chains' moduli are buffers.  Its digit path,
    which the ext step shares: an inverse NTT per base channel, each digit
    re-expanded into every channel of the extended chain as the prologue
    of its forward NTT (the free diagonal in base channel i), the hint
    inner products over Q*P (`digits`), then the special primes dropped
    (`drop_specials`)."""

    def __init__(self, bb: BatchedBGV, hint: KSHintExt):
        super().__init__()
        _check_rns_gadget(hint.spec)
        self.bb = bb
        self.ext, self.drops = bb._ext_hint_setup(hint)
        lo, hi = self.ext.chans.start, self.ext.chans.stop
        self.register_buffer("qv", bb._consts(lambda q: q))
        self.register_buffer("qv_ext", self.ext._consts(lambda q: q))
        self.register_buffer("h0", hint.h0[:, lo:hi].to(bb.device, torch.int64)[..., None])
        self.register_buffer("h1", hint.h1[:, lo:hi].to(bb.device, torch.int64)[..., None])
        for drop in self.drops:
            drop._rescale_consts(bb.device)

    @torch.no_grad()
    def digits(self, xc, x):
        """The inner products over Q*P of the base-chain digits of x with
        the hint, over the extended pipeline's channels: xc is iNTT(x) over
        every base channel (on a mesh, gathered), x the pipeline's channels
        of the CRT stack; int32 (a0, a1)."""
        ext = self.ext
        a0 = a1 = 0
        for i in range(len(self.bb.qs)):
            di = ext._digit_crt(xc[i], i, x).long()
            a0 = (a0 + di * self.h0[i]) % self.qv_ext
            a1 = (a1 + di * self.h1[i]) % self.qv_ext
        return a0.to(torch.int32), a1.to(torch.int32)

    @torch.no_grad()
    def drop_specials(self, a0, a1):
        """The special primes dropped by exact LSD rescales: int32 over Q."""
        for drop in self.drops:
            a0, a1 = drop._rescale_crt(a0), drop._rescale_crt(a1)
        return a0, a1

    @torch.no_grad()
    def forward(self, c0, c1):
        a0, a1 = self.drop_specials(*self.digits(self.bb._ntt(c1, inverse=True), c1))
        return _addmod_ch(self.qv, c0, a0).to(torch.int32), a1

    @staticmethod
    def _sharded_switch(blocks: _Blocks, parts: np.ndarray, xc, x):
        """The digit path over a mesh, from the blocks' inverse xc: the
        digits on the gathered inverse, then each drop's rescale over the
        blocks (the special primes are on the last row)."""
        a0, a1 = blocks.map(lambda k, f, y: k.digits(f, y), parts, blocks.gather(xc), x)
        for t in range(len(parts[0, 0].drops)):
            drops = blocks.map(lambda k: k.drops[t], parts)
            a0 = blocks.rescale(drops, a0, "lsd", relayout=False)
            a1 = blocks.rescale(drops, a1, "lsd", relayout=False)
        return a0, a1

    @staticmethod
    def sharded(blocks: _Blocks, parts: np.ndarray, c0, c1):
        xc = blocks.map(lambda k, c: k.bb._ntt(c, inverse=True), parts, c1)
        a0, a1 = KeySwitchLinearExt._sharded_switch(blocks, parts, xc, c1)
        return blocks.map(lambda k, c, a, b: (_addmod_ch(k.qv, c, a).to(torch.int32), b),
                          parts, c0, a0, a1)


class BGVStepExt(KeySwitchLinearExt):
    """The BGV step with the extended-modulus key switch
    (`build_step_ext`); `.to(device)` moves it, as the step."""

    def __init__(self, bb: BatchedBGV, hint: KSHintExt, encoding: str = "lsd"):
        super().__init__(bb, hint)
        self.encoding = _check_encoding(encoding)
        bb._rescale_consts(bb.device)

    @torch.no_grad()
    def front(self, c0, c1, d0, d1):
        """(e0, e1, e2, iNTT(e2)), as `BGVStep.front`."""
        if self.encoding == "msd":  # the second operand to LSD: times p
            d0, d1 = _lsd_operand(self.qv, self.bb.params.p, d0, d1)
        e0, e1, e2 = _ct_mul(self.bb.cqs, c0, c1, d0, d1)
        return e0, e1, e2, self.bb._ntt(e2, inverse=True)

    @torch.no_grad()
    def forward(self, c0, c1, d0, d1):
        bb, qv = self.bb, self.qv
        e0, e1, e2, xc = self.front(c0, c1, d0, d1)
        a0, a1 = self.drop_specials(*self.digits(xc, e2))
        e0, e1 = _addmod_ch(qv, e0, a0), _addmod_ch(qv, e1, a1)
        return (bb._rescale_crt(e0.to(torch.int32), self.encoding),
                bb._rescale_crt(e1.to(torch.int32), self.encoding))

    @staticmethod
    def sharded(blocks: _Blocks, parts: np.ndarray, c0, c1, d0, d1):
        e0, e1, e2, xc = blocks.map(lambda k, *a: k.front(*a), parts, c0, c1, d0, d1)
        a0, a1 = KeySwitchLinearExt._sharded_switch(blocks, parts, xc, e2)
        e0, e1 = blocks.map(lambda k, a, b, x, y: _i32(_addmod_ch(k.qv, a, x),
                                                        _addmod_ch(k.qv, b, y)),
                            parts, e0, e1, a0, a1)
        views, enc = blocks.map(lambda k: k.bb, parts), parts[0, 0].encoding
        return blocks.rescale(views, e0, enc), blocks.rescale(views, e1, enc)


class Tunnel(nn.Module):
    """The fused ring tunnel R -> S (`build_tunnel`); the index tables,
    the images ys (CRT over S) and the hints of the pipeline's channels
    are buffers:

        e0 = sum_i NTT_S(embed(a0_i)) ys_i + sum_{i,j} NTT_S(embed(digit_j(a1_i))) h0_{i,j}
        e1 = sum_{i,j} NTT_S(embed(digit_j(a1_i))) h1_{i,j}

    where a_i = gather_i(iNTT_R(c)) are the relative (powerful-basis)
    coefficients over E, and NTT_S is S's CRT transform (per-ring dispatch,
    `BatchedBGV._crt_one`).  Digit j's re-expansion into channel ch runs as
    the prologue of ch's forward transform over S, into every channel, j
    included (where it is the identity; the embed scatter keeps zeros, so
    the order commutes).  e0's channel ch reads iNTT_R(c0)'s channel ch
    alone; the digits read every channel of iNTT_R(c1), which a mesh
    gathers."""

    def __init__(self, bb: BatchedBGV, th: TunnelHint):
        super().__init__()
        lin = th.lin
        bb._check_lin(lin, "build_tunnel")
        _check_rns_gadget(th.spec, *(h.spec for h in th.hints))
        nrns, n_s = len(bb.qs), lin.s_ctx.n
        if len(th.hints) != lin.d or any(
                h.h0.shape != (nrns, nrns, n_s) or h.h1.shape != h.h0.shape
                for h in th.hints):
            raise ValueError(f"build_tunnel: need {lin.d} hints of shape (ell, nrns, n_s) = "
                             f"{(nrns, nrns, n_s)}")
        self.bb = bb
        self.s_ctx = lin.s_ctx
        dev = bb.device
        lo, hi = bb.chans.start, bb.chans.stop
        self.register_buffer("qv", bb._consts(lambda q: q))
        self.register_buffer("coeff", torch.from_numpy(
            gen.rel_coeff_table(lin.e_ctx.m, lin.r_ctx.m).copy()).to(dev))
        self.register_buffer("embed", torch.from_numpy(
            gen.embed_pow_table(lin.e_ctx.m, lin.s_ctx.m).copy()).to(dev))
        ys = np.stack([_crt_np(lin.s_ctx, y)[lo:hi] for y in lin.ys]).astype(np.int64)
        self.register_buffer("ys", torch.from_numpy(ys).to(dev)[..., None])
        for k in ("h0", "h1"):
            self.register_buffer(k, torch.stack([getattr(h, k)[:, lo:hi] for h in th.hints]).to(
                dev, torch.int64)[..., None])  # (d, ell, len(chans), n_s, 1)

    def _embed(self, a: torch.Tensor) -> torch.Tensor:
        """(..., n_e, B) coefficients over E -> (..., n_s, B) over S."""
        out = a.new_zeros((*a.shape[:-2], self.s_ctx.n, a.shape[-1]))
        out[..., self.embed, :] = a
        return out

    def _ntt_s(self, x, ch, pre_digit_q=None):
        return self.bb._crt_one(x, ch, ctx=self.s_ctx, pre_digit_q=pre_digit_q)

    @torch.no_grad()
    def combine(self, c0p, c1p):
        """The tunnel's output from the inverse-transformed components:
        c0p over the pipeline's channels, c1p over every channel."""
        bb, qv = self.bb, self.qv
        e0 = e1 = 0
        for i, rows in enumerate(self.coeff):
            a0 = self._embed(c0p[:, rows, :])
            t0 = torch.stack([self._ntt_s(a0[k], ch) for k, ch in enumerate(bb.chans)])
            e0 = (e0 + t0.long() * self.ys[i]) % qv
            a1 = self._embed(c1p[:, rows, :])
            for j, qj in enumerate(bb.qs):
                dj = torch.stack([self._ntt_s(a1[j], ch, pre_digit_q=qj)
                                  for ch in bb.chans]).long()
                e0 = (e0 + dj * self.h0[i, j]) % qv
                e1 = (e1 + dj * self.h1[i, j]) % qv
        return e0.to(torch.int32), e1.to(torch.int32)

    @torch.no_grad()
    def forward(self, c0, c1):
        return self.combine(self.bb._ntt(c0, inverse=True), self.bb._ntt(c1, inverse=True))

    @staticmethod
    def sharded(blocks: _Blocks, parts: np.ndarray, c0, c1):
        c0p, c1p = blocks.map(lambda k, a, b: (k.bb._ntt(a, inverse=True),
                                               k.bb._ntt(b, inverse=True)), parts, c0, c1)
        return blocks.map(lambda k, a, f: k.combine(a, f), parts, c0p, blocks.gather(c1p))


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

    @staticmethod
    def sharded(blocks: _Blocks, parts: np.ndarray, c0, c1):
        c0k, c1k = blocks.map(lambda k, a, b: (a.index_select(1, k.perm),
                                               b.index_select(1, k.perm)), parts, c0, c1)
        return KeySwitchLinear.sharded(blocks, parts, c0k, c1k)


class GaloisMany(nn.Module):
    """Hoisted Galois automorphisms (`build_galois_many`): per k, the hint
    tables pre-permuted by sigma_k^-1 on the host and the slot permutation
    are buffers, so e_k = sigma_k(c + sum_i d_i sigma_k^-1(h_i)) runs on
    the digits d_i of c1, made once for all k (slot permutations commute
    with the pointwise products)."""

    def __init__(self, bb: BatchedBGV, hints: dict):
        super().__init__()
        _check_rns_gadget(*(h.spec for h in hints.values()))
        nrns = len(bb.qs)
        self.bb = bb
        self.ks = tuple(sorted(hints))
        lo, hi = bb.chans.start, bb.chans.stop
        self.register_buffer("qv", bb._consts(lambda q: q))
        for k in self.ks:
            h = hints[k]
            if h.h0.shape != (nrns, nrns, bb.ctx.n) or h.h1.shape != h.h0.shape:
                raise ValueError(f"galois: hint {k} of shape {tuple(h.h0.shape)} "
                                 f"!= (ell, nrns, n) = {(nrns, nrns, bb.ctx.n)}")
            perm = zmstar.automorphism_slot_perm(bb.ctx.m, bb.qs[0], k)
            inv = torch.from_numpy(np.argsort(perm))
            self.register_buffer(f"perm_{k}", torch.from_numpy(perm).to(bb.device))
            for name in ("h0", "h1"):
                self.register_buffer(f"{name}_{k}", getattr(h, name)[:, lo:hi].to(torch.int64)[
                    :, :, inv].to(bb.device)[..., None])  # (ell, len(chans), n, 1)

    @torch.no_grad()
    def rotations(self, c0, c1, xc):
        """{k: (e0_k, e1_k)} from c1's inverse xc over every channel (on a
        mesh, gathered)."""
        bb, qv = self.bb, self.qv
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

    @torch.no_grad()
    def forward(self, c0, c1):
        return self.rotations(c0, c1, self.bb._ntt(c1, inverse=True))

    @staticmethod
    def sharded(blocks: _Blocks, parts: np.ndarray, c0, c1):
        xc = blocks.gather(blocks.map(lambda k, b: k.bb._ntt(b, inverse=True), parts, c1))
        outs = blocks.map(lambda k, a, b, f: k.rotations(a, b, f), parts, c0, c1, xc)
        return {k: blocks.map(lambda o: o[k], outs) for k in parts[0, 0].ks}
