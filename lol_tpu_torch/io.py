"""Serialization: keys, ciphertexts, linear maps and hints to and from the
wire messages of `proto/lol.proto`.

Counterpart of `lol_tpu/io.py` (Lol's `Protoable`), and the port's
checkpoint / resume story: keys, ciphertexts, key-switch and tunnel hints
and HomomPRF's `EvalHints` are generated once per key, saved, and
reloaded by every serving process.  The messages are `proto.wire`'s (no
protobuf runtime), and their bytes are the JAX package's: each package
reads what the other writes.

    msg = io.eval_hints_to_proto(hints)
    data = msg.SerializeToString()
    hints = io.eval_hints_from_proto(pb.EvalHints.FromString(data))   # on the card

An `Rq` holds an element's (nrns, n) residues as little-endian u32 in the
representation the element holds; a CRT-rep element's slots are in the
bit-reversed-exponent order both packages share.  A `KSHint`'s rows are
its (ell, nrns, n) CRT stacks, one `Rq` a row.  Every `*_from_proto`
takes `device`, by default the card (`device="cpu"` for the plain
versions); an `SK` keeps its integer coefficients on the host whatever
the device, as every `SK` of the port does.  Reading a row in another
representation than CRT converts it on that device (the NTT kernels on a
card).
"""

from __future__ import annotations

import numpy as np
import torch

from . import gadget as gd
from .cyc import Cyc, Rep
from .linear import Linear, linear_pow
from .prf import EvalHints
from .proto import wire as pb
from .ring import RingContext, ring_context
from .she import CT, KSHint, KSHintExt, PTRoundHints, SHEParams, SK, TunnelHint


def _device(device) -> torch.device:
    return torch.device("cuda" if device is None else device)


# --- Rq (mod-q ring elements) -------------------------------------------------


def _rq(ctx: RingContext, rep: str, residues: np.ndarray) -> pb.Rq:
    return pb.Rq(m=ctx.m, qs=list(ctx.basis.qs), rep=rep,
                 coeffs=residues.astype("<u4").tobytes())


def cyc_to_proto(c: Cyc) -> pb.Rq:
    """One element, (nrns, n) residues, in the representation it holds."""
    if c.data.dim() != 2:
        raise ValueError("cyc_to_proto: single elements only (nrns, n)")
    return _rq(c.ctx, c.rep.value, c.data.cpu().numpy())


def _residues(msg: pb.Rq) -> tuple[RingContext, np.ndarray]:
    ctx = ring_context(int(msg.m), tuple(int(q) for q in msg.qs))
    arr = np.frombuffer(msg.coeffs, dtype="<u4")
    if arr.size != ctx.nrns * ctx.n:
        raise ValueError(f"Rq: {arr.size} residues, the ring holds {ctx.nrns} x {ctx.n}")
    arr = arr.reshape(ctx.nrns, ctx.n)
    if (arr >= np.array(ctx.basis.qs, dtype=np.uint64)[:, None]).any():
        raise ValueError("Rq: a residue at or above its modulus")
    return ctx, arr


def cyc_from_proto(msg: pb.Rq, device=None) -> Cyc:
    ctx, arr = _residues(msg)
    return Cyc(ctx, Rep(msg.rep), torch.from_numpy(arr.astype(np.int32)).to(_device(device)))


# --- R (integer ring elements) ------------------------------------------------


def ints_to_proto(m: int, coeffs, rep: str = "dec") -> pb.R:
    if isinstance(coeffs, torch.Tensor):
        coeffs = coeffs.cpu().numpy()
    return pb.R(m=m, rep=rep, coeffs=np.asarray(coeffs).reshape(-1).tolist())


def ints_from_proto(msg: pb.R) -> np.ndarray:
    return np.array([int(v) for v in msg.coeffs], dtype=np.int64)


# --- SHE objects --------------------------------------------------------------


def sk_to_proto(sk: SK) -> pb.SecretKey:
    return pb.SecretKey(m=sk.params.m, p=sk.params.p, qs=list(sk.params.qs), var=sk.var,
                        s=ints_to_proto(sk.params.m, sk.s_ints))


def sk_from_proto(msg: pb.SecretKey, device=None) -> SK:
    params = SHEParams(m=int(msg.m), p=int(msg.p), qs=tuple(int(q) for q in msg.qs),
                       var=float(msg.var))
    return SK(params, torch.from_numpy(ints_from_proto(msg.s)), float(msg.var))


def ct_to_proto(ct: CT) -> pb.SHECiphertext:
    return pb.SHECiphertext(m=ct.ctx.m, qs=list(ct.ctx.basis.qs), p=ct.params.p, f=ct.f,
                            cs=[cyc_to_proto(c) for c in ct.cs], encoding=ct.encoding)


def ct_from_proto(msg: pb.SHECiphertext, device=None) -> CT:
    params = SHEParams(m=int(msg.m), p=int(msg.p), qs=tuple(int(q) for q in msg.qs))
    cs = tuple(cyc_from_proto(c, device) for c in msg.cs)
    return CT(params, params.ctx, cs, f=int(msg.f), encoding=msg.encoding or "lsd")


def linear_to_proto(lin: Linear) -> pb.LinearRq:
    """The images as powerful-basis elements of S, as the reference builds
    them (`Cyc.from_ints`)."""
    return pb.LinearRq(e=lin.e_ctx.m, r=lin.r_ctx.m, s=lin.s_ctx.m, ys=[
        cyc_to_proto(Cyc.from_ints(lin.s_ctx, y, device="cpu")) for y in lin.ys])


def linear_from_proto(msg: pb.LinearRq, device=None) -> Linear:
    """The images' centered powerful-basis coefficients (an image in
    another representation is converted on `device`)."""
    ys = [cyc_from_proto(y, device) for y in msg.ys]
    qs = ys[0].ctx.basis.qs
    return linear_pow(*(ring_context(int(m), qs) for m in (msg.e, msg.r, msg.s)),
                      [np.array(y.lift_ints(rep=Rep.POW), dtype=np.int64) for y in ys])


# --- key-switch and tunnel hints (Lol Protoable KSHint / TunnelHint) ----------


def _gad_to_str(spec: gd.GadgetSpec) -> str:
    if isinstance(spec, gd.TrivGad):
        return "triv"
    if isinstance(spec, gd.BaseBGad):
        return f"base:{spec.b}"
    if isinstance(spec, gd.RnsGad):
        return "rns"
    raise ValueError(f"unknown gadget spec {spec!r}")


def _gad_from_str(s: str) -> gd.GadgetSpec:
    if s == "triv":
        return gd.TrivGad()
    if s == "rns":
        return gd.RnsGad()
    if s.startswith("base:"):
        return gd.BaseBGad(int(s.split(":", 1)[1]))
    raise ValueError(f"unknown gadget string {s!r}")


def _rows_to_proto(ctx: RingContext, stack: torch.Tensor) -> list[pb.Rq]:
    """An (ell, nrns, n) CRT stack as one `Rq` a row."""
    arr = stack.cpu().numpy()
    return [_rq(ctx, Rep.CRT.value, arr[j]) for j in range(arr.shape[0])]


def _rows_from_proto(rows, ctx: RingContext, device) -> torch.Tensor:
    """`Rq` rows over ctx as an (ell, nrns, n) CRT stack on device."""
    out = []
    for r in rows:
        c = cyc_from_proto(r, device)
        if c.ctx != ctx:
            raise ValueError(f"hint row over {c.ctx}, the hint is over {ctx}")
        out.append(c.to_crt().data)
    return torch.stack(out)


def ks_hint_to_proto(h: KSHint) -> pb.KSHint:
    return pb.KSHint(m=h.ctx.m, qs=list(h.ctx.basis.qs), p=h.params.p, var=h.params.var,
                     gad=_gad_to_str(h.spec), h0=_rows_to_proto(h.ctx, h.h0),
                     h1=_rows_to_proto(h.ctx, h.h1))


def ks_hint_from_proto(msg: pb.KSHint, device=None) -> KSHint:
    params = SHEParams(m=int(msg.m), p=int(msg.p), qs=tuple(int(q) for q in msg.qs),
                       var=float(msg.var))
    dev = _device(device)
    return KSHint(params, _rows_from_proto(msg.h0, params.ctx, dev),
                  _rows_from_proto(msg.h1, params.ctx, dev), _gad_from_str(msg.gad))


def ks_hint_ext_to_proto(h: KSHintExt) -> pb.KSHintExt:
    base = h.params.qs
    return pb.KSHintExt(m=h.params.m, qs=list(base), special_qs=list(h.ext_qs[len(base):]),
                        p=h.params.p, var=h.params.var, gad=_gad_to_str(h.spec),
                        h0=_rows_to_proto(h.ctx_ext, h.h0), h1=_rows_to_proto(h.ctx_ext, h.h1))


def ks_hint_ext_from_proto(msg: pb.KSHintExt, device=None) -> KSHintExt:
    base = tuple(int(q) for q in msg.qs)
    special = tuple(int(q) for q in msg.special_qs)
    params = SHEParams(m=int(msg.m), p=int(msg.p), qs=base, var=float(msg.var))
    ctx_ext, dev = ring_context(params.m, base + special), _device(device)
    return KSHintExt(params, base + special, len(special),
                     _rows_from_proto(msg.h0, ctx_ext, dev),
                     _rows_from_proto(msg.h1, ctx_ext, dev), _gad_from_str(msg.gad))


def tunnel_hint_to_proto(th: TunnelHint) -> pb.TunnelHint:
    return pb.TunnelHint(lin=linear_to_proto(th.lin), gad=_gad_to_str(th.spec),
                         hints=[ks_hint_to_proto(h) for h in th.hints])


def tunnel_hint_from_proto(msg: pb.TunnelHint, device=None) -> TunnelHint:
    return TunnelHint(linear_from_proto(msg.lin, device),
                      tuple(ks_hint_from_proto(h, device) for h in msg.hints),
                      _gad_from_str(msg.gad))


# --- hint bundles (the aggregates a serving deployment checkpoints) ----------


def pt_round_hints_to_proto(rh: PTRoundHints) -> pb.PTRoundHints:
    return pb.PTRoundHints(hints=[ks_hint_to_proto(h) for h in rh.hints])


def pt_round_hints_from_proto(msg: pb.PTRoundHints, device=None) -> PTRoundHints:
    return PTRoundHints(tuple(ks_hint_from_proto(h, device) for h in msg.hints))


def eval_hints_to_proto(eh: EvalHints) -> pb.EvalHints:
    """`rounds` is written only where the bundle has the rounding hints."""
    return pb.EvalHints(tunnels=[tunnel_hint_to_proto(t) for t in eh.tunnels],
                        p_final=eh.p_final,
                        rounds=None if eh.rounds is None else pt_round_hints_to_proto(eh.rounds))


def eval_hints_from_proto(msg: pb.EvalHints, device=None) -> EvalHints:
    return EvalHints(tuple(tunnel_hint_from_proto(t, device) for t in msg.tunnels),
                     int(msg.p_final),
                     pt_round_hints_from_proto(msg.rounds, device)
                     if msg.HasField("rounds") else None)
