"""Carry state across from the JAX package as numpy arrays.

The JAX package's keys, hints and packed ciphertexts become the port's
objects, so both sides compute on identical state:

    sk_from_numpy(params, sk.s_ints)
    c = cyc_from_numpy(ctx, x.rep.value, np.asarray(x.data))      # a Cyc
    ct = ct_from_numpy(params, [(c.rep.value, np.asarray(c.data)) for c in jct.cs],
                       jct.f, jct.encoding)                          # an object CT
    rep, data = cyc_to_numpy(c);  cs, f, encoding = ct_to_numpy(ct)
    hint_from_numpy(params, np.stack([np.asarray(h.data) for h in hint.h0]),
                            np.stack([np.asarray(h.data) for h in hint.h1]))
    hint_from_numpy(params, h0, h1, spec=BaseBGad(2))  # another gadget's hint
    cts_from_numpy(*bb.pack(cts))
    lin = linear_from_numpy(qs, f.e_ctx.m, f.r_ctx.m, f.s_ctx.m,
                            [y.lift_ints(rep=Rep.POW) for y in f.ys])
    tunnel_hint_from_numpy(params_s, lin, h0, h1)  # h0[i, j] = th.hints[i].h0[j].data
    shards = ring_shards_from_numpy(x, mesh)          # x: (..., n), ring-sharded
    x = ring_shards_to_numpy(shards, batch=x.shape[:-1])
    ext = hint_ext_from_numpy(params, ext_qs, n_special, h0, h1)  # a KSHintExt
    fam = prf_family_from_numpy(m, p, b, tree, [a.lift_ints(rep=Rep.POW) for a in jfam.a0],
                                [a.lift_ints(rep=Rep.POW) for a in jfam.a1])
    rh = pt_round_hints_from_numpy(params, [(h0_i, h1_i), ...])  # hint i at qs[:L0 - i]
    hints = eval_hints_from_numpy(params, [(m_e, m_r, m_s, ys, h0, h1), ...], p_final,
                                  rounds=[(h0_i, h1_i), ...])

They work at any m (a general-m `Linear`'s ys are powerful-basis
coefficients, as `lift_ints(rep=Rep.POW)` gives them).  A ciphertext's
ring is its params' (the reference keeps them equal); a hint's gadget is
named by the port's spec of the same gadget.  Like the port's other
entry points they place their tensors on the card unless the caller
names another device.
"""

from __future__ import annotations

from dataclasses import replace

import numpy as np
import torch

from . import zq
from .cyc import Cyc, Rep
from .gadget import BaseBGad, GadgetSpec, RnsGad
from .linear import Linear, linear_pow
from .parallel import sharding
from .prf import EvalHints, PRFFamily, Tree
from .ring import RingContext, ring_context
from .she import CT, KSHint, KSHintExt, PTRoundHints, SHEParams, SK, TunnelHint


def _residues(x, device) -> torch.Tensor:
    """u32 residue array (values < 2^30) -> int32 tensor on device."""
    a = np.asarray(x)
    if a.size and (int(a.min()) < 0 or int(a.max()) >= 1 << zq.MAX_MODULUS_BITS):
        raise ValueError("residues must lie in [0, 2^30)")
    return torch.from_numpy(a.astype(np.int32)).to(device)


def sk_from_numpy(params: SHEParams, s_ints) -> SK:
    """Secret key from its (n,) integer coefficients."""
    s = torch.from_numpy(np.asarray(s_ints, dtype=np.int64).copy())
    if s.shape != (params.ctx.n,):
        raise ValueError(f"sk_from_numpy: shape {tuple(s.shape)} != ({params.ctx.n},)")
    return SK(params, s, params.var)


def hint_from_numpy(params: SHEParams, h0, h1, device="cuda",
                    spec: GadgetSpec = RnsGad()) -> KSHint:
    """Key-switch hint from (ell, nrns, n) CRT residue arrays."""
    return KSHint(params, _residues(h0, device), _residues(h1, device), spec)


def cyc_from_numpy(ctx: RingContext, rep: str, data, device="cuda") -> Cyc:
    """A ring element from its representation's name ("pow", "dec" or
    "crt") and its (..., nrns, n) residue array."""
    return Cyc(ctx, Rep(rep), _residues(data, device))


def cyc_to_numpy(c: Cyc) -> tuple[str, np.ndarray]:
    """(the representation's name, the (..., nrns, n) u32 residues)."""
    return c.rep.value, c.data.cpu().numpy().astype(np.uint32)


def ct_from_numpy(params: SHEParams, cs, f: int = 1, encoding: str = "lsd",
                  device="cuda") -> CT:
    """An object-path ciphertext over params' ring from its components,
    [(rep, (nrns, n) residues), ...] as `cyc_to_numpy` gives them."""
    ctx = params.ctx
    return CT(params, ctx, tuple(cyc_from_numpy(ctx, r, d, device) for r, d in cs), f, encoding)


def ct_to_numpy(ct: CT) -> tuple[list[tuple[str, np.ndarray]], int, str]:
    """(components as `cyc_to_numpy` gives them, f, encoding)."""
    return [cyc_to_numpy(c) for c in ct.cs], ct.f, ct.encoding


def linear_from_numpy(qs, m_e: int, m_r: int, m_s: int, ys) -> Linear:
    """The E-linear map R -> S (indices m_e | m_r, m_s over the chain qs)
    from its images ys, each the (n_s,) integer coefficients over S."""
    qs = tuple(qs)
    return linear_pow(*(ring_context(m, qs) for m in (m_e, m_r, m_s)),
                      [np.asarray(y).astype(np.int64) for y in ys])


def tunnel_hint_from_numpy(params_s: SHEParams, lin: Linear, h0, h1,
                           device="cuda") -> TunnelHint:
    """Tunnel hint from (d, ell, nrns, n_s) CRT residue arrays: one
    key-switch hint over S (params_s) per relative basis element."""
    return TunnelHint(lin, tuple(hint_from_numpy(params_s, a, b, device)
                                 for a, b in zip(h0, h1)))


def hint_ext_from_numpy(params: SHEParams, ext_qs, n_special: int, h0, h1,
                        device="cuda") -> KSHintExt:
    """Extended-modulus hint from (ell, nrns_ext, n) CRT residue arrays over
    the chain ext_qs (params.qs followed by n_special special primes)."""
    return KSHintExt(params, tuple(ext_qs), n_special, _residues(h0, device),
                     _residues(h1, device))


def prf_family_from_numpy(m: int, p: int, b: int, tree: Tree, a0, a1) -> PRFFamily:
    """The KH-PRF family over R_p (index m) with the base-b gadget, from its
    public vectors' (ell, n) integer coefficients (any lift)."""
    return PRFFamily(m, p, BaseBGad(b), tree, *(np.asarray(a, dtype=np.int64) % p
                                                 for a in (a0, a1)))


def pt_round_hints_from_numpy(params: SHEParams, hints, device="cuda") -> PTRoundHints:
    """Rounding hints from [(h0, h1), ...] CRT residue arrays: hint i lives
    at chain prefix qs[:L0 - i], shape (L0 - i, L0 - i, n)."""
    L0 = len(params.qs)
    return PTRoundHints(tuple(
        hint_from_numpy(replace(params, qs=params.qs[: L0 - i]), h0, h1, device)
        for i, (h0, h1) in enumerate(hints)))


def eval_hints_from_numpy(params: SHEParams, tunnels, p_final: int, rounds=None,
                          device="cuda") -> EvalHints:
    """HomomPRF hints: tunnels is [(m_e, m_r, m_s, ys, h0, h1), ...] down
    the tower (each as `linear_from_numpy` and `tunnel_hint_from_numpy`
    take them, over params' chain, p and var); rounds, if given, the
    rounding hints' arrays over the last ring (`pt_round_hints_from_numpy`)."""
    ths, m_last = [], params.m
    for m_e, m_r, m_s, ys, h0, h1 in tunnels:
        lin = linear_from_numpy(params.qs, m_e, m_r, m_s, ys)
        ths.append(tunnel_hint_from_numpy(replace(params, m=m_s), lin, h0, h1, device))
        m_last = m_s
    rh = None if rounds is None else pt_round_hints_from_numpy(
        replace(params, m=m_last), rounds, device)
    return EvalHints(tuple(ths), p_final, rh)


def cts_from_numpy(c0, c1, device="cuda") -> tuple[torch.Tensor, torch.Tensor]:
    """Packed ciphertext components, (nrns, n, B) residue arrays each."""
    return _residues(c0, device), _residues(c1, device)


def ring_shards_from_numpy(x, mesh: sharding.Mesh, axis: str = "ring") -> list[torch.Tensor]:
    """A JAX (..., n) residue array (last axis sharded there) as the port's
    ring shards: the coefficient-major (n, B) array, B = prod(...), split
    into the D (n/D, B) int32 shards of mesh axis `axis`."""
    a = np.asarray(x)
    return sharding.ring_shard(_residues(a.reshape(-1, a.shape[-1]).T, "cpu"), mesh, axis)


def ring_shards_to_numpy(shards: list[torch.Tensor], batch: tuple[int, ...] = ()) -> np.ndarray:
    """The inverse of `ring_shards_from_numpy`: the (*batch, n) u32 array."""
    x = sharding.ring_unshard(shards).cpu().numpy()
    return np.ascontiguousarray(x.T).reshape(*batch, x.shape[0]).astype(np.uint32)
