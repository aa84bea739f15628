"""Serving-scale orchestration: homomorphic rounding and HomomPRF over
ciphertext batches.

Counterpart of `lol_tpu/serving.py`, assembled from `BatchedBGV`'s
builders, so whole batches ride each stage:

  - `build_pt_round` / `batched_pt_round`: the homomorphic plaintext
    rounding chain (Z_{2^k} -> Z_2 LSB stripping, Z_{3^k} -> Z_3
    balanced-ternary stripping; `she._pt_round_base` derives why exactly
    these), every multiply a `build_step` (an `nn.Module` holding its
    hint), every chain alignment a `build_mod_switch`, the subtraction a
    `build_add` and the exact divide a `build_div_d`.
  - `batched_homom_prf_component`: the HomomPRF call stack
    (mulPublic -> tunnel chain -> PTRound) at batch scale:
    `build_mul_public` -> `build_tunnel` per tower hop -> the rounding.

The schedules are the reference's statement for statement, so every
output is bit-identical to `lol_tpu.serving` over
`BatchedBGV(params, use_pallas=False)`.  Every stage runs on the
pipeline's device: the NTT and ct_mul kernels on the card, their plain
versions on the CPU.  With `mesh=` (axes 'rns' and 'data') every stage is
its builder's mesh form, so the inputs and outputs are
`parallel.sharding.shard_batch_rns` blocks; the chain shrinks stage by
stage, and each stage takes the layout its chain's length gives
(`sharding.rns_rows`).
"""

from __future__ import annotations

import numpy as np
import torch

from . import she
from .prf import EvalHints, PRFFamily
from .she_batched import BatchedBGV, _check_encoding


def _mk(bb: BatchedBGV, p_cur: int, L: int) -> BatchedBGV:
    """The pipeline over chain prefix qs[:L] at plaintext modulus p_cur, on
    bb's device."""
    base = bb.params
    return BatchedBGV(she.SHEParams(m=base.m, p=p_cur, qs=base.qs[:L], var=base.var),
                      bb.device)


def build_pt_round(bb: BatchedBGV, rh: she.PTRoundHints, f: int = 1,
                   encoding: str = "lsd", mesh=None):
    """Build every stage of the rounding chain once and return (run, bb_out,
    f_out): run: (c0, c1) -> (c0', c1') over bb_out's chain, reusable
    across serving calls (the stages and all scale bookkeeping are
    data-independent, so they are laid out here).

    The schedule is the reference's (hint i is consumed at chain prefix
    L0 - i, as `she.pt_round_hints` lays the hints out); plaintexts must
    be scalar (constant polynomials), since ring multiplication agrees
    with scalar multiplication only there.

    pr = 2 (p = 2^k): msb by iterated LSB stripping: at modulus 2^j,
    b = lsb(y) = y^(2^t) (`she._lsb_squarings(j)` squarings, each
    relinearized and rescaled), then y <- div_2(y - b); the pre-added
    2^{k-2} turns truncation into round-half-up.  pr = 3: at modulus
    3^j, t = y^(3^{j-1}) (j - 1 relinearized cubings) is the balanced
    ternary digit, then y <- div_3(y - t).

    encoding: "lsd" or "msd".  The exact divide is intrinsically LSD (its
    unit multiplication divides the LSD noise scale exactly but not MSD
    raw noise), so MSD inputs ride the exact encoding switches at the
    boundary: to_lsd in front, the LSD chain, to_msd on the output
    pipeline.

    mesh: every stage built over it (module docstring)."""
    if _check_encoding(encoding) == "msd":
        run_l, bb_out, f_out = build_pt_round(bb, rh, f=bb.to_lsd_f(f), encoding="lsd",
                                              mesh=mesh)
        to_lsd = bb.build_to_lsd(mesh)
        to_msd = bb_out.build_to_msd(mesh)

        def run_m(c0, c1):
            return to_msd(*run_l(*to_lsd(c0, c1)))

        return run_m, bb_out, bb_out.to_msd_f(f_out)
    p = bb.params.p
    pr, k = she._pt_round_base(p)
    if k == 1:
        return (lambda c0, c1: (c0, c1)), bb, f
    it = iter(rh.hints)
    L = len(bb.params.qs)
    py, fy, Ly = p, f, L
    prog = []  # closures over the state {"y": pair, "b": pair, "sq": pair}

    if pr == 2:
        shift = torch.zeros((bb.ctx.n, 1), dtype=torch.int32, device=bb.device)
        shift[0, 0] = 1 << (k - 2)
        addp = bb.build_add_public(f=f, mesh=mesh)
        prog.append(lambda st: {**st, "y": addp(*st["y"], shift)})

    def emit_square(reg, pcur, Lcur, hint):
        step = _mk(bb, pcur, Lcur).build_step(hint, mesh=mesh)
        prog.append(lambda st: {**st, reg: step(*st[reg], *st[reg])})

    def emit_align(reg, pcur, Lfrom, Lto):
        for Lc in range(Lfrom, Lto, -1):
            ms = _mk(bb, pcur, Lc).build_mod_switch(mesh=mesh)
            prog.append(lambda st, ms=ms: {**st, reg: ms(*st[reg])})

    for j in range(k, 1, -1):
        if pr == 2:
            fb, Lb = fy, Ly
            prog.append(lambda st: {**st, "b": st["y"]})
            for _ in range(she._lsb_squarings(j)):
                cur = _mk(bb, py, Lb)
                emit_square("b", py, Lb, next(it))
                fb = cur.step_f(fb, fb)
                Lb -= 1
        else:
            ft, Lt = fy, Ly
            prog.append(lambda st: {**st, "b": st["y"]})
            for _ in range(j - 1):  # b <- b^3 (square, align, times b)
                cur = _mk(bb, py, Lt)
                sq_step = cur.build_step(next(it), mesh=mesh)
                prog.append(lambda st, s=sq_step: {**st, "sq": s(*st["b"], *st["b"])})
                fsq = cur.step_f(ft, ft)
                emit_align("b", py, Lt, Lt - 1)
                ft = _mk(bb, py, Lt).mod_switch_f(ft)
                Lt -= 1
                cur = _mk(bb, py, Lt)
                mul_step = cur.build_step(next(it), mesh=mesh)
                prog.append(lambda st, s=mul_step: {**st, "b": s(*st["sq"], *st["b"])})
                ft = cur.step_f(fsq, ft)
                Lt -= 1
            fb, Lb = ft, Lt
        emit_align("y", py, Ly, Lb)
        while Ly > Lb:
            fy = _mk(bb, py, Ly).mod_switch_f(fy)
            Ly -= 1
        cur = _mk(bb, py, Ly)
        sub = cur.build_add(f_a=fy, f_b=fb, sub=True, mesh=mesh)
        div = cur.build_div_d(pr, mesh)
        prog.append(lambda st, sub=sub, div=div: {**st, "y": div(*sub(*st["y"], *st["b"]))})
        fy = cur.div_d_f(pr, fy)
        py //= pr

    def run(c0, c1):
        st = {"y": (c0, c1)}
        for op in prog:
            st = op(st)
        return st["y"]

    return run, _mk(bb, py, Ly), fy


def batched_pt_round(bb: BatchedBGV, rh: she.PTRoundHints, c0, c1, f: int = 1,
                     encoding: str = "lsd", mesh=None):
    """One-shot form of build_pt_round: (bb_out, f_out, (c0', c1'))."""
    run, bb_out, f_out = build_pt_round(bb, rh, f=f, encoding=encoding, mesh=mesh)
    return bb_out, f_out, run(c0, c1)


def batched_homom_prf_component(fam: PRFFamily, hints: EvalHints, bb: BatchedBGV,
                                c0, c1, bits, i: int, f: int = 1,
                                encoding: str = "lsd", mesh=None):
    """Component i of s * A_T(x) over a batch of key ciphertexts:
    `build_mul_public`, a `build_tunnel` per tower hop (both
    encoding-agnostic), then the homomorphic rounding (`batched_pt_round`,
    encoding-aware) when hints.rounds is present, else the plaintext
    modulus reinterpretation (p/f bookkeeping in LSD; MSD rides the exact
    encoding switches, since Delta = Q//p depends on p).  Returns
    (bb_out, f_out, (c0', c1')); with mesh, every stage over it (module
    docstring)."""
    a = fam.a_t(bits)[i]
    a = np.where(a >= (fam.p + 1) // 2, a - fam.p, a)  # the centered lift
    a_pt = torch.from_numpy((a % bb.params.p).astype(np.int32)[:, None])
    c0, c1 = bb.build_mul_public(mesh)(c0, c1, a_pt)
    cur = bb
    for th in hints.tunnels:
        c0, c1 = cur.build_tunnel(th, mesh)(c0, c1)
        cur = cur.target_pipeline(th)
    if hints.rounds is not None:
        return batched_pt_round(cur, hints.rounds, c0, c1, f=f, encoding=encoding, mesh=mesh)
    if hints.p_final != cur.params.p:
        base = cur.params
        msd = _check_encoding(encoding) == "msd"
        if msd:  # the exact switch to LSD, where reinterpretation is free
            c0, c1 = cur.build_to_lsd(mesh)(c0, c1)
            f = cur.to_lsd_f(f)
        cur = BatchedBGV(she.SHEParams(m=base.m, p=hints.p_final, qs=base.qs, var=base.var),
                         cur.device)
        f = f % hints.p_final
        if msd:
            c0, c1 = cur.build_to_msd(mesh)(c0, c1)
            f = cur.to_msd_f(f)
    return cur, f, (c0, c1)
