"""Per-op microbenchmark table over the port's three backends (counterpart
of `lol_tpu/bench/micro.py`, the reference's criterion / pretty-printed
table over op x backend).

Backends: `torch`, the plain torch versions on CPU tensors (host clock);
`cpp`, the C++ host backend (`tensor/cpp_backend`, host clock); `cuda`,
the same ops on the card, through the hand-written kernels where the op
has one and the torch glue otherwise (CUDA events, as the caller sees it,
`bench.time_ms`).  Inputs: residues over nrns 30-bit primes of the ring
m = 2n (the ring-element layout (batch, nrns, n)), the index ops between
it and its half ring, L and g on the odd ring m = 2^k 17 of the same n
(its 17-axis, phi = 16: the cpp backend's one-axis stencils), and the
dense odd-axis DFT at phi = 96 by each route (on the card both kernels:
`modmat_small`, forced there by use_mxu=False, and `modmat_s8`; CUDA
events for every card leg).  Every op's backends are
checked equal on its inputs before any timing.

Run on the card: python -m lol_tpu_torch.bench.micro [--n 4096]
[--batch 1024] [--rns 2]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from .. import gadget as gd, numtheory as nt, prng, ring as rg, she, zq
from ..ops import general as gen, ntt
from ..ops.cuda import modmat, ntt_kernel as tk
from ..ring import ring_context
from ..she_batched import BatchedBGV
from ..tensor import cpp_backend as cpp
from . import card_line, host_ms, require_cuda, time_ms

ODD_P = 17  # the odd axis of the L / g rows: phi = 16


def _same(op: str, outs: dict) -> None:
    """Every backend's output of op equal bit for bit (on the CPU)."""
    ref = None
    for backend, o in outs.items():
        o = [t.cpu().long() for t in (o if isinstance(o, (list, tuple)) else [o])]
        if ref is None:
            ref = o
        elif len(o) != len(ref) or not all(torch.equal(a, b) for a, b in zip(o, ref)):
            raise AssertionError(f"micro: {op} on {backend} != the first backend")


def run(n: int = 4096, batch: int = 1024, nrns: int = 2, iters: int = 10,
        host_iters: int = 2) -> list[tuple]:
    """Check, time and print every op; returns rows (op, backend, ms,
    poly-ops/s)."""
    dev = require_cuda()
    cpu = torch.device("cpu")
    qs = tuple(nt.ntt_primes(2 * n, 30, nrns))
    ctx, sub = ring_context(2 * n, qs), ring_context(n, qs)
    m_odd = (2 * n // (ODD_P - 1)) * ODD_P
    octx = ring_context(m_odd, tuple(nt.ntt_primes(m_odd, 30, nrns)))
    plans = [ntt.ntt_plan(n, q) for q in qs]
    key = prng.KeyChain(0)
    x_d = torch.stack([torch.randint(0, q, (batch, n), dtype=torch.int32) for q in qs], 1)
    xo_d = torch.stack([torch.randint(0, q, (batch, n), dtype=torch.int32)
                        for q in octx.basis.qs], 1)
    xr = {cpu: x_d, dev: x_d.to(dev)}  # (batch, nrns, n)
    xo = {cpu: xo_d, dev: xo_d.to(dev)}
    xcm = {d: [v[:, i].t().contiguous() for i in range(nrns)] for d, v in xr.items()}  # (n, B)
    rows = []

    def bench(op: str, fns: dict, count: int = batch * nrns) -> None:
        """fns: backend -> zero-argument call; checked equal, then timed."""
        _same(op, {b: f() for b, f in fns.items()})
        for backend, f in fns.items():
            ms = (time_ms(f, iters)[0] if backend.startswith("cuda")
                  else host_ms(f, host_iters, 3))
            rows.append((op, backend, ms, count / (ms / 1e3)))

    def per_q(fn, d):
        return [fn(v, i) for i, v in enumerate(xcm[d])]

    bench("crt (fwd NTT)", {
        "torch": lambda: per_q(lambda v, i: tk.ntt_cm_ref(v, plans[i]), cpu),
        "cpp": lambda: [cpp.ntt_forward(x_d[:, i], plans[i]).t() for i in range(nrns)],
        "cuda": lambda: per_q(lambda v, i: tk.ntt_cm(v, plans[i]), dev)})
    bench("crtInv", {
        "torch": lambda: per_q(lambda v, i: tk.ntt_cm_ref(v, plans[i], inverse=True), cpu),
        "cpp": lambda: [cpp.ntt_inverse(x_d[:, i], plans[i]).t() for i in range(nrns)],
        "cuda": lambda: per_q(lambda v, i: tk.ntt_cm(v, plans[i], inverse=True), dev)})
    for name, zq_op, cpp_op in (("zipWith (*)", zq.mul_mod, cpp.zq_mul),
                                ("zipWith (+)", zq.add_mod, cpp.zq_add)):
        bench(name, {
            "torch": lambda f=zq_op: per_q(lambda v, i: f(v, v, qs[i]).to(torch.int32), cpu),
            "cpp": lambda f=cpp_op: [f(v, v, qs[i]) for i, v in enumerate(xcm[cpu])],
            "cuda": lambda f=zq_op: per_q(lambda v, i: f(v, v, qs[i]).to(torch.int32), dev)})

    # L and g along the odd ring's 17-axis (the last axis of phi_shape)
    oq = octx.basis.qs

    def cpp_axis(fn):
        return lambda: torch.stack([fn(xo_d[:, i], ODD_P, 1, q) for i, q in enumerate(oq)], 1)

    for name, ring_op, cpp_op in (("l (dec->pow)", rg.l, cpp.l_fwd), ("lInv", rg.l_inv, cpp.l_inv),
                                  ("mulG (pow)", rg.mul_g_pow, cpp.mul_g_pow),
                                  ("divG (pow)", rg.div_g_pow, cpp.div_g_pow),
                                  ("mulG (dec)", rg.mul_g_dec, cpp.mul_g_dec)):
        bench(name, {"torch": lambda f=ring_op: f(octx, xo[cpu]), "cpp": cpp_axis(cpp_op),
                     "cuda": lambda f=ring_op: f(octx, xo[dev])})

    # cross-ring index ops between ctx (2n) and its half ring
    xs = {d: v[..., :sub.n].contiguous() for d, v in xr.items()}

    def cpp_rows(fn):
        return lambda: torch.stack([fn(i, q) for i, q in enumerate(qs)], 1)

    bench("embedPow", {"torch": lambda: rg.embed_pow(sub, ctx, xs[cpu]),
                       "cpp": cpp_rows(lambda i, q: cpp.embed_pow(xs[cpu][:, i], n, 2 * n, q)),
                       "cuda": lambda: rg.embed_pow(sub, ctx, xs[dev])})
    bench("twacePowDec", {"torch": lambda: rg.twace_pow(ctx, sub, xr[cpu]),
                          "cpp": cpp_rows(lambda i, q: cpp.twace_pow(x_d[:, i], n, 2 * n, q)),
                          "cuda": lambda: rg.twace_pow(ctx, sub, xr[dev])})
    bench("embedCRT", {"torch": lambda: rg.embed_crt(sub, ctx, xs[cpu]),
                       "cpp": cpp_rows(lambda i, q: cpp.embed_crt(xs[cpu][:, i], n, 2 * n, q)),
                       "cuda": lambda: rg.embed_crt(sub, ctx, xs[dev])})
    bench("twaceCRT", {"torch": lambda: rg.twace_crt(ctx, sub, xr[cpu]),
                       "cpp": cpp_rows(lambda i, q: cpp.twace_crt(x_d[:, i], n, 2 * n, q)),
                       "cuda": lambda: rg.twace_crt(ctx, sub, xr[dev])})
    bench("coeffs", {"torch": lambda: rg.coeffs_pow(ctx, sub, xr[cpu]),
                     "cpp": lambda: torch.stack([cpp.coeffs_rel(x_d[:, i], n, 2 * n)
                                                 for i in range(nrns)], 2),
                     "cuda": lambda: rg.coeffs_pow(ctx, sub, xr[dev])})
    if nrns >= 2:
        bench("rescale (RNS)", {"torch": lambda: ctx.basis.rescale_drop_last(xr[cpu]),
                                "cuda": lambda: ctx.basis.rescale_drop_last(xr[dev])})
    bench("decompose (rns)", {"torch": lambda: gd.decompose(gd.RnsGad(), ctx.basis, xr[cpu]),
                              "cuda": lambda: gd.decompose(gd.RnsGad(), ctx.basis, xr[dev])})
    bench("liftDec mod p", {"torch": lambda: ctx.basis.lift_mod(xr[cpu].transpose(0, 1), 257),
                            "cuda": lambda: ctx.basis.lift_mod(xr[dev].transpose(0, 1), 257)})

    # the batched serving path on the card: decrypts, noise, one hint
    pars = she.SHEParams(m=2 * n, p=257, qs=qs, var=2.0)
    sk = she.gen_sk(pars, key(), dev)
    bbp = BatchedBGV(pars, dev)
    ccm = xr[dev].permute(1, 2, 0).contiguous()  # (nrns, n, B)
    for name, fn in (("decrypt (lsd)", bbp.build_decrypt(sk)),
                     ("decrypt (msd)", bbp.build_decrypt(sk, encoding="msd")),
                     ("noise_bits", bbp.build_noise_bits(sk))):
        ms = time_ms(lambda f=fn: f(ccm, ccm), iters)[0]
        rows.append((name, "cuda", ms, batch / (ms / 1e3)))
    ms = time_ms(lambda: bbp.gen_ks_quad_hint(sk, key()), 3)[0]
    rows.append(("hintGen (quad)", "cuda", ms, 1 / (ms / 1e3)))

    # the dense odd-axis DFT (the general-m CRT's leg): every route
    phi, q0 = 96, qs[0]
    rng = np.random.default_rng(0)
    Md = rng.integers(0, q0, (phi, phi)).astype(np.uint32)
    Md.flags.writeable = False
    xv = torch.from_numpy(rng.integers(0, q0, (batch, phi)).astype(np.int32))
    xvd = xv.to(dev)
    bench(f"denseDFT p{phi}", {
        "torch": lambda: gen.matvec_mod(Md, xv, q0, use_mxu=False),
        "cpp": lambda: cpp.axis_matvec(Md, xv, q0),
        "cuda modmat_small": lambda: gen.matvec_mod(Md, xvd, q0, use_mxu=False),
        "cuda modmat_s8": lambda: modmat.modmat_s8(Md, xvd, q0)}, count=batch)

    print(f"\nlol_tpu_torch microbench: n={n}, batch={batch}, nrns={nrns}, "
          f"card {card_line()}; torch and cpp on the host")
    print(f"{'op':<16} {'backend':<15} {'ms/call':>10} {'poly-ops/s':>14}")
    for op, backend, ms, rate in rows:
        print(f"{op:<16} {backend:<15} {ms:>10.3f} {rate:>14,.0f}")
    return rows


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--rns", type=int, default=2)
    args = ap.parse_args()
    run(args.n, args.batch, args.rns)


if __name__ == "__main__":
    main()
