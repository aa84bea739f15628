"""Requests of ring tunnels R -> S: the E-linear map L of the mix's
images moves B ciphertexts a batch from R (the configuration's ring m)
to S (m / `descent`), with E = S, through the module
`BatchedBGV(params).build_tunnel(th)` returns.

A batch is two (nrns, n_r, B) int32 stacks (c0, c1) of uniform CRT
residues over R, which is what fresh ciphertexts look like; `pool` such
batches are made on the card from the seed in one draw a modulus.  The
mix's `ys` are the images of R / E's relative basis, each an integer
constant of S ([1, 0]: the tower descent's projection onto E).  The keys
s_R and s_S (uniform ternary) and the tunnel hint
(`reference.tunnel.tunnel_hint`: uniform a, rounded Gaussian error) are
made by the benchmark from the seed and handed to the program through
`she.TunnelHint` and to the reference alike.  An answer is the pair
(c0', c1') of (nrns, n_s, B) stacks over S; it is checked against
`reference.tunnel.tunnel`.
"""

from __future__ import annotations

import torch

from benchmark.data import draw_residues
from benchmark.reference import ring as ref_ring, tunnel as ref_tunnel

CHECK_COLUMNS = 256  # the reference's block of ciphertexts


class Kind:
    def __init__(self, config: dict, mix: dict, seed: int, device, system: str = "program"):
        if config["gadget"] != "rns" or config["encoding"] != "lsd":
            raise ValueError("tunnel: the RNS gadget and the LSD encoding only")
        self.m, self.p, self.qs = config["m"], config["p"], tuple(config["qs"])
        self.m_s = self.m // mix["descent"]
        self.B, self.pool_size = mix["batch"], mix["pool"]
        self.items_per_batch = self.B
        self.device = torch.device(device)
        ring_r = ref_ring.Ring(self.m, self.qs, self.device)
        ring_s = ref_ring.Ring(self.m_s, self.qs, self.device)
        n_r, n_s, nrns = ring_r.n, ring_s.n, len(self.qs)
        d = n_r // n_s
        if len(mix["ys"]) != d:
            raise ValueError(f"tunnel: need {d} images, the mix gives {len(mix['ys'])}")
        ys = torch.zeros((d, n_s), dtype=torch.int64, device=self.device)
        ys[:, 0] = torch.tensor(mix["ys"], dtype=torch.int64)
        self.lmap = ref_tunnel.Map(self.m_s, ring_r, ring_s, ys)
        g = torch.Generator(device=self.device).manual_seed(seed)
        s_r = torch.randint(-1, 2, (n_r,), generator=g, device=self.device)
        s_s = torch.randint(-1, 2, (n_s,), generator=g, device=self.device)
        e = torch.normal(0.0, config["var"] ** 0.5, (d, nrns, n_s), generator=g,
                         device=self.device).round().long()
        a = draw_residues((d, nrns, nrns, n_s), 2, self.qs, g, self.device).long()
        self.h0, self.h1 = ref_tunnel.tunnel_hint(self.lmap, self.p, s_r, s_s, a, e)
        # pool[k, j]: component j of batch slot k, a contiguous (nrns, n_r, B) stack
        self.pool = draw_residues((self.pool_size, 2, nrns, n_r, self.B), 2, self.qs, g,
                                  self.device)
        self.work_per_batch = []
        if not self.m & (self.m - 1):  # a general-m transform is no one negacyclic NTT
            self.work_per_batch = ([("ntt_inv_gs", n_r, self.B)] * (2 * nrns)
                                   + [("ntt_fwd", n_s, self.B)] * (d * nrns * (1 + nrns)))
        if system == "program":
            from lol_tpu_torch import linear, she
            from lol_tpu_torch.she_batched import BatchedBGV

            params = she.SHEParams(m=self.m, p=self.p, qs=self.qs, var=config["var"])
            params_s = she.SHEParams(m=self.m_s, p=self.p, qs=self.qs, var=config["var"])
            s_ctx = params_s.ctx
            lin = linear.linear_pow(s_ctx, params.ctx, s_ctx, list(ys.cpu().numpy()))
            th = she.TunnelHint(lin, tuple(she.KSHint(params_s, self.h0[i], self.h1[i])
                                           for i in range(d)))
            self.fn = BatchedBGV(params, self.device).build_tunnel(th)
        elif system == "control":
            low = ref_tunnel.Map(
                self.m_s, ref_ring.Ring(self.m, self.qs, self.device, mul=ref_ring.mul_float64),
                ref_ring.Ring(self.m_s, self.qs, self.device, mul=ref_ring.mul_float64), ys)
            self.fn = lambda *cts: self._blocks(low, *cts)
        else:
            raise ValueError(f"tunnel: unknown system {system!r}")

    def operands(self, k: int):
        return tuple(self.pool[k % self.pool_size, j] for j in range(2))

    def issue(self, k: int):
        return self.fn(*self.operands(k))

    def sample_class(self, k: int) -> int:
        return 0

    def work(self, k: int) -> list:
        return list(self.work_per_batch)

    def release(self) -> None:
        self.fn = None

    def _blocks(self, lmap, *cts):
        outs = [ref_tunnel.tunnel(lmap, *(c[..., b:b + CHECK_COLUMNS] for c in cts),
                                  self.h0, self.h1)
                for b in range(0, self.B, CHECK_COLUMNS)]
        return tuple(torch.cat([o[i] for o in outs], dim=-1) for i in range(2))

    def words_wrong(self, k: int, answer) -> int:
        """Words of the answer to batch k that differ from the reference's
        (every word of a missing or misshapen component)."""
        want = self._blocks(self.lmap, *self.operands(k))
        got = list(answer)[:len(want)] + [None] * (len(want) - len(answer))
        return sum(int((a != w).sum()) if a is not None and a.shape == w.shape else w.numel()
                   for a, w in zip(got, want))
