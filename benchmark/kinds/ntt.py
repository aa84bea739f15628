"""Requests of bare negacyclic transforms: each request is the forward or
the inverse CRT transform of a batch of B ring elements in every modulus
of the chain, `ops.cuda.ntt_kernel.ntt_cm(x[i], plan_i, inverse=)` over
channel i of an (nrns, n, B) int32 stack with the chain's plans: the call
`BatchedBGV` and `ring.crt` make for each channel.  The mix's `mix` gives
the directions' shares, {"forward": a, "inverse": b}: a forward requests
then b inverse ones, over and over.

`pool` stacks of uniform residues are made on the card from the seed.
An answer is the nrns transformed channels; it is checked against the
reference's `Ring.crt`.  A 2-power ring only.
"""

from __future__ import annotations

import torch

from benchmark.data import draw_residues
from benchmark.reference import ring as ref_ring

CHECK_COLUMNS = 1024  # the reference's block of ring elements


class Kind:
    def __init__(self, config: dict, mix: dict, seed: int, device, system: str = "program"):
        self.m, self.qs = config["m"], tuple(config["qs"])
        if self.m & (self.m - 1):
            raise ValueError("ntt: a 2-power ring only")
        self.B, self.pool_size = mix["batch"], mix["pool"]
        self.items_per_batch = self.B
        self.inverse = [False] * mix["mix"]["forward"] + [True] * mix["mix"]["inverse"]
        self.device = torch.device(device)
        self.ring = ref_ring.Ring(self.m, self.qs, self.device)
        self.n = self.ring.n
        g = torch.Generator(device=self.device).manual_seed(seed)
        self.pool = draw_residues((self.pool_size, len(self.qs), self.n, self.B), 1, self.qs, g,
                                  self.device)
        if system == "program":
            from lol_tpu_torch.ops import ntt
            from lol_tpu_torch.ops.cuda import ntt_kernel

            plans = [ntt.ntt_plan(self.n, q) for q in self.qs]
            self.fn = lambda x, inv: [ntt_kernel.ntt_cm(x[i], plans[i], inverse=inv)
                                      for i in range(len(plans))]
        elif system == "control":
            low = ref_ring.Ring(self.m, self.qs, self.device, mul=ref_ring.mul_float64)
            self.fn = lambda x, inv: self._blocks(low, x, inv)
        else:
            raise ValueError(f"ntt: unknown system {system!r}")

    def sample_class(self, k: int) -> int:
        return int(self.inverse[k % len(self.inverse)])

    def issue(self, k: int):
        return self.fn(self.pool[k % self.pool_size], self.inverse[k % len(self.inverse)])

    def work(self, k: int) -> list:
        op = "ntt_inv_gs" if self.inverse[k % len(self.inverse)] else "ntt_fwd"
        return [(op, self.n, self.B)] * len(self.qs)

    def release(self) -> None:
        self.fn = None

    def _blocks(self, ring, x, inv):
        return [torch.cat([ring.crt(x[i, :, b:b + CHECK_COLUMNS], i, inv).to(torch.int32)
                           for b in range(0, self.B, CHECK_COLUMNS)], dim=1)
                for i in range(len(self.qs))]

    def words_wrong(self, k: int, answer) -> int:
        """Words of the answer to request k that differ from the
        reference's (every word of a missing or misshapen channel)."""
        want = self._blocks(self.ring, self.pool[k % self.pool_size],
                            self.inverse[k % len(self.inverse)])
        got = list(answer)[:len(want)] + [None] * (len(want) - len(answer))
        return sum(int((a != w).sum()) if a is not None and a.shape == w.shape else w.numel()
                   for a, w in zip(got, want))
