"""Requests of whole BGV steps: ciphertext multiply, RNS-gadget key
switch and exact rescale of B ciphertext pairs a batch, through the
module `BatchedBGV(params).build_step(hint)` returns.

A batch is four (nrns, n, B) int32 stacks (c0, c1, d0, d1) of uniform CRT
residues, which is what fresh ciphertexts look like; `pool` such batches
are made on the card from the seed in one draw a modulus.  The secret key
(uniform ternary), the relinearisation hint (`reference.bgv.relin_hint`:
uniform a, rounded Gaussian error) are made by the benchmark from the
seed and handed to the program through `she.KSHint` and to the
reference alike.  An answer is the pair (c0', c1') of (nrns - 1, n, B)
stacks; it is checked against `reference.bgv.step`.
"""

from __future__ import annotations

import torch

from benchmark.data import draw_residues
from benchmark.reference import bgv as ref_bgv, ring as ref_ring

CHECK_COLUMNS = 256  # the reference's block of ciphertexts


class Kind:
    def __init__(self, config: dict, mix: dict, seed: int, device, system: str = "program"):
        if config["gadget"] != "rns" or config["encoding"] != "lsd":
            raise ValueError("bgv_step: the RNS gadget and the LSD encoding only")
        self.m, self.p, self.qs = config["m"], config["p"], tuple(config["qs"])
        self.B, self.pool_size = mix["batch"], mix["pool"]
        self.items_per_batch = self.B
        self.device = torch.device(device)
        self.ring = ref_ring.Ring(self.m, self.qs, self.device)
        n, nrns = self.ring.n, len(self.qs)
        g = torch.Generator(device=self.device).manual_seed(seed)
        s = torch.randint(-1, 2, (n,), generator=g, device=self.device)
        e = torch.normal(0.0, config["var"] ** 0.5, (nrns, n), generator=g,
                         device=self.device).round().long()
        a = draw_residues((nrns, nrns, n), 1, self.qs, g, self.device).long()
        self.h0, self.h1 = ref_bgv.relin_hint(self.ring, self.p, s, a, e)
        # pool[k, j]: operand j of batch slot k, a contiguous (nrns, n, B) stack
        self.pool = draw_residues((self.pool_size, 4, nrns, n, self.B), 2, self.qs, g,
                                  self.device)
        if system == "program":
            from lol_tpu_torch import she
            from lol_tpu_torch.she_batched import BatchedBGV

            params = she.SHEParams(m=self.m, p=self.p, qs=self.qs, var=config["var"])
            self.fn = BatchedBGV(params, self.device).build_step(
                she.KSHint(params, self.h0, self.h1))
        elif system == "control":
            low = ref_ring.Ring(self.m, self.qs, self.device, mul=ref_ring.mul_float64)
            self.fn = lambda *cts: self._blocks(low, *cts)
        else:
            raise ValueError(f"bgv_step: unknown system {system!r}")

    def operands(self, k: int):
        return tuple(self.pool[k % self.pool_size, j] for j in range(4))

    def issue(self, k: int):
        return self.fn(*self.operands(k))

    def sample_class(self, k: int) -> int:
        return 0

    def work(self, k: int) -> list:
        return []

    def release(self) -> None:
        self.fn = None

    def _blocks(self, ring, *cts):
        outs = [ref_bgv.step(ring, self.p, *(c[..., b:b + CHECK_COLUMNS] for c in cts),
                             self.h0, self.h1)
                for b in range(0, self.B, CHECK_COLUMNS)]
        return tuple(torch.cat([o[i] for o in outs], dim=-1) for i in range(2))

    def words_wrong(self, k: int, answer) -> int:
        """Words of the answer to batch k that differ from the reference's
        (every word of a missing or misshapen component)."""
        want = self._blocks(self.ring, *self.operands(k))
        got = list(answer)[:len(want)] + [None] * (len(want) - len(answer))
        return sum(int((a != w).sum()) if a is not None and a.shape == w.shape else w.numel()
                   for a, w in zip(got, want))
