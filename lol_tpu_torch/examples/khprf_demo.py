"""KH-PRF demo (analog of lol-apps KHPRF example main)."""

import numpy as np

from lol_tpu_torch import gadget as gd, numtheory as nt, prf, prng
from lol_tpu_torch.cyc import Cyc
from lol_tpu_torch.examples import cli
from lol_tpu_torch.ring import ring_context


def main(device="cuda"):
    q = nt.ntt_primes(64, 20, 1)[0]
    ctx = ring_context(32, (q,))
    fam = prf.PRFFamily.random(ctx, gd.BaseBGad(8), prf.balanced(8),
                               prng.PRNGKey(0), device=device)
    rng = np.random.default_rng(0)
    s1 = Cyc.from_ints(ctx, rng.integers(-9, 9, ctx.n), device=device)
    s2 = Cyc.from_ints(ctx, rng.integers(-9, 9, ctx.n), device=device)
    x = (1, 0, 1, 1, 0, 0, 1, 0)
    f1 = prf.prf(fam, s1, x, 2)
    f2 = prf.prf(fam, s2, x, 2)
    f12 = prf.prf(fam, s1 + s2, x, 2)
    agree = float(np.mean((f12 - f1 - f2) % 2 == 0))
    print(f"PRF output bits: {f1[0][:16]}")
    print(f"key-homomorphism agreement: {agree:.1%} (1 - rounding slack)")


if __name__ == "__main__":
    cli(main, __doc__)
