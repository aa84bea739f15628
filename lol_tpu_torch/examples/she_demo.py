"""SHE demo (analog of lol-apps SHE example main): full BGV flow."""

import numpy as np

from lol_tpu_torch import gadget as gd, numtheory as nt, prng, she
from lol_tpu_torch.examples import cli


def main(device="cuda"):
    m = 256
    qs = tuple(nt.ntt_primes(m, 30, 3))
    params = she.SHEParams(m=m, p=257, qs=qs, var=3.0)
    rng = np.random.default_rng(0)
    key = prng.PRNGKey(0)
    ks, k1, k2, kh = prng.split(key, 4)

    sk = she.gen_sk(params, ks, device=device)
    m1, m2 = (she.pt_random(params, rng, device="cpu") for _ in range(2))  # host plaintexts
    c1, c2 = she.encrypt(sk, m1, k1, device=device), she.encrypt(sk, m2, k2, device=device)
    print("enc/dec roundtrip:", np.array_equal(she.decrypt(sk, c1), m1))

    csum = she.ct_add(c1, c2)
    print("hom add:", np.array_equal(she.decrypt(sk, csum), she.pt_add(params, m1, m2)))

    hint = she.ks_quad_circ_hint(sk, gd.RnsGad(), kh, device=device)
    prod = she.key_switch_quad_circ(hint, she.ct_mul(c1, c2))
    print("hom mul+relin:", np.array_equal(she.decrypt(sk, prod), she.pt_mul(params, m1, m2)))
    print("noise before rescale: %.1f bits" % she.noise_bits(sk, prod))

    small = she.mod_switch(prod)
    sk2 = she.SK(small.params, sk.s_ints, sk.var)
    print("after mod-switch:", np.array_equal(she.decrypt(sk2, small), she.pt_mul(params, m1, m2)),
          "(noise %.1f bits)" % she.noise_bits(sk2, small))


if __name__ == "__main__":
    cli(main, __doc__)
