"""Ring-tunneling demo: homomorphically move a ciphertext between rings."""

import numpy as np

from lol_tpu_torch import gadget as gd, linear as lin, numtheory as nt, prng, she
from lol_tpu_torch.cyc import Cyc
from lol_tpu_torch.examples import cli
from lol_tpu_torch.ring import ring_context


def main(device="cuda"):
    me, mr, ms = 16, 32, 64
    qs = tuple(nt.ntt_primes(64, 30, 3))
    E, R, S = (ring_context(m, qs) for m in (me, mr, ms))
    pr = she.SHEParams(m=mr, p=257, qs=qs, var=2.0)
    ps = she.SHEParams(m=ms, p=257, qs=qs, var=2.0)
    key = prng.PRNGKey(0)
    kr, ks_, kh, ke = prng.split(key, 4)
    sk_r, sk_s = she.gen_sk(pr, kr, device=device), she.gen_sk(ps, ks_, device=device)

    rng = np.random.default_rng(0)
    ys = [Cyc.from_ints(S, rng.integers(-2, 3, S.n), device=device) for _ in range(R.n // E.n)]
    f = lin.linear_pow(E, R, S, ys)
    th = she.tunnel_hint(f, sk_s, sk_r, gd.RnsGad(), kh, device=device)

    m = she.pt_random(pr, rng, device="cpu")  # a host plaintext
    ct = she.encrypt(sk_r, m, ke, device=device)
    out = she.tunnel(th, ct)
    print(f"tunneled ciphertext: ring m={mr} -> m={ms}")
    print("decrypts under target key:", she.decrypt(sk_s, out)[:8], "...")


if __name__ == "__main__":
    cli(main, __doc__)
