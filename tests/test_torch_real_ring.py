"""The port's CPU step against the JAX package's at the reference bench's
real rings, bit for bit.

The port makes the key, the relinearization hint and the ciphertexts; the
same arrays go into the JAX package's `BatchedBGV(params,
use_pallas=False)`, and the two steps (ct_mul, the RNS-gadget key switch,
the rescale) must give the same residues: at m = 8192 (n = 4096, three
30-bit primes, LSD, B = 8), at m = 32768 (n = 2^14, LSD, B = 4), and at
the general ring m = 18432 = 2^11 3^2 with p = 7 (MSD, B = 4).  The
suite's other comparisons run at m <= 90; this is the CPU reference at
the rings the card runs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lol_tpu import gadget as jgd
from lol_tpu import she as jshe
from lol_tpu.cyc import Cyc as JCyc, Rep as JRep
from lol_tpu.she_batched import BatchedBGV as JBatchedBGV
from lol_tpu_torch import prng
from lol_tpu_torch import numtheory as nt, she
from lol_tpu_torch.she_batched import BatchedBGV

torch.set_num_threads(2)


def _u32(t: torch.Tensor):
    return jnp.asarray(t.numpy().astype(np.uint32))


@pytest.mark.parametrize("m,p,encoding,B", [(8192, 257, "lsd", 8), (32768, 257, "lsd", 4),
                                            (18432, 7, "msd", 4)])
def test_cpu_step_equals_the_jax_step_at_a_real_ring(m, p, encoding, B):
    params = she.SHEParams(m=m, p=p, qs=tuple(nt.ntt_primes(m, 30, 3)), var=2.0)
    g, rng = prng.KeyChain(m), np.random.default_rng(m)
    sk = she.gen_sk(params, g(), "cpu")
    bb = BatchedBGV(params, "cpu")
    hint = bb.gen_ks_quad_hint(sk, g())
    enc = bb.build_encrypt(sk, encoding)
    m1, m2 = she.pt_random(params, rng, (B,), "cpu"), she.pt_random(params, rng, (B,), "cpu")
    cts = (*enc(m1, g()), *enc(m2, g()))
    got = bb.build_step(hint, encoding=encoding)(*cts)

    jp = jshe.SHEParams(m=m, p=p, qs=params.qs, var=2.0)
    jhint = jshe.KSHint(jp, jp.ctx, jgd.RnsGad(), *(
        tuple(JCyc(jp.ctx, JRep.CRT, _u32(t[j])) for j in range(t.shape[0]))
        for t in (hint.h0, hint.h1)))
    want = JBatchedBGV(jp, use_pallas=False).build_step(jhint, encoding=encoding)(
        *(_u32(c) for c in cts))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy().astype(np.uint32), np.asarray(b))
    # and the product decrypts, so the comparison is of a working step
    p2 = she.SHEParams(m=m, p=p, qs=params.qs[:-1], var=2.0)
    dec = BatchedBGV(p2, "cpu").build_decrypt(she.SK(p2, sk.s_ints, sk.var),
                                              f=bb.step_f(1, 1, encoding), encoding=encoding)
    np.testing.assert_array_equal(dec(*got)[:, 0].numpy(),
                                  she.pt_mul(params, m1[:, 0].numpy(), m2[:, 0].numpy()))
