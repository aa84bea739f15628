"""A property of the reference pinned in the port: the CRT-set slot
projection at 512 -> 256, p = 257, has no solution, and both packages'
`make_eval_hints(maps="slots")` (what the HomomPRF demo calls with
maps="project") refuse it with the same error, before any hint is made.
If either package ever solved it, or refused differently, this fails: a
refusal must not turn into a silent divergence.  (~30 s a package: the
host's pure-Python Z_p system.)"""

import jax
import numpy as np
import pytest
import torch

from lol_tpu import gadget as jgd, numtheory as jnt, prf as jprf, she as jshe
from lol_tpu.ring import ring_context as j_ring_context
from lol_tpu_torch import gadget as gd, numtheory as nt, prf, prng, she
from lol_tpu_torch.ring import ring_context

torch.set_num_threads(2)

P, RINGS = 257, [512, 256]
MESSAGE = "slot projection system inconsistent mod p"


def _refusal(pkg):
    """The error make_eval_hints(maps="slots") raises in one package."""
    if pkg == "port":
        qs = tuple(nt.ntt_primes(512, 30, 2))
        fam = prf.PRFFamily.random(ring_context(512, (P,)), gd.BaseBGad(2), prf.balanced(1),
                                   prng.PRNGKey(0), device="cpu")
        sks = [she.gen_sk(she.SHEParams(m=m, p=P, qs=qs, var=2.0), prng.PRNGKey(m), "cpu")
               for m in RINGS]
        call = lambda: prf.make_eval_hints(fam, sks, RINGS, [256], gd.RnsGad(),  # noqa: E731
                                           prng.PRNGKey(1), maps="slots", device="cpu")
    else:
        qs = tuple(jnt.ntt_primes(512, 30, 2))
        fam = jprf.PRFFamily.random(j_ring_context(512, (P,)), jgd.BaseBGad(2),
                                    jprf.balanced(1), jax.random.PRNGKey(0))
        sks = [jshe.gen_sk(jshe.SHEParams(m=m, p=P, qs=qs, var=2.0), jax.random.PRNGKey(m))
               for m in RINGS]
        call = lambda: jprf.make_eval_hints(fam, sks, RINGS, [256], jgd.RnsGad(),  # noqa: E731
                                            jax.random.PRNGKey(1), maps="slots")
    with pytest.raises(ValueError) as err:
        call()
    return str(err.value)


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_slot_projection_512_to_256_is_refused(pkg):
    """Each package refuses with the one message, so the port refuses where
    and as the JAX package does."""
    assert np.gcd(P, 512) == 1  # a prime coprime to the index: the refusal is the system's
    assert _refusal(pkg) == MESSAGE
