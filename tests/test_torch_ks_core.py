"""The pipeline's one key-switch core (`BatchedBGV._ks_planes`,
`_ks_digits`, `_ks_inner`).

Every builder that key-switches, but the tunnel, holds its hint only as
`ks_hint` planes and runs its hint inner products through one
`ks_inner_cm` call a key switch over all its digits: the step, the linear
key switch, a Galois rotation, the hoisted rotations (one call a
rotation) and both extended-modulus builders, at m = 64, three 30-bit
primes (two special ones for the ext chain), p = 257, B = 3, on the
port's own keys and hints.  Their outputs against the JAX package are
held by test_torch_she_batched, test_torch_galois and test_torch_ext_ks.
"""

import numpy as np
import pytest
import torch

from lol_tpu_torch import numtheory as nt, prng, she, she_batched
from lol_tpu_torch.she_batched import BatchedBGV

torch.set_num_threads(2)

M, P, B = 64, 257, 3
ALL5 = tuple(nt.ntt_primes(M, 30, 5))
QS, SPECIAL = ALL5[:3], ALL5[3:]
PARAMS = she.SHEParams(m=M, p=P, qs=QS, var=2.0)
KS = (3, 63)

# builder -> (module from the pipeline and the hints, ciphertexts it takes,
# ks_inner_cm calls a forward)
BUILDERS = {
    "build_step": (lambda bb, h: bb.build_step(h["quad"]), 2, 1),
    "build_key_switch_linear": (lambda bb, h: bb.build_key_switch_linear(h["lin"]), 1, 1),
    "build_galois": (lambda bb, h: bb.build_galois(h["galois"][KS[0]], KS[0]), 1, 1),
    "build_galois_many": (lambda bb, h: bb.build_galois_many(h["galois"]), 1, len(KS)),
    "build_step_ext": (lambda bb, h: bb.build_step_ext(h["quad_ext"]), 2, 1),
    "build_key_switch_linear_ext": (lambda bb, h: bb.build_key_switch_linear_ext(h["lin_ext"]),
                                    1, 1),
}


@pytest.fixture(scope="module")
def st():
    g, rng = prng.KeyChain(26), np.random.default_rng(26)
    bb = BatchedBGV(PARAMS, "cpu")
    sk, sk_new = she.gen_sk(PARAMS, g(), "cpu"), she.gen_sk(PARAMS, g(), "cpu")
    enc = bb.build_encrypt(sk)
    cts = [enc(she.pt_random(PARAMS, rng, (B,), "cpu"), g()) for _ in range(2)]
    hints = dict(quad=bb.gen_ks_quad_hint(sk, g()), lin=bb.gen_ks_linear_hint(sk_new, sk, g()),
                 quad_ext=bb.gen_ks_quad_hint_ext(sk, SPECIAL, g()),
                 lin_ext=bb.gen_ks_linear_hint_ext(sk_new, sk, SPECIAL, g()),
                 galois={k: bb.gen_galois_hint(k, sk, g()) for k in KS})
    return bb, hints, cts


@pytest.mark.parametrize("builder", list(BUILDERS))
def test_key_switch_runs_on_the_shared_core(st, builder, monkeypatch):
    """The module's hint is `ks_hint` planes (int32, (4, ell, k, n)) and no
    int64 buffer as large as a hint's rows; a forward calls `ks_inner_cm`
    once a key switch, each call over all ell digits."""
    bb, hints, cts = st
    make, n_cts, calls = BUILDERS[builder]
    mod = make(bb, hints)
    ell, n = len(QS), bb.ctx.n
    bufs = dict(mod.named_buffers())
    planes = [b for name, b in bufs.items() if name.startswith("hint_sh")]
    assert len(planes) == calls
    for b in planes:
        assert b.dtype == torch.int32 and b.shape[:2] == (4, ell) and b.shape[-1] == n
    assert not [name for name, b in bufs.items() if b.dtype == torch.int64 and b.numel() >= ell * n]
    seen = []
    real = she_batched.ks_inner_cm

    def counted(e0, e1, digits, hint, qs):
        seen.append(len(digits))
        return real(e0, e1, digits, hint, qs)

    monkeypatch.setattr(she_batched, "ks_inner_cm", counted)
    mod(*(t for c in cts[:n_cts] for t in c))
    assert seen == [ell] * calls
