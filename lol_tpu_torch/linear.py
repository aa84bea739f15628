"""E-linear maps between cyclotomic rings (`Linear`, `eval_lin`).

Counterpart of `lol_tpu/linear.py`: an E-linear map f : R -> S (E a
common subring, m_E | m_R and m_E | m_S) held by its images ys_i = f(b_i)
of the relative powerful basis of R/E (monomials b_i).  Writing
x = sum_i b_i * embed_R(a_i) with a_i in E (a gather of x's
powerful-basis coefficients by `ops.general.rel_coeff_table`),
f(x) = sum_i ys_i * embed_S(a_i).

The JAX package keeps each ys_i as a ring element mod Q; here ys_i is its
(n_s,) integer powerful-basis coefficient vector over S (numpy int64),
which the tunnel reduces into each channel.  `eval_lin` is the host
plaintext map on numpy, the oracle that ring tunneling is checked against.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .ops import general as gen
from .ring import RingContext


@dataclass(frozen=True, eq=False)
class Linear:
    """f : R -> S, E-linear, via the images ys of R/E's relative powerful
    basis, each an (n_s,) int64 coefficient vector over S."""

    e_ctx: RingContext
    r_ctx: RingContext
    s_ctx: RingContext
    ys: tuple[np.ndarray, ...]

    def __post_init__(self):
        for name, ctx in (("R", self.r_ctx), ("S", self.s_ctx)):
            if not self.e_ctx.fm.divides(ctx.fm):
                raise ValueError(f"Linear: E={self.e_ctx.m} must divide {name}={ctx.m}")
        d = self.r_ctx.n // self.e_ctx.n
        if len(self.ys) != d:
            raise ValueError(f"Linear: need {d} basis images, got {len(self.ys)}")
        for y in self.ys:
            if y.shape != (self.s_ctx.n,):
                raise ValueError(f"Linear: image of shape {y.shape}, S has n={self.s_ctx.n}")

    @property
    def d(self) -> int:
        """The number of relative basis elements, n_r / n_e."""
        return len(self.ys)


def linear_pow(e_ctx: RingContext, r_ctx: RingContext, s_ctx: RingContext, ys) -> Linear:
    """The map with images ys (integer coefficients over S) of the
    relative powerful basis monomials."""
    return Linear(e_ctx, r_ctx, s_ctx,
                  tuple(np.array(y, dtype=np.int64) for y in ys))


def eval_lin(lin: Linear, x, p: int) -> np.ndarray:
    """f(x) mod p for x in R given by its (n_r,) integer powerful-basis
    coefficients: the (n_s,) int64 powerful-basis coefficients of the image
    in [0, p), exact (`she.ring_mul_sum` over S).  (At 2-power m the
    powerful and decoding bases coincide; elsewhere `ops.general.l_host`
    converts a decryption's decoding-basis coefficients.)"""
    from .she import ring_mul_sum

    n_r, n_s = lin.r_ctx.n, lin.s_ctx.n
    x = np.asarray(x, dtype=np.int64) % p
    if x.shape != (n_r,):
        raise ValueError(f"eval_lin: x of shape {x.shape}, R has n={n_r}")
    coeff = gen.rel_coeff_table(lin.e_ctx.m, lin.r_ctx.m)
    embed = gen.embed_pow_table(lin.e_ctx.m, lin.s_ctx.m)
    pairs = []
    for y, rows in zip(lin.ys, coeff):
        a = np.zeros(n_s, dtype=np.int64)
        a[embed] = x[rows]
        pairs.append((y, a))
    return ring_mul_sum(pairs, p, lin.s_ctx.m, basis="pow")
