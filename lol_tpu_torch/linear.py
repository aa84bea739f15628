"""E-linear maps between 2-power cyclotomic rings (`Linear`, `eval_lin`).

Counterpart of `lol_tpu/linear.py` for 2-power indices: an E-linear map
f : R -> S (E a common subring) held by its images ys_i = f(b_i) of the
relative powerful basis of R/E, the monomials b_i = x^i.  Writing
x = sum_i b_i * embed_R(a_i) with a_i in E (a gather by
`ops.general.rel_coeff_table`), f(x) = sum_i ys_i * embed_S(a_i).

The JAX package keeps each ys_i as a ring element mod Q; here ys_i is its
(n_s,) integer coefficient vector over S (numpy int64), which the
tunnel reduces into each channel.  `eval_lin` is the host plaintext map
on numpy, the oracle that ring tunneling is checked against.
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
            if ctx.m % self.e_ctx.m:
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


def _negacyclic_mul(a: np.ndarray, b: np.ndarray, p: int) -> np.ndarray:
    """a * b in Z_p[x]/(x^n + 1) for coefficient vectors in [0, p)."""
    n = a.shape[0]
    full = np.convolve(a, b)
    out = full[:n].copy()
    out[: n - 1] -= full[n:]
    return out % p


def eval_lin(lin: Linear, x, p: int) -> np.ndarray:
    """f(x) mod p for x in R given by its (n_r,) integer coefficients:
    the (n_s,) int64 coefficients of the image in [0, p) (exact: int64
    convolutions, n_s (p - 1)^2 < 2^62)."""
    n_r, n_s = lin.r_ctx.n, lin.s_ctx.n
    if n_s * (p - 1) ** 2 >= 1 << 62:
        raise ValueError(f"eval_lin: n={n_s}, p={p} overflow the int64 products")
    x = np.asarray(x, dtype=np.int64) % p
    if x.shape != (n_r,):
        raise ValueError(f"eval_lin: x of shape {x.shape}, R has n={n_r}")
    coeff = gen.rel_coeff_table(lin.e_ctx.m, lin.r_ctx.m)
    embed = gen.embed_pow_table(lin.e_ctx.m, lin.s_ctx.m)
    acc = np.zeros(n_s, dtype=np.int64)
    for y, rows in zip(lin.ys, coeff):
        a = np.zeros(n_s, dtype=np.int64)
        a[embed] = x[rows]
        acc = (acc + _negacyclic_mul(y % p, a, p)) % p
    return acc
