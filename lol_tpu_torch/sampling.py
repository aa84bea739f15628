"""Randomness: uniform ring elements, real and rounded Gaussians.

Counterpart of `lol_tpu/sampling.py`, with its keys and its draws: every
function takes a `prng` key (the raw `uint32[2]` of `jax.random.PRNGKey`)
where the reference does, splits it as the reference does, and draws the
reference's bits (`prng` is the threefry2x32 twin; on a CUDA device the
draws run the kernel of `csrc/prng.cu`).  So the same key gives the same
elements in both packages, bit for bit.

For 2-power m the decoding basis is orthogonal, so `var` is the
per-coefficient variance of iid rounded N(0, var) integers; at general m
`gaussian_dec_ints` mixes the iid draw axis by axis with the decoding
basis's factors (the same normalization: on the 2-power axis the factor is
a scaled identity), in float32 and in the order XLA's CPU dot sums: each
output a left-to-right sum of single-rounded products.  The reference
compiles the normal and its scale as one program, so XLA folds sqrt(2)
into the scale there (`prng.folded_scale`); `real_gaussians` scales an
eager normal, and keeps both roundings.
"""

from __future__ import annotations

import numpy as np
import torch

from . import prng
from .cyc import Cyc, Rep
from .factored import fact
from .ops import general as gen
from .ring import RingContext


def gaussian_ints(shape, var: float, key, device="cuda", how: str = "f32") -> torch.Tensor:
    """round(jax.random.normal(key, shape) * sqrt(var)) as compiled in one
    program (sqrt(2) folded into the scale), int64 on device: how="f32"
    takes the scale as `jnp.sqrt(jnp.float32(var))` (encryption), "f64"
    as `np.sqrt(var)` (the batched hint generator)."""
    return prng.gaussian(key, shape, prng.folded_scale(var, how), pre=1.0, rounded=True,
                         device=device).long()


def uniform_residues(qs, shape, key, device="cuda") -> torch.Tensor:
    """(nrns, *shape) int32 residues: channel i is `randint(split(key,
    nrns)[i], shape, 0, q_i)`, as `uniform` draws them."""
    return prng.randint_channels(list(prng.split(key, len(qs))), qs, shape, device)


def uniform(ctx, key, batch: tuple[int, ...] = (), device="cuda") -> Cyc:
    """A uniform element of R_q, tagged CRT (uniform in any basis), or POW
    where the modulus has no CRT basis (the plaintext rings R_{2^k})."""
    r = uniform_residues(ctx.basis.qs, (*batch, ctx.n), key, device)
    return Cyc(ctx, Rep.CRT if ctx.has_crt() else Rep.POW, torch.movedim(r, 0, -2))


def real_gaussians(key, var: float, shape, device="cuda") -> torch.Tensor:
    """Continuous spherical Gaussians of variance var, float32 (Lol
    realGaussians): `jax.random.normal(key, shape) * sqrt(var)`."""
    return prng.gaussian(key, shape, prng.sqrt_var(var), device=device)


def _mix_axis(x: torch.Tensor, L: np.ndarray) -> torch.Tensor:
    """x (..., a) -> (..., a) with out_i = sum_j L_ij x_j in float32, each
    product rounded and the sum taken left to right, as XLA's CPU dot does;
    a scaled identity is one product per element."""
    Lf = L.astype(np.float32)
    a = Lf.shape[0]
    if not np.count_nonzero(Lf - np.diag(np.diag(Lf))):
        return x * torch.from_numpy(np.diag(Lf).copy()).to(x.device)
    cols = []
    for i in range(a):
        acc = x[..., 0] * float(Lf[i, 0])
        for j in range(1, a):
            acc = acc + x[..., j] * float(Lf[i, j])
        cols.append(acc)
    return torch.stack(cols, dim=-1)


def gaussian_dec_ints(ctx, key, var: float, batch=(), device="cuda") -> torch.Tensor:
    """Rounded decoding-basis Gaussian coefficients, int64 of shape
    (*batch, n) on device (Lol tweakedGaussianDec + errorRounded): float32
    normals times sqrt(var), at general m mixed along each tensor axis of
    `phi_shape` by `dec_mixing_factors` (axis 0's scaled by sqrt(n)), then
    rounded half to even."""
    fm, n = ctx.fm, ctx.n
    scale = prng.folded_scale(var)
    if fm.is_pow2():
        return prng.gaussian(key, (*batch, n), scale, pre=1.0, rounded=True,
                             device=device).long()
    g = prng.gaussian(key, (*batch, n), scale, pre=1.0, device=device)
    gs = g.view(*batch, *fm.phi_shape)
    for i, Li in enumerate(gen.dec_mixing_factors(fm.m)):
        ax = len(batch) + i
        gs = torch.movedim(_mix_axis(torch.movedim(gs, ax, -1),
                                     Li * np.sqrt(n) if i == 0 else Li), -1, ax)
    return torch.round(gs.reshape(*batch, n)).long()


def _dec_mixing_matrix(m: int) -> np.ndarray:
    """The dense L with L L^T = Gram_dec(m)^-1 (I / sqrt(n) at 2-power m),
    the Kronecker product of `dec_mixing_factors`: only the bounds of
    `rlwe.gaussian_quad_bound` want it; the sampler applies the factors."""
    f = fact(m)
    if f.is_pow2():
        return np.eye(f.phi) / np.sqrt(max(f.phi, 1))
    out = np.ones((1, 1))
    for Li in gen.dec_mixing_factors(m):
        out = np.kron(out, Li)
    return out


def _ints_to_rns(ctx, x: torch.Tensor) -> torch.Tensor:
    """Signed integer coefficients (..., n) -> (..., nrns, n) int32 residues."""
    return torch.stack([torch.remainder(x.long(), q) for q in ctx.basis.qs],
                       dim=-2).to(torch.int32)


def gaussian_cyc(ctx, key, var: float, batch: tuple[int, ...] = (), device="cuda") -> Cyc:
    """A rounded decoding-basis Gaussian error element."""
    return Cyc(ctx, Rep.DEC, _ints_to_rns(ctx, gaussian_dec_ints(ctx, key, var, batch, device)))


def gaussian_ints_np(ctx_or_n, key, var: float, device="cuda") -> np.ndarray:
    """The sampled integers on the host, int64 (secrets kept as ints).
    ctx_or_n must be a `RingContext`, as in the JAX package."""
    if not isinstance(ctx_or_n, RingContext):
        raise TypeError(f"gaussian_ints_np: need a RingContext, got {type(ctx_or_n).__name__}")
    return gaussian_dec_ints(ctx_or_n, key, var, device=device).cpu().numpy()


def error_coset(ctx, key, var: float, coset_ints, p: int, device="cuda") -> Cyc:
    """An error congruent to coset_ints mod p (Lol errorCoset):
    coset + p * (rounded Gaussian), in the decoding basis."""
    g = gaussian_dec_ints(ctx, key, var, device=device)
    coset = torch.as_tensor(np.asarray(coset_ints, dtype=np.int64)).to(g.device)
    return Cyc(ctx, Rep.DEC, _ints_to_rns(ctx, coset + p * g))
