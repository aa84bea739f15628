"""BGV parameters, keys, plaintexts, key-switch and tunnel hints, and the
homomorphic rounding's schedule.

Counterpart of the pieces of `lol_tpu/she.py` that the batched pipeline
and the serving layer use, at any m: c(s) = c0 + c1 s satisfies
c(s) = f*m + p*e (mod Q) under the LSD encoding and c(s) = round(Q/p)*m
+ e (mod Q) under the MSD one, with message m in R_p, small error e and
a tracked scale factor f in Z_p^*.  Beside them: the extended-modulus
(hybrid) key-switch hint `KSHintExt`, the rounding's pieces
(`PTRoundHints`, `pt_round_mults`, `pt_round_hints`) that
`serving.build_pt_round` runs, and the host plaintext oracles: exact
products in R_p (`pt_mul`, `ring_mul_sum`) and the automorphisms
(`galois_ints`).  Messages are decoding-basis coefficients (at 2-power m
the powerful and decoding bases coincide).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace

import numpy as np
import torch

from . import numtheory as nt
from . import sampling
from .factored import fact
from .linear import Linear
from .ops import general as gen
from .ring import RingContext, ring_context
from .rns import rns_basis


@dataclass(frozen=True)
class SHEParams:
    """Cyclotomic index m, plaintext modulus p, ciphertext chain qs (NTT
    primes for m), and the error variance."""

    m: int
    p: int
    qs: tuple[int, ...]
    var: float = 9.0

    def __post_init__(self):
        for q in self.qs:
            if math.gcd(self.p, q) != 1:
                raise ValueError(f"p={self.p} not coprime to q={q}")

    @property
    def ctx(self) -> RingContext:
        return ring_context(self.m, self.qs)


@dataclass(frozen=True, eq=False)
class SK:
    """Secret key: small integer coefficients, an (n,) int64 CPU tensor."""

    params: SHEParams
    s_ints: torch.Tensor
    var: float


@dataclass(frozen=True, eq=False)
class KSHint:
    """RNS-gadget key-switch hint in the CRT domain: h0[j] = p e_j + g_j t
    - a_j s and h1[j] = a_j, each an (ell, nrns, n) int32 tensor."""

    params: SHEParams
    h0: torch.Tensor
    h1: torch.Tensor


@dataclass(frozen=True, eq=False)
class KSHintExt:
    """Extended-modulus (hybrid) key-switch hint: gadget encryptions of
    P * target over the chain ext_qs = Q * P (P the product of the last
    n_special primes), with the BASE chain's RNS gadget, so ell = the base
    chain's length.  h0 / h1 are (ell, nrns_ext, n) int32 CRT tensors;
    params is the base chain's."""

    params: SHEParams
    ext_qs: tuple[int, ...]
    n_special: int
    h0: torch.Tensor
    h1: torch.Tensor


@dataclass(frozen=True, eq=False)
class TunnelHint:
    """Everything that applies the E-linear map `lin` (R -> S) to a
    ciphertext and moves it to ring S: per relative basis element b_i of
    R/E, a KSHint over S encrypting f(b_i * s_R) under s_S."""

    lin: Linear
    hints: tuple[KSHint, ...]


def gen_sk(params: SHEParams, generator: torch.Generator) -> SK:
    """Sample s from the rounded decoding-basis Gaussian of variance
    params.var (`sampling.gaussian_dec_ints`)."""
    s = sampling.gaussian_dec_ints(params.ctx, params.var, generator, device="cpu")
    return SK(params, s, params.var)


def pt_random(params: SHEParams, generator: torch.Generator,
              batch: tuple[int, ...] = ()) -> torch.Tensor:
    """Uniform plaintext coefficients in [0, p), shape (n, *batch), int32."""
    return torch.randint(0, params.p, (params.ctx.n, *batch),
                         generator=generator, device=generator.device,
                         dtype=torch.int32)


def pt_mul(params: SHEParams, a, b) -> np.ndarray:
    """Plaintext ring product in R_p of decoding-basis coefficient vectors
    (exact, host; `ring_mul_sum`).  int64 (n,) out."""
    return ring_mul_sum([(a, b)], params.p, params.m)


def ring_mul_sum(pairs, p: int, m: int | None = None, basis: str = "dec") -> np.ndarray:
    """sum_k a_k * b_k in R_p = Z_p[zeta_m], exact on the host, for any p
    (p = 2^k is no NTT modulus): the operands' centered lifts, a numpy CRT
    product over an auxiliary chain sized to the integer bound, the
    centered CRT lift, then mod p.  pairs: (a_k, b_k), integer (n,)
    coefficient arrays; int64 (n,) out in [0, p).  m: the index, by
    default the 2-power one of n = len(a) (Z_p[x]/(x^n + 1), where the
    bases coincide).  `basis` says whether the coefficients are
    decoding-basis ("dec", messages) or powerful-basis ("pow"); at 2-power
    m, where L is the identity, the two agree.  The chain covers
    n max|a| max|b| 2^(omega + 1), omega the number of odd primes of m (the
    reference's general-m bound)."""
    def centered(x):
        x = np.asarray(x, dtype=np.int64) % p
        return np.where(x >= (p + 1) // 2, x - p, x)

    a = np.stack([centered(x) for x, _ in pairs])
    b = np.stack([centered(y) for _, y in pairs])
    n = a.shape[-1]
    bound = n * sum(int(np.abs(x).max()) * int(np.abs(y).max()) for x, y in zip(a, b))
    fm = fact(2 * n if m is None else m)
    if fm.phi != n:
        raise ValueError(f"ring_mul_sum: coefficients of length {n}, phi({fm.m}) = {fm.phi}")
    if basis not in ("dec", "pow"):
        raise ValueError(f"ring_mul_sum: basis must be 'dec' or 'pow', got {basis!r}")
    omega = sum(1 for pp in fm.pps if pp.p != 2)
    aux_qs = _aux_chain(fm.m, 2 * (bound << (omega + 1)))
    plans = [gen.general_plan(fm.m, q) for q in aux_qs]
    dec = basis == "dec"

    def fwd(x, gp):
        return gen.np_crt(gp, gen.np_l(gp, x) if dec else x)

    def inv(x, gp):
        y = gen.np_crt(gp, x, inverse=True)
        return gen.np_l(gp, y, inverse=True) if dec else y

    res = []
    for plan in plans:
        q = plan.q
        fa = fwd(np.mod(a, q).astype(np.uint32), plan).astype(np.int64)
        fb = fwd(np.mod(b, q).astype(np.uint32), plan).astype(np.int64)
        prod = (fa * fb % q).sum(0) % q
        res.append(inv(prod[None].astype(np.uint32), plan)[0])
    lifted = rns_basis(aux_qs).lift_centered(np.stack(res))
    return (lifted % p).astype(np.int64)


def galois_ints(m: int, x, k: int, p: int) -> np.ndarray:
    """The plaintext automorphism sigma_k (zeta -> zeta^k, gcd(k, m) = 1)
    of x in R_p given by its decoding-basis coefficients; int64 (n,) out
    in [0, p) (the host counterpart of the reference's `Cyc.galois`).  At
    2-power m the signed permutation x^i -> x^(ik mod 2n); at general m
    the CRT slot permutation of `zmstar.automorphism_slot_perm` on the
    centered lift over an auxiliary chain sized to n^2 max|x| 4^omega (L,
    sigma_k on the powerful basis and L^-1 each grow the coefficients by at
    most n, p - 1 and 2 per odd axis)."""
    from . import zmstar

    fm = fact(m)
    x = np.asarray(x, dtype=np.int64) % p
    x = np.where(x >= (p + 1) // 2, x - p, x)
    n = fm.phi
    if x.shape != (n,):
        raise ValueError(f"galois_ints: x of shape {x.shape}, phi({m}) = {n}")
    if math.gcd(k, m) != 1:
        raise ValueError(f"galois_ints: k={k} not a unit mod m={m}")
    if fm.is_pow2():
        e = np.arange(n, dtype=np.int64) * k % (2 * n)
        out = np.zeros(n, dtype=np.int64)
        out[e % n] = np.where(e < n, x, -x)
        return out % p
    omega = sum(1 for pp in fm.pps if pp.p != 2)
    aux_qs = _aux_chain(m, 2 * (n * n * max(1, int(np.abs(x).max())) << (2 * omega)))
    res = []
    for q in aux_qs:
        gp = gen.general_plan(m, q)
        slots = gen.np_crt(gp, gen.np_l(gp, np.mod(x, q).astype(np.uint32)))
        moved = slots[zmstar.automorphism_slot_perm(m, q, k)]
        res.append(gen.np_l(gp, gen.np_crt(gp, moved, inverse=True), inverse=True))
    return (rns_basis(aux_qs).lift_centered(np.stack(res)) % p).astype(np.int64)


def _aux_chain(m_mult: int, bound: int) -> tuple[int, ...]:
    """The smallest chain of 29-bit primes = 1 mod m_mult whose product
    exceeds `bound`, so centered lifts of values in [-bound/2, bound/2]
    are exact."""
    k = 1
    while True:
        qs = nt.ntt_primes(m_mult, 29, k)
        if math.prod(qs) > bound:
            return tuple(qs)
        k += 1


# --- homomorphic plaintext rounding (serving.build_pt_round's schedule) ---


@dataclass(frozen=True, eq=False)
class PTRoundHints:
    """One relinearization hint per pt_round multiplication, generated at
    the modulus chain that multiplication runs on (the reference's
    rounding hints inside HomomPRF's EvalHints)."""

    hints: tuple[KSHint, ...]


def _lsb_squarings(j: int) -> int:
    """Squarings to compute lsb over Z_{2^j} as y^(2^t): 2^t must be a
    multiple of the exponent 2^{j-2} of (Z/2^j)* (odd y -> 1) and have
    2^t >= j (even y -> 0)."""
    if j == 2:
        return 1
    if j == 3:
        return 2
    return j - 2


def _pt_round_base(p: int) -> tuple[int, int]:
    """p = pr^k with pr in {2, 3}: the bases pt_round supports.

    Why exactly these: for any prime pr and x in Z_{pr^j}, the map
    x -> x^(pr^{j-1}) depends only on x mod pr (binomial lift:
    (y + pr t)^(pr^{j-1}) = y^(pr^{j-1}) mod pr^j, and pr | x gives 0
    since pr^{j-1} >= j), i.e. it computes the TEICHMUELLER digit, the
    multiplicative lift omega(x mod pr).  Digit stripping
    y <- (y - omega(y)) / pr therefore works for every pr; but the
    stripped expansion x = sum_i omega(d_i) pr^i rounds the standard
    representative only when the Teichmueller reps are centered
    integers.  omega(d) is a (pr-1)-th root of unity mod pr^j, so the
    reps are {0, +-1, other roots}: for pr = 2 they are {0, 1} (the
    standard binary digits; a pre-add of pr^{k-2} turns truncation into
    rounding), for pr = 3 they are {0, 1, -1} (BALANCED ternary:
    truncation is already round-to-nearest, ties impossible), and for
    pr >= 5 they are non-central roots of unity (e.g. omega(2) mod 25 =
    7), so the technique stops computing a rounding of the integer digit
    expansion.  2 and 3 are exactly the primes whose units are {+-1}."""
    for pr in (2, 3):
        v, k = p, 0
        while v % pr == 0:
            v //= pr
            k += 1
        if v == 1 and k >= 1:
            return pr, k
    raise ValueError(f"pt_round: plaintext modulus {p} is not 2^k or 3^k")


def pt_round_mults(p: int) -> int:
    """Total ciphertext multiplications pt_round performs: at modulus
    2^j, `_lsb_squarings(j)` squarings (y^(2^t) is lsb(y)); at modulus
    3^j, j - 1 relinearized cubings of 2 multiplications each
    (y^(3^(j-1)) is the balanced ternary digit)."""
    pr, k = _pt_round_base(p)
    if pr == 2:
        return sum(_lsb_squarings(j) for j in range(2, k + 1))
    return sum(2 * (j - 1) for j in range(2, k + 1))


def pt_round_hints(sk: SK, generator: torch.Generator, device="cuda") -> PTRoundHints:
    """Quad hints for pt_round (RNS gadget), made on the device: hint i
    lives at chain prefix qs[:L0-i], because every multiplication is
    followed by one modulus switch, and is made there by that prefix's
    `BatchedBGV.gen_ks_quad_hint`."""
    from .she_batched import BatchedBGV

    M = pt_round_mults(sk.params.p)
    L0 = len(sk.params.qs)
    if L0 < M + 1:
        raise ValueError(f"pt_round needs >= {M + 1} RNS primes, have {L0}")
    hints = []
    for i in range(M):
        params_i = replace(sk.params, qs=sk.params.qs[: L0 - i])
        hints.append(BatchedBGV(params_i, device).gen_ks_quad_hint(
            SK(params_i, sk.s_ints, sk.var), generator))
    return PTRoundHints(tuple(hints))
