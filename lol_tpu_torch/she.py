"""BGV-style symmetric somewhat-homomorphic encryption: parameters, keys,
hints, and the object path over single ciphertexts.

Counterpart of `lol_tpu/she.py` (Lol's SymmSHE), at any m: a ciphertext
c = (c_0, ..., c_d) satisfies c(s) = sum_i c_i s^i = f*m + p*e (mod Q)
under the LSD encoding and c(s) = round(Q/p)*m + e (mod Q) under the MSD
one, with message m in R_p, small error e and a tracked scale factor f
in Z_p^*.  Messages are decoding-basis coefficients (at 2-power m the
powerful and decoding bases coincide).

The object path (`CT` of `cyc.Cyc` components): encrypt / decrypt,
the error term and noise budget, add / mul / public ops, the encoding
switches, gadget key switching (linear, quadratic, Galois, and over an
extended modulus), exact modulus switching, plaintext-modulus switches
and the homomorphic rounding (`pt_round`), and ring switching (embed,
twace, tunnel).  Its ring arithmetic is `Cyc`'s: on the card every CRT
transform runs the NTT kernels, and `ct_mul` of two degree-1
ciphertexts runs the ct_mul kernel (`ops.cuda.pointwise.ct_mul_cm`), one
launch per channel.  The hints are shared with the batched pipeline
(`she_batched.BatchedBGV`): one `KSHint` (CRT residue stacks with its
gadget) and one `TunnelHint` serve both paths.  Beside them: the rounding's
schedule (`pt_round_mults`, `PTRoundHints`) and the host plaintext
oracles, exact products in R_p (`pt_mul`, `ring_mul_sum`) and the
automorphisms (`galois_ints`).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace

import numpy as np
import torch

from . import gadget as gd
from . import numtheory as nt
from . import prng, sampling
from .cyc import Cyc, Rep
from .factored import fact
from .linear import Linear
from .ops import general as gen
from .ops.cuda.pointwise import ct_mul_cm
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

    def s_cyc(self, ctx: RingContext, device="cuda") -> Cyc:
        """s over ring ctx, in the CRT basis, on device."""
        return Cyc.from_ints(ctx, self.s_ints, device=device).to_crt()


def _hint_rows(h) -> torch.Tensor:
    """A hint's rows as one (ell, nrns, n) int32 CRT tensor: a tensor as
    given, the reference's tuple of `Cyc` stacked in the CRT basis."""
    return h if isinstance(h, torch.Tensor) else torch.stack([c.to_crt().data for c in h])


def _set_fields(obj, **fields) -> None:
    for name, value in fields.items():
        object.__setattr__(obj, name, value)


@dataclass(frozen=True, eq=False, init=False)
class KSHint:
    """Gadget-encoded encryptions of a target t under s, in the CRT domain:
    h0[j] = p e_j + g_j t - a_j s and h1[j] = a_j, each an (ell, nrns, n)
    int32 tensor, g the gadget of `spec` over params' chain.  The batched
    pipeline takes RNS-gadget hints; the object path takes any gadget.
    The ring is params' own: the reference's `ctx` is taken by keyword and
    must be it, and its tuples of `Cyc` are taken for h0 / h1."""

    params: SHEParams
    h0: torch.Tensor
    h1: torch.Tensor
    spec: gd.GadgetSpec = gd.RnsGad()

    def __init__(self, params: SHEParams, h0, h1, spec: gd.GadgetSpec = gd.RnsGad(), *,
                 ctx: RingContext | None = None):
        if ctx is not None and ctx != params.ctx:
            raise ValueError(f"KSHint: ctx {ctx} is not params' ring {params.ctx}")
        _set_fields(self, params=params, h0=_hint_rows(h0), h1=_hint_rows(h1), spec=spec)

    @property
    def ctx(self) -> RingContext:
        return self.params.ctx


@dataclass(frozen=True, eq=False, init=False)
class KSHintExt:
    """Extended-modulus (hybrid) key-switch hint: gadget encryptions of
    P * target over the chain ext_qs = Q * P (P the product of the last
    n_special primes), with the BASE chain's RNS gadget, so ell = the base
    chain's length.  h0 / h1 are (ell, nrns_ext, n) int32 CRT tensors;
    params is the base chain's.  The chain may be given as the reference
    gives it, `ctx_ext` (the ring over Q * P), and h0 / h1 as tuples of
    `Cyc`."""

    params: SHEParams
    ext_qs: tuple[int, ...]
    n_special: int
    h0: torch.Tensor
    h1: torch.Tensor
    spec: gd.GadgetSpec = gd.RnsGad()

    def __init__(self, params: SHEParams, ext_qs: tuple[int, ...] | None = None,
                 n_special: int | None = None, h0=None, h1=None,
                 spec: gd.GadgetSpec = gd.RnsGad(), *, ctx_ext: RingContext | None = None):
        if ctx_ext is not None:
            if ctx_ext.m != params.m or ext_qs is not None and tuple(ext_qs) != ctx_ext.basis.qs:
                raise ValueError(f"KSHintExt: ctx_ext {ctx_ext} is not m={params.m} over "
                                 f"ext_qs={ext_qs}")
            ext_qs = ctx_ext.basis.qs
        if ext_qs is None or n_special is None or h0 is None or h1 is None:
            raise TypeError("KSHintExt: needs ext_qs (or ctx_ext), n_special, h0 and h1")
        _set_fields(self, params=params, ext_qs=tuple(ext_qs), n_special=n_special,
                    h0=_hint_rows(h0), h1=_hint_rows(h1), spec=spec)

    @property
    def ctx_ext(self) -> RingContext:
        return ring_context(self.params.m, self.ext_qs)


@dataclass(frozen=True, eq=False)
class TunnelHint:
    """Everything that applies the E-linear map `lin` (R -> S) to a
    ciphertext and moves it to ring S: per relative basis element b_i of
    R/E, a KSHint over S encrypting f(b_i * s_R) under s_S, with the
    gadget `spec`."""

    lin: Linear
    hints: tuple[KSHint, ...]
    spec: gd.GadgetSpec = gd.RnsGad()


def gen_sk(params: SHEParams, key, device="cuda") -> SK:
    """Sample s from the rounded decoding-basis Gaussian of variance
    params.var (`sampling.gaussian_dec_ints`), drawn on device; the
    integers are kept on the host."""
    s = sampling.gaussian_dec_ints(params.ctx, key, params.var, device=device).cpu()
    return SK(params, s, params.var)


def pt_random(params: SHEParams, rng: np.random.Generator, batch: tuple[int, ...] = (),
              device="cuda") -> torch.Tensor:
    """Uniform plaintext coefficients in [0, p), shape (n, *batch), int32
    on device: `rng.integers(0, p, (n, *batch))`, so with batch () the
    same rng gives the reference's `pt_random(params, rng)`."""
    x = rng.integers(0, params.p, (params.ctx.n, *batch)).astype(np.int32)
    return torch.from_numpy(x).to(device)


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


def pt_round_hints(sk: SK, spec: gd.GadgetSpec, key, device="cuda") -> PTRoundHints:
    """Quad hints for pt_round, made on the device: hint i lives at chain
    prefix qs[:L0-i], because every multiplication is followed by one
    modulus switch, and is `ks_quad_circ_hint` there under the i-th
    subkey of the key (the batched rounding takes spec = RnsGad())."""
    M = pt_round_mults(sk.params.p)
    L0 = len(sk.params.qs)
    if L0 < M + 1:
        raise ValueError(f"pt_round needs >= {M + 1} RNS primes, have {L0}")
    hints = []
    for i in range(M):
        key, sub = prng.split(key)
        params_i = replace(sk.params, qs=sk.params.qs[: L0 - i])
        hints.append(ks_quad_circ_hint(SK(params_i, sk.s_ints, sk.var), spec, sub, device))
    return PTRoundHints(tuple(hints))


# ---------------------------------------------------------------------------
# the object path: ciphertexts of ring elements
# ---------------------------------------------------------------------------


@dataclass(frozen=True, eq=False)
class CT:
    """A ciphertext (c_0, ..., c_d) of `Cyc` components over ctx (the
    current ring and chain), scale factor f in Z_p^*, and one of the
    reference's two encodings: "lsd", c(s) = f m + p e (mod Q), or "msd",
    c(s) = round(Q/p) m + e (mod Q)."""

    params: SHEParams
    ctx: RingContext
    cs: tuple[Cyc, ...]
    f: int = 1
    encoding: str = "lsd"

    @property
    def degree(self) -> int:
        return len(self.cs) - 1

    @property
    def device(self) -> torch.device:
        return self.cs[0].device


def pt_add(params: SHEParams, a, b) -> np.ndarray:
    return (np.asarray(a, dtype=np.int64) + np.asarray(b, dtype=np.int64)) % params.p


def _gaussian(ctx: RingContext, key, var: float, device) -> np.ndarray:
    return sampling.gaussian_dec_ints(ctx, key, var, device=device).cpu().numpy()


def encrypt(sk: SK, m_ints, key, device="cuda") -> CT:
    """LSD encryption (Lol encrypt): c1 uniform, c0 = (m + p e) - c1 s."""
    params = sk.params
    ctx = params.ctx
    k_err, k_unif = prng.split(key)
    e = _gaussian(ctx, k_err, params.var, device)
    msg_err = Cyc.from_ints(ctx, np.asarray(m_ints, dtype=np.int64) + params.p * e,
                            rep=Rep.DEC, device=device)
    c1 = sampling.uniform(ctx, k_unif, device=device)
    return CT(params, ctx, (msg_err - c1 * sk.s_cyc(ctx, device), c1))


def encrypt_msd(sk: SK, m_ints, key, device="cuda") -> CT:
    """MSD encryption: c(s) = Delta m + e, Delta = Q // p."""
    params = sk.params
    ctx = params.ctx
    delta = ctx.basis.modulus // params.p
    k_err, k_unif = prng.split(key)
    e = _gaussian(ctx, k_err, params.var, device)
    scaled = np.asarray(m_ints, dtype=object) % params.p * delta + e.astype(object)
    msg_err = Cyc.from_ints(ctx, scaled, rep=Rep.DEC, device=device)
    c1 = sampling.uniform(ctx, k_unif, device=device)
    return CT(params, ctx, (msg_err - c1 * sk.s_cyc(ctx, device), c1), encoding="msd")


def _eval_at_s(sk: SK, ct: CT) -> Cyc:
    """c(s) = sum c_i s^i by Horner in the CRT domain."""
    s = sk.s_cyc(ct.ctx, ct.device)
    acc = ct.cs[-1].to_crt()
    for c in reversed(ct.cs[:-1]):
        acc = acc * s + c.to_crt()
    return acc


def decrypt(sk: SK, ct: CT) -> np.ndarray:
    """The message's decoding-basis coefficients, int64 in [0, p): LSD,
    the centered lift of c(s) mod p times f^-1; MSD, round-half-up of
    (p / Q) times the lift, exact on Python ints."""
    d = _eval_at_s(sk, ct).lift_ints()
    p = ct.params.p
    finv = nt.modinv(ct.f, p)
    if ct.encoding == "msd":
        Q = ct.ctx.basis.modulus
        d = (2 * d * p + Q) // (2 * Q)
    return (d % p * finv % p).astype(np.int64)


def decrypt_unrestricted(sk: SK, ct: CT) -> np.ndarray:
    """Lol decryptUnrestricted: `decrypt`, which enforces no error bound."""
    return decrypt(sk, ct)


def error_term(sk: SK, ct: CT) -> np.ndarray:
    """The integer noise e with c(s) = f m + p e (Lol errorTerm): the lift
    of c(s) less its centered residue mod p, over p; object ints."""
    d = _eval_at_s(sk, ct).lift_ints()
    p = ct.params.p
    mu = d % p
    mu = np.where(mu >= (p + 1) // 2, mu - p, mu)
    return (d - mu) // p


def error_term_unrestricted(sk: SK, ct: CT) -> np.ndarray:
    return error_term(sk, ct)


def absorb_g_factors(ct: CT) -> CT:
    """Lol absorbGFactors: the identity here, as in the reference (the
    product is a plain CRT Hadamard and decryption never divides by g)."""
    return ct


def noise_bits(sk: SK, ct: CT) -> float:
    """log2 of the largest |noise| coefficient."""
    mx = max(abs(int(v)) for v in error_term(sk, ct).reshape(-1))
    return float(np.log2(float(mx))) if mx else 0.0


# --- homomorphic arithmetic -------------------------------------------------


def _p_times(ctx: RingContext, p: int, key, var: float, device) -> Cyc:
    """p e (CRT) for e the rounded decoding-basis Gaussian of the key."""
    e = sampling.gaussian_dec_ints(ctx, key, var, device=device)
    return Cyc(ctx, Rep.POW, sampling._ints_to_rns(ctx, p * e)).to_crt()


def _scalar_crt(ctx: RingContext, c: int, device) -> Cyc:
    return Cyc.scalar(ctx, c, device).to_crt()


def _align(a: CT, b: CT) -> tuple[CT, CT]:
    """Equal scales: b's components times u = f_a f_b^-1 (centered)."""
    if a.ctx != b.ctx:
        raise ValueError("CT op across different rings/moduli")
    if a.encoding != b.encoding:
        raise ValueError("CT op across encodings (lsd vs msd)")
    if a.f == b.f:
        return a, b
    p = a.params.p
    u = a.f * nt.modinv(b.f, p) % p
    if u >= (p + 1) // 2:
        u -= p
    return a, replace(b, cs=tuple(c * int(u) for c in b.cs), f=a.f)


def ct_add(a: CT, b: CT) -> CT:
    a, b = _align(a, b)
    la, lb = list(a.cs), list(b.cs)
    while len(la) < len(lb):
        la.append(Cyc.zero(a.ctx, device=a.device))
    while len(lb) < len(la):
        lb.append(Cyc.zero(a.ctx, device=a.device))
    return replace(a, cs=tuple(x + y for x, y in zip(la, lb)))


def ct_sub(a: CT, b: CT) -> CT:
    a, b = _align(a, b)
    return ct_add(a, replace(b, cs=tuple(-c for c in b.cs)))


def to_lsd(ct: CT) -> CT:
    """MSD -> LSD: every component times p (p Delta = -Q mod p), the scale
    picking up -Q mod p."""
    if ct.encoding == "lsd":
        return ct
    p = ct.params.p
    f = ct.f * ((-ct.ctx.basis.modulus) % p) % p
    return replace(ct, cs=tuple(c * p for c in ct.cs), f=f, encoding="lsd")


def to_msd(ct: CT) -> CT:
    """LSD -> MSD: every component times p^-1 mod Q, the scale picking up
    -Q^-1 mod p."""
    if ct.encoding == "msd":
        return ct
    p = ct.params.p
    Q = ct.ctx.basis.modulus
    u = _scalar_crt(ct.ctx, nt.modinv(p % Q, Q), ct.device)
    f = ct.f * ((-nt.modinv(Q % p, p)) % p) % p
    return replace(ct, cs=tuple(c.to_crt() * u for c in ct.cs), f=f, encoding="msd")


def _ct_mul_11(ctx: RingContext, ca, cb) -> tuple[Cyc, Cyc, Cyc]:
    """(c0 + c1 s)(d0 + d1 s) of CRT components: `ct_mul_cm` per channel."""
    ins = [torch.movedim(c.data, -2, 0).contiguous() for c in (*ca, *cb)]
    es = tuple(torch.empty_like(ins[0]) for _ in range(3))
    for i, q in enumerate(ctx.basis.qs):
        ct_mul_cm(*(t[i] for t in ins), q, out=tuple(e[i] for e in es))
    return tuple(Cyc(ctx, Rep.CRT, torch.movedim(e, 0, -2)) for e in es)


def ct_mul(a: CT, b: CT) -> CT:
    """The component convolution (Lol CT (*)): degree adds.  LSD * LSD is
    LSD, MSD * LSD is MSD, and MSD * MSD switches b to LSD first.  Two
    degree-1 operands run the ct_mul kernel; other degrees the CRT
    Hadamards."""
    if a.ctx != b.ctx:
        raise ValueError("CT mul across different rings/moduli")
    if a.encoding == "msd" and b.encoding == "msd":
        b = to_lsd(b)
    ca = [c.to_crt() for c in a.cs]
    cb = [c.to_crt() for c in b.cs]
    if len(ca) == len(cb) == 2:
        out = _ct_mul_11(a.ctx, ca, cb)
    else:
        out = [Cyc.zero(a.ctx, device=a.device, rep=Rep.CRT)
               for _ in range(len(ca) + len(cb) - 1)]
        for i, x in enumerate(ca):
            for j, y in enumerate(cb):
                out[i + j] = out[i + j] + x * y
    enc = "msd" if "msd" in (a.encoding, b.encoding) else "lsd"
    return CT(a.params, a.ctx, tuple(out), f=a.f * b.f % a.params.p, encoding=enc)


def add_public(ct: CT, m_pub) -> CT:
    """ct + m_pub (Lol addPublic): c0 plus f m_pub (LSD) or
    Delta [f m_pub]_p (MSD)."""
    p = ct.params.p
    scaled = np.asarray(m_pub, dtype=np.int64) * ct.f % p
    if ct.encoding == "msd":
        scaled = scaled.astype(object) * (ct.ctx.basis.modulus // p)
    enc = Cyc.from_ints(ct.ctx, scaled, rep=Rep.DEC, device=ct.device)
    return replace(ct, cs=(ct.cs[0] + enc,) + ct.cs[1:])


def mul_public(ct: CT, m_pub) -> CT:
    """ct * m_pub (Lol mulPublic): every component times the centered lift
    of the public plaintext."""
    p = ct.params.p
    lifted = np.asarray(m_pub, dtype=np.int64) % p
    lifted = np.where(lifted >= (p + 1) // 2, lifted - p, lifted)
    mc = Cyc.from_ints(ct.ctx, lifted, rep=Rep.DEC, device=ct.device).to_crt()
    return replace(ct, cs=tuple(c * mc for c in ct.cs))


# --- key switching (Lol KSLinearHint / KSQuadCircHint) ----------------------


def _ks_hint(sk: SK, target: Cyc, spec: gd.GadgetSpec, key, device="cuda") -> KSHint:
    """Gadget encryptions of target under sk: for each gadget entry g_j,
    h0_j = p e_j + g_j t - a_j s, h1_j = a_j (CRT), a_j and e_j drawn from
    the j-th (k_a, k_e) of the key's split chain."""
    params = sk.params
    ctx = params.ctx
    s = sk.s_cyc(ctx, device)
    t = target.to_crt()
    h0, h1 = [], []
    for gj in gd.gadget_ints(spec, ctx.basis):
        key, k_a, k_e = prng.split(key, 3)
        a_j = sampling.uniform(ctx, k_a, device=device)
        pe = _p_times(ctx, params.p, k_e, params.var, device)
        h0.append((pe + t * _scalar_crt(ctx, gj, device) - a_j * s).to_crt().data)
        h1.append(a_j.to_crt().data)
    return KSHint(params, torch.stack(h0), torch.stack(h1), spec)


def ks_linear_hint(s_new: SK, s_old: SK, spec: gd.GadgetSpec, key,
                   device="cuda") -> KSHint:
    """The hint re-encrypting from s_old to s_new (Lol ksLinearHint)."""
    tgt = Cyc.from_ints(s_new.params.ctx, s_old.s_ints, device=device)
    return _ks_hint(s_new, tgt, spec, key, device)


def ks_quad_circ_hint(sk: SK, spec: gd.GadgetSpec, key,
                      device="cuda") -> KSHint:
    """The hint relinearizing the s^2 component (Lol ksQuadCircHint)."""
    s = sk.s_cyc(sk.params.ctx, device)
    return _ks_hint(sk, s * s, spec, key, device)


def ks_galois_hint(k: int, sk: SK, spec: gd.GadgetSpec, key,
                   device="cuda") -> KSHint:
    """The hint of sigma_k (gcd(k, m) = 1): gadget encryptions of
    sigma_k(s) under s."""
    target = Cyc.from_ints(sk.params.ctx, sk.s_ints, device=device).galois(k)
    return _ks_hint(sk, target, spec, key, device)


def _hint_cycs(ctx: RingContext, h: torch.Tensor, device) -> list[Cyc]:
    h = h.to(device)
    return [Cyc(ctx, Rep.CRT, h[j]) for j in range(h.shape[0])]


def _ks_inner(hint: KSHint, c: Cyc) -> tuple[Cyc, Cyc]:
    """sum_j digit_j(c) hint_j, the gadget inner product (CRT)."""
    ctx = hint.ctx
    if c.ctx != ctx:
        raise ValueError(f"key switch: ciphertext over {c.ctx}, hint over {ctx}")
    digits = gd.decompose(hint.spec, ctx.basis, c.to_pow().data)
    h0, h1 = _hint_cycs(ctx, hint.h0, c.device), _hint_cycs(ctx, hint.h1, c.device)
    if digits.shape[0] != len(h0):
        raise ValueError(f"key switch: {digits.shape[0]} digits, the hint has {len(h0)}")
    acc0 = acc1 = Cyc.zero(ctx, device=c.device, rep=Rep.CRT)
    for j in range(digits.shape[0]):
        dj = Cyc(ctx, Rep.POW, digits[j]).to_crt()
        acc0 = acc0 + dj * h0[j]
        acc1 = acc1 + dj * h1[j]
    return acc0, acc1


def key_switch_linear(hint: KSHint, ct: CT) -> CT:
    """Re-encrypt a degree-1 ciphertext from the hint's old key to its new
    one (Lol keySwitchLinear)."""
    if ct.degree != 1:
        raise ValueError("key_switch_linear: need a linear (2-comp) ct")
    b0, b1 = _ks_inner(hint, ct.cs[1])
    return replace(ct, cs=(ct.cs[0].to_crt() + b0, b1))


def key_switch_quad_circ(hint: KSHint, ct: CT) -> CT:
    """Relinearize a degree-2 ciphertext (Lol keySwitchQuadCirc); either
    encoding (the hint adds a p-multiple of small noise)."""
    if ct.degree != 2:
        raise ValueError("key_switch_quad_circ: need a quadratic ct")
    b0, b1 = _ks_inner(hint, ct.cs[2])
    return replace(ct, cs=(ct.cs[0].to_crt() + b0, ct.cs[1].to_crt() + b1))


def ct_galois(hint: KSHint, k: int, ct: CT) -> CT:
    """sigma_k under encryption: both components slot-permuted, then the
    key switch of sigma_k(c1) back to s with the sigma_k(s) hint."""
    if ct.degree != 1:
        raise ValueError("ct_galois: need a linear (2-comp) ct")
    c0k, c1k = ct.cs[0].galois(k), ct.cs[1].galois(k)
    b0, b1 = _ks_inner(hint, c1k)
    return replace(ct, cs=(c0k.to_crt() + b0, b1))


# --- extended-modulus (hybrid) key switching --------------------------------


def _ks_hint_ext(sk: SK, target: Cyc, spec: gd.GadgetSpec, key,
                 special_qs: tuple[int, ...], device="cuda") -> KSHintExt:
    """Gadget encryptions of P g_j t over Q P (P the special primes'
    product) under sk, g the base chain's gadget."""
    params = sk.params
    ext_qs = params.qs + tuple(special_qs)
    ctx_ext = ring_context(params.m, ext_qs)
    P = math.prod(special_qs)
    s_ext = Cyc.from_ints(ctx_ext, sk.s_ints, device=device).to_crt()
    t_ext = Cyc.from_ints(ctx_ext, target.lift_ints(rep=Rep.POW), device=device).to_crt()
    h0, h1 = [], []
    for gj in gd.gadget_ints(spec, params.ctx.basis):
        key, k_a, k_e = prng.split(key, 3)
        a_j = sampling.uniform(ctx_ext, k_a, device=device)
        pe = _p_times(ctx_ext, params.p, k_e, params.var, device)
        pg = _scalar_crt(ctx_ext, P * gj % ctx_ext.basis.modulus, device)
        h0.append((pe + t_ext * pg - a_j * s_ext).to_crt().data)
        h1.append(a_j.to_crt().data)
    return KSHintExt(params, ext_qs, len(special_qs), torch.stack(h0), torch.stack(h1), spec)


def ks_quad_circ_hint_ext(sk: SK, spec: gd.GadgetSpec, key,
                          special_qs: tuple[int, ...], device="cuda") -> KSHintExt:
    """The relinearization hint over the extended modulus Q P."""
    s = sk.s_cyc(sk.params.ctx, device)
    return _ks_hint_ext(sk, s * s, spec, key, special_qs, device)


def ks_linear_hint_ext(s_new: SK, s_old: SK, spec: gd.GadgetSpec, key,
                       special_qs: tuple[int, ...], device="cuda") -> KSHintExt:
    """The re-encryption hint over the extended modulus Q P."""
    tgt = Cyc.from_ints(s_new.params.ctx, s_old.s_ints, device=device)
    return _ks_hint_ext(s_new, tgt, spec, key, special_qs, device)


def _ks_inner_ext(hint: KSHintExt, c: Cyc) -> tuple[Cyc, Cyc]:
    """The digits' inner product over Q P, then the special primes dropped
    by exact LSD rescales (the key-switch noise divided by P)."""
    base_ctx, ctx_ext, p = hint.params.ctx, hint.ctx_ext, hint.params.p
    digits = gd.decompose(hint.spec, base_ctx.basis, c.to_pow().data)
    h0, h1 = _hint_cycs(ctx_ext, hint.h0, c.device), _hint_cycs(ctx_ext, hint.h1, c.device)
    acc0 = acc1 = Cyc.zero(ctx_ext, device=c.device, rep=Rep.CRT)
    for j in range(digits.shape[0]):
        dj_ints = Cyc(base_ctx, Rep.POW, digits[j]).lift_ints(rep=Rep.POW)
        dj = Cyc.from_ints(ctx_ext, dj_ints, device=c.device).to_crt()
        acc0 = acc0 + dj * h0[j]
        acc1 = acc1 + dj * h1[j]
    for _ in range(hint.n_special):
        cctx = acc0.ctx
        ctx2 = ring_context(cctx.m, cctx.basis.qs[:-1])
        acc0 = Cyc(ctx2, Rep.POW, _bgv_rescale(cctx, acc0.to_pow().data, p))
        acc1 = Cyc(ctx2, Rep.POW, _bgv_rescale(cctx, acc1.to_pow().data, p))
    return acc0, acc1


def key_switch_linear_ext(hint: KSHintExt, ct: CT) -> CT:
    if ct.degree != 1:
        raise ValueError("key_switch_linear_ext: need a linear (2-comp) ct")
    b0, b1 = _ks_inner_ext(hint, ct.cs[1])
    return replace(ct, cs=(ct.cs[0].to_crt() + b0.to_crt(), b1.to_crt()))


def key_switch_quad_circ_ext(hint: KSHintExt, ct: CT) -> CT:
    if ct.degree != 2:
        raise ValueError("key_switch_quad_circ_ext: need a quadratic ct")
    b0, b1 = _ks_inner_ext(hint, ct.cs[2])
    return replace(ct, cs=(ct.cs[0].to_crt() + b0.to_crt(), ct.cs[1].to_crt() + b1.to_crt()))


# --- modulus switching ------------------------------------------------------


def _bgv_rescale(ctx: RingContext, a: torch.Tensor, p: int) -> torch.Tensor:
    """(a - p centered([a p^-1]_{q_last})) / q_last over the chain's prefix,
    for (..., nrns, n) powerful-basis residues; int32."""
    qs = ctx.basis.qs
    ql = qs[-1]
    v = a[..., -1:, :].long() * nt.modinv(p % ql, ql) % ql
    centered = torch.where(v >= (ql + 1) // 2, v - ql, v)
    prefix = ctx.basis.drop_last()
    qv = prefix.qv(a.device)
    k = torch.tensor([[nt.modinv(ql % q, q), p % q] for q in qs[:-1]], dtype=torch.int64,
                     device=a.device)
    delta = centered % qv * k[:, 1:] % qv
    return ((a[..., :-1, :].long() - delta) % qv * k[:, :1] % qv).to(torch.int32)


def mod_switch(ct: CT) -> CT:
    """Drop the last prime, the exact BGV rescale (Lol modSwitch): LSD
    subtracts p centered([c p^-1]_{q_last}) first and the scale picks up
    q_last^-1; MSD rounds to nearest and keeps f."""
    ctx, p = ct.ctx, ct.params.p
    ql = ctx.basis.qs[-1]
    ctx2 = ring_context(ctx.m, ctx.basis.qs[:-1])
    params2 = replace(ct.params, qs=ctx2.basis.qs)
    if ct.encoding == "msd":
        cs2 = tuple(Cyc(ctx2, Rep.POW, ctx.basis.rescale_drop_last(c.to_pow().data))
                    for c in ct.cs)
        return CT(params2, ctx2, cs2, f=ct.f, encoding="msd")
    cs2 = tuple(Cyc(ctx2, Rep.POW, _bgv_rescale(ctx, c.to_pow().data, p)) for c in ct.cs)
    return CT(params2, ctx2, cs2, f=ct.f * nt.modinv(ql % p, p) % p)


def mod_switch_pt(ct: CT, p_new: int) -> CT:
    """Plaintext modulus p -> p' for p' | p (Lol modSwitchPT): LSD
    reinterprets the ciphertext; MSD goes through the encoding switches."""
    if ct.params.p % p_new != 0:
        raise ValueError("mod_switch_pt: p' must divide p")
    if ct.encoding == "msd":
        return to_msd(mod_switch_pt(to_lsd(ct), p_new))
    return replace(ct, params=replace(ct.params, p=p_new), f=ct.f % p_new)


def div_d(ct: CT, d: int) -> CT:
    """Exact division by d | p of a plaintext divisible by d: every
    component times d^-1 mod Q, so f m + p e becomes f (m / d) + (p / d) e."""
    p = ct.params.p
    if p % d:
        raise ValueError("div_d: d must divide the plaintext modulus")
    Q = ct.ctx.basis.modulus
    u = _scalar_crt(ct.ctx, nt.modinv(d % Q, Q), ct.device)
    return replace(ct, params=replace(ct.params, p=p // d),
                   cs=tuple(c.to_crt() * u for c in ct.cs), f=ct.f % (p // d))


def div_2(ct: CT) -> CT:
    return div_d(ct, 2)


def pt_round(ct: CT, rh: PTRoundHints) -> CT:
    """Homomorphic rounding of a scalar plaintext Z_{pr^k} -> Z_pr (pr in
    {2, 3}): the output encrypts round-half-up(x / pr^(k-1)) mod pr.
    pr = 2: iterated LSB stripping (b = y^(2^t), y <- div_2(y - b), after a
    pre-add of 2^(k-2)); pr = 3: balanced-digit stripping by cubings.
    Each multiplication is relinearized by its hint and rescaled.  MSD
    runs the LSD schedule between the exact encoding switches."""
    if ct.encoding == "msd":
        return to_msd(pt_round(to_lsd(ct), rh))
    pr, k = _pt_round_base(ct.params.p)
    if k == 1:
        return ct
    it = iter(rh.hints)

    def mult(x: CT, y: CT) -> CT:
        return mod_switch(key_switch_quad_circ(next(it), ct_mul(x, y)))

    def drop_to(x: CT, other: CT) -> CT:
        while len(x.ctx.basis.qs) > len(other.ctx.basis.qs):
            x = mod_switch(x)
        return x

    if pr == 2:
        shift = np.zeros(ct.ctx.n, dtype=np.int64)
        shift[0] = 1 << (k - 2)
        y = add_public(ct, shift)
        for j in range(k, 1, -1):
            b = y
            for _ in range(_lsb_squarings(j)):
                b = mult(b, b)
            y = div_2(ct_sub(drop_to(y, b), b))
        return y
    y = ct
    for j in range(k, 1, -1):
        t = y
        for _ in range(j - 1):  # t <- t^3
            sq = mult(t, t)
            t = mult(sq, drop_to(t, sq))
        y = div_d(ct_sub(drop_to(y, t), t), 3)
    return y


# --- ring switching (Lol embedSK / embedCT / twaceCT / tunnel) --------------


def embed_sk(sk: SK, m_sup: int) -> SK:
    """The subring's key viewed in the larger ring (Lol embedSK)."""
    params = sk.params
    sup = ring_context(m_sup, params.qs)
    emb = Cyc.from_ints(params.ctx, sk.s_ints, device="cpu").embed(sup)
    s = torch.from_numpy(emb.lift_ints().astype(np.int64))
    return SK(replace(params, m=m_sup), s, sk.var)


def embed_ct(ct: CT, m_sup: int) -> CT:
    """A ciphertext viewed in a larger ring (Lol embedCT); it decrypts under
    the embedded key."""
    sup = ring_context(m_sup, ct.params.qs)
    return replace(ct, params=replace(ct.params, m=m_sup), ctx=sup,
                   cs=tuple(c.embed(sup) for c in ct.cs))


def twace_ct(ct: CT, m_sub: int) -> CT:
    """The tweaked trace of a ciphertext down to a subring (Lol twaceCT),
    valid when the key lives in the subring."""
    sub = ring_context(m_sub, ct.params.qs)
    return replace(ct, params=replace(ct.params, m=m_sub), ctx=sub,
                   cs=tuple(c.twace(sub) for c in ct.cs))


def tunnel_hint(lin: Linear, sk_s: SK, sk_r: SK, spec: gd.GadgetSpec,
                key, device="cuda") -> TunnelHint:
    """Lol tunnelHint: hint i holds the gadget encryptions of f(b_i s_R)
    under s_S, b_i the relative powerful basis of R / E."""
    from . import linear

    s_r = Cyc.from_ints(lin.r_ctx, sk_r.s_ints, device=device).to_crt()
    hints = []
    for b_i in linear.rel_basis_elements(lin.r_ctx, lin.e_ctx, device):
        key, sub = prng.split(key)
        hints.append(_ks_hint(sk_s, linear.eval_lin(lin, b_i * s_r), spec, sub, device))
    return TunnelHint(lin, tuple(hints), spec)


def tunnel(th: TunnelHint, ct: CT) -> CT:
    """Apply th.lin under encryption, moving ct from ring R to ring S (Lol
    tunnel): for ct = (c0, c1) with c1 = sum_i b_i embed(a_i),
    out = (evalLin(c0), 0) + sum_{i, j} digit_j(a_i) hint_{i, j}."""
    from . import linear

    if ct.degree != 1:
        raise ValueError("tunnel: need a linear (2-component) ct")
    lin = th.lin
    if ct.ctx != lin.r_ctx:
        raise ValueError("tunnel: ct not in the map's source ring")
    s_ctx, e_ctx = lin.s_ctx, lin.e_ctx
    c0, c1 = ct.cs
    out0 = linear.eval_lin(lin, c0.to_crt())
    acc1 = Cyc.zero(s_ctx, device=ct.device, rep=Rep.CRT)
    for a_i, hint in zip(c1.coeffs(e_ctx, rep=Rep.POW), th.hints):
        digits = gd.decompose(th.spec, e_ctx.basis, a_i.to_pow().data)
        h0 = _hint_cycs(s_ctx, hint.h0, ct.device)
        h1 = _hint_cycs(s_ctx, hint.h1, ct.device)
        for j in range(digits.shape[0]):
            dj = Cyc(e_ctx, Rep.POW, digits[j]).embed(s_ctx).to_crt()
            out0 = out0 + dj * h0[j]
            acc1 = acc1 + dj * h1[j]
    return CT(replace(ct.params, m=s_ctx.m), s_ctx, (out0, acc1), f=ct.f, encoding=ct.encoding)
