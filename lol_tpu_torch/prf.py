"""The key-homomorphic PRF (BP14, ring version): its public family, the
clear PRF, the hints of its homomorphic evaluation, and that evaluation
on the object path.

Counterpart of `lol_tpu/prf.py` (the batched form of the evaluation is
`serving.batched_homom_prf_component`).  Public parameters are two
gadget-dimension vectors a0, a1 in R_p^ell (p the PRF modulus, ell the
digits of the base-b gadget over Z_p); a full binary tree T over the
input bits defines

    A_T(x) = a_x                           (leaf)
    A_T(x) = A_l(x_l) * G^{-1}(A_r(x_r))   (internal)

with G^{-1} the balanced base-b decomposition applied entrywise, and the
PRF is F_s(x) = round_{p -> p_out}(s * A_T(x)).  At 2-power m the
decoding basis is the power basis, so a ring element here is its (n,)
int64 coefficient vector in [0, p).  p = 2^k is no NTT modulus, so every
product is exact over the integers (`she.ring_mul_sum`); this is host
set-up, once per PRF input.

`prf` / `prf_pre_round` take the key as a `Cyc` over the family's ring
`fam.ctx` and multiply there (the E route where p has no CRT basis), as
the reference does; `prf_ints` / `prf_pre_round_ints` are their host
oracles on the key's integer coefficients.  `homom_prf_component` /
`homom_prf` run the evaluation on one `she.CT` through the object path
(`she.mul_public`, `she.tunnel`, `she.pt_round`) on the hints that
`make_eval_hints` makes for either path.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from . import gadget as gd
from . import linear as lin
from . import prng, sampling, she
from .cyc import Cyc
from .ring import RingContext, ring_context
from .rns import rns_basis


# ---------------------------------------------------------------------------
# full binary trees (Lol FullBinTree)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Tree:
    """Full binary tree with `size` leaves (input bits)."""

    left: "Tree | None" = None
    right: "Tree | None" = None

    @property
    def is_leaf(self) -> bool:
        return self.left is None

    @property
    def size(self) -> int:
        if self.is_leaf:
            return 1
        return self.left.size + self.right.size


def leaf() -> Tree:
    return Tree()


def left_spine(n: int) -> Tree:
    """((((x1 x2) x3) x4) ...): Lol leftSpineTree."""
    t = leaf()
    for _ in range(n - 1):
        t = Tree(t, leaf())
    return t


def right_spine(n: int) -> Tree:
    t = leaf()
    for _ in range(n - 1):
        t = Tree(leaf(), t)
    return t


def balanced(n: int) -> Tree:
    if n == 1:
        return leaf()
    h = n // 2
    return Tree(balanced(n - h), balanced(h))


# ---------------------------------------------------------------------------
# PRF family
# ---------------------------------------------------------------------------


def _coeff_rows(a) -> np.ndarray:
    """Public vectors as (ell, n) int64 coefficients: an array as given,
    a sequence of `Cyc` over R_p by their powerful-basis residues."""
    if isinstance(a, np.ndarray):
        return a
    return np.stack([c.to_pow().data[0].cpu().numpy() for c in a]).astype(np.int64)


@dataclass(init=False)
class PRFFamily:
    """Public params + tree + per-assignment node cache (Lol PRFState):
    ring index m (2-power), PRF modulus p, the base-b gadget, and a0 / a1
    as (ell, n) int64 coefficient arrays mod p.  The ring may be given as
    the reference gives it, `ctx` (R_p) in place of m and p, and a0 / a1
    as its tuples of `Cyc`."""

    m: int
    p: int
    spec: gd.BaseBGad
    tree: Tree
    a0: np.ndarray
    a1: np.ndarray
    _cache: dict = field(default_factory=dict)

    def __init__(self, m: int | None = None, p: int | None = None, spec: gd.BaseBGad = None,
                 tree: Tree = None, a0=None, a1=None, _cache: dict | None = None, *,
                 ctx: RingContext | None = None):
        if ctx is not None:
            if ctx.nrns != 1 or (m, p) not in ((None, None), (ctx.m, ctx.basis.qs[0])):
                raise ValueError(f"PRFFamily: ctx {ctx} is not R_p at m={m}, p={p}")
            m, p = ctx.m, ctx.basis.qs[0]
        self.m, self.p, self.spec, self.tree = m, p, spec, tree
        self.a0, self.a1 = _coeff_rows(a0), _coeff_rows(a1)
        self._cache = {} if _cache is None else _cache
        shape = (gd.num_digits(self.spec, rns_basis((self.p,))), self.m // 2)
        for a in (self.a0, self.a1):
            if a.shape != shape:
                raise ValueError(f"PRFFamily: public vector of shape {a.shape} != (ell, n) = "
                                 f"{shape}")

    @property
    def n(self) -> int:
        return self.m // 2

    @property
    def ctx(self) -> RingContext:
        """The family's ring R_p."""
        return ring_context(self.m, (self.p,))

    @staticmethod
    def random(ctx: RingContext, spec: gd.BaseBGad, tree: Tree, key,
               device="cuda") -> "PRFFamily":
        """a0, a1 uniform in R_p^ell over ctx = R_p (2-power m, one modulus
        p): a0[j] = `sampling.uniform(ctx, ks[j])`, a1[j] from ks[ell + j],
        ks = split(key, 2 ell), as the reference draws them (drawn on device,
        kept as powerful-basis coefficients on the host)."""
        if ctx.nrns != 1 or not ctx.fm.is_pow2():
            raise ValueError(f"PRFFamily: a 2-power ring over one modulus, got {ctx}")
        p = ctx.basis.qs[0]
        ell = gd.num_digits(spec, ctx.basis)
        a = np.stack([sampling.uniform(ctx, k, device=device).to_pow().data[0].cpu().numpy()
                      for k in prng.split(key, 2 * ell)]).astype(np.int64)
        return PRFFamily(ctx.m, p, spec, tree, a[:ell], a[ell:])

    # -- A_T(x) with per-node caching --------------------------------------
    def _eval_node(self, tree: Tree, bits: tuple[int, ...]) -> np.ndarray:
        key = (id(tree), bits)
        hit = self._cache.get(key)
        if hit is not None:
            return hit
        if tree.is_leaf:
            out = self.a1 if bits[0] else self.a0
        else:
            nl = tree.left.size
            al = self._eval_node(tree.left, bits[:nl])
            ar = self._eval_node(tree.right, bits[nl:])
            out = self._mul_ginv(al, ar)
        self._cache[key] = out
        return out

    def _mul_ginv(self, al: np.ndarray, ar: np.ndarray) -> np.ndarray:
        """al * G^{-1}(ar): column i = sum_j al[j] * digit_j(ar[i]),
        exact in R_p."""
        digits = gd.decompose_mod(self.spec, self.p, ar)  # (ell_digit, ell, n)
        return np.stack([
            she.ring_mul_sum([(al[j], digits[j, i]) for j in range(len(al))], self.p)
            for i in range(len(ar))
        ])

    def a_t(self, bits) -> np.ndarray:
        """A_T(x): (ell, n) int64 coefficients mod p."""
        bits = tuple(int(b) & 1 for b in bits)
        if len(bits) != self.tree.size:
            raise ValueError(f"PRF input needs {self.tree.size} bits")
        return self._eval_node(self.tree, bits)


def prf_pre_round_ints(fam: PRFFamily, s, bits) -> np.ndarray:
    """s * A_T(x) over R_p, the value before rounding: (ell, n) int64 mod
    p; s is the key's (n,) integer coefficients (the host oracle of
    `prf_pre_round`)."""
    return np.stack([she.ring_mul_sum([(s, a)], fam.p) for a in fam.a_t(bits)])


def _round_to(v, q: int, p_out: int) -> np.ndarray:
    """Round-half-UP of centered values from q to p_out, floor(c p_out / q
    + 1/2), matching the homomorphic pt_round chain; mod p_out, int64."""
    v = np.asarray(v, dtype=object) % q
    c = np.where(v >= (q + 1) // 2, v - q, v)
    return ((2 * c * p_out + q) // (2 * q) % p_out).astype(np.int64)


def prf_ints(fam: PRFFamily, s, bits, p_out: int) -> np.ndarray:
    """F_s(x) of the key's integer coefficients s: each coefficient of
    `prf_pre_round_ints` rounded from p to p_out.  (ell, n) int64 mod p_out."""
    return _round_to(prf_pre_round_ints(fam, s, bits), fam.p, p_out)


def prf_pre_round(fam: PRFFamily, s: Cyc, bits) -> tuple[Cyc, ...]:
    """s * A_T(x) over R_p as ring elements on s's device, the key s a
    `Cyc` over `fam.ctx`."""
    if s.ctx != fam.ctx:
        raise ValueError(f"prf: key over {s.ctx}, the family's ring is {fam.ctx}")
    sc = s.to_crt() if fam.ctx.has_crt() else s
    return tuple(sc * Cyc.from_ints(fam.ctx, a, device=s.device) for a in fam.a_t(bits))


def prf(fam: PRFFamily, s: Cyc, bits, p_out: int) -> np.ndarray:
    """F_s(x): each decoding coefficient of `prf_pre_round` rounded from p
    to p_out, round-half-UP.  (ell, n) int64 out, mod p_out."""
    return np.stack([_round_to(v.lift_ints(), fam.p, p_out)
                     for v in prf_pre_round(fam, s, bits)])


# ---------------------------------------------------------------------------
# homomorphic PRF evaluation hints (Lol EvalHints)
# ---------------------------------------------------------------------------


@dataclass(frozen=True, eq=False)
class EvalHints:
    """Lol EvalHints: the chain of tunnel hints walking down a cyclotomic
    tower, the rounding hints (relinearization hints of the homomorphic
    pt_round chain, present when the PRF modulus is 2^k and true
    homomorphic rounding is requested), and the final plaintext modulus."""

    tunnels: tuple[she.TunnelHint, ...]
    p_final: int
    rounds: "she.PTRoundHints | None" = None


MAPS = ("auto", "project", "slots")


def make_eval_hints(fam: PRFFamily, sks: list[she.SK], rings: list[int],
                    e_rings: list[int], spec: gd.GadgetSpec, key,
                    p_final: int = 2, homomorphic_round: bool = False,
                    maps: str = "auto", device="cuda") -> tuple[EvalHints, she.SK]:
    """The tunnel chain down `rings` (sks[i] lives in rings[i]; e_rings[i]
    is the common subring of rings[i] and rings[i+1]), made on the device
    by `she.tunnel_hint` with the gadget `spec` (the batched HomomPRF takes
    `RnsGad()`), and with homomorphic_round (p = 2^k, p_final = 2) the
    rounding hints of the last key (`she.pt_round_hints`); hop i takes the
    i-th subkey of the key's split chain and the rounding the next, as the
    reference's do.

    maps: "project" takes the coefficient projection (b_0 -> 1, the rest
    -> 0) at every hop; "slots" the CRT-set slot projection
    (`linear.slot_projection`, mode "select": the plaintext slots survive
    the descent), which needs e_rings[i] == rings[i+1] and the plaintext
    modulus a prime power coprime to the ring indices, and raises where
    it cannot be built; "auto" takes the slot map where it builds and the
    projection elsewhere, hop by hop, as the reference does."""
    if maps not in MAPS:
        raise ValueError(f"make_eval_hints: maps must be one of {MAPS}, got {maps!r}")
    qs = sks[0].params.qs  # the ciphertext chain, not the PRF modulus
    p = sks[0].params.p
    tunnels = []
    for i in range(len(rings) - 1):
        r_ctx, s_ctx, e_ctx = (ring_context(m, qs) for m in (rings[i], rings[i + 1], e_rings[i]))
        f = None
        if maps in ("slots", "auto") and e_rings[i] == rings[i + 1]:
            try:
                f = lin.slot_projection(r_ctx, s_ctx, p, mode="select")
            except (ValueError, ZeroDivisionError):
                if maps == "slots":
                    raise
        if f is None:
            ys = [np.zeros(s_ctx.n, dtype=np.int64) for _ in range(r_ctx.n // e_ctx.n)]
            ys[0][0] = 1
            f = lin.linear_pow(e_ctx, r_ctx, s_ctx, ys)
        key, sub = prng.split(key)
        tunnels.append(she.tunnel_hint(f, sks[i + 1], sks[i], spec, sub, device))
    rounds = None
    if homomorphic_round:
        if p_final != 2:
            raise ValueError("homomorphic rounding targets Z_2")
        key, kr = prng.split(key)
        rounds = she.pt_round_hints(sks[-1], spec, kr, device)
    return EvalHints(tuple(tunnels), p_final, rounds), sks[-1]


# ---------------------------------------------------------------------------
# homomorphic evaluation on the object path (Lol HomomPRF)
# ---------------------------------------------------------------------------


def homom_prf_component(fam: PRFFamily, hints: EvalHints, ct_s: "she.CT", bits,
                        i: int) -> "she.CT":
    """Component i of s * A_T(x) under encryption: ct_s encrypts the key
    s (plaintext modulus p = the PRF's), times the public A_T(x)_i, walked
    down the tunnel chain, then the homomorphic rounding (`she.pt_round`)
    where hints.rounds is present, else the plaintext modulus switch to
    hints.p_final."""
    a_pt = fam.a_t(bits)[i] % ct_s.params.p
    ct = she.mul_public(ct_s, a_pt)
    for th in hints.tunnels:
        ct = she.tunnel(th, ct)
    if hints.rounds is not None:
        return she.pt_round(ct, hints.rounds)
    if hints.p_final != ct.params.p:
        ct = she.mod_switch_pt(ct, hints.p_final)
    return ct


def homom_prf(fam: PRFFamily, hints: EvalHints, ct_s: "she.CT", bits) -> tuple["she.CT", ...]:
    """Every component of s * A_T(x) under encryption, each walked down
    the chain and rounded: one ciphertext per component, in the chain's
    last ring."""
    return tuple(homom_prf_component(fam, hints, ct_s, bits, i)
                 for i in range(len(fam.a_t(bits))))
