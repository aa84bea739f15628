"""The JAX package's randomness: a threefry2x32 twin of `jax.random`.

Every random draw of the reference comes from a `jax.random` key, so a
fixed key gives the same secrets, ciphertexts and hints on any backend.
This module reproduces those draws bit for bit, in the default mode of
jax 0.9.0 (`jax_threefry_partitionable = True`, fixed here: the port reads
no JAX config):

- a key is the raw `uint32[2]` of `jax.random.PRNGKey`, held as an int64
  tensor of shape (2,) (a batch of keys: (..., 2)); `PRNGKey(seed)` is
  `[0, seed mod 2^32]`, as JAX makes it with 64-bit types off;
- `split(key, num)` hashes the counters (0, i), i < num, with the key
  (`_threefry_split_foldlike`); iterating over its rows gives the keys;
- `random_bits(key, shape)` hashes the 64-bit counter of each element's
  flat index, (i >> 32, i mod 2^32), and xors the two output words
  (`_threefry_random_bits_partitionable`);
- `randint` draws two such words from `split(key)` and reduces them mod
  the span as `jax.random._randint` does, in wrapping u32 arithmetic;
- `uniform` keeps a word's top 23 bits as the mantissa of a float in
  [1, 2) (`jax.random._uniform`);
- `normal` is `sqrt(2) * erf_inv(u)` on u = uniform over
  (nextafter(-1, 0), 1) (`jax.random._normal_real`), with `erf_inv` and
  the `log1p` inside it computed op for op as XLA's CPU backend compiles
  them: every multiply-add that LLVM contracts there is one fused
  multiply-add here (`fma32`, exact), the rest single float32 operations.
  Only the top 23 bits of a word reach the normal, so the whole map has
  2^23 inputs, and the tests hold it against `jax.lax.erf_inv` on every
  one of them.

These are the plain versions (int64 words masked to 32 bits, since torch's
CPU uint32 has no add or shift).  The draws run on the card unless the
caller passes `device="cpu"`: there they run the hand-written kernel of
`csrc/prng.cu` (`ops/cuda/prng.py`), which must equal them bit for bit.
Keys themselves are tiny and stay on the host: `split` is always
computed here.
"""

from __future__ import annotations

import math
import struct

import numpy as np
import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


# ---------------------------------------------------------------------------
# keys and the threefry2x32 hash
# ---------------------------------------------------------------------------


def PRNGKey(seed: int) -> torch.Tensor:
    """The raw key of `jax.random.PRNGKey(seed)` (64-bit types off: the
    seed is taken mod 2^32, its high word is 0)."""
    return torch.tensor([0, int(seed) & MASK], dtype=torch.int64)


def key_words(key) -> tuple[int, int]:
    """A single key's two words as Python ints."""
    k = torch.as_tensor(key)
    if k.shape != (2,):
        raise ValueError(f"a key is a (2,) tensor of u32 words, got shape {tuple(k.shape)}")
    k0, k1 = (int(v) for v in k.tolist())
    if not (0 <= k0 <= MASK and 0 <= k1 <= MASK):
        raise ValueError(f"key words out of u32 range: {k0}, {k1}")
    return k0, k1


def threefry2x32(k0: int, k1: int, x0: torch.Tensor, x1: torch.Tensor):
    """The Threefry-2x32 hash (20 rounds) of the counter pairs (x0, x1)
    under the key (k0, k1): int64 tensors of u32 words in and out."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    t = torch.empty_like(x1)
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0.add_(x1).bitwise_and_(MASK)
            torch.bitwise_left_shift(x1, r, out=t).bitwise_and_(MASK)
            x1.bitwise_right_shift_(32 - r).bitwise_or_(t).bitwise_xor_(x0)
        x0.add_(ks[(i + 1) % 3]).bitwise_and_(MASK)
        x1.add_(ks[(i + 2) % 3] + i + 1).bitwise_and_(MASK)
    return x0, x1


def _hash_words(k0: int, k1: int, x0: int, x1: int) -> tuple[int, int]:
    """`threefry2x32` of one counter pair on Python ints: a key operation
    hashes a few counters, where a tensor op's dispatch would dominate."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0, x1 = (x0 + ks[0]) & MASK, (x1 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = (((x1 << r) | (x1 >> (32 - r))) & MASK) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK
    return x0, x1


def split(key, num: int = 2) -> torch.Tensor:
    """`jax.random.split(key, num)`: a (num, 2) tensor of keys, on the
    key's device, hashed on the host."""
    k = torch.as_tensor(key)
    k0, k1 = key_words(k)
    words = [_hash_words(k0, k1, i >> 32, i & MASK) for i in range(int(num))]
    return torch.tensor(words, dtype=torch.int64).view(int(num), 2).to(k.device)


class KeyChain:
    """Fresh keys from one seed (or key), for callers that draw many times:
    each call splits the chain's key into (next, sub) and returns sub."""

    def __init__(self, seed_or_key):
        self.key = (PRNGKey(seed_or_key) if isinstance(seed_or_key, int)
                    else torch.as_tensor(seed_or_key))

    def __call__(self) -> torch.Tensor:
        self.key, sub = split(self.key)
        return sub


def bits_at(key, idx: torch.Tensor) -> torch.Tensor:
    """The words of the elements at flat indices idx (an int64 tensor, on
    any device) of a `random_bits` draw under key: the xor of the two
    threefry outputs of each counter (i >> 32, i mod 2^32)."""
    b0, b1 = threefry2x32(*key_words(key), idx >> 32, idx & MASK)
    return b0 ^ b1


def _shape(shape) -> tuple[int, ...]:
    return (int(shape),) if isinstance(shape, int) else tuple(int(s) for s in shape)


def _draw(keys, shape, mode, device, **kw) -> torch.Tensor:
    """(len(keys), *shape) from the kernel's wrapper (the plain version on
    the CPU)."""
    from .ops.cuda import prng as kernel

    shape = _shape(shape)
    out = kernel.draw(list(keys), math.prod(shape), mode, device=device, **kw)
    return out.view(len(keys), *shape)


def random_bits_ref(key, shape, device="cpu") -> torch.Tensor:
    """Plain `jax.random.bits(key, shape, uint32)`: u32 words as int64,
    computed on `device` (any)."""
    shape = _shape(shape)
    return bits_at(key, torch.arange(math.prod(shape), device=device)).reshape(shape)


def random_bits(key, shape, device="cuda") -> torch.Tensor:
    """`jax.random.bits(key, shape, uint32)`: u32 words as int64, on
    `device` (the kernel's on a CUDA device)."""
    dev = torch.device(device)
    if dev.type != "cpu":
        return _draw([key], shape, "bits", dev)[0].to(torch.int64) & MASK
    return random_bits_ref(key, shape)


def randint_multiplier(span: int) -> int:
    """`_randint`'s 2^32 mod span, as its u32 arithmetic computes it: the
    square of 2^16 mod span wraps, so it is 0 for every span > 2^16."""
    mult = (1 << 16) % span
    return (mult * mult & MASK) % span


def randint_at(key, idx: torch.Tensor, minval: int, maxval: int) -> torch.Tensor:
    """Plain `jax.random.randint(key, shape, minval, maxval)` for a 32-bit
    integer dtype at the flat element indices idx (int64, on any device),
    as int64: two words from `split(key)`, each reduced mod the span,
    combined in wrapping u32 arithmetic."""
    span = maxval - minval if maxval > minval else 1
    if not (1 <= span <= MASK):
        raise ValueError(f"randint: span {span} out of the u32 range")
    k1, k2 = split(torch.as_tensor(key).cpu())
    hi, lo = bits_at(k1, idx), bits_at(k2, idx)
    off = (((hi % span) * randint_multiplier(span)) & MASK) + lo % span
    return minval + (off & MASK) % span


def randint_ref(key, shape, minval: int, maxval: int, device="cpu") -> torch.Tensor:
    """`randint_at` over a whole draw of `shape`, on `device` (any)."""
    shape = _shape(shape)
    idx = torch.arange(math.prod(shape), device=device)
    return randint_at(key, idx, minval, maxval).reshape(shape)


def randint(key, shape, minval: int, maxval: int, device="cuda") -> torch.Tensor:
    """`jax.random.randint(key, shape, minval, maxval)` for int32 or uint32
    values: the plain int64 on the CPU; on a CUDA device the kernel's int32,
    for minval = 0 and 0 < maxval < 2^31."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return randint_ref(key, shape, int(minval), int(maxval))
    if int(minval) != 0:
        raise ValueError(f"randint on the card: need minval = 0, got {minval}")
    return _draw([key], shape, "randint", dev, qs=[int(maxval)])[0]


def randint_channels(keys, qs, shape, device="cuda") -> torch.Tensor:
    """(len(qs), *shape) int32: row c is `randint(keys[c], shape, 0,
    qs[c])`, all rows in one launch on the card."""
    if len(keys) != len(qs):
        raise ValueError(f"randint_channels: {len(keys)} keys for {len(qs)} moduli")
    return _draw(keys, shape, "randint", device, qs=[int(q) for q in qs])


# ---------------------------------------------------------------------------
# float32 arithmetic as XLA's CPU backend does it
# ---------------------------------------------------------------------------


def _f32(h: int) -> float:
    """A float32 constant from the 64-bit hex pattern LLVM prints it as."""
    return struct.unpack("<d", struct.pack("<Q", h))[0]


def fma32(a: torch.Tensor, b: torch.Tensor, c) -> torch.Tensor:
    """round_f32(a * b + c) with one rounding (an FMA), for float32 a, b
    and c: the product is exact in float64 and the sum exact as the
    float64 pair (s, err), so s rounds wrong only where it lands on a
    float32 midpoint (its low 29 mantissa bits 1 followed by 28 zeros)
    with err != 0; there s moves one float64 step toward err first."""
    p = a.double() * b.double()
    c64 = torch.as_tensor(c, dtype=torch.float64)
    s = p + c64
    bb = s - p
    err = (p - (s - bb)) + (c64 - bb)
    bits = s.view(torch.int64)
    tie = ((bits & 0x1FFFFFFF) == 0x10000000) & (err != 0)
    if bool(tie.any()):
        step = torch.where((err > 0) == (s > 0), 1, -1)
        s = torch.where(tie, bits + step, bits).view(torch.float64)
    return s.float()


def sqrt32(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 square root: numpy's on the CPU
    (torch's CPU float32 sqrt is not always correctly rounded, nor the same
    from one allocation to the next), elsewhere the float64 root rounded to
    float32 (a float64 root has room for a single float32 rounding)."""
    if x.device.type == "cpu":
        return torch.from_numpy(np.sqrt(x.contiguous().numpy()))
    return torch.sqrt(x.double()).float()


def _c(h: int) -> torch.Tensor:
    return torch.tensor(_f32(h), dtype=torch.float32)


# XLA CPU's f32 log (Cephes' logf polynomial, Eigen's plog): in op order.
_LOG_P = [_c(h) for h in (0x3FB2043760000000, 0xBFBD7A3700000000, 0x3FBDE4A340000000,
                           0xBFBFCBA9E0000000, 0x3FC23D37E0000000, 0xBFC555CA00000000,
                           0x3FC999D580000000, 0xBFCFFFFF80000000, 0x3FD5555540000000)]
_LOG_Q1 = _c(0xBF2BD01060000000)   # -2.12194440e-4
_LOG_Q2 = _c(0x3FE6300000000000)   # 0.693359375
_SQRT_HALF = _c(0x3FE6A09E60000000)
_FLT_MIN = _c(0x3810000000000000)


def xla_log(x: torch.Tensor) -> torch.Tensor:
    """XLA CPU's float32 log of float32 x > 0 (the compiled kernel's ops:
    mantissa in [0.5, 1), the sqrt(1/2) fold, three interleaved Horner
    chains, the exponent added in two parts)."""
    xm = torch.where(x > _FLT_MIN, x, float(_FLT_MIN))
    bits = xm.view(torch.int32)
    mant = ((bits & 0x7FFFFF) | 0x3F000000).view(torch.float32)
    e = ((bits >> 23) - 127).float() + 1.0
    small = mant < _SQRT_HALF
    t = torch.where(small, mant, torch.zeros_like(mant))
    e = e - small.float()
    v = (mant + -1.0) + t
    v2 = v * v
    v3 = v2 * v
    P = _LOG_P
    y = fma32(v, P[0], P[1])
    y1 = fma32(v, P[3], P[4])
    y2 = fma32(v, P[6], P[7])
    y = fma32(y, v, P[2])
    y1 = fma32(y1, v, P[5])
    y2 = fma32(y2, v, P[8])
    y = fma32(y, v3, y1)
    y = fma32(y, v3, y2)
    y = fma32(y, v3, e * _LOG_Q1)
    r = fma32(v2, _c(0xBFE0000000000000), v) + y
    r = fma32(e, _LOG_Q2, r)
    r = torch.where(x == math.inf, math.inf, r)
    r = torch.where(x == 0, -math.inf, r)
    return torch.where(x < 0, math.nan, r)


_L1P_N = [_c(h) for h in (0x402E2035A0000000, 0x4054C30B60000000, 0x406BB865A0000000,
                           0x4073519460000000, 0x406B0DB140000000, 0x404E0F3040000000)]
_L1P_D = [_c(h) for h in (0x3F07BC0960000000, 0x3FDFE818A0000000, 0x401A509F40000000,
                           0x403DE97380000000, 0x404E798EC0000000, 0x404C8E75A0000000,
                           0x40340A2020000000)]
_L1P_CUT = _c(0x3FDA8279A0000000)  # sqrt(2) - 1


def xla_log1p(y: torch.Tensor) -> torch.Tensor:
    """XLA CPU's float32 log-plus-one: for |y| < sqrt(2) - 1 Cephes'
    rational y - y^2/2 + y^3 N(y)/D(y); else log(1 + y) by `xla_log`."""
    y2 = y * y
    den = torch.ones_like(y)
    for c in _L1P_N:
        den = fma32(den, y, c)
    num = torch.full_like(y, float(_L1P_D[0]))
    for c in _L1P_D[1:]:
        num = fma32(num, y, c)
    near = y + fma32(y2, _c(0xBFE0000000000000), (y * y2) * (num / den))
    return torch.where(y.abs() < _L1P_CUT, near, xla_log(y + 1.0))


# Giles' single-precision erfinv, the w < 5 branch first.
_ERFINV = [(_f32(a), _f32(b)) for a, b in (
    (0x3E5E2CB100000000, 0xBF2A3E1360000000), (0x3E970966C0000000, 0x3F1A76AD60000000),
    (0xBECD8E6AE0000000, 0x3F561B8E40000000), (0xBED26B5820000000, 0xBF6E17BCE0000000),
    (0x3F2CA65B60000000, 0x3F77824F60000000), (0xBF548A8100000000, 0xBF7F38BAE0000000),
    (0xBF711C9DE0000000, 0x3F8354AFC0000000), (0x3FCF91EC60000000, 0x3FF006DB60000000),
    (0x3FF805C5E0000000, 0x4006A9EFC0000000))]


def xla_erf_inv(u: torch.Tensor) -> torch.Tensor:
    """XLA CPU's float32 erf_inv: w = -log1p(-u^2), Giles' two degree-8
    polynomials in w - 2.5 (w < 5) or sqrt(w) - 3, all FMA Horner steps,
    times u (|u| == 1 gives u * inf)."""
    lp = xla_log1p(u * -u)
    near = lp > -5.0
    z = torch.where(near, -2.5 - lp, sqrt32(-lp) + -3.0)
    a, b = _ERFINV[0]
    p = fma32(torch.where(near, a, b), z, torch.where(near, *_ERFINV[1]))
    for a, b in _ERFINV[2:]:
        p = fma32(z, p, torch.where(near, a, b))
    p = torch.where(u.abs() == 1.0, math.inf, p)
    return u * p


SQRT2 = float(np.float32(math.sqrt(2.0)))
_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))


def bits_to_unit(bits: torch.Tensor) -> torch.Tensor:
    """float32 in [0, 1) from u32 words: the top 23 bits as a mantissa."""
    return ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0


def gaussian_from_bits(bits: torch.Tensor, pre: float = SQRT2,
                       scale: float = 1.0) -> torch.Tensor:
    """erf_inv(u) * pre * scale in float32 (two roundings), u each word's
    `jax.random.uniform` value on (nextafter(-1, 0), 1); the defaults give
    `jax.random.normal`."""
    u = bits_to_unit(bits) * 2.0 + _NORMAL_LO  # exact: every u is a float32
    r = xla_erf_inv(torch.clamp(u, min=_NORMAL_LO))
    return (r * torch.tensor(pre, dtype=torch.float32)) * torch.tensor(scale, dtype=torch.float32)


def uniform(key, shape, minval: float = 0.0, maxval: float = 1.0,
            device="cuda") -> torch.Tensor:
    """`jax.random.uniform(key, shape, float32, minval, maxval)` (the
    scale-and-shift is one FMA, as XLA contracts it), on `device` (the
    words are the kernel's on a card)."""
    lo = torch.tensor(minval, dtype=torch.float32)
    hi = torch.tensor(maxval, dtype=torch.float32)
    f = bits_to_unit(random_bits(key, shape, device))
    return torch.clamp(fma32(f, hi - lo, lo), min=float(lo))


def gaussian(key, shape, scale: float = 1.0, pre: float = SQRT2, rounded: bool = False,
             device="cuda") -> torch.Tensor:
    """erf_inv(u) * pre * scale over `shape`, float32, or rounded half to
    even to int32: `jax.random.normal(key, shape) * scale` with the
    defaults' pre; where XLA compiles the product in one program it folds
    sqrt(2) into the scale (`folded_scale`, pre = 1)."""
    return _draw([key], shape, "round" if rounded else "float", device, pre=pre,
                 scale=scale)[0]


def normal(key, shape, device="cuda") -> torch.Tensor:
    """`jax.random.normal(key, shape, float32)`."""
    return gaussian(key, shape, device=device)


def sqrt_var(var: float, how: str = "f32") -> float:
    """The float32 standard deviation a sampler multiplies by: "f32" is
    `jnp.sqrt(jnp.float32(var))` (a float32 square root), "f64" is
    `np.sqrt(var)` rounded to float32 (the batched hint generator's)."""
    if how == "f64":
        return float(np.float32(math.sqrt(var)))
    return float(np.sqrt(np.float32(var)))


def folded_scale(var: float, how: str = "f32") -> float:
    """sqrt(var) * sqrt(2) in float32: XLA's algebraic simplifier turns
    (sqrt(2) erf_inv(u)) * s into erf_inv(u) * (s sqrt(2)) wherever the
    normal and its scale are compiled together."""
    return float(np.float32(sqrt_var(var, how)) * np.float32(SQRT2))
