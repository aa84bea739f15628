"""Host-side exact number theory (Python ints).

Counterpart of `lol_tpu/numtheory.py`: the same primality test, prime
search and canonical root choice, so the port derives the same NTT primes
and the same principal roots (hence the same twiddle tables and CRT-domain
order) as the JAX package.  Runs at plan-build time only.
"""

from __future__ import annotations

import math
from functools import lru_cache

_MR_BASES_64 = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37)


def is_prime(n: int) -> bool:
    """Deterministic Miller-Rabin for n < 3.3e24 (covers all 64-bit ints)."""
    if n < 2:
        return False
    for p in _MR_BASES_64:
        if n % p == 0:
            return n == p
    d = n - 1
    r = (d & -d).bit_length() - 1
    d >>= r
    for a in _MR_BASES_64:
        x = pow(a, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(r - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


@lru_cache(maxsize=4096)
def factorize(n: int) -> tuple[tuple[int, int], ...]:
    """Prime factorization as a sorted tuple of (p, e) pairs."""
    if n < 1:
        raise ValueError(f"factorize: n must be >= 1, got {n}")
    out: list[tuple[int, int]] = []
    d = 2
    while d * d <= n:
        if n % d == 0:
            e = 0
            while n % d == 0:
                n //= d
                e += 1
            out.append((d, e))
        d += 1 if d == 2 else 2
    if n > 1:
        out.append((n, 1))
    return tuple(out)


def radical(n: int) -> int:
    """The product of the distinct primes of n."""
    return math.prod(p for p, _ in factorize(n))


def divides(a: int, b: int) -> bool:
    """a | b."""
    return b % a == 0


def crt_reconstruct(residues: list[int], moduli: list[int]) -> int:
    """Garner: the unique x in [0, prod(moduli)) with x = r_i mod q_i."""
    x, q = 0, 1
    for r, qi in zip(residues, moduli):
        x += q * ((r - x) * modinv(q, qi) % qi)
        q *= qi
    return x


def modinv(a: int, q: int) -> int:
    """Inverse of a mod q; raises if gcd(a, q) != 1."""
    g = math.gcd(a % q, q)
    if g != 1:
        raise ValueError(f"modinv: gcd({a}, {q}) = {g} != 1")
    return pow(a, -1, q)


def primitive_root(q: int) -> int:
    """Smallest primitive root mod prime q."""
    if not is_prime(q):
        raise ValueError(f"primitive_root: {q} is not prime")
    if q == 2:
        return 1
    fac = [p for p, _ in factorize(q - 1)]
    g = 2
    while True:
        if all(pow(g, (q - 1) // p, q) != 1 for p in fac):
            return g
        g += 1


def principal_root_of_unity(m: int, q: int) -> int:
    """The canonical principal m-th root of unity in Z_q (prime q, m | q-1):
    g^((q-1)/m) for g the smallest primitive root."""
    if not is_prime(q):
        raise ValueError(f"principal_root_of_unity: q={q} not prime")
    if (q - 1) % m != 0:
        raise ValueError(f"principal_root_of_unity: m={m} does not divide q-1={q - 1}")
    w = pow(primitive_root(q), (q - 1) // m, q)
    # exact order m: w^(m/p) != 1 for every prime p | m
    if any(pow(w, m // p, q) == 1 for p, _ in factorize(m)):
        raise ArithmeticError(f"root {w} mod {q} is not principal of order {m}")
    return w


def ntt_primes(m: int, nbits: int, count: int, below: int | None = None) -> list[int]:
    """`count` primes q with q = 1 (mod m), q < 2**nbits, largest first."""
    out: list[int] = []
    start = (below if below is not None else (1 << nbits)) - 1
    q = start - (start - 1) % m  # largest value = 1 mod m, <= start
    while q > m and len(out) < count:
        if is_prime(q):
            out.append(q)
        q -= m
    if len(out) < count:
        raise ValueError(f"ntt_primes: only found {len(out)} primes = 1 mod {m} under 2^{nbits}")
    return out


def euler_phi(n: int) -> int:
    """Euler's totient of n."""
    phi = 1
    for p, e in factorize(n):
        phi *= (p - 1) * p ** (e - 1)
    return phi


def multiplicative_order(a: int, q: int) -> int:
    """The order of a in (Z/qZ)^*; q need not be prime, a must be a unit."""
    if math.gcd(a, q) != 1:
        raise ValueError("multiplicative_order: a not a unit")
    order = euler_phi(q)
    for p, _ in factorize(order):
        while order % p == 0 and pow(a, order // p, q) == 1:
            order //= p
    return order
