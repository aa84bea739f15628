"""Plain CRT transforms of a cyclotomic ring R_q = Z_q[x] / Phi_m(x).

Written from the definitions, in plain int64 torch, with no code of the
program under test.  It follows the program's conventions as they stand
at commit 652d80f0e2dba092fb96240d08c6b33e6d72c43b (`lol_tpu_torch/ops/
ntt.py` and `ops/general.py`, their docstrings), because the ciphertexts
and hints of a run are in that basis and order:

- the root: omega = g^((q - 1) / m) for g the smallest primitive root mod
  q; the p^e axis uses g^((q - 1) / p^e);
- a ring element is the row-major flattening of the tensor of shape
  (phi(p^e) for each prime p of m, ascending), each axis in the powerful
  (power) basis of Z[zeta_{p^e}];
- the CRT slot order: the 2-power axis in bit-reversed-exponent order,
  forward(a)[i] = a(psi^(2 brv(i) + 1)) for psi the 2^e-th root, and an
  odd axis over the units u of Z_{p^e} ascending, slot u = a(w^u).

The 2-power axis is a textbook negacyclic transform: a twist by psi^j,
then an iterative radix-2 cyclic DFT at omega = psi^2 over bit-reversed
input.  An odd axis is its dense Vandermonde matrix and that matrix's
inverse by Gauss-Jordan.  Every product goes through `mul`, so that the
control can compute the same transforms in a lower precision
(`mul_float64`).
"""

from __future__ import annotations

import math

import torch


def mul_exact(a: torch.Tensor, b, q) -> torch.Tensor:
    """a b mod q for int64 residues below 2^30 (products below 2^60)."""
    return a * b % q


def mul_float64(a: torch.Tensor, b, q) -> torch.Tensor:
    """a b mod q with the product rounded to float64's 53 bits: the
    control's lower precision, wrong wherever a b passes 2^53."""
    f = lambda v: v.double() if isinstance(v, torch.Tensor) else float(v)
    return torch.remainder(a.double() * f(b), f(q)).long()


def factorize(n: int) -> list[tuple[int, int]]:
    """[(p, e), ...], primes ascending."""
    out, d = [], 2
    while d * d <= n:
        e = 0
        while n % d == 0:
            n //= d
            e += 1
        if e:
            out.append((d, e))
        d += 1
    if n > 1:
        out.append((n, 1))
    return out


def primitive_root(q: int) -> int:
    """The smallest primitive root mod the prime q."""
    if factorize(q) != [(q, 1)]:
        raise ValueError(f"{q} is not prime")
    ps = [p for p, _ in factorize(q - 1)]
    g = 2
    while any(pow(g, (q - 1) // p, q) == 1 for p in ps):
        g += 1
    return g


def root(order: int, q: int) -> int:
    """The canonical root of unity of this order mod q."""
    if (q - 1) % order:
        raise ValueError(f"{order} does not divide {q} - 1")
    return pow(primitive_root(q), (q - 1) // order, q)


def bit_reverse(n: int) -> torch.Tensor:
    k = n.bit_length() - 1
    return torch.tensor([int(format(i, f"0{k}b")[::-1], 2) if k else 0 for i in range(n)])


def powers(base: int, count: int, q: int) -> list[int]:
    out, v = [], 1
    for _ in range(count):
        out.append(v)
        v = v * base % q
    return out


def inverse_matrix(M: list[list[int]], q: int) -> list[list[int]]:
    """M^-1 over Z_q (q prime), Gauss-Jordan on Python integers."""
    n = len(M)
    A = [[x % q for x in row] + [int(i == j) for j in range(n)] for i, row in enumerate(M)]
    for c in range(n):
        piv = next(r for r in range(c, n) if A[r][c])
        A[c], A[piv] = A[piv], A[c]
        inv = pow(A[c][c], -1, q)
        A[c] = [x * inv % q for x in A[c]]
        for r in range(n):
            if r != c and A[r][c]:
                f = A[r][c]
                A[r] = [(x - f * y) % q for x, y in zip(A[r], A[c])]
    return [row[n:] for row in A]


class Axis2:
    """The 2^e axis (length n2 = 2^(e-1)) over Z_q on a device."""

    def __init__(self, two_e: int, q: int, device):
        n2 = two_e // 2
        psi = root(two_e, q)
        omega, n_inv = psi * psi % q, pow(n2, -1, q)
        t = lambda v: torch.tensor(v, dtype=torch.int64, device=device)
        self.q, self.n2 = q, n2
        self.brv = bit_reverse(n2).to(device)
        self.twist = t(powers(psi, n2, q))[:, None]
        self.untwist = t([x * n_inv % q for x in powers(pow(psi, -1, q), n2, q)])[:, None]
        self.stages = {}  # direction -> [(half, twiddles)]
        for sign, w in ((1, omega), (-1, pow(omega, -1, q))):
            self.stages[sign] = [(h, t(powers(pow(w, n2 // (2 * h), q), h, q))[None, :, None])
                                 for h in (1 << s for s in range(n2.bit_length() - 1))]

    def _dft(self, a: torch.Tensor, sign: int, mul) -> torch.Tensor:
        """Cyclic DFT of bit-reversed-order a along axis 0, natural out."""
        n2, rest = a.shape
        q = self.q
        for h, tw in self.stages[sign]:
            a = a.view(n2 // (2 * h), 2, h, rest)
            u, v = a[:, 0], mul(a[:, 1], tw, q)
            a = torch.stack(((u + v) % q, (u - v) % q), dim=1).view(n2, rest)
        return a

    def forward(self, x: torch.Tensor, mul) -> torch.Tensor:
        y = mul(x, self.twist, self.q)
        return self._dft(y[self.brv], 1, mul)[self.brv]

    def inverse(self, z: torch.Tensor, mul) -> torch.Tensor:
        # X[k] = z[brv(k)], so the DFT's bit-reversed input X[brv] is z
        return mul(self._dft(z, -1, mul), self.untwist, self.q)


class AxisOdd:
    """An odd p^e axis over Z_q: the Vandermonde matrix of the units."""

    def __init__(self, p: int, e: int, q: int, device):
        pe = p ** e
        w = root(pe, q)
        units = [u for u in range(pe) if u % p]
        M = [[pow(w, u * j, q) for j in range(len(units))] for u in units]
        t = lambda v: torch.tensor(v, dtype=torch.int64, device=device)
        self.q, self.phi = q, len(units)
        self.M, self.Minv = t(M), t(inverse_matrix(M, q))

    def apply(self, x: torch.Tensor, inverse: bool, mul) -> torch.Tensor:
        """x viewed (pre, phi, post) times M (or M^-1) along axis 1."""
        M = self.Minv if inverse else self.M
        acc = torch.zeros_like(x)
        for j in range(self.phi):
            acc = (acc + mul(M[:, j].view(1, -1, 1), x[:, j:j + 1], self.q)) % self.q
        return acc


class Ring:
    """CRT transforms of R_m over each modulus of a chain, on a device."""

    def __init__(self, m: int, qs, device, mul=mul_exact):
        self.m, self.qs, self.mul = m, tuple(qs), mul
        self.pps = factorize(m)
        self.shape = [(p - 1) * p ** (e - 1) for p, e in self.pps]
        self.n = math.prod(self.shape)
        self.axes = [[None if phi == 1 else Axis2(p ** e, q, device) if p == 2
                      else AxisOdd(p, e, q, device)
                      for (p, e), phi in zip(self.pps, self.shape)] for q in self.qs]

    def crt(self, x: torch.Tensor, ch: int, inverse: bool = False) -> torch.Tensor:
        """(n, B) residues mod qs[ch]: powerful -> CRT basis, or back;
        int64 out."""
        n, B = x.shape
        x = x.long()
        for i, ax in enumerate(self.axes[ch]):
            if ax is None:
                continue
            pre, post = math.prod(self.shape[:i]), math.prod(self.shape[i + 1:]) * B
            if isinstance(ax, Axis2):  # the 2-axis leads: (n2, everything else)
                x = (ax.inverse if inverse else ax.forward)(x.reshape(ax.n2, -1), self.mul)
            else:
                x = ax.apply(x.reshape(pre, ax.phi, post), inverse, self.mul)
        return x.reshape(n, B)
