"""Paillier additively-homomorphic encryption in plain Python integers
(port of ``repro.privacy.paillier``, the paper's homomorphic-encryption
pillar).

Encrypting quantized client updates with a real additive HE scheme and
aggregating ciphertexts shows

    Dec( Enc(a) * Enc(b) mod n^2 ) = a + b   (mod n)

on model-update vectors.  Too slow for full-size rows (the ring-masked path
of ``secure_agg.py`` is what the strategies run); no strategy calls it.

Implementation notes: g = n + 1 (standard simplification), Miller-Rabin
prime generation, CRT-free decryption via Carmichael's lambda.
"""
from __future__ import annotations

import dataclasses
import math
import secrets


def _is_probable_prime(n: int, rounds: int = 40) -> bool:
    if n < 2:
        return False
    for p in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
        if n % p == 0:
            return n == p
    d, r = n - 1, 0
    while d % 2 == 0:
        d //= 2
        r += 1
    for _ in range(rounds):
        a = secrets.randbelow(n - 3) + 2
        x = pow(a, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(r - 1):
            x = pow(x, 2, n)
            if x == n - 1:
                break
        else:
            return False
    return True


def _random_prime(bits: int) -> int:
    while True:
        cand = secrets.randbits(bits) | (1 << (bits - 1)) | 1
        if _is_probable_prime(cand):
            return cand


@dataclasses.dataclass(frozen=True)
class PublicKey:
    n: int

    @property
    def n_sq(self) -> int:
        return self.n * self.n

    def encrypt(self, m: int, r: int | None = None) -> int:
        """Enc(m) = (1 + m*n) * r^n mod n^2   (g = n + 1)."""
        m %= self.n
        if r is None:
            while True:
                r = secrets.randbelow(self.n - 1) + 1
                if math.gcd(r, self.n) == 1:
                    break
        return ((1 + m * self.n) % self.n_sq) * pow(r, self.n, self.n_sq) % self.n_sq

    def add(self, c1: int, c2: int) -> int:
        """Homomorphic addition: Enc(a) (*) Enc(b) = Enc(a+b)."""
        return c1 * c2 % self.n_sq

    def add_plain(self, c: int, k: int) -> int:
        return c * self.encrypt(k, r=1) % self.n_sq

    def mul_plain(self, c: int, k: int) -> int:
        """Enc(a)^k = Enc(k*a) — scalar reweighting of encrypted updates."""
        return pow(c, k % self.n, self.n_sq)


@dataclasses.dataclass(frozen=True)
class PrivateKey:
    pub: PublicKey
    lam: int  # Carmichael lambda(n) = lcm(p-1, q-1)
    mu: int   # (L(g^lam mod n^2))^-1 mod n

    def decrypt(self, c: int) -> int:
        n, n_sq = self.pub.n, self.pub.n_sq
        x = pow(c, self.lam, n_sq)
        L = (x - 1) // n
        return L * self.mu % n

    def decrypt_signed(self, c: int) -> int:
        """Decode ring element to a signed integer (two's-complement style)."""
        m = self.decrypt(c)
        return m - self.pub.n if m > self.pub.n // 2 else m


def keygen(bits: int = 512) -> tuple[PublicKey, PrivateKey]:
    while True:
        p = _random_prime(bits // 2)
        q = _random_prime(bits // 2)
        if p != q:
            n = p * q
            if math.gcd(n, (p - 1) * (q - 1)) == 1:
                break
    lam = math.lcm(p - 1, q - 1)
    pub = PublicKey(n)
    x = pow(n + 1, lam, pub.n_sq)
    L = (x - 1) // n
    mu = pow(L, -1, n)
    return pub, PrivateKey(pub, lam, mu)


# ---------------------------------------------------------------------------
# Vector convenience API over quantized updates
# ---------------------------------------------------------------------------


def encrypt_vector(pub: PublicKey, q_vec) -> list[int]:
    return [pub.encrypt(int(v)) for v in q_vec]


def aggregate_ciphertexts(pub: PublicKey, vecs: list[list[int]]) -> list[int]:
    out = vecs[0]
    for v in vecs[1:]:
        out = [pub.add(a, b) for a, b in zip(out, v)]
    return out


def decrypt_vector_signed(priv: PrivateKey, c_vec) -> list[int]:
    return [priv.decrypt_signed(c) for c in c_vec]
