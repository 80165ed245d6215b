"""Plain CKKS decryption and decoding, the benchmark's own.

It turns a ciphertext that the program returns into the m×n matrix it
encrypts, from the configuration's sizes and the run's seed alone, so that
the comparison with A·B owes nothing to the program's code or tables:

- the primes: ``count`` primes q ≡ 1 (mod 2N) walking down from 2^bits, in
  the order [q_0 (q0_bits), q_1 … q_L (scale_bits), p_0 … (sp_bits)];
- the NTT roots: for each prime in that order, x^((q−1)/2N) for random x
  until the root has order 2N, drawing x from numpy's generator seeded
  with 0xFA3E (FAME's tables are defined this way);
- the evaluation domain: limb i of a polynomial holds its values at
  ψ^(2·brv(j)+1), j = 0 … N−1 (bit-reversed order);
- the secret: s ∈ {−1, 0, 1}^N, the first draw of the generator that the
  benchmark hands to key generation;
- decoding: the centred coefficients of c0 + c1·s, evaluated at the slots'
  roots ζ^(5^j), ζ = e^(iπ/N), divided by the output scale.

Everything runs in int64 torch on the device it is given (q < 2^30, so a
product of two residues fits).  The coefficients are lifted from the first
two limbs (|x| < q_0·q_1 / 2 for any message this benchmark decrypts) and
every other limb is checked against the lift, so an output that is not a
small message is reported, never decoded.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

_WITNESSES = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37)
TABLE_SEED = 0xFA3E


def is_prime(n: int) -> bool:
    """Deterministic Miller–Rabin for n < 3.3e24."""
    if n < 2:
        return False
    for p in _WITNESSES:
        if n % p == 0:
            return n == p
    d, r = n - 1, 0
    while d % 2 == 0:
        d //= 2
        r += 1
    for a in _WITNESSES:
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


def ntt_primes(count: int, bits: int, two_n: int, skip=frozenset()) -> list:
    """``count`` primes q ≡ 1 (mod two_n), walking down from 2^bits."""
    out = []
    q = (1 << bits) - ((1 << bits) - 1) % two_n
    while len(out) < count:
        if q <= two_n:
            raise ValueError(f"no {bits}-bit primes left ≡ 1 mod {two_n}")
        if q not in skip and is_prime(q):
            out.append(q)
        q -= two_n
    return out


@functools.lru_cache(maxsize=None)
def moduli(logN: int, L: int, k: int, q0_bits: int, scale_bits: int,
           sp_bits: int) -> tuple:
    """[q_0, q_1 … q_L, p_0 … p_{k−1}] of a parameter set."""
    two_n = 2 << logN
    special = ntt_primes(k, sp_bits, two_n)
    q0 = ntt_primes(1, q0_bits, two_n, frozenset(special))
    main = ntt_primes(L, scale_bits, two_n, frozenset(special + q0))
    return tuple(q0 + main + special)


@functools.lru_cache(maxsize=None)
def roots(logN: int, qs: tuple) -> tuple:
    """ψ of order 2N for each prime of ``qs`` (all primes of the set, in
    order: each draw depends on the draws before it)."""
    two_n = 2 << logN
    rng = np.random.default_rng(TABLE_SEED)
    out = []
    for q in qs:
        cof = (q - 1) // two_n
        while True:
            psi = pow(int(rng.integers(2, q - 1)), cof, q)
            if pow(psi, two_n // 2, q) == q - 1:
                out.append(psi)
                break
    return tuple(out)


def bit_reverse(n: int) -> np.ndarray:
    bits = n.bit_length() - 1
    idx = np.arange(n, dtype=np.int64)
    rev = np.zeros_like(idx)
    for b in range(bits):
        rev |= ((idx >> b) & 1) << (bits - 1 - b)
    return rev


def _powers(bases, n: int, qs) -> np.ndarray:
    """(M, n) int64: bases[i]^j mod qs[i], by doubling blocks."""
    q = np.asarray(qs, np.int64)[:, None]
    out = np.empty((len(qs), n), np.int64)
    out[:, 0] = 1
    step = np.asarray(bases, np.int64)[:, None] % q
    filled = 1
    while filled < n:
        take = min(filled, n - filled)
        out[:, filled:filled + take] = out[:, :take] * step % q
        filled += take
        step = step * step % q
    return out


class Transform:
    """The negacyclic transform of limbs ``qs`` with roots ``psis``:
    natural-order coefficients <-> bit-reversed evaluations."""

    def __init__(self, N: int, qs, psis, device):
        self.N = N
        self.q = torch.tensor(qs, dtype=torch.int64, device=device)[:, None]
        inv = [pow(p, -1, q) for p, q in zip(psis, qs, strict=True)]
        t = lambda a: torch.from_numpy(a).to(device)
        self.psi = t(_powers(psis, N, qs))
        self.psi_inv = t(_powers(inv, N, qs))
        self.w = t(_powers([p * p % q for p, q in zip(psis, qs, strict=True)],
                           N, qs))
        self.w_inv = t(_powers([p * p % q for p, q in zip(inv, qs, strict=True)],
                               N, qs))
        self.n_inv = torch.tensor([pow(N, -1, q) for q in qs],
                                  dtype=torch.int64, device=device)[:, None]
        self.brv = torch.from_numpy(bit_reverse(N)).to(device)

    def _dft(self, x, w):
        """Y[j] = Σ_k x[k]·w^(jk) per limb: radix-2, bit-reversed input."""
        M, N = x.shape
        q3 = self.q[:, :, None]
        x = x[:, self.brv]
        size = 2
        while size <= N:
            half = size // 2
            tw = w[:, :: N // size][:, :half][:, None, :]
            v = x.view(M, N // size, 2, half)
            lo, hi = v[:, :, 0, :], v[:, :, 1, :] * tw % q3
            x = torch.stack([(lo + hi) % q3, (lo - hi) % q3], dim=2)
            x = x.reshape(M, N)
            size *= 2
        return x

    def forward(self, coeffs):
        """(M, N) residues, natural order -> bit-reversed evaluations."""
        return self._dft(coeffs * self.psi % self.q, self.w)[:, self.brv]

    def inverse(self, evals):
        """Bit-reversed evaluations -> natural-order residues."""
        y = self._dft(evals[:, self.brv], self.w_inv) * self.n_inv % self.q
        return y * self.psi_inv % self.q


class Decryptor:
    """Decrypts and decodes ciphertexts at one level and scale.

    ``sizes`` holds the configuration's logN, L, k, q0_bits, scale_bits and
    sp_bits; ``key_rng`` is a generator built as the one handed to key
    generation (its first draw is the secret)."""

    def __init__(self, sizes: dict, key_rng: np.random.Generator,
                 level: int, scale: float, device):
        self.N = 1 << sizes["logN"]
        qs_all = moduli(sizes["logN"], sizes["L"], sizes["k"],
                        sizes["q0_bits"], sizes["scale_bits"],
                        sizes["sp_bits"])
        psis = roots(sizes["logN"], qs_all)
        self.level, self.scale, self.device = level, scale, device
        self.qs = qs_all[: level + 1]
        self.tr = Transform(self.N, self.qs, psis[: level + 1], device)
        s = torch.from_numpy(key_rng.integers(-1, 2, size=self.N)
                             .astype(np.int64)).to(device)
        self.s_eval = self.tr.forward(s[None, :] % self.tr.q)
        q0, q1 = self.qs[0], self.qs[1]
        self.q01 = q0 * q1
        self.q0_inv = pow(q0, -1, q1)
        two_n = 2 * self.N
        rot = np.empty(self.N // 2, np.int64)
        g = 1
        for j in range(self.N // 2):
            rot[j] = g
            g = g * 5 % two_n
        self.rot = torch.from_numpy(rot).to(device)

    def coefficients(self, c0, c1):
        """The centred integer coefficients of c0 + c1·s, or None where the
        limbs disagree (the output decrypts to no small message)."""
        if tuple(c0.shape) != (self.level + 1, self.N) \
                or tuple(c1.shape) != tuple(c0.shape):
            return None
        q = self.tr.q
        c0 = c0.to(self.device, torch.int64) % q
        c1 = c1.to(self.device, torch.int64) % q
        x = self.tr.inverse((c0 + c1 * self.s_eval % q) % q)
        r0, r1 = x[0], x[1]
        q0, q1 = self.qs[0], self.qs[1]
        lift = r0 + q0 * ((r1 - r0) % q1 * self.q0_inv % q1)
        lift = torch.where(lift > self.q01 // 2, lift - self.q01, lift)
        if not bool(torch.equal(lift[None, :] % q[2:], x[2:])):
            return None
        return lift

    def decode(self, c0, c1, count: int):
        """The first ``count`` slots (real parts, float64), or None."""
        lift = self.coefficients(c0, c1)
        if lift is None:
            return None
        spec = torch.fft.fft(lift.to(torch.float64), n=2 * self.N)
        return (spec.conj()[self.rot[:count]].real / self.scale)


def output_scale(sizes: dict, qs: tuple) -> float:
    """The scale of a hemm's product (Algorithm 2 from level L): every
    input and diagonal at 2^scale_bits; Step 1 and Step 2 rescale by q_L
    and q_{L−1}, each product by q_{L−2} after the ciphertext multiply."""
    L, delta = sizes["L"], float(1 << sizes["scale_bits"])
    s1 = delta * delta / qs[L]
    s2 = s1 * delta / qs[L - 1]
    return s2 * s2 / qs[L - 2]
