"""Modular arithmetic over RNS limbs, in plain PyTorch.

Counterpart of ``repro/core/modmath.py``.  Residues are < 2^30 and are
stored as ``torch.int32``; every function here computes in ``int64`` and
returns ``int32``.  Torch's CPU ``uint32`` lacks ``+ - >> < %``, so the
port never computes in it.  ``qneg_inv`` (-q^-1 mod 2^32, which is
>= 2^31 for most primes) is carried as the int32 view of its uint32 bits.

Two families, as in the reference:

* ``mulmod``/``addmod``/``submod`` — the exact u64 reference arithmetic;
  moduli are ``(M, 1)`` int64 columns broadcasting over the coefficients.
* ``montmul``/``montadd``/``montsub``/``montsum``/``to_mont`` — the u32
  Montgomery datapath (R = 2^32) that the CUDA kernels run with
  ``__umulhi``; here REDC is written out in int64 step for step.

The host helpers (prime search, primitive roots, bit reversal, Montgomery
constants) are numpy/Python copies of the reference's.
"""
from __future__ import annotations

import numpy as np
import torch

I32 = torch.int32
I64 = torch.int64
MASK32 = 0xFFFFFFFF


def _i64(x):
    return x.to(I64) if isinstance(x, torch.Tensor) else torch.as_tensor(x, dtype=I64)


def as_u32(x):
    """int32-stored uint32 bits -> their int64 value (>= 0)."""
    return _i64(x) & MASK32


# ---------------------------------------------------------------------------
# u64 reference arithmetic
# ---------------------------------------------------------------------------


def mulmod(x, y, q):
    """(x * y) mod q, exact in int64 (x, y < 2^30)."""
    return ((_i64(x) * _i64(y)) % q).to(I32)


def addmod(x, y, q):
    s = _i64(x) + _i64(y)
    return torch.where(s >= q, s - q, s).to(I32)


def submod(x, y, q):
    d = _i64(x) + q - _i64(y)
    return torch.where(d >= q, d - q, d).to(I32)


# ---------------------------------------------------------------------------
# u32 Montgomery datapath
# ---------------------------------------------------------------------------


def montmul(a, b, q32, qneg_inv):
    """Montgomery product a * b * 2^-32 mod q, REDC exactly as the kernels.

    a, b < 2^30; q32 the modulus; qneg_inv the int32 view of -q^-1 mod 2^32.
    lo * qneg_inv is split into 16-bit halves so no int64 product overflows.
    """
    q = _i64(q32)
    qn = as_u32(qneg_inv)
    x = _i64(a) * _i64(b)
    lo = x & MASK32
    hi = x >> 32
    m = (lo * (qn & 0xFFFF) + (((lo * (qn >> 16)) & 0xFFFF) << 16)) & MASK32
    t = hi + ((m * q) >> 32) + (lo != 0).to(I64)
    return torch.where(t >= q, t - q, t).to(I32)


def montadd(a, b, q32):
    q = _i64(q32)
    s = _i64(a) + _i64(b)
    return torch.where(s >= q, s - q, s).to(I32)


def montsub(a, b, q32):
    q = _i64(q32)
    d = _i64(a) + q - _i64(b)
    return torch.where(d >= q, d - q, d).to(I32)


def montsum(x, q32, axis: int = 0):
    """Modular sum along ``axis``.  Each term is < q < 2^30, so the int64
    sum is exact and one final reduction gives the same residue as the
    reference's montadd tree."""
    return (_i64(x).sum(dim=axis) % _i64(q32)).to(I32)


def to_mont(x, q32, qneg_inv, r2):
    """Standard -> Montgomery domain: x * 2^32 mod q (r2 = 2^64 mod q)."""
    return montmul(x, r2, q32, qneg_inv)


# ---------------------------------------------------------------------------
# host-side (python int / numpy) helpers for table precomputation
# ---------------------------------------------------------------------------


def host_inv(x: int, q: int) -> int:
    return pow(x, q - 2, q)  # q prime


def mont_constants(q: int) -> tuple[int, int]:
    """Return (qneg_inv, r2) for R=2^32: -q^{-1} mod 2^32 and R^2 mod q."""
    qinv = pow(q, -1, 1 << 32)
    qneg_inv = ((1 << 32) - qinv) & 0xFFFFFFFF
    r2 = (1 << 64) % q
    return qneg_inv, r2


def to_mont_host_arr(x: np.ndarray, qs: np.ndarray) -> np.ndarray:
    """(x << 32) % q with broadcasting, as uint32 (x, q < 2^30)."""
    return ((np.asarray(x).astype(np.uint64) << np.uint64(32))
            % np.asarray(qs).astype(np.uint64)).astype(np.uint32)


_MR_WITNESSES = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37)


def is_prime(n: int) -> bool:
    """Deterministic Miller-Rabin for n < 3.3e24."""
    if n < 2:
        return False
    for p in _MR_WITNESSES:
        if n % p == 0:
            return n == p
    d, r = n - 1, 0
    while d % 2 == 0:
        d //= 2
        r += 1
    for a in _MR_WITNESSES:
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


def gen_ntt_primes(count: int, bits: int, two_n: int,
                   skip: frozenset = frozenset()) -> list[int]:
    """`count` primes q ≡ 1 (mod two_n), q < 2^30, walking down from 2^bits."""
    if bits > 30:
        raise ValueError("the u32 Montgomery path requires q < 2^30")
    out: list[int] = []
    q = (1 << bits) - ((1 << bits) - 1) % two_n
    while len(out) < count:
        if q <= two_n:
            raise ValueError(f"ran out of {bits}-bit primes ≡ 1 mod {two_n}")
        if q not in skip and is_prime(q):
            out.append(q)
        q -= two_n
    return out


def find_primitive_root(q: int, two_n: int, rng: np.random.Generator) -> int:
    """ψ of order exactly two_n mod q (draws from ``rng`` as the reference)."""
    assert (q - 1) % two_n == 0
    cof = (q - 1) // two_n
    while True:
        x = int(rng.integers(2, q - 1))
        psi = pow(x, cof, q)
        if pow(psi, two_n // 2, q) == q - 1:
            return psi


def bit_reverse_indices(n: int) -> np.ndarray:
    bits = n.bit_length() - 1
    idx = np.arange(n, dtype=np.int64)
    rev = np.zeros_like(idx)
    for b in range(bits):
        rev |= ((idx >> b) & 1) << (bits - 1 - b)
    return rev


def host_powers(base: int, n: int, q: int) -> np.ndarray:
    """[base^0, ..., base^(n-1)] mod q as uint64, by doubling blocks
    (exact: every factor is < 2^30, so each product fits uint64)."""
    out = np.empty(n, dtype=np.uint64)
    out[0] = 1
    filled, step = 1, base % q
    qq = np.uint64(q)
    while filled < n:
        take = min(filled, n - filled)
        out[filled:filled + take] = out[:take] * np.uint64(step) % qq
        filled += take
        step = step * step % q
    return out
