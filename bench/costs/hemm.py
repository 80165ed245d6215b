"""The least work of an encrypted matrix product (Algorithm 2), frozen.

For each stage, the 32-bit words that any evaluation has to move through
device memory, counted once each, and the modular products it has to
compute.  They depend only on the parameter set and (m, l, n): no kernel
or schedule of the program enters, so removing or fusing a kernel cannot
make them read zero.

Words of a stage:
- its input ciphertexts (2 polynomials of level+1 limbs of N words);
- the plaintext diagonals of its maps, at the stage's level (level+1
  limbs), each distinct diagonal vector once;
- each Galois key it rotates by, and the relinearisation key, at its
  level: 2 polynomials × digits × (level+1+k) limbs;
- its output ciphertexts, written once.

Products of a stage (one 32-bit operation each, a lower bound: a modular
product costs several): each distinct diagonal times a ciphertext, each
key's inner product with the digits, and each ciphertext product's three
tensor terms.

The maps are those of FAME's Algorithm 2 (σ, τ, ε^k, ω^k over column-major
flattened matrices); a diagonal z = col − row rotates by z mod N/2.
"""
from __future__ import annotations

import math

import numpy as np

from costs import PEAK_BYTES_PER_S, PEAK_OPS_PER_S, WORD_BYTES


def _sigma(m, l):
    i, j = np.arange(m)[:, None], np.arange(l)[None, :]
    return (i + j * m).ravel(), (i + ((i + j) % l) * m).ravel()


def _tau(l, n):
    i, j = np.arange(l)[:, None], np.arange(n)[None, :]
    return (i + j * l).ravel(), (((i + j) % l) + j * l).ravel()


def _eps(k, m, l, n):
    r = np.arange(m * n)
    return r, (k * m + r) % (m * l)


def _omega(k, m, l, n):
    r = np.arange(m * n)
    return r, (k + r % m) % l + (r // m) * l


def diagonals(maps, slots: int):
    """(distinct diagonal vectors, distinct non-zero rotations) over a
    stage's maps, each a (rows, cols) pair of index arrays with unit
    entries: diagonal z holds the rows i with an entry at (i, i + z)."""
    vectors, steps = set(), set()
    for rows, cols in maps:
        z = cols - rows
        order = np.argsort(z, kind="stable")
        zs, starts = np.unique(z[order], return_index=True)
        for zz, part in zip(zs, np.split(rows[order], starts[1:]),
                            strict=True):
            vectors.add(np.sort(part).tobytes())
            if zz % slots:
                steps.add(int(zz) % slots)
    return len(vectors), steps


def _digits(sizes: dict, level: int) -> int:
    alpha = math.ceil((sizes["L"] + 1) / sizes["beta"])
    return math.ceil((level + 1) / alpha)


def _ct(sizes: dict, level: int) -> int:
    return 2 * (level + 1) * (1 << sizes["logN"])


def _key(sizes: dict, level: int) -> int:
    return (2 * _digits(sizes, level) * (level + 1 + sizes["k"])
            * (1 << sizes["logN"]))


def _hlt(sizes: dict, level: int, maps, n_in: int, n_out: int):
    """(words, products, rotations) of one HLT stage at ``level``."""
    N = 1 << sizes["logN"]
    n_diag, steps = diagonals(maps, N // 2)
    words = (n_in * _ct(sizes, level) + n_diag * (level + 1) * N
             + len(steps) * _key(sizes, level)
             + n_out * _ct(sizes, level - 1))
    products = (n_diag * 2 * (level + 1) * N
                + len(steps) * _key(sizes, level))
    return words, products, steps


def seconds(words: int, products: int) -> float:
    """The least time of a stage: its bytes over the memory's peak rate,
    or its products over the 32-bit peak rate, whichever is longer."""
    return max(words * WORD_BYTES / PEAK_BYTES_PER_S,
               products / PEAK_OPS_PER_S)


def least(sizes: dict, m: int, l: int, n: int) -> dict:
    """Stage -> {"words", "products", "seconds"} for a hemm from level L:
    ``step1`` (σ(A), τ(B)), ``step2`` (the 2·l ε^k, ω^k), ``loop`` (l
    products and their sum), ``hlt`` (Step 1 and Step 2), and ``request``
    (the whole call: the intermediate ciphertexts are not counted, and a
    key used at both HLT levels is read once, at the higher)."""
    L, N = sizes["L"], 1 << sizes["logN"]
    w1, p1, st1 = _hlt(sizes, L, [_sigma(m, l), _tau(l, n)], 2, 2)
    maps2 = ([_eps(k, m, l, n) for k in range(l)]
             + [_omega(k, m, l, n) for k in range(l)])
    w2, p2, st2 = _hlt(sizes, L - 1, maps2, 2, 2 * l)
    lv = L - 2
    w3 = 2 * l * _ct(sizes, lv) + _key(sizes, lv) + _ct(sizes, lv - 1)
    p3 = l * (3 * (lv + 1) * N + _key(sizes, lv))
    n1, _ = diagonals([_sigma(m, l), _tau(l, n)], N // 2)
    n2, _ = diagonals(maps2, N // 2)
    w_req = (2 * _ct(sizes, L) + n1 * (L + 1) * N + n2 * L * N
             + len(st1) * _key(sizes, L) + len(st2 - st1) * _key(sizes, L - 1)
             + _key(sizes, lv) + _ct(sizes, lv - 1))
    stages = {"step1": (w1, p1), "step2": (w2, p2), "loop": (w3, p3),
              "hlt": (w1 + w2, p1 + p2), "request": (w_req, p1 + p2 + p3)}
    return {k: {"words": w, "products": p, "seconds": seconds(w, p)}
            for k, (w, p) in stages.items()}
