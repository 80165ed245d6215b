"""Galois automorphisms ψ_g: a(X) -> a(X^g) in the evaluation domain.

Counterpart of ``repro/core/automorph.py``.  In bit-reversed evaluation
order an automorphism is a pure permutation of the N values; rotation by
r slots uses g = 5^r mod 2N.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.core import modmath as mm


def galois_elt_rot(r: int, N: int) -> int:
    """Galois element for a circular left rotation by r slots."""
    slots = N // 2
    return pow(5, r % slots, 2 * N)


@functools.lru_cache(maxsize=None)
def eval_perm(N: int, g: int) -> np.ndarray:
    """perm: out_eval[j] = in_eval[perm[j]], bit-reversed eval order."""
    brv = mm.bit_reverse_indices(N)
    j = np.arange(N, dtype=np.int64)
    r = brv[j]
    rp = ((2 * r + 1) * g % (2 * N) - 1) // 2
    return brv[rp]


def apply_eval(x: torch.Tensor, N: int, g: int) -> torch.Tensor:
    """x: (..., M, N) bit-reversed eval domain. Pure gather, no arithmetic."""
    perm = torch.as_tensor(eval_perm(N, g), device=x.device)
    return x[..., perm]
