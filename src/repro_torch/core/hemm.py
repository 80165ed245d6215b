"""Homomorphic Encrypted Matrix Multiplication (paper §II-C, Algorithm 2):
the transformation matrices, the plan and the matrix encrypt/decrypt —
counterpart of ``repro/core/hemm.py``.

A_{m×l} × B_{l×n} = Σ_k (ε^k∘σ(A)) ⊙ (ω^k∘τ(B)), each transformation an
HLT over the column-major flattened matrix.  Every matrix has one entry
per row, so the plan encodes its diagonals from the sparse form; the
dense ``u_*`` functions build the same matrices as the reference.
Execution is ``compile_hemm`` (core/compile.py).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np

from repro_torch.core.ckks import Ciphertext, CkksEngine, Keys
from repro_torch.core.hlt import DiagSet, SparseMatrix, encode_diagonals


def _sparse(shape, rows, cols) -> SparseMatrix:
    rows = np.asarray(rows, np.int64).ravel()
    return SparseMatrix(shape, rows, np.asarray(cols, np.int64).ravel(),
                        np.ones(rows.size))


def sigma_map(m: int, l: int) -> SparseMatrix:
    i = np.arange(m)[:, None]
    j = np.arange(l)[None, :]
    return _sparse((m * l, m * l), i + j * m, i + ((i + j) % l) * m)


def tau_map(l: int, n: int) -> SparseMatrix:
    i = np.arange(l)[:, None]
    j = np.arange(n)[None, :]
    return _sparse((l * n, l * n), i + j * l, ((i + j) % l) + j * l)


def eps_map(k: int, m: int, l: int, n: int) -> SparseMatrix:
    r = np.arange(m * n)
    return _sparse((m * n, m * l), r, (k * m + r) % (m * l))


def omega_map(k: int, m: int, l: int, n: int) -> SparseMatrix:
    r = np.arange(m * n)
    return _sparse((m * n, l * n), r, (k + r % m) % l + (r // m) * l)


def _dense(s: SparseMatrix) -> np.ndarray:
    U = np.zeros(s.shape, dtype=np.float64)
    U[s.rows, s.cols] = s.vals
    return U


def u_sigma(m: int, l: int) -> np.ndarray:
    return _dense(sigma_map(m, l))


def u_tau(l: int, n: int) -> np.ndarray:
    return _dense(tau_map(l, n))


def u_eps(k: int, m: int, l: int, n: int) -> np.ndarray:
    return _dense(eps_map(k, m, l, n))


def u_omega(k: int, m: int, l: int, n: int) -> np.ndarray:
    return _dense(omega_map(k, m, l, n))


def min_logN(m: int, l: int, n: int) -> int:
    """Slots must hold both inputs AND the m×n output."""
    need = 2 * max(m * l, l * n, m * n)
    return max(1, math.ceil(math.log2(need)))


@dataclasses.dataclass
class HeMMPlan:
    m: int
    l: int
    n: int
    ds_sigma: DiagSet
    ds_tau: DiagSet
    ds_eps: list
    ds_omega: list
    rot_steps: tuple

    @property
    def total_rotations(self) -> int:
        return (self.ds_sigma.d + self.ds_tau.d
                + sum(d.d for d in self.ds_eps)
                + sum(d.d for d in self.ds_omega))


def plan_hemm(eng: CkksEngine, m: int, l: int, n: int,
              scale: Optional[float] = None) -> HeMMPlan:
    p = eng.params
    if max(m * l, l * n, m * n) > p.slots:
        raise ValueError(f"{(m, l, n)} needs logN >= {min_logN(m, l, n)} "
                         f"(have {p.logN})")
    enc = lambda U: encode_diagonals(eng, U, scale)
    ds_sigma = enc(sigma_map(m, l))
    ds_tau = enc(tau_map(l, n))
    ds_eps = [enc(eps_map(k, m, l, n)) for k in range(l)]
    ds_omega = [enc(omega_map(k, m, l, n)) for k in range(l)]
    steps = set()
    for ds in [ds_sigma, ds_tau, *ds_eps, *ds_omega]:
        steps.update(z for z in ds.zs if z != 0)
    return HeMMPlan(m, l, n, ds_sigma, ds_tau, ds_eps, ds_omega,
                    tuple(sorted(steps)))


def encrypt_matrix(eng: CkksEngine, keys: Keys, X: np.ndarray,
                   rng: np.random.Generator, level: Optional[int] = None,
                   scale: Optional[float] = None) -> Ciphertext:
    """Column-major flatten into the first rows·cols slots (paper Fig. 1)."""
    vec = np.asarray(X, dtype=np.float64).flatten(order="F")
    return eng.encrypt(eng.encode(vec, level=level, scale=scale), keys, rng)


def decrypt_matrix(eng: CkksEngine, keys: Keys, ct: Ciphertext,
                   m: int, n: int) -> np.ndarray:
    vals = eng.decrypt_decode(ct, keys, num=m * n).real
    return vals.reshape((m, n), order="F")
