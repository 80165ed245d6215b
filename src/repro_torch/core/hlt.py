"""Homomorphic Linear Transformation: diagonal encoding, the single and
batched hoists and the Montgomery operand builder of the fused schedule —
counterpart of ``repro/core/hlt.py`` (its ``"pallas"`` schedule; the
reference schedules ``baseline``/``hoisted``/``mo`` are not ported yet).

The a-part (c0) is "scale-raised" into PQ_ℓ (× [P]_{q_i}, zero on the
special limbs) so DiagIP accumulates both output polynomials in the
extended basis and shares the one merged ModDown+Rescale.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core import automorph, modmath as mm
from repro_torch.core.ckks import Ciphertext, CkksEngine, Keys
from repro_torch.kernels import ops


@dataclasses.dataclass
class DiagSet:
    """Non-zero diagonals of a transformation matrix U, encoded over the FULL
    prime basis (sliceable to any level / extended basis)."""
    zs: tuple
    pt: torch.Tensor                 # (d, M_total, N) int32 eval residues
    scale: float
    shape: tuple                     # U is (rows, cols)

    @property
    def d(self) -> int:
        return len(self.zs)


@dataclasses.dataclass
class Hoisted:
    """Hoisting product: reusable across every HLT applied to the same ct."""
    digits: torch.Tensor             # (β', M_ext, N) eval, full extended basis
    c0_ext: torch.Tensor             # (M_ext, N) eval, P·c0 (zeros on specials)
    c1_ext: torch.Tensor             # (M_ext, N) eval, P·c1
    level: int
    scale: float


@dataclasses.dataclass(frozen=True)
class SparseMatrix:
    """A transformation matrix given by its non-zero entries (the hemm
    matrices are permutation-like: one entry per row)."""
    shape: tuple
    rows: np.ndarray
    cols: np.ndarray
    vals: np.ndarray


# ---------------------------------------------------------------------------
# diagonal encoding
# ---------------------------------------------------------------------------


def _diagonals(U):
    """[(z, vec)] for every generalised diagonal z = col − row with a
    non-zero entry, ascending z; vec[i] = U[i, i+z] — exactly the
    reference's dense scan, computed from the non-zero entries."""
    if isinstance(U, SparseMatrix):
        r, c, v = U.rows, U.cols, U.vals
    else:
        U = np.asarray(U)
        r, c = np.nonzero(U)
        v = U[r, c]
    z = c.astype(np.int64) - r.astype(np.int64)
    order = np.argsort(z, kind="stable")
    z, r, v = z[order], r[order], v[order]
    zs, starts = np.unique(z, return_index=True)
    bounds = list(starts[1:]) + [len(z)]
    return [(int(zz), r[s:e], v[s:e])
            for zz, s, e in zip(zs, starts, bounds, strict=True)]


def encode_diagonals(eng: CkksEngine, U, scale: Optional[float] = None) -> DiagSet:
    """Halevi–Shoup ambient-rotation decomposition: U·m = Σ_z u_z ⊙ ρ(m; z).

    ``U`` is a dense array or a :class:`SparseMatrix`; both give the
    reference's diagonals (u_z[i] = U[i, i+z])."""
    p = eng.params
    rows, cols = U.shape
    if max(rows, cols) > p.slots:
        raise ValueError(f"matrix {U.shape} exceeds {p.slots} slots")
    scale = p.scale if scale is None else scale
    full = list(range(p.num_total))
    diags = [(z, i, v) for z, i, v in _diagonals(U) if np.any(v != 0)]
    pt = torch.empty((len(diags), p.num_total, p.N), dtype=torch.int32,
                     device=eng.device)
    for t, (_z, i, vals) in enumerate(diags):
        vec = np.zeros(p.slots)
        vec[i] = vals
        pt[t] = eng.encode_to_basis(vec, full, scale)
    return DiagSet(zs=tuple(z for z, _, _ in diags), pt=pt, scale=scale,
                   shape=(rows, cols))


# ---------------------------------------------------------------------------
# hoisting (fused kernels)
# ---------------------------------------------------------------------------


def hoist(eng: CkksEngine, ct: Ciphertext) -> Hoisted:
    """Decomp + ModUp once (Algorithm 3 lines 1–2), through the single
    fused hoist (``intt_scale`` then ``baseconv_ntt``)."""
    level = ct.level
    digits = ops.hoist_fused(ct.c1, eng.fused_hoist_tables(level))
    return Hoisted(digits=digits, c0_ext=_scale_raise(eng, ct.c0, level),
                   c1_ext=_scale_raise(eng, ct.c1, level), level=level,
                   scale=ct.scale)


def hoist_batched(eng: CkksEngine, cts: Sequence[Ciphertext]) -> list:
    """Decomp + ModUp for a batch of ciphertexts at one level, through the
    batched fused hoist (one ``hoist_db`` call for the whole batch); one
    ciphertext goes through :func:`hoist`, as in the reference."""
    cts = list(cts)
    if not cts:
        return []
    levels = {ct.level for ct in cts}
    if len(levels) != 1:
        raise ValueError(f"hoist_batched needs one common level: {levels}")
    if len(cts) == 1:
        return [hoist(eng, cts[0])]
    level = cts[0].level
    c0s = torch.stack([ct.c0 for ct in cts])
    c1s = torch.stack([ct.c1 for ct in cts])
    digits = ops.hoist_fused_db(c1s, eng.fused_hoist_tables(level))
    c0e, c1e = _scale_raise(eng, c0s, level), _scale_raise(eng, c1s, level)
    return [Hoisted(digits=digits[b], c0_ext=c0e[b], c1_ext=c1e[b],
                    level=level, scale=ct.scale)
            for b, ct in enumerate(cts)]


def _scale_raise(eng: CkksEngine, x, ell: int):
    """x (..., ℓ+1, N) over Q_ℓ -> P·x over Q_ℓ ∪ P (zeros on special limbs)."""
    p = eng.params
    Pprod = 1
    for i in range(p.num_main, p.num_total):
        Pprod *= eng.ctx.moduli_host[i]
    pres = torch.tensor([Pprod % eng.ctx.moduli_host[i] for i in range(ell + 1)],
                        dtype=torch.int64, device=eng.device)[:, None]
    top = mm.mulmod(x, pres, eng.main_basis(ell).moduli)
    zeros = torch.zeros(x.shape[:-2] + (p.k, p.N), dtype=torch.int32,
                        device=eng.device)
    return torch.cat([top, zeros], dim=-2)


def _perm_table(eng: CkksEngine, zs) -> np.ndarray:
    """(d, N) eval-domain automorph gather indices (identity for z=0)."""
    N = eng.params.N
    return np.stack([np.arange(N, dtype=np.int64) if z == 0 else
                     automorph.eval_perm(N, automorph.galois_elt_rot(z, N))
                     for z in zs])


def operand_shapes(eng: CkksEngine, level: int, nbeta: int, d_pad: int):
    """Shapes of (u_m, rk0_m, rk1_m, perms, is_id) for one DiagSet."""
    M, N = len(eng.tools.digit_bases(level)[0][2]), eng.params.N
    return ((d_pad, M, N), (d_pad, nbeta, M, N), (d_pad, nbeta, M, N),
            (d_pad, N), (d_pad, 1))


def _build_pallas_operands(eng: CkksEngine, diags: DiagSet, keys: Keys,
                           level: int, nbeta: int, d_pad: int, out=None):
    """Montgomery-domain kernel operands for one DiagSet, padded to d_pad
    rotations: (u_m, rk0_m, rk1_m, perms, is_id), all int32; written into
    ``out`` (zero-filled tensors of ``operand_shapes``) when given.

    Padding entries are identity rotations (perm = arange) with zero
    diagonal and is_id = 1, so they bypass KeyIP and contribute exactly
    zero.  The z = 0 entry keeps zero key rows, as the reference's.  The
    operands are filled one rotation at a time so the int64 temporaries
    stay one rotation's size."""
    p = eng.params
    full = eng.tools.digit_bases(level)[0][2]
    view = eng.basis(full)
    q32, qneg, r2 = view.moduli_u32, view.qneg_inv, view.r2
    rows = torch.as_tensor(full, device=eng.device)
    N, dev = p.N, eng.device
    if out is None:
        out = tuple(torch.zeros(s, dtype=torch.int32, device=dev)
                    for s in operand_shapes(eng, level, nbeta, d_pad))
    u_m, rk0_m, rk1_m, perms_t, is_id_t = out
    for t, z in enumerate(diags.zs):
        u_m[t] = mm.to_mont(diags.pt[t][rows], q32, qneg, r2)
        if z == 0:
            continue
        key = keys.galois[automorph.galois_elt_rot(z, N)]
        rk0_m[t] = mm.to_mont(key.k0[:nbeta][:, rows], q32, qneg, r2)
        rk1_m[t] = mm.to_mont(key.k1[:nbeta][:, rows], q32, qneg, r2)
    perms = np.tile(np.arange(N, dtype=np.int32), (d_pad, 1))
    perms[: diags.d] = _perm_table(eng, diags.zs)
    is_id = np.ones((d_pad, 1), np.int32)
    is_id[: diags.d, 0] = [1 if z == 0 else 0 for z in diags.zs]
    perms_t.copy_(torch.from_numpy(perms))
    is_id_t.copy_(torch.from_numpy(is_id))
    return out
