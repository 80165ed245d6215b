"""Homomorphic Linear Transformation: diagonal encoding, the single and
batched hoists, the reference schedules and the Montgomery operand builder
of the fused schedule — counterpart of ``repro/core/hlt.py``.

Six schedules, the same math (``mo``, ``hoisted``, ``pallas`` and the
sharded pair give identical residues):

* ``baseline`` — Algorithm 1: every rotation is a full ``rotate`` (a
  KeySwitch each), then ``cmult`` by its diagonal, one rescale at the end.
* ``hoisted`` — Algorithm 3: Decomp/ModUp hoisted out of the rotation
  loop, DiagIP accumulated in the extended basis PQ_ℓ, one merged
  ModDown+Rescale.
* ``mo`` — the same with the loop order inverted, limb outer and rotation
  inner; here plain torch over all limbs at once, ``rotation_chunk``
  rotations per step (it bounds the gathered temporaries).
* ``pallas`` — the fused Automorph→KeyIP→DiagIP kernels
  (``kernels/fused_hlt.py``) on Montgomery operands (``core/compile.py``).
* ``sharded`` / ``sharded_xla`` — the same over a mesh of ranks, limbs
  over ``model`` and ciphertexts over ``data`` (``core/hlt_dist.py``):
  the fused kernels on each rank's rows, or plain torch.

``hoist`` / ``hoist_batched`` take a ``datapath``: ``"pallas"`` runs the
fused hoist kernels, ``"xla"`` the per-digit chain iNTT → ModUp BaseConv →
NTT on the engine's own transforms (the reference's XLA form).  ``hlt()``
and ``hlt_batched()`` are deprecated shims over ``compile_hlt``.

The a-part (c0) is "scale-raised" into PQ_ℓ (× [P]_{q_i}, zero on the
special limbs) so DiagIP accumulates both output polynomials in the
extended basis and shares the one merged ModDown+Rescale.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core import automorph, modmath as mm
from repro_torch.core.ckks import Ciphertext, CkksEngine, Keys, Plaintext
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
# hoisting
# ---------------------------------------------------------------------------


def _hoist_digits(eng: CkksEngine, c1, level: int, datapath: str):
    """c1 (ℓ+1, N) eval -> digits (β, M_ext, N).  ``"pallas"``: the single
    fused hoist (``intt_scale`` then ``baseconv_ntt``); ``"xla"``: per digit
    iNTT → ModUp BaseConv → NTT on the engine's transforms, the own limbs
    copied from c1."""
    if datapath == "pallas":
        return ops.hoist_fused(c1, eng.fused_hoist_tables(level))
    bases = eng.tools.digit_bases(level)
    full = bases[0][2]
    digs = torch.zeros((len(bases), len(full), eng.params.N),
                       dtype=torch.int32, device=eng.device)
    for j, (own, gen, _) in enumerate(bases):
        # own is the main rows s..e-1 of the extended basis, gen the rest
        # in order: slices, so nothing is copied from the host
        s, e = own[0], own[-1] + 1
        dig_eval = c1[s:e]
        coeff = eng._intt(dig_eval, eng.basis(own))
        ext_eval = eng._ntt(eng.tools.mod_up(coeff, own, gen), eng.basis(gen))
        digs[j, s:e] = dig_eval
        digs[j, :s] = ext_eval[:s]
        digs[j, e:] = ext_eval[s:]
    return digs


def hoist(eng: CkksEngine, ct: Ciphertext,
          datapath: Optional[str] = None) -> Hoisted:
    """Decomp + ModUp once (Algorithm 3 lines 1–2); ``datapath`` defaults
    to the engine's."""
    level = ct.level
    dp = eng.datapath if datapath is None else datapath
    return Hoisted(digits=_hoist_digits(eng, ct.c1, level, dp),
                   c0_ext=_scale_raise(eng, ct.c0, level),
                   c1_ext=_scale_raise(eng, ct.c1, level), level=level,
                   scale=ct.scale)


def hoist_batched(eng: CkksEngine, cts: Sequence[Ciphertext], *,
                  datapath: Optional[str] = None) -> list:
    """Decomp + ModUp for a batch of ciphertexts at one level.  On
    ``"pallas"`` the whole batch is one ``hoist_db`` call; on ``"xla"`` each
    ciphertext runs the chain (the reference vmaps the same body).  One
    ciphertext goes through :func:`hoist`, as in the reference."""
    cts = list(cts)
    if not cts:
        return []
    levels = {ct.level for ct in cts}
    if len(levels) != 1:
        raise ValueError(f"hoist_batched needs one common level: {levels}")
    dp = eng.datapath if datapath is None else datapath
    if len(cts) == 1 or dp != "pallas":
        return [hoist(eng, ct, dp) for ct in cts]
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
    key = ("p_raise", ell)                  # built once a level: a call
    pres = eng._fused_tabs.get(key)         # copies nothing to the device
    if pres is None:
        Pprod = 1
        for i in range(p.num_main, p.num_total):
            Pprod *= eng.ctx.moduli_host[i]
        pres = torch.tensor([Pprod % eng.ctx.moduli_host[i]
                             for i in range(ell + 1)],
                            dtype=torch.int64, device=eng.device)[:, None]
        eng._fused_tabs[key] = pres
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


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------


SCHEDULES = ("baseline", "hoisted", "mo", "pallas", "sharded", "sharded_xla")

_DEPRECATION = ("%s is deprecated: build an HEContext and use "
                "repro_torch.core.compile.compile_hlt / compile_hemm (the "
                "plan/compile/execute API) instead.")


def hlt(eng: CkksEngine, ct: Ciphertext, diags: DiagSet, keys: Keys,
        schedule: str = "mo", rotation_chunk: Optional[int] = None,
        hoisted: Optional[Hoisted] = None) -> Ciphertext:
    """Ct' = Rescale(Σ_t u_{z_t} ⊙ Rot(Ct; z_t)), Algorithm 1's semantics.

    DEPRECATED shim: compiles through ``compile_hlt`` on a pooled
    HEContext.  ``baseline`` ignores ``hoisted`` (it has no hoisting
    product), as the reference's shim does."""
    warnings.warn(_DEPRECATION % "hlt()", DeprecationWarning, stacklevel=2)
    from repro_torch.core.compile import compile_hlt, legacy_context
    item = ct if schedule == "baseline" or hoisted is None else hoisted
    run = compile_hlt(legacy_context(eng, keys), diags, level=item.level,
                      schedule=schedule, rotation_chunk=rotation_chunk)
    return run(item)


def hlt_batched(eng: CkksEngine, items: Sequence, keys: Keys,
                schedule: str = "pallas",
                rotation_chunk: Optional[int] = None) -> list:
    """Many HLTs over ``(ct_or_hoisted, DiagSet)`` pairs at one level, as one
    batched compile; returns one Ciphertext per pair, in order.

    DEPRECATED shim over ``compile_hlt(ctx, [ds, ...], level=...)``."""
    warnings.warn(_DEPRECATION % "hlt_batched()", DeprecationWarning,
                  stacklevel=2)
    from repro_torch.core.compile import compile_hlt, legacy_context
    items = list(items)
    levels = {it.level for it, _ in items}
    if len(levels) != 1:
        raise ValueError(f"hlt_batched needs one common level, got {levels}")
    run = compile_hlt(legacy_context(eng, keys), [ds for _, ds in items],
                      level=levels.pop(), schedule=schedule,
                      rotation_chunk=rotation_chunk)
    return run([it for it, _ in items])


def _hlt_baseline(eng: CkksEngine, ct: Ciphertext, diags: DiagSet,
                  keys: Keys) -> Ciphertext:
    ell = ct.level
    acc: Optional[Ciphertext] = None
    for t, z in enumerate(diags.zs):
        rt = ct if z == 0 else eng.rotate(ct, z, keys)
        term = eng.cmult(rt, Plaintext(diags.pt[t][: ell + 1], ell,
                                       diags.scale))
        acc = term if acc is None else eng.add(acc, term)
    return eng.rescale(acc)


def _gather_keys(eng: CkksEngine, keys: Keys, zs, nbeta: int, full):
    """Rotation-key rows of the extended basis, (d, β, M_ext, N) each; the
    z = 0 entry (never read) is zeros."""
    rows = torch.as_tensor(full, device=eng.device)
    zero = torch.zeros((nbeta, len(full), eng.params.N), dtype=torch.int32,
                       device=eng.device)
    k0s, k1s = [], []
    for z in zs:
        if z == 0:
            k0s.append(zero)
            k1s.append(zero)
            continue
        key = keys.galois[automorph.galois_elt_rot(z, eng.params.N)]
        k0s.append(key.k0[:nbeta][:, rows])
        k1s.append(key.k1[:nbeta][:, rows])
    return torch.stack(k0s), torch.stack(k1s)


def _accumulate(eng: CkksEngine, hst: Hoisted, diags: DiagSet, keys: Keys,
                full, view, t_indices, acc0, acc1):
    """The rotation loop of ``hoisted`` (rotation outer, all limbs at once)."""
    nbeta = hst.digits.shape[0]
    N = eng.params.N
    q = view.moduli
    rows = torch.as_tensor(full, device=eng.device)
    for t in t_indices:
        z = diags.zs[t]
        u = diags.pt[t][rows]
        if z == 0:
            acc0 = mm.addmod(acc0, mm.mulmod(u, hst.c0_ext, q), q)
            acc1 = mm.addmod(acc1, mm.mulmod(u, hst.c1_ext, q), q)
            continue
        g = automorph.galois_elt_rot(z, N)
        key = keys.galois[g]
        d_rot = automorph.apply_eval(hst.digits, N, g)
        c0_rot = automorph.apply_eval(hst.c0_ext, N, g)
        k0 = torch.zeros_like(acc0)
        k1 = torch.zeros_like(acc1)
        for j in range(nbeta):
            k0 = mm.addmod(k0, mm.mulmod(d_rot[j], key.k0[j][rows], q), q)
            k1 = mm.addmod(k1, mm.mulmod(d_rot[j], key.k1[j][rows], q), q)
        acc0 = mm.addmod(acc0, mm.mulmod(u, mm.addmod(k0, c0_rot, q), q), q)
        acc1 = mm.addmod(acc1, mm.mulmod(u, k1, q), q)
    return acc0, acc1


def _finish(eng: CkksEngine, hst: Hoisted, diags: DiagSet, acc0,
            acc1) -> Ciphertext:
    """The merged ModDown+Rescale (PQ_ℓ → Q_{ℓ-1}) on the engine's
    datapath: the fused kernels on ``"pallas"``, the chain on ``"xla"``."""
    ell = hst.level
    c0 = eng._mod_down_eval(acc0, ell, drop_last=True)
    c1 = eng._mod_down_eval(acc1, ell, drop_last=True)
    q_ell = eng.ctx.moduli_host[ell]
    return Ciphertext(c0, c1, ell - 1, hst.scale * diags.scale / q_ell)


def _hlt_hoisted(eng: CkksEngine, hst: Hoisted, diags: DiagSet,
                 keys: Keys) -> Ciphertext:
    full = eng.tools.digit_bases(hst.level)[0][2]
    view = eng.basis(full)
    acc0 = torch.zeros((len(full), eng.params.N), dtype=torch.int32,
                       device=eng.device)
    acc0, acc1 = _accumulate(eng, hst, diags, keys, full, view,
                             range(diags.d), acc0, torch.zeros_like(acc0))
    return _finish(eng, hst, diags, acc0, acc1)


def _reduce_add(x, q):
    """Sum (M, c, N) mod q (M, 1, 1) along the rotation axis: exact in
    int64 (c·q < 2^63), one reduction at the end."""
    return (x.to(torch.int64).sum(dim=1) % q[:, 0]).to(torch.int32)


def _mo_pipeline(eng: CkksEngine, hst: Hoisted, u_all, rk0, rk1, perms,
                 is_id, chunk: int):
    """Limb-outer / rotation-inner accumulation over all extended limbs at
    once, ``chunk`` rotations per step, then the merged ModDown+Rescale.
    u_all (d, M, N); rk0/rk1 (d, β, M, N); perms (d, N) int64; is_id (d,)
    bool.  Returns (c0, c1) over Q_{ℓ-1}."""
    level = hst.level
    view = eng.basis(eng.tools.digit_bases(level)[0][2])
    q3 = view.moduli[:, :, None]                  # (M, 1, 1)
    nbeta, M, N = hst.digits.shape
    d = u_all.shape[0]
    a0 = torch.zeros((M, N), dtype=torch.int32, device=eng.device)
    a1 = torch.zeros_like(a0)
    for s in range(0, d, chunk):
        e = min(s + chunk, d)
        pm = perms[s:e]                           # (c, N)
        dig_rot = hst.digits[:, :, pm]            # (β, M, c, N) gather
        c0_rot = hst.c0_ext[:, pm]                # (M, c, N)
        k0 = torch.zeros((M, e - s, N), dtype=torch.int32, device=eng.device)
        k1 = torch.zeros_like(k0)
        for j in range(nbeta):
            k0 = mm.addmod(k0, mm.mulmod(dig_rot[j], rk0[s:e, j].transpose(0, 1),
                                         q3), q3)
            k1 = mm.addmod(k1, mm.mulmod(dig_rot[j], rk1[s:e, j].transpose(0, 1),
                                         q3), q3)
        # z = 0 entries bypass KeyIP: (P·c0, P·c1) directly
        sel = is_id[s:e][None, :, None]
        t0 = torch.where(sel, hst.c0_ext[:, None], mm.addmod(k0, c0_rot, q3))
        t1 = torch.where(sel, hst.c1_ext[:, None], k1)
        u = u_all[s:e].transpose(0, 1)            # (M, c, N)
        a0 = mm.addmod(a0, _reduce_add(mm.mulmod(u, t0, q3), q3), view.moduli)
        a1 = mm.addmod(a1, _reduce_add(mm.mulmod(u, t1, q3), q3), view.moduli)
    return (eng._mod_down_eval(a0, level, drop_last=True),
            eng._mod_down_eval(a1, level, drop_last=True))


def _hlt_mo(eng: CkksEngine, hst: Hoisted, diags: DiagSet, keys: Keys,
            rotation_chunk: Optional[int]) -> Ciphertext:
    """Limb-outer / rotation-inner schedule over the extended basis."""
    full = eng.tools.digit_bases(hst.level)[0][2]
    nbeta = hst.digits.shape[0]
    rk0, rk1 = _gather_keys(eng, keys, diags.zs, nbeta, full)
    perms = torch.as_tensor(_perm_table(eng, diags.zs), device=eng.device)
    u_all = diags.pt[:, torch.as_tensor(full, device=eng.device)]
    is_id = torch.tensor([z == 0 for z in diags.zs], device=eng.device)
    d = diags.d
    chunk = d if rotation_chunk is None else max(1, min(rotation_chunk, d))
    c0, c1 = _mo_pipeline(eng, hst, u_all, rk0, rk1, perms, is_id, chunk)
    q_ell = eng.ctx.moduli_host[hst.level]
    return Ciphertext(c0, c1, hst.level - 1, hst.scale * diags.scale / q_ell)


# ---------------------------------------------------------------------------
# pallas schedule: Montgomery operand builder for the fused kernels
# ---------------------------------------------------------------------------


def operand_shapes(eng: CkksEngine, level: int, nbeta: int, d_pad: int,
                   rows: Optional[int] = None):
    """Shapes of (u_m, rk0_m, rk1_m, perms, is_id) for one DiagSet, over
    the extended basis or ``rows`` rows of it."""
    M, N = len(eng.tools.digit_bases(level)[0][2]), eng.params.N
    M = M if rows is None else rows
    return ((d_pad, M, N), (d_pad, nbeta, M, N), (d_pad, nbeta, M, N),
            (d_pad, N), (d_pad, 1))


def _build_pallas_operands(eng: CkksEngine, diags: DiagSet, keys: Keys,
                           level: int, nbeta: int, d_pad: int, out=None,
                           limbs: Optional[tuple] = None):
    """Montgomery-domain kernel operands for one DiagSet, padded to d_pad
    rotations: (u_m, rk0_m, rk1_m, perms, is_id), all int32; written into
    ``out`` (zero-filled tensors of ``operand_shapes``) when given.
    ``limbs=(lo, hi)``: only the rows lo..hi-1 of the extended basis (a
    rank's block of the sharded schedule; rows past the basis are padding
    and stay zero).

    Padding entries are identity rotations (perm = arange) with zero
    diagonal and is_id = 1, so they bypass KeyIP and contribute exactly
    zero.  The z = 0 entry keeps zero key rows, as the reference's.  The
    operands are filled one rotation at a time so the int64 temporaries
    stay one rotation's size."""
    p = eng.params
    full = eng.tools.digit_bases(level)[0][2]
    lo, hi = (0, len(full)) if limbs is None else limbs
    sel = full[lo:hi]                   # the block's rows of the basis
    n = len(sel)
    N, dev = p.N, eng.device
    if out is None:
        out = tuple(torch.zeros(s, dtype=torch.int32, device=dev)
                    for s in operand_shapes(eng, level, nbeta, d_pad,
                                            rows=hi - lo))
    u_m, rk0_m, rk1_m, perms_t, is_id_t = out
    if n:
        view = eng.basis(sel)
        q32, qneg, r2 = view.moduli_u32, view.qneg_inv, view.r2
        rows = torch.as_tensor(sel, device=dev)
        for t, z in enumerate(diags.zs):
            u_m[t, :n] = mm.to_mont(diags.pt[t][rows], q32, qneg, r2)
            if z == 0:
                continue
            key = keys.galois[automorph.galois_elt_rot(z, N)]
            rk0_m[t, :, :n] = mm.to_mont(key.k0[:nbeta][:, rows], q32, qneg,
                                         r2)
            rk1_m[t, :, :n] = mm.to_mont(key.k1[:nbeta][:, rows], q32, qneg,
                                         r2)
    perms = np.tile(np.arange(N, dtype=np.int32), (d_pad, 1))
    perms[: diags.d] = _perm_table(eng, diags.zs)
    is_id = np.ones((d_pad, 1), np.int32)
    is_id[: diags.d, 0] = [1 if z == 0 else 0 for z in diags.zs]
    perms_t.copy_(torch.from_numpy(perms))
    is_id_t.copy_(torch.from_numpy(is_id))
    return out
