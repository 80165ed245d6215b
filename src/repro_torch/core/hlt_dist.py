"""Limb-sharded MO-HLT: the ``schedule="sharded"`` program as SPMD over
``torch.distributed`` — counterpart of the sharded half of
``repro/core/hlt_dist.py`` (``build_shard_tables`` …
``make_sharded_hlt_fn``).

Mapping (``distributed/sharding.py`` rules ``limbs -> model``,
``ct_batch -> pod × data``): the extended limb axis (the ``full`` basis,
M rows, padded to ``M_pad = rows_loc · n_model``) shards over the
``model`` ranks, the ciphertext batch (padded to a multiple of the ct
ranks) over ``pod`` × ``data``.  Each rank is one process with one
device; every rank holds the same keys and ciphertexts (the same seeds),
as a JAX mesh's replicated inputs, and computes the row block
``[r·rows_loc, (r+1)·rows_loc)`` of its block of the batch.  Limbs are
independent through NTT / Automorph / KeyIP / DiagIP, so ModUp runs
collective-free off the limb-replicated inputs, and the merged
ModDown+Rescale BaseConv is the only collective: one ``all_reduce`` over
the ``model`` group an output polynomial (the reference's ``psum``), of
the (B, k+1, N) drop-basis inputs, where each row has exactly one
contributor — an exact sum.  ``core/compile.py`` gathers the output
blocks after the body (over ``model``, then over the ct ranks), counted
apart from the body's collectives.

Two datapaths share the skeleton (``make_sharded_hlt_fn(datapath=)``):

* ``"pallas"`` (``schedule="sharded"``): each rank runs its row block
  through ``fused_hlt_indexed``, and the in-program hoist is deduped by
  ciphertext slot (``hoist_layout="dedup"``: each unique input hoisted
  once a rank) or per element (``"element"``: a rank hoists its share of
  a mostly-distinct batch).  ``stages="pallas"`` puts the hoist
  (``intt_scale`` on the replicated main rows, then ``baseconv_ntt`` on
  the rank's rows) and the merged ModDown (``intt_scale``, the scatter
  and the all-reduce, ``moddown_finish``) on the kernels; ``"xla"`` keeps
  both on plain torch (the named int64 NTTs of ``core/ntt.py``).
* ``"xla"`` (``schedule="sharded_xla"``): the fusion baseline, plain
  torch throughout, every batch element re-hoisted.

The float BaseConv correction is float64 with the fused kernels'
``+0.5e-6`` (``kernels/basechange.py`` ``CORRECTION_EPS``), the
reference's CPU choice, so a sharded program is array-equal to the
one-device ``"pallas"`` one.

The reference's GSPMD prototype is here too (``build_tables``,
``make_mo_hlt_fn``): one DiagSet's d rotations applied to a ciphertext
batch over all limbs, the float correction in float32 or float64 with
the reference's ``+0.5e-6``, array-equal to the reference's.  Eager
torch places nothing, so its sharding constraints have no counterpart
(every rank computes the same values); the distributed MO-HLT is
``schedule="sharded"``.  ``lower_mo_hlt_spmd`` returns what the dry-run
(``launch/dryrun.py``) prices in the reference's place: one rank's share
of the limb-sharded MO-HLT on the ``"sharded_xla"`` datapath, on
arguments of the rank's shapes.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import automorph
from repro_torch.core import modmath as mm
from repro_torch.core import ntt
from repro_torch.core.params import HEParams, get_context, u32_tensor
from repro_torch.core.rns import RnsTools
from repro_torch.distributed import collectives, hlo_cost
from repro_torch.kernels import basechange, ops

_mont = mm.to_mont_host_arr

#: elements (output polynomials) a step of the plain-torch stages: bounds
#: their int64 temporaries (a step of 32 at Set-B's 12 rows a rank: ~0.1 GB
#: each) where a Step 2 of 256 HLTs at once took ~35 GB a rank
PLAIN_CHUNK = 32


# ---------------------------------------------------------------------------
# the GSPMD prototype (the reference's dry-run workload)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class DistTables:
    """Host tables of the prototype MO-HLT (the reference's, numpy)."""
    params: HEParams
    d: int
    full: tuple                    # prime indices [Q_L..., P...]
    q32: np.ndarray                # (M,1) u32
    qneg: np.ndarray               # (M,1)
    r2: np.ndarray                 # (M,1)
    psi_m: np.ndarray              # (M,N) mont twiddles
    psii_m: np.ndarray
    ninv_m: np.ndarray             # (M,1) mont
    perms: np.ndarray              # (d,N) int32
    p_raise_m: np.ndarray          # (L+1,1) [P]_{q_i} in mont form
    digits: list                   # per digit: dict(own, gen, tables...)
    md: dict                       # merged ModDown+Rescale tables
    ctb: int


def build_tables(params: HEParams, d: int, ctb: int) -> DistTables:
    """The prototype's tables at level L: rotations z = −(d//2) ..
    d − d//2 − 1 (z = 0 the identity), the digits' ModUp and the merged
    ModDown+Rescale BaseConv tables."""
    ctx = get_context(params)
    h = ctx.host
    tools = RnsTools(ctx)
    L, N = params.L, params.N
    full = tuple(range(L + 1)) + tuple(range(params.num_main,
                                             params.num_total))
    M = len(full)
    qs = np.array([ctx.moduli_host[i] for i in full], dtype=np.uint64)[:, None]
    q32 = qs.astype(np.uint32)
    qneg = np.empty((M, 1), np.uint32)
    r2 = np.empty((M, 1), np.uint32)
    for r_, i in enumerate(full):
        qneg[r_, 0], r2[r_, 0] = mm.mont_constants(ctx.moduli_host[i])
    rows = np.asarray(full)
    ninv_m = _mont(np.asarray(h.n_inv)[rows][:, None].astype(np.uint64), qs)
    zs = list(range(-(d // 2), d - d // 2))
    perms = np.stack([
        np.arange(N, dtype=np.int32) if z == 0 else
        automorph.eval_perm(N, automorph.galois_elt_rot(z, N)).astype(
            np.int32) for z in zs])
    Pprod = 1
    for i in range(params.num_main, params.num_total):
        Pprod *= ctx.moduli_host[i]
    p_raise = np.array([Pprod % ctx.moduli_host[i] for i in range(L + 1)],
                       dtype=np.uint64)[:, None]
    p_raise_m = _mont(p_raise, qs[: L + 1])

    pos = {g: i for i, g in enumerate(full)}

    def bc(own, gen):
        hat_inv, W, D_mod_t, inv_d = tools._bc_tables(own, gen)
        own_q = np.array([ctx.moduli_host[i] for i in own],
                         dtype=np.uint64)[:, None]
        gen_q = np.array([ctx.moduli_host[i] for i in gen],
                         dtype=np.uint64)[:, None]
        return dict(hat_inv_m=_mont(np.asarray(hat_inv, np.uint64), own_q),
                    W_m=_mont(np.asarray(W, np.uint64), gen_q)[:, :, None],
                    D_mod_m=_mont(np.asarray(D_mod_t, np.uint64), gen_q),
                    inv_d=np.asarray(inv_d, np.float64))

    digits = [dict(own_rows=np.array([pos[i] for i in own]),
                   gen_rows=np.array([pos[i] for i in gen]), **bc(own, gen))
              for own, gen, _ in tools.digit_bases(L)]
    spec = tuple(range(params.num_main, params.num_total))
    P_ext = spec + (L,)
    Q_out = tuple(range(L))
    qo_q = np.array([ctx.moduli_host[i] for i in Q_out],
                    dtype=np.uint64)[:, None]
    md = dict(drop_rows=np.array([pos[i] for i in P_ext]),
              out_rows=np.array([pos[i] for i in Q_out]),
              p_inv_m=_mont(np.asarray(tools._moddown_tables(P_ext, Q_out),
                                       np.uint64), qo_q),
              **bc(P_ext, Q_out))
    return DistTables(params, d, full, q32, qneg, r2,
                      np.asarray(h.psi_brv_mont)[rows],
                      np.asarray(h.psi_inv_brv_mont)[rows], ninv_m, perms,
                      p_raise_m, digits, md, ctb)


def _base_conv_mont(x, t, fp_dtype):
    """x: (..., |own|, N) coefficients, standard domain.  Returns (...,
    |gen|, N): the HPS BaseConv with the reference's float floor (in
    ``fp_dtype``, + 0.5e-6)."""
    q_own, q_gen = t["q_own"], t["q_gen"]          # (|own|,1), (|gen|,1)
    y = mm.montmul(x, t["hat_inv_m"], q_own, t["qneg_own"])
    v = torch.floor(torch.sum(y.to(fp_dtype) * t["inv_d"].to(fp_dtype),
                              dim=-2) + 0.5e-6).to(torch.int64)  # (..., N)
    prod = mm.montmul(y[..., None, :, :], t["W_m"], q_gen[..., None, :],
                      t["qneg_gen"][..., None, :])  # (..., |gen|, |own|, N)
    acc = mm.montsum(prod, q_gen, axis=-2)
    corr = mm.montmul(v[..., None, :], t["D_mod_m"], q_gen, t["qneg_gen"])
    return mm.montsub(acc, corr, q_gen)


def _mk_bc_tables(tabs: DistTables, spec: dict, device) -> dict:
    own = spec.get("own_rows", spec.get("drop_rows"))
    gen = spec.get("gen_rows", spec.get("out_rows"))
    return dict(
        hat_inv_m=_dev(spec["hat_inv_m"], device),
        W_m=_dev(spec["W_m"], device),
        D_mod_m=_dev(spec["D_mod_m"], device),
        inv_d=_dev(spec["inv_d"], device),
        q_own=_dev(tabs.q32[own], device), qneg_own=_dev(tabs.qneg[own], device),
        q_gen=_dev(tabs.q32[gen], device), qneg_gen=_dev(tabs.qneg[gen], device),
    )


def make_mo_hlt_fn(tabs: DistTables, rules=None, fp_dtype=torch.float32,
                   unroll: int = 1):
    """Returns fn(c0, c1, u_mont, rk0_mont, rk1_mont) -> (c0', c1').

    c0, c1: (CTB, L+1, N) u32 (int32 bits) std-domain eval.
    u_mont: (d, M, N); rk{0,1}_mont: (d, β, M, N) — Montgomery domain.
    Output: (CTB, L, N) ×2 (one level consumed — merged ModDown+Rescale),
    the reference's values bit for bit.  ``rules`` and ``unroll`` are the
    reference's GSPMD placement hints and its scan unrolling: eager torch
    has no counterpart, so every rank computes the same values (the
    distributed MO-HLT is ``schedule="sharded"``).  The tables go to the
    inputs' device."""
    p = tabs.params
    L, N, M = p.L, p.N, len(tabs.full)
    nb = len(tabs.digits)
    md = tabs.md

    def fn(c0, c1, u_mont, rk0_mont, rk1_mont):
        B, device = c0.shape[0], c0.device
        q32, qneg = _dev(tabs.q32, device), _dev(tabs.qneg, device)
        psi_m, psii_m = _dev(tabs.psi_m, device), _dev(tabs.psii_m, device)
        ninv_m = _dev(tabs.ninv_m, device)
        p_raise_m = _dev(tabs.p_raise_m, device)
        perms = torch.as_tensor(tabs.perms, dtype=torch.int64, device=device)
        dig_bc = [_mk_bc_tables(tabs, s, device) for s in tabs.digits]
        md_bc = _mk_bc_tables(tabs, md, device)
        p_inv_m = _dev(md["p_inv_m"], device)
        # ---- hoist: Decomp + ModUp ----
        digs = []
        for j, spec in enumerate(tabs.digits):
            own, gen = spec["own_rows"], spec["gen_rows"]
            dig_eval = c1[:, own[0]: own[-1] + 1]
            coeff = ntt.intt_mont_raw(dig_eval, psii_m[own], ninv_m[own],
                                      q32[own], qneg[own])
            ext = _base_conv_mont(coeff, dig_bc[j], fp_dtype)
            ext_eval = ntt.ntt_mont_raw(ext, psi_m[gen], q32[gen], qneg[gen])
            x = torch.zeros((B, M, N), dtype=torch.int32, device=c1.device)
            x[:, own] = dig_eval
            x[:, gen] = ext_eval
            digs.append(x)
        digits = torch.stack(digs, dim=1)                   # (CTB, β, M, N)
        zeros_sp = torch.zeros((B, p.k, N), dtype=torch.int32,
                               device=c0.device)
        c0e = torch.cat([mm.montmul(c0, p_raise_m, q32[: L + 1],
                                    qneg[: L + 1]), zeros_sp], dim=1)
        c1e = torch.cat([mm.montmul(c1, p_raise_m, q32[: L + 1],
                                    qneg[: L + 1]), zeros_sp], dim=1)

        # ---- rotation loop (Automorph → KeyIP → DiagIP, limb-local) ----
        a0 = torch.zeros((B, M, N), dtype=torch.int32, device=c0.device)
        a1 = torch.zeros_like(a0)
        for t in range(tabs.d):
            pm = perms[t]
            dig_rot = digits[..., pm]
            c0r = c0e[..., pm]
            k0 = torch.zeros_like(a0)
            k1 = torch.zeros_like(a1)
            for j in range(nb):
                k0 = mm.montadd(k0, mm.montmul(dig_rot[:, j], rk0_mont[t, j],
                                               q32, qneg), q32)
                k1 = mm.montadd(k1, mm.montmul(dig_rot[:, j], rk1_mont[t, j],
                                               q32, qneg), q32)
            is_id = t == tabs.d // 2        # z = 0 bypasses KeyIP
            t0 = c0e if is_id else mm.montadd(k0, c0r, q32)
            t1 = c1e if is_id else k1
            a0 = mm.montadd(a0, mm.montmul(u_mont[t], t0, q32, qneg), q32)
            a1 = mm.montadd(a1, mm.montmul(u_mont[t], t1, q32, qneg), q32)

        # ---- merged ModDown+Rescale ----
        def mod_down(acc):
            drop, out = md["drop_rows"], md["out_rows"]
            xp = ntt.intt_mont_raw(acc[:, drop], psii_m[drop], ninv_m[drop],
                                   q32[drop], qneg[drop])
            conv = _base_conv_mont(xp, md_bc, fp_dtype)
            conv_eval = ntt.ntt_mont_raw(conv, psi_m[out], q32[out],
                                         qneg[out])
            diff = mm.montsub(acc[:, out], conv_eval, q32[out])
            return mm.montmul(diff, p_inv_m, q32[out], qneg[out])

        return mod_down(a0), mod_down(a1)

    return fn


@dataclasses.dataclass
class ShardTables:
    """Constant tables of the limb-sharded MO-HLT at one (params, level,
    n_model) compile point, numpy on the host, over the padded extended
    basis.  Padding rows carry valid moduli (copies of the last row) and
    all-zero operands, so every stage maps them zero -> zero."""
    params: HEParams
    level: int
    n_model: int
    full: tuple                    # prime indices [Q_level..., P...], len M
    M: int
    M_pad: int
    rows_loc: int                  # M_pad // n_model (rows a model rank)
    # replicated main-basis tables (the hoist's iNTT; own rows are main)
    q_main: np.ndarray             # (level+1, 1) u32
    qneg_main: np.ndarray          # (level+1, 1)
    psii_main: np.ndarray          # (level+1, N) mont
    ninv_main: np.ndarray          # (level+1, 1) mont
    # per-row tables over the padded extended basis
    q32: np.ndarray                # (M_pad, 1)
    qneg: np.ndarray               # (M_pad, 1)
    psi_m: np.ndarray              # (M_pad, N) mont twiddles
    psii_m: np.ndarray             # (M_pad, N)
    ninv_m: np.ndarray             # (M_pad, 1) mont
    p_raise_m: np.ndarray          # (M_pad, 1) [P]_{q_i} mont; 0 off-main
    digits: list                   # per digit: dict(sl, hat_inv_m, inv_d,
    #                                W_full, D_full, own_mask)
    md: dict                       # merged ModDown+Rescale tables


def build_shard_tables(params: HEParams, level: int,
                       n_model: int) -> ShardTables:
    """Tables for ``make_sharded_hlt_fn`` — pure and deterministic.  The
    digit and ModDown BaseConv tables are expressed over the full padded
    row axis (zero off their target rows), so a rank's row block is a
    plain slice."""
    ctx = get_context(params)
    h = ctx.host
    tools = RnsTools(ctx)
    n_model = max(1, int(n_model))
    bases = tools.digit_bases(level)
    full = bases[0][2]
    M = len(full)
    rows_loc = -(-M // n_model)
    M_pad = rows_loc * n_model
    pos = {g: i for i, g in enumerate(full)}

    def pad_rows(x: np.ndarray, copy_last: bool = False) -> np.ndarray:
        if M_pad == M:
            return x
        pad = (np.repeat(x[-1:], M_pad - M, axis=0) if copy_last else
               np.zeros((M_pad - M,) + x.shape[1:], x.dtype))
        return np.concatenate([x, pad], axis=0)

    rows = np.asarray(full)
    qs = np.array([ctx.moduli_host[i] for i in full], np.uint64)[:, None]
    q32 = qs.astype(np.uint32)
    qneg = np.empty((M, 1), np.uint32)
    for r_, i in enumerate(full):
        qneg[r_, 0], _ = mm.mont_constants(ctx.moduli_host[i])
    ninv_m = _mont(np.asarray(h.n_inv)[rows][:, None].astype(np.uint64), qs)

    nq = level + 1
    Pprod = 1
    for i in range(params.num_main, params.num_total):
        Pprod *= ctx.moduli_host[i]
    p_raise = np.zeros((M, 1), np.uint64)
    p_raise[:nq, 0] = [Pprod % ctx.moduli_host[i] for i in range(nq)]
    p_raise_m = _mont(p_raise, qs)

    digits = []
    for own, gen, _ in bases:
        hat_inv, W, D_mod_t, inv_d = tools._bc_tables(own, gen)
        own_q = np.array([ctx.moduli_host[i] for i in own], np.uint64)[:, None]
        na = len(own)
        W_full = np.zeros((M, na), np.uint64)
        D_full = np.zeros((M, 1), np.uint64)
        gen_rows = np.array([pos[i] for i in gen])
        W_full[gen_rows] = np.asarray(W, np.uint64)        # W is (|gen|, |own|)
        D_full[gen_rows] = np.asarray(D_mod_t, np.uint64)
        own_mask = np.zeros((M, 1), bool)
        own_mask[[pos[i] for i in own]] = True
        digits.append(dict(
            sl=(pos[own[0]], pos[own[-1]] + 1),            # contiguous main rows
            hat_inv_m=_mont(np.asarray(hat_inv, np.uint64), own_q),
            inv_d=np.asarray(inv_d, np.float64),
            W_full=pad_rows(_mont(W_full, qs)),
            D_full=pad_rows(_mont(D_full, qs)),
            own_mask=pad_rows(own_mask),
        ))

    # merged ModDown+Rescale: drop the specials and q_level, in the
    # one-device order (P_ext = specials, then q_level): the float64
    # overflow count sums the rows in exactly this order
    spec = tuple(range(params.num_main, params.num_total))
    P_ext = spec + (level,)
    Q_out = tuple(range(level))
    hat_inv, W, D_mod_t, inv_d = tools._bc_tables(P_ext, Q_out)
    p_inv = tools._moddown_tables(P_ext, Q_out)
    drop_rows = np.array([pos[i] for i in P_ext])
    nd = len(P_ext)
    hat_full = np.zeros((M, 1), np.uint64)
    hat_full[drop_rows] = np.asarray(hat_inv, np.uint64)
    sel_drop = np.zeros((nd, M_pad), np.uint32)
    sel_drop[np.arange(nd), drop_rows] = 1
    W_full = np.zeros((M, nd), np.uint64)
    D_full = np.zeros((M, 1), np.uint64)
    pinv_full = np.zeros((M, 1), np.uint64)
    out_rows = np.array([pos[i] for i in Q_out])
    W_full[out_rows] = np.asarray(W, np.uint64)            # (|Q_out|, |P_ext|)
    D_full[out_rows] = np.asarray(D_mod_t, np.uint64)
    pinv_full[out_rows] = np.asarray(p_inv, np.uint64)
    md = dict(
        n_drop=nd,
        hat_inv_full=pad_rows(_mont(hat_full, qs)),
        sel_drop=sel_drop,
        inv_d=np.asarray(inv_d, np.float64),
        W_full=pad_rows(_mont(W_full, qs)),
        D_full=pad_rows(_mont(D_full, qs)),
        p_inv_full=pad_rows(_mont(pinv_full, qs)),
    )
    return ShardTables(
        params=params, level=level, n_model=n_model, full=full, M=M,
        M_pad=M_pad, rows_loc=rows_loc,
        q_main=q32[:nq], qneg_main=qneg[:nq],
        psii_main=np.asarray(h.psi_inv_brv_mont)[rows[:nq]],
        ninv_m=pad_rows(ninv_m, True), ninv_main=ninv_m[:nq],
        q32=pad_rows(q32, True), qneg=pad_rows(qneg, True),
        psi_m=pad_rows(np.asarray(h.psi_brv_mont)[rows], True),
        psii_m=pad_rows(np.asarray(h.psi_inv_brv_mont)[rows], True),
        p_raise_m=pad_rows(p_raise_m),
        digits=digits, md=md)


#: table keys whose leading axis is the digit index (limb rows on axis 1)
_STACKED_TAB_KEYS = ("w_stack", "d_stack", "mask_stack")


def shard_operand_arrays(tabs: ShardTables) -> dict:
    """The limb-sharded tables of the program, numpy over the whole padded
    row axis (a rank takes its row block: ``rank_tables``).
    ``w_stack`` / ``d_stack`` / ``mask_stack`` are the per-digit BaseConv
    tables stacked on a leading digit axis (columns zero-padded to the
    common ``alpha``), the layout of ``baseconv_ntt``; the per-digit
    ``W{j}`` / ``D{j}`` / ``mask{j}`` serve the plain-torch stages."""
    alpha = max(dg["W_full"].shape[1] for dg in tabs.digits)
    out = dict(
        q32=tabs.q32, qneg=tabs.qneg, psi_m=tabs.psi_m, psii_m=tabs.psii_m,
        ninv_m=tabs.ninv_m, p_raise_m=tabs.p_raise_m,
        md_hat_inv=tabs.md["hat_inv_full"], md_W=tabs.md["W_full"],
        md_D=tabs.md["D_full"], md_p_inv=tabs.md["p_inv_full"],
        sel_drop=tabs.md["sel_drop"],
        w_stack=np.stack([
            np.pad(dg["W_full"], ((0, 0), (0, alpha - dg["W_full"].shape[1])))
            for dg in tabs.digits]),
        d_stack=np.stack([dg["D_full"] for dg in tabs.digits]),
        mask_stack=np.stack([dg["own_mask"].astype(np.uint32)
                             for dg in tabs.digits]),
    )
    for j, dg in enumerate(tabs.digits):
        out[f"W{j}"] = dg["W_full"]
        out[f"D{j}"] = dg["D_full"]
        out[f"mask{j}"] = dg["own_mask"]
    return out


def _dev(a: np.ndarray, device) -> torch.Tensor:
    """numpy -> a contiguous tensor on ``device``: uint32 as int32 bits,
    float64 and int64 as they are, bool as bool."""
    if a.dtype == np.uint32:
        return u32_tensor(a, device)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def rank_tables(tabs: ShardTables, model_rank: int, device) -> dict:
    """Model rank ``model_rank``'s row block of ``shard_operand_arrays``
    and the replicated tables, as tensors on ``device``.  The merged
    ModDown's drop-row selection becomes two index vectors: the rank's
    local rows that hold drop rows (``drop_src``) and their positions in
    the drop basis (``drop_dst``)."""
    arrs = shard_operand_arrays(tabs)
    lo = model_rank * tabs.rows_loc
    hi = lo + tabs.rows_loc
    t = {}
    for k, v in arrs.items():
        if k == "sel_drop":
            continue
        t[k] = _dev(v[:, lo:hi] if k in _STACKED_TAB_KEYS else v[lo:hi],
                    device)
    dst, src = np.nonzero(arrs["sel_drop"][:, lo:hi])
    t["drop_src"] = torch.as_tensor(src, dtype=torch.int64, device=device)
    t["drop_dst"] = torch.as_tensor(dst, dtype=torch.int64, device=device)
    for k in ("q_main", "qneg_main", "psii_main", "ninv_main"):
        t[k] = _dev(getattr(tabs, k), device)
    t["dig_hat"] = [_dev(dg["hat_inv_m"], device) for dg in tabs.digits]
    t["dig_invd"] = [_dev(dg["inv_d"], device) for dg in tabs.digits]
    t["md_invd"] = _dev(tabs.md["inv_d"], device)
    t.update(_hoist_tables(tabs, device))
    return t


def _hoist_tables(tabs: ShardTables, device) -> dict:
    """The replicated digit-padded tables of the fused hoist's first stage
    (``intt_scale`` over the main rows: digit j at rows j·alpha..; padded
    rows carry zero twiddles and scales and map zero -> zero)."""
    N = tabs.params.N
    dig_sl = [dg["sl"] for dg in tabs.digits]
    nbeta = len(dig_sl)
    alpha = max(e - s for s, e in dig_sl)
    R = nbeta * alpha
    h_psii = np.zeros((R, N), np.uint32)
    h_ninv = np.zeros((R, 1), np.uint32)
    h_hat = np.zeros((R, 1), np.uint32)
    h_q = np.full((R, 1), tabs.q_main[0, 0], np.uint32)
    h_qneg = np.full((R, 1), tabs.qneg_main[0, 0], np.uint32)
    h_invd = np.zeros((nbeta, alpha, 1), np.float64)
    for j, (s, e) in enumerate(dig_sl):
        rows = slice(j * alpha, j * alpha + e - s)
        h_psii[rows] = tabs.psii_main[s:e]
        h_ninv[rows] = tabs.ninv_main[s:e]
        h_q[rows] = tabs.q_main[s:e]
        h_qneg[rows] = tabs.qneg_main[s:e]
        h_hat[rows] = tabs.digits[j]["hat_inv_m"]
        h_invd[j, :e - s] = tabs.digits[j]["inv_d"]
    return {k: _dev(v, device) for k, v in dict(
        h_psii=h_psii, h_ninv=h_ninv, h_hat=h_hat, h_q=h_q, h_qneg=h_qneg,
        h_invd=h_invd).items()}


def build_slot_tables(diag_slots, ct_slots, b_pad: int,
                      device="cpu") -> dict:
    """The batch index -> slot maps padded to the ct-axis multiple
    ``b_pad``: ``diag`` (unique diagonal set of each element) and ``ct``
    (the compile-time aliasing hint of unique input ciphertexts, or None
    when there is none).  Padding elements point at slot 0; their outputs
    are computed and dropped.  int32 tensors on ``device``."""
    B = len(diag_slots)
    if b_pad < B:
        raise ValueError(f"b_pad {b_pad} < batch {B}")
    pad = [0] * (b_pad - B)
    out = dict(diag=torch.tensor(list(diag_slots) + pad, dtype=torch.int32,
                                 device=device))
    if ct_slots is None:
        out["ct"] = None
    else:
        if len(ct_slots) != B:
            raise ValueError(f"{len(ct_slots)} ct slots for {B} elements")
        out["ct"] = torch.tensor(list(ct_slots) + pad, dtype=torch.int32,
                                 device=device)
    return out


def expected_collectives(tabs: ShardTables) -> dict:
    """The sharded program's collective contract, read by the verifier's
    census (``analysis/census.py``, JX001): the merged ModDown+Rescale
    BaseConv reduction is the only collective — one all-reduce (the
    reference's ``psum``) an output polynomial when the limb axis is
    really sharded, none when n_model == 1 — and nothing else."""
    return {"psum": 2 if tabs.n_model > 1 else 0}


def _physical_axes(rules, logical: str) -> tuple:
    """Mesh axis names a logical axis maps to (empty without a mesh)."""
    if rules is None or rules.mesh is None:
        return ()
    axes = rules.rules.get(logical) or ()
    return tuple(a for a in axes if a in rules.mesh.shape)


def _baseconv_rows(y, W, D, inv_d, q, qn):
    """y (B, S, N) scaled coefficients of S source rows -> (B, rows, N),
    their HPS BaseConv onto this rank's rows (W (rows, S) and D (rows, 1)
    are zero off the target rows).  One source row at a time: the modular
    sum is exact in any order."""
    v = basechange._floor_count(y, inv_d)        # float64, +0.5e-6: (B, N)
    acc = None
    for s in range(y.shape[1]):
        term = mm.montmul(y[:, s, None, :], W[None, :, s, None], q, qn)
        acc = term if acc is None else mm.montadd(acc, term, q)
    corr = mm.montmul(v[:, None, :], D, q, qn)
    return mm.montsub(acc, corr, q)


def _steps(n: int):
    """(start, end) of consecutive steps of ``PLAIN_CHUNK`` over n."""
    return [(s, min(n, s + PLAIN_CHUNK)) for s in range(0, n, PLAIN_CHUNK)]


def make_sharded_hlt_fn(tabs: ShardTables, rules, t: dict, *, d_pad: int,
                        nbeta: int, datapath: str = "pallas",
                        chunk: Optional[int] = None,
                        hoist_layout: str = "dedup", stages: str = "pallas"):
    """The ``schedule="sharded"`` body of one rank at one compile point.

    ``rules`` carries the mesh (``distributed/sharding.py``; None or a
    meshless rules object: one rank, no collective); ``t`` is the rank's
    ``rank_tables``.  Returns ``body(args) -> (out0, out1)``, the rank's
    (B_loc, rows_loc, N) blocks of both output polynomials after the
    merged ModDown+Rescale (real rows: 0 .. level-1 of the gathered basis).

    ``datapath="pallas"``: ``args`` holds the rank's hoist inputs
    ``c0u``, ``c1u`` (H, rows_loc, N; its rows of the zero-extended
    ciphertexts) and ``c1rep`` (H, level+1, N; the main rows, replicated
    over the limb ranks), ``ct_slots`` / ``slots`` (B_loc,) its elements'
    hoist and diagonal slots, and the operands ``u`` (S, d_pad, rows_loc,
    N), ``rk0`` / ``rk1`` (S, d_pad, β, rows_loc, N), ``perms`` (S, d_pad,
    N), ``is_id`` (S, d_pad, 1).  ``hoist_layout="dedup"``: H unique
    ciphertexts, global slots; ``"element"``: the rank's B_loc elements,
    local slots.  ``chunk`` is the reference's per-rank rotation chunk: a
    divisor of d_pad that the CUDA kernel does not need (it loops over
    every rotation), checked and kept for the plan.

    ``datapath="xla"`` (``schedule="sharded_xla"``): ``args`` holds
    per-element ``c0f``, ``c1f`` (B_loc, rows_loc, N), ``c1rep`` (B_loc,
    level+1, N) and ``slots``; every element re-hoists and the rotation
    loop is plain torch."""
    if datapath not in ("pallas", "xla"):
        raise ValueError(f"datapath={datapath!r}")
    if stages not in ("pallas", "xla"):
        raise ValueError(f"stages={stages!r}")
    if hoist_layout not in ("dedup", "element"):
        raise ValueError(f"hoist_layout={hoist_layout!r}")
    kchunk = d_pad if chunk is None else max(1, min(int(chunk), d_pad))
    if d_pad % kchunk:
        raise ValueError(f"chunk {kchunk} does not divide d_pad {d_pad}")
    limb_axes = _physical_axes(rules, "limbs") if tabs.n_model > 1 else ()
    group = rules.mesh.group(limb_axes) if limb_axes else None
    q, qn = t["q32"], t["qneg"]
    nd = tabs.md["n_drop"]
    dig_sl = [dg["sl"] for dg in tabs.digits]
    nq = tabs.level + 1
    R = t["h_psii"].shape[0]

    def scatter_reduce(y):
        """y (P, rows_loc, N), zero off the drop rows -> (P, nd, N): each
        drop row at its place, summed over the limb ranks.  One all-reduce
        for each output polynomial (the halves of P)."""
        P = y.shape[0]
        part = torch.zeros((P, nd, y.shape[-1]), dtype=torch.int32,
                           device=y.device)
        part[:, t["drop_dst"]] = y[:, t["drop_src"]]
        if group is not None:
            for half in (part[:P // 2], part[P // 2:]):
                collectives.all_reduce_sum(half, group)
        return part

    def hoist_local(c1rep, c1f):
        """Decomp + ModUp of each element in plain torch, collective-free
        off the replicated main rows; own rows from the rank's ``c1f``."""
        digs = []
        for j, (s, e) in enumerate(dig_sl):
            coeff = ntt.intt_mont(c1rep[:, s:e], t["psii_main"][s:e],
                                  t["ninv_main"][s:e], t["q_main"][s:e],
                                  t["qneg_main"][s:e])
            y = mm.montmul(coeff, t["dig_hat"][j], t["q_main"][s:e],
                           t["qneg_main"][s:e])
            ext = _baseconv_rows(y, t[f"W{j}"], t[f"D{j}"], t["dig_invd"][j],
                                 q, qn)
            ext_eval = ntt.ntt_mont(ext, t["psi_m"], q, qn)
            digs.append(torch.where(t[f"mask{j}"], c1f, ext_eval))
        return torch.stack(digs, dim=1)

    def hoist_fused(c1rep, c1f):
        """The hoist on the kernels: ``intt_scale`` over every hoist
        input's digit-padded main rows (one launch), then ``baseconv_ntt``
        onto the rank's rows, own rows passed through from ``c1f``."""
        y = ops.intt_scale(F.pad(c1rep, (0, 0, 0, R - nq)), t["h_psii"],
                           t["h_ninv"], t["h_hat"], t["h_q"], t["h_qneg"])
        return torch.stack([
            ops.baseconv_ntt(y[i], t["w_stack"], t["d_stack"], t["h_invd"],
                             t["psi_m"], q, qn, c1f[i], t["mask_stack"])
            for i in range(y.shape[0])])

    def mod_down_plain(acc):
        """Merged ModDown+Rescale of (P, rows_loc, N) in plain torch,
        ``PLAIN_CHUNK`` polynomials a step around the one reduction."""
        P = acc.shape[0]
        y = torch.empty_like(acc)
        for s, e in _steps(P):
            xp = ntt.intt_mont(acc[s:e], t["psii_m"], t["ninv_m"], q, qn)
            y[s:e] = mm.montmul(xp, t["md_hat_inv"], q, qn)  # 0 off drop rows
        y_drop = scatter_reduce(y)
        out = torch.empty_like(acc)
        for s, e in _steps(P):
            conv = _baseconv_rows(y_drop[s:e], t["md_W"], t["md_D"],
                                  t["md_invd"], q, qn)
            conv_eval = ntt.ntt_mont(conv, t["psi_m"], q, qn)
            out[s:e] = mm.montmul(mm.montsub(acc[s:e], conv_eval, q),
                                  t["md_p_inv"], q, qn)
        return out

    def mod_down_fused(acc):
        """Merged ModDown+Rescale on the kernels: ``intt_scale`` of the
        rank's rows (zero off the drop rows), the scatter and the
        all-reduce, then ``moddown_finish`` on the rank's rows."""
        y = ops.intt_scale(acc, t["psii_m"], t["ninv_m"], t["md_hat_inv"], q,
                           qn)
        return ops.moddown_finish(acc, scatter_reduce(y), t["md_W"],
                                  t["md_D"], t["md_invd"], t["psi_m"],
                                  t["md_p_inv"], q, qn)

    fused = datapath == "pallas" and stages == "pallas"
    hoist = hoist_fused if fused else hoist_local
    mod_down = mod_down_fused if fused else mod_down_plain

    def body_pallas(a):
        digits = hoist(a["c1rep"], a["c1u"])
        c0e = mm.montmul(a["c0u"], t["p_raise_m"], q, qn)
        c1e = mm.montmul(a["c1u"], t["p_raise_m"], q, qn)
        acc = ops.fused_hlt_indexed(digits, c0e, c1e, a["u"], a["rk0"],
                                    a["rk1"], a["perms"], a["is_id"],
                                    a["ct_slots"], a["slots"], q, qn)
        out = mod_down(acc.flatten(0, 1))               # (2·B_loc, rows, N)
        B = acc.shape[1]
        return out[:B], out[B:]

    def body_xla(a):
        B = a["c0f"].shape[0]
        acc = torch.empty((2,) + tuple(a["c0f"].shape), dtype=torch.int32,
                          device=a["c0f"].device)
        for s, e in _steps(B):
            acc[0, s:e], acc[1, s:e] = rotations_xla(
                a, s, e, hoist_local(a["c1rep"][s:e], a["c1f"][s:e]))
        out = mod_down_plain(acc.flatten(0, 1))
        return out[:B], out[B:]

    def rotations_xla(a, s, e, digits):
        """The rotation loop of elements s..e-1 in plain torch."""
        c0e = mm.montmul(a["c0f"][s:e], t["p_raise_m"], q, qn)
        c1e = mm.montmul(a["c1f"][s:e], t["p_raise_m"], q, qn)
        slots = a["slots"][s:e].long()
        acc0 = torch.zeros_like(c0e)
        acc1 = torch.zeros_like(c0e)
        for ti in hlo_cost.loop(d_pad, "rotations"):
            pm = a["perms"][slots, ti].long()           # (B, N)
            dig_rot = torch.gather(digits, -1,
                                   pm[:, None, None, :].expand_as(digits))
            c0r = torch.gather(c0e, -1, pm[:, None, :].expand_as(c0e))
            k0w, k1w = a["rk0"][slots, ti], a["rk1"][slots, ti]
            k0 = k1 = None
            for j in range(nbeta):
                p0 = mm.montmul(dig_rot[:, j], k0w[:, j], q, qn)
                p1 = mm.montmul(dig_rot[:, j], k1w[:, j], q, qn)
                k0 = p0 if k0 is None else mm.montadd(k0, p0, q)
                k1 = p1 if k1 is None else mm.montadd(k1, p1, q)
            sel = a["is_id"][slots, ti].bool()[:, :, None]   # (B, 1, 1)
            t0 = torch.where(sel, c0e, mm.montadd(k0, c0r, q))
            t1 = torch.where(sel, c1e, k1)
            u_t = a["u"][slots, ti]
            acc0 = mm.montadd(acc0, mm.montmul(u_t, t0, q, qn), q)
            acc1 = mm.montadd(acc1, mm.montmul(u_t, t1, q, qn), q)
        return acc0, acc1

    return body_pallas if datapath == "pallas" else body_xla


@dataclasses.dataclass
class MoHltShare:
    """One rank's share of the limb-sharded MO-HLT (``lower_mo_hlt_spmd``):
    ``share()`` runs ``fn(args)``, the rank's (B_loc, rows_loc, N) blocks
    of both output polynomials; ``unroll`` as the caller asked."""
    fn: object
    args: dict
    unroll: int

    def __call__(self):
        return self.fn(self.args)


def lower_mo_hlt_spmd(params: HEParams, mesh, rules, d: int = 127,
                      ctb: Optional[int] = None, unroll: int = 1,
                      device="cuda") -> MoHltShare:
    """What the dry-run prices in place of the reference's lowered GSPMD
    prototype: this rank's share of the limb-partitioned MO-HLT, one
    DiagSet of ``d`` rotations applied to ``ctb`` ciphertexts (default:
    the ct ranks, pod × data, one a rank) at level L, as
    ``make_sharded_hlt_fn`` runs it on the ``"sharded_xla"`` datapath
    (plain torch: the reference prices XLA's partitioning of its plain
    prototype, not a Pallas kernel).  The tables are
    ``build_shard_tables`` over the mesh's model ranks, this rank's rows;
    the arguments are fresh tensors of the rank's shapes on ``device``
    with no meaningful values (the dry-run makes them under
    ``FakeTensorMode``: nothing is allocated).  ``unroll`` has no eager
    meaning; it is kept in the record."""
    limb = _physical_axes(rules, "limbs")
    ct = _physical_axes(rules, "ct_batch")
    n_model, n_ct = mesh.size(limb), mesh.size(ct)
    ctb = n_ct if ctb is None else int(ctb)
    tabs = build_shard_tables(params, params.L, n_model)
    t = rank_tables(tabs, mesh.index(limb), device)
    nbeta = len(tabs.digits)
    b_loc = -(-ctb // n_ct)
    N, rows, i32 = params.N, tabs.rows_loc, torch.int32

    def empty(*shape):
        return torch.empty(shape, dtype=i32, device=device)

    args = dict(c0f=empty(b_loc, rows, N), c1f=empty(b_loc, rows, N),
                c1rep=empty(b_loc, params.L + 1, N),
                slots=torch.zeros(b_loc, dtype=i32, device=device),
                u=empty(1, d, rows, N), rk0=empty(1, d, nbeta, rows, N),
                rk1=empty(1, d, nbeta, rows, N),
                perms=torch.zeros((1, d, N), dtype=i32, device=device),
                is_id=torch.zeros((1, d, 1), dtype=i32, device=device))
    fn = make_sharded_hlt_fn(tabs, rules, t, d_pad=d, nbeta=nbeta,
                             datapath="xla")
    return MoHltShare(fn, args, unroll)
