"""Fused base-change stages: the hoist and the merged ModDown+Rescale.

Counterpart of ``repro/kernels/basechange.py``.  Four functions, each with
a plain PyTorch version (int64 arithmetic, used for CPU tensors and as the
on-card reference) and a CUDA kernel wrapper (``csrc/intt_scale.cu``,
``csrc/hoist.cu``, ``csrc/moddown.cu``; one launch counter each):

* ``intt_scale``     — per-row iNTT, then montmul by a per-row scale.
* ``baseconv_ntt``   — the single hoist's second half, with the
  reference's operands: HPS BaseConv of each digit's (zero-padded) scaled
  rows → NTT, own rows taken from a passthrough.
* ``hoist_db``       — the batched hoist: iNTT·q̂⁻¹ of every digit row →
  HPS BaseConv (float64 floor correction) → NTT, own rows passed through.
  The TPU kernel double-buffers its copy-in because its grid runs in
  order; on the GPU many blocks in flight hide the copy, so the CUDA form
  is two launches (the ``intt_scale`` kernel over all B·nq limb rows,
  then a BaseConv+NTT+passthrough kernel over (B, β, M) rows) that
  together compute the same function.  Both read the ciphertexts' c1 rows
  in place: digit j's rows are c1 rows j·α.., and the TPU's zero-padded
  operand layout is not rebuilt.
* ``moddown_finish`` — BaseConv from the nd drop-basis rows → NTT →
  (x − conv)·P⁻¹, over a leading batch of polynomials in one launch.

Every kernel splits each row over a thread-block cluster of
``kernels/ntt.py`` ``cluster_size`` blocks, as ``ntt`` does: the inverse
ones (``intt_scale``) on ``common.cuh`` ``split_inv_row`` with the N⁻¹
and the scale folded into one per-row constant, the forward ones on
``split_fwd_row`` with the BaseConv computed into its cross stages, in
the order of the ``*_split_plain`` functions (tests only).  So every ring
up to ``SPLIT_MAX_LOGN`` fits.  The merged ModDown's ``intt_scale``
launch reads its drop rows in place through a row table
(``intt_scale_rows_cuda``).

The BaseConv floor correction is ``floor(Σ y_i·inv_d_i + 0.5e-6)`` in
float64 everywhere: the reference is bit-exact in f64 (its CPU backend),
and an f32 correction would silently lose that.  Table layouts are the
reference's, digit-padded to ``alpha`` rows (padded rows carry zero
``hat``/``inv_d``/``w`` and contribute exactly zero).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.core import modmath as mm
from repro_torch.core import ntt as core_ntt
from repro_torch.kernels import build

#: floor-correction epsilon of the fused HPS BaseConv (the reference's)
CORRECTION_EPS = 0.5e-6

#: largest ring of the kernels: a 2^16 row over 8 blocks is 32 KiB of
#: values a block (2^17 would need chunks above the 2^13 a block takes)
SPLIT_MAX_LOGN = 16


# ---------------------------------------------------------------------------
# plain versions (int64 PyTorch; any device)
# ---------------------------------------------------------------------------


def _floor_count(y, inv_d):
    """v = floor(Σ_i y_i·inv_d_i + eps), float64, ascending i.
    y: (..., n, N); inv_d: (n, 1) float64.  Returns (..., N) int64."""
    s = y[..., 0, :].to(torch.float64) * inv_d[0]
    for i in range(1, y.shape[-2]):
        s = s + y[..., i, :].to(torch.float64) * inv_d[i]
    return torch.floor(s + CORRECTION_EPS).to(torch.int64)


def _conv(y, w, d, inv_d, q32, qneg):
    """y: (c, n, K) scaled coefficients of n source rows at any K
    positions; w: (R, n); d: (R, 1); inv_d: (n, 1).  Returns the (c, R, K)
    HPS BaseConv onto the R target rows, coefficient domain."""
    v = _floor_count(y, inv_d)                                    # (c, K)
    prod = mm.montmul(y[:, None], w[None, :, :, None], q32[..., None],
                      qneg[..., None])                            # (c, R, n, K)
    acc = mm.montsum(prod, q32, axis=2)
    return mm.montsub(acc, mm.montmul(v[:, None], d, q32, qneg), q32)


def _conv_split(y, w, d, inv_d, q32, qneg, C: int):
    """``_conv`` at every position, in the kernels' order over a cluster
    of C blocks: block k of a row's cluster computes the positions j =
    a·n + k·R' + u (a < C, u < R' = n/C, n = N/C), its r-slice."""
    from repro_torch.kernels import ntt as kntt
    c, nd, N = y.shape
    R = w.shape[0]
    kntt._split_dims(N, C)
    r_blk = N // C // C
    yv = y.reshape(c, nd, C, C, r_blk)                            # [a, k, u]
    conv = torch.empty((c, R, C, C, r_blk), dtype=torch.int32,
                       device=y.device)
    for k in range(C):                        # block k's slice, every a
        ys = yv[:, :, :, k].reshape(c, nd, C * r_blk)
        conv[:, :, :, k] = _conv(ys, w, d, inv_d, q32, qneg
                                 ).reshape(c, R, C, r_blk)
    return conv.reshape(c, R, N)


def intt_scale_plain(x, psii_m, ninv_m, scale_m, q32, qneg):
    """x: (..., R, N) eval domain; tables (R, N) / (R, 1).  Returns the
    (..., R, N) coefficient-domain rows times their Montgomery scale."""
    coeff = core_ntt.intt_mont_raw(x, psii_m, ninv_m, q32, qneg)
    return mm.montmul(coeff, scale_m, q32, qneg)


def intt_scale_split_plain(x, psii_m, ninv_m, scale_m, q32, qneg, C: int,
                           rows=None):
    """``intt_scale`` in the order of its kernel over a cluster of C blocks
    (tests only): ``intt_split_plain`` with the epilogue's one product by
    the folded constant montmul(N⁻¹, scale).  ``rows``: the kernel's row
    table, output row r reading input row rows[r] of x (..., *, N)."""
    from repro_torch.kernels import ntt as kntt
    if rows is not None:
        x = x[..., rows, :]
    return kntt.intt_split_plain(x, psii_m, mm.montmul(ninv_m, scale_m, q32,
                                                        qneg), q32, qneg, C)


def _baseconv_ntt_plain(y, w, d, inv_d, psi_m, q32, qneg):
    """y: (B, alpha, N) one digit's scaled rows; w: (M, alpha); d: (M, 1);
    inv_d: (alpha, 1).  Returns the (B, M, N) eval-domain BaseConv."""
    return core_ntt.ntt_mont_raw(_conv(y, w, d, inv_d, q32, qneg), psi_m, q32,
                                 qneg)


def _baseconv_ntt_split_plain(y, w, d, inv_d, psi_m, q32, qneg, C: int):
    """``_baseconv_ntt_plain`` in the order of ``csrc/hoist.cu``: the
    BaseConv per block r-slice, then ``ntt_split_plain``."""
    from repro_torch.kernels import ntt as kntt
    return kntt.ntt_split_plain(_conv_split(y, w, d, inv_d, q32, qneg, C),
                                psi_m, q32, qneg, C)


def _baseconv_ntt(y, w, d, inv_d, psi_m, q32, qneg, passthrough, mask,
                  transform):
    nbeta, _, alpha = w.shape
    outs = []
    for j in range(nbeta):
        res = transform(y[None, j * alpha:(j + 1) * alpha], w[j], d[j],
                        inv_d[j], psi_m, q32, qneg)[0]
        outs.append(torch.where(mask[j] != 0, passthrough, res))
    return torch.stack(outs)


def baseconv_ntt_plain(y, w, d, inv_d, psi_m, q32, qneg, passthrough, mask):
    """y: (nbeta·alpha, N) scaled digit rows (digit j at rows j·alpha..);
    w: (nbeta, M, alpha); d/mask: (nbeta, M, 1); inv_d: (nbeta, alpha, 1)
    float64; psi_m: (M, N); q32/qneg: (M, 1); passthrough: (M, N).
    Returns (nbeta, M, N): where mask != 0 the passthrough row, else the
    eval-domain BaseConv."""
    return _baseconv_ntt(y, w, d, inv_d, psi_m, q32, qneg, passthrough, mask,
                         _baseconv_ntt_plain)


def baseconv_ntt_split_plain(y, w, d, inv_d, psi_m, q32, qneg, passthrough,
                             mask, C: int):
    """``baseconv_ntt`` in the order of its kernel over a cluster of C
    blocks (tests only): per digit and target limb the BaseConv per block
    r-slice, then ``ntt_split_plain``; own limbs from the passthrough."""
    return _baseconv_ntt(y, w, d, inv_d, psi_m, q32, qneg, passthrough, mask,
                         functools.partial(_baseconv_ntt_split_plain, C=C))


def _hoist_db(c1s, psii_m, ninv_m, hat_m, q_pad, qneg_pad, w, d, inv_d,
              psi_m, q_full, qneg_full, mask, nbeta, alpha, scale,
              transform):
    nq = c1s.shape[1]
    y = scale(c1s, psii_m[:nq], ninv_m[:nq], hat_m[:nq], q_pad[:nq],
              qneg_pad[:nq])
    outs = []
    for j in range(nbeta):
        na = min(alpha, nq - j * alpha)
        res = transform(y[:, j * alpha:j * alpha + na], w[j][:, :na], d[j],
                        inv_d[j][:na], psi_m, q_full, qneg_full)
        top = torch.where(mask[j][:nq] != 0, c1s, res[:, :nq])
        outs.append(torch.cat([top, res[:, nq:]], dim=1))
    return torch.stack(outs, dim=1)


def hoist_db_plain(c1s, *tables, nbeta: int, alpha: int):
    """c1s: (B, nq, N) eval-domain main limbs; tables: psii_m, ninv_m,
    hat_m, q_pad, qneg_pad, w, d, inv_d, psi_m, q_full, qneg_full, mask
    (``build_hoist_tables``).  Digit j owns c1s rows j·alpha.. (the last
    digit may be short: its padded table rows would contribute exactly
    zero, so they are skipped).  Returns (B, nbeta, M, N), the own rows
    passed through from c1s."""
    return _hoist_db(c1s, *tables, nbeta, alpha, intt_scale_plain,
                     _baseconv_ntt_plain)


def hoist_db_split_plain(c1s, *tables, nbeta: int, alpha: int, C: int):
    """``hoist_db`` in the order of its two kernels over clusters of C
    blocks (tests only): ``intt_scale_split_plain`` over the nq rows, then
    per digit and target limb the BaseConv per block r-slice and
    ``ntt_split_plain``; own limbs passed through from c1s."""
    return _hoist_db(c1s, *tables, nbeta, alpha,
                     functools.partial(intt_scale_split_plain, C=C),
                     functools.partial(_baseconv_ntt_split_plain, C=C))


#: polynomials per step of the plain ModDown: bounds its (16, R, nd, N)
#: int64 product (≈ 0.5 GB at Set-B) when it runs over a whole HLT batch
_PLAIN_MODDOWN_POLYS = 16


def moddown_finish_plain(x, y_drop, w, d, inv_d, psi_m, p_inv_m, q32, qneg):
    """x: (P, R, N) eval-domain target rows; y_drop: (P, nd, N) scaled
    drop-basis coefficients; w: (R, nd); d/p_inv_m/q32/qneg: (R, 1);
    inv_d: (nd, 1).  Returns (P, R, N)."""
    out = []
    chunk = _PLAIN_MODDOWN_POLYS
    for s in range(0, x.shape[0], chunk):
        conv = _conv(y_drop[s:s + chunk], w, d, inv_d, q32, qneg)
        conv_eval = core_ntt.ntt_mont_raw(conv, psi_m, q32, qneg)
        diff = mm.montsub(x[s:s + chunk], conv_eval, q32)
        out.append(mm.montmul(diff, p_inv_m, q32, qneg))
    return torch.cat(out)


def moddown_finish_split_plain(x, y_drop, w, d, inv_d, psi_m, p_inv_m, q32,
                               qneg, C: int):
    """``moddown_finish`` in the order of its kernel over a cluster of C
    blocks (tests only): block k of a row's cluster computes the BaseConv
    at j = a·n + k·R' + u (a < C, u < R' = n/C, n = N/C), the row goes
    through ``ntt_split_plain``'s cross stages, exchange and local stages,
    and the epilogue (x − conv)·P⁻¹ runs on each chunk."""
    from repro_torch.kernels import ntt as kntt
    conv_eval = kntt.ntt_split_plain(_conv_split(y_drop, w, d, inv_d, q32,
                                                 qneg, C), psi_m, q32, qneg, C)
    return mm.montmul(mm.montsub(x, conv_eval, q32), p_inv_m, q32, qneg)


# ---------------------------------------------------------------------------
# CUDA kernel wrappers
# ---------------------------------------------------------------------------

#: launches per kernel, counted by the wrapper right where it launches
LAUNCHES = {"intt_scale": 0, "hoist_db": 0, "moddown_finish": 0,
            "baseconv_ntt": 0}


def _logn(N: int) -> int:
    logN = N.bit_length() - 1
    if N != 1 << logN or logN < 1:
        raise ValueError(f"ring dimension {N} is not a power of two")
    if logN > SPLIT_MAX_LOGN:
        raise ValueError(
            f"N = 2^{logN}: the kernels split a row over a thread-block "
            f"cluster of at most 16 blocks, chunks of at most 2^13 values, "
            f"so they take N <= 2^{SPLIT_MAX_LOGN}")
    return logN


def _logc(rows: int, N: int) -> int:
    """log2 of the cluster that transforms each of a launch's ``rows``
    rows of N (``kernels/ntt.py`` ``cluster_size``, as ``ntt``'s)."""
    from repro_torch.kernels import ntt as kntt
    return kntt.cluster_size(rows, N).bit_length() - 1


def split_smem_bytes(rows: int, N: int) -> int:
    """Dynamic shared memory one block of a launch over ``rows`` rows of N
    allocates: the padded chunk of n = N/C values and its twiddle table,
    C = ``cluster_size(rows, N)`` (``common.cuh`` ``split_smem_bytes``).
    Every kernel of this module launches this way."""
    n = N >> _logc(rows, N)
    return 4 * (2 * n + (n >> 5))


def hoist_smem_bytes(B: int, nbeta: int, nq: int, M: int, N: int) -> int:
    """Per-block footprint of ``hoist_db`` over B ciphertexts of nq limbs:
    the larger of its two launches (the iNTT over B·nq rows, the BaseConv
    + NTT over B·β·M rows).  It takes the place of the TPU kernel's
    ``hoist_db_working_set_rows``."""
    return max(split_smem_bytes(B * nq, N), split_smem_bytes(B * nbeta * M, N))


def moddown_smem_bytes(P: int, nd: int, R: int, N: int) -> int:
    """Per-block footprint of the merged ModDown over P polynomials: the
    larger of ``intt_scale`` over the P·nd drop rows and ``moddown_finish``
    over the P·R target rows.  It takes the place of the TPU kernel's
    ``moddown_working_set_rows``."""
    return max(split_smem_bytes(P * nd, N), split_smem_bytes(P * R, N))


def _fold(ninv_m, scale_m, q32, qneg):
    """The (R, 1) epilogue constants montmul(N⁻¹, scale) of the
    ``intt_scale`` kernel, computed on the host once per table and kept
    on the scale table (the engine's tables come back on every call)."""
    got = getattr(scale_m, "_fame_fold", None)
    if got is None or got[0] is not ninv_m:
        f = mm.montmul(*(t.cpu() for t in (ninv_m, scale_m, q32, qneg)))
        got = (ninv_m, f.to(scale_m.device))
        scale_m._fame_fold = got
    return got[1]


def _check_rows(rows, R: int, nrows: int):
    """A row table: R int64 indices below ``nrows``, on the device; the
    bounds are read once per table."""
    build.check_tables("intt_scale", rows.device, (rows, (R,)),
                       dtype=torch.int64)
    if getattr(rows, "_fame_rows", None) != nrows:
        if not 0 <= int(rows.min()) and int(rows.max()) < nrows:
            raise ValueError(f"intt_scale: row table outside {nrows} rows")
        rows._fame_rows = nrows


def _launch_intt_scale(x, rows, R, psii_m, ninv_m, scale_m, q32, qneg):
    """Raw launch over x (B, *, N) with contiguous rows: output row r reads
    x row ``rows[r]`` (None: row r) of each batch element.  Checks the
    operands; returns a fresh contiguous (B, R, N) output."""
    B, nrows, N = x.shape
    logN = _logn(N)
    build.check("intt_scale", x, torch.int32, rows_contiguous=True)
    build.check_tables("intt_scale", x.device, (psii_m, (R, N)),
                       (ninv_m, (R, 1)), (scale_m, (R, 1)), (q32, (R, 1)),
                       (qneg, (R, 1)))
    if rows is None:
        if R > nrows:
            raise ValueError(f"intt_scale: {R} rows of {nrows}")
    else:
        _check_rows(rows, R, nrows)
    out = torch.empty((B, R, N), dtype=torch.int32, device=x.device)
    build.call("intt_scale_launch", x, x.stride(0), rows, out, B, R, logN,
               _logc(B * R, N), psii_m, _fold(ninv_m, scale_m, q32, qneg),
               q32, qneg)
    LAUNCHES["intt_scale"] += 1
    return out


def intt_scale_cuda(x, psii_m, ninv_m, scale_m, q32, qneg):
    """x: (R, N) or (B, R, N) int32 on CUDA, rows contiguous."""
    squeeze = x.dim() == 2
    x3 = x[None] if squeeze else x
    out = _launch_intt_scale(x3, None, x3.shape[1], psii_m, ninv_m, scale_m,
                             q32, qneg)
    return out[0] if squeeze else out


def intt_scale_rows_cuda(x, rows, psii_m, ninv_m, scale_m, q32, qneg):
    """``intt_scale`` of the rows ``rows`` (R int64) of x (B, *, N): the
    kernel reads them in place, as ``intt_scale_cuda(x[:, rows], …)``
    would after a gather."""
    return _launch_intt_scale(x, rows, rows.shape[0], psii_m, ninv_m,
                              scale_m, q32, qneg)


def hoist_db_cuda(c1s, psii_m, ninv_m, hat_m, q_pad, qneg_pad, w, d, inv_d,
                  psi_m, q_full, qneg_full, mask, *, nbeta: int, alpha: int):
    """c1s: (B, nq, N) int32 on CUDA, rows contiguous (any batch stride)."""
    B, nq, N = c1s.shape
    R = nbeta * alpha
    M = psi_m.shape[0]
    if not R - alpha < nq <= R:
        raise ValueError(f"hoist_db: {nq} limbs for {nbeta} digits of "
                         f"{alpha}")
    logN = _logn(N)
    build.check("hoist_db", c1s, torch.int32, rows_contiguous=True)
    build.check_tables("hoist_db", c1s.device, (psii_m, (R, N)),
                       (ninv_m, (R, 1)), (hat_m, (R, 1)), (q_pad, (R, 1)),
                       (qneg_pad, (R, 1)), (w, (nbeta, M, alpha)),
                       (d, (nbeta, M, 1)), (psi_m, (M, N)), (q_full, (M, 1)),
                       (qneg_full, (M, 1)), (mask, (nbeta, M, 1)))
    build.check_tables("hoist_db", c1s.device, (inv_d, (nbeta, alpha, 1)),
                       dtype=torch.float64)
    # digit rows are c1s rows: the iNTT runs over the nq real ones only (a
    # launch of the intt_scale kernel, counted as hoist_db's)
    y = torch.empty((B, nq, N), dtype=torch.int32, device=c1s.device)
    build.call("intt_scale_launch", c1s, c1s.stride(0), None, y, B, nq, logN,
               _logc(B * nq, N), psii_m, _fold(ninv_m, hat_m, q_pad,
                                               qneg_pad), q_pad, qneg_pad)
    out = torch.empty((B, nbeta, M, N), dtype=torch.int32, device=c1s.device)
    build.call("hoist_bc_ntt_launch", y, c1s, c1s.stride(0), out, B, nbeta,
               alpha, nq, M, logN, _logc(B * nbeta * M, N), w, d, inv_d,
               psi_m, q_full, qneg_full, mask)
    LAUNCHES["hoist_db"] += 1
    return out


def baseconv_ntt_cuda(y, w, d, inv_d, psi_m, q32, qneg, passthrough, mask):
    """Operands as ``baseconv_ntt_plain``, all contiguous on CUDA."""
    nbeta, M, alpha = w.shape
    N = y.shape[-1]
    logN = _logn(N)
    name = "baseconv_ntt"
    build.check(name, y, torch.int32)
    if tuple(y.shape) != (nbeta * alpha, N):
        raise ValueError(f"{name}: y {tuple(y.shape)}, want "
                         f"{(nbeta * alpha, N)}")
    build.check_tables(name, y.device, (w, (nbeta, M, alpha)),
                       (d, (nbeta, M, 1)), (psi_m, (M, N)), (q32, (M, 1)),
                       (qneg, (M, 1)), (passthrough, (M, N)),
                       (mask, (nbeta, M, 1)))
    build.check_tables(name, y.device, (inv_d, (nbeta, alpha, 1)),
                       dtype=torch.float64)
    out = torch.empty((nbeta, M, N), dtype=torch.int32, device=y.device)
    build.call("baseconv_ntt_launch", y, passthrough, out, nbeta, alpha, M,
               logN, _logc(nbeta * M, N), w, d, inv_d, psi_m, q32, qneg, mask)
    LAUNCHES[name] += 1
    return out


def moddown_finish_cuda(x, y_drop, w, d, inv_d, psi_m, p_inv_m, q32, qneg):
    """x: (P, R, N) with contiguous rows (any batch stride); y_drop:
    (P, nd, N) contiguous."""
    P, R, N = x.shape
    nd = y_drop.shape[1]
    logN = _logn(N)
    build.check("moddown_finish", x, torch.int32, rows_contiguous=True)
    build.check("moddown_finish", y_drop, torch.int32)
    if y_drop.shape != (P, nd, N):
        raise ValueError(f"moddown_finish: y_drop {tuple(y_drop.shape)} vs x "
                         f"{tuple(x.shape)}")
    build.check_tables("moddown_finish", x.device, (w, (R, nd)), (d, (R, 1)),
                       (psi_m, (R, N)), (p_inv_m, (R, 1)), (q32, (R, 1)),
                       (qneg, (R, 1)))
    build.check_tables("moddown_finish", x.device, (inv_d, (nd, 1)),
                       dtype=torch.float64)
    # the cluster that ntt would give as many rows: C = 8 at the Set-B
    # shapes, the fastest of 4, 8 and 16 there (PERF.md §6)
    out = torch.empty((P, R, N), dtype=torch.int32, device=x.device)
    build.call("moddown_finish_launch", x, x.stride(0), y_drop, out, P, R, nd,
               logN, _logc(P * R, N), w, d, inv_d, psi_m, p_inv_m, q32, qneg)
    LAUNCHES["moddown_finish"] += 1
    return out


# ---------------------------------------------------------------------------
# table builders (host numpy, the reference's digit-padded layout)
# ---------------------------------------------------------------------------


def _mont_col(x_u64, qs_u64):
    return mm.to_mont_host_arr(np.asarray(x_u64, np.uint64),
                               np.asarray(qs_u64, np.uint64))


def build_hoist_tables(ctx, tools, level: int) -> dict:
    """Digit-padded fused-hoist tables at ``level`` (numpy; f64 inv_d)."""
    p = ctx.params
    h = ctx.host
    bases = tools.digit_bases(level)
    full = bases[0][2]
    pos = {g: i for i, g in enumerate(full)}
    nbeta, alpha = len(bases), max(len(own) for (own, _, _) in bases)
    M, N = len(full), p.N
    qs = np.asarray(h.moduli, np.uint64)
    q32_np = np.asarray(h.moduli, np.uint32)

    R = nbeta * alpha
    psii_pad = np.zeros((R, N), np.uint32)
    ninv_pad = np.zeros((R, 1), np.uint32)
    q_pad = np.ones((R, 1), np.uint32) * q32_np[0]
    qneg_pad = np.ones((R, 1), np.uint32) * h.qneg_inv[0]
    hat_pad = np.zeros((R, 1), np.uint32)
    w = np.zeros((nbeta, M, alpha), np.uint32)
    dmod = np.zeros((nbeta, M, 1), np.uint32)
    inv_d = np.zeros((nbeta, alpha, 1), np.float64)
    mask = np.zeros((nbeta, M, 1), np.uint32)

    for j, (own, gen, _) in enumerate(bases):
        hat_inv, W, D_mod_t, invd = tools._bc_tables(own, gen)
        na = len(own)
        rows = slice(j * alpha, j * alpha + na)
        psii_pad[rows] = h.psi_inv_brv_mont[list(own)]
        ninv_pad[rows, 0] = h.n_inv_mont[list(own)]
        q_pad[rows, 0] = q32_np[list(own)]
        qneg_pad[rows, 0] = h.qneg_inv[list(own)]
        hat_pad[rows] = _mont_col(hat_inv, qs[list(own)][:, None])
        inv_d[j, :na] = invd
        for ti, g in enumerate(gen):
            w[j, pos[g], :na] = _mont_col(W[ti], qs[g])
            dmod[j, pos[g], 0] = _mont_col(D_mod_t[ti], qs[g])[0]
        for g in own:
            mask[j, pos[g], 0] = 1

    rows_full = list(full)
    return dict(
        nbeta=nbeta, alpha=alpha, nq=level + 1,
        psii_pad=psii_pad, ninv_pad=ninv_pad, q_pad=q_pad, qneg_pad=qneg_pad,
        hat_pad=hat_pad, w=w, d=dmod, inv_d=inv_d,
        psi_full=h.psi_brv_mont[rows_full],
        q_full=q32_np[rows_full][:, None],
        qneg_full=h.qneg_inv[rows_full][:, None],
        mask=mask)


def build_moddown_tables(ctx, tools, level: int) -> dict:
    """Merged ModDown+Rescale tables at ``level`` (drop basis P ∪ {q_ℓ})."""
    p = ctx.params
    h = ctx.host
    nq = level + 1
    spec = tuple(range(p.num_main, p.num_total))
    P = spec + (level,)
    Q = tuple(range(level))
    drop_idx = np.asarray(list(range(nq, nq + p.k)) + [level], np.int64)
    hat_inv, W, D_mod_t, invd = tools._bc_tables(P, Q)
    p_inv = tools._moddown_tables(P, Q)
    qs = np.asarray(h.moduli, np.uint64)
    q32_np = np.asarray(h.moduli, np.uint32)
    rows_p, rows_q = list(P), list(Q)
    return dict(
        drop_idx=drop_idx, n_out=len(Q),
        psii_drop=h.psi_inv_brv_mont[rows_p],
        ninv_drop=h.n_inv_mont[rows_p][:, None],
        q_drop=q32_np[rows_p][:, None],
        qneg_drop=h.qneg_inv[rows_p][:, None],
        hat_drop=_mont_col(hat_inv, qs[rows_p][:, None]),
        w=_mont_col(W, qs[rows_q][:, None]),
        d=_mont_col(D_mod_t, qs[rows_q][:, None]),
        inv_d=invd.astype(np.float64),
        psi_out=h.psi_brv_mont[rows_q],
        q_out=q32_np[rows_q][:, None],
        qneg_out=h.qneg_inv[rows_q][:, None],
        p_inv=_mont_col(p_inv[:, 0], qs[rows_q])[:, None])


def to_device(tabs: dict, device) -> dict:
    """numpy tables -> tensors: uint32 as int32 bits, float64 as float64,
    int64 index arrays as int64; Python ints stay."""
    out = {}
    for k, v in tabs.items():
        if not isinstance(v, np.ndarray):
            out[k] = v
        elif v.dtype == np.uint32:
            out[k] = torch.from_numpy(np.ascontiguousarray(v).view(np.int32)
                                      ).to(device)
        else:
            out[k] = torch.from_numpy(np.ascontiguousarray(v)).to(device)
    return out
