"""Per-limb negacyclic NTT / iNTT on the u32 Montgomery datapath —
counterpart of ``repro/kernels/ntt.py``.

``CkksEngine(datapath="pallas")`` runs every transform of its own (encode,
the keyswitch inside ``mult``, its ModDown, ``rescale``) through these.
Each has a plain PyTorch version (``core/ntt.py`` ``ntt_mont_raw`` /
``intt_mont_raw``, for CPU tensors and as the on-card reference) and a
CUDA kernel wrapper (``csrc/ntt.cu``; one launch counter each).

The kernel transforms each row on a thread-block cluster of
:func:`cluster_size` blocks, in the order of :func:`ntt_split_plain` /
:func:`intt_split_plain` (the same butterflies as the plain versions, so
the same output; the tests hold the two orders equal).

Shapes: x (B, M, N) int32 (u32 residues, standard domain); twiddles
(M, N) Montgomery; constants (M, 1).  The CUDA wrappers read x in place
through its batch stride (the engine passes row slices of larger
polynomials), and return a fresh contiguous (B, M, N).
"""
from __future__ import annotations

import torch

from repro_torch.core import modmath as mm
from repro_torch.core import ntt as core_ntt
from repro_torch.kernels import build
from repro_torch.kernels.basechange import _logn

#: launches per kernel, counted by the wrapper right where it launches
LAUNCHES = {"ntt": 0, "intt": 0}

#: streaming multiprocessors of an H100 SXM
SMS = 132
#: shortest chunk a block of a cluster > 1 transforms
MIN_CHUNK = 1024


def ntt_plain(x, psi_m, q32, qneg):
    """Natural-order coefficients -> bit-reversed evaluation order."""
    return core_ntt.ntt_mont_raw(x, psi_m, q32, qneg)


def intt_plain(x, psii_m, ninv_m, q32, qneg):
    """Bit-reversed evaluation order -> natural-order coefficients."""
    return core_ntt.intt_mont_raw(x, psii_m, ninv_m, q32, qneg)


def cluster_size(rows: int, N: int) -> int:
    """Blocks C of the cluster that transforms one row of a launch over
    ``rows`` (batch × limb) rows: chunks N/C of at least ``MIN_CHUNK``
    values (C = 1 below 2^11), 16 while one cluster a row fits the card's
    SMs, else 8 (the portable cluster size).  The kernels of
    ``kernels/basechange.py`` spread their rows the same way."""
    cmax = min(16, max(1, N // MIN_CHUNK))
    if cmax == 16 and rows * 16 <= SMS:
        return 16
    return min(cmax, 8)


# ---------------------------------------------------------------------------
# the kernel's schedule in plain torch (tests only): a row index is
# j = a·n + r (chunk a < C of n = N/C values); block k of the cluster owns
# r in [k·R, (k+1)·R), R = n/C, for the cross stages, and chunk k for the
# local ones
# ---------------------------------------------------------------------------


def _split_dims(N: int, C: int):
    c, ln = C.bit_length() - 1, (N // C).bit_length() - 1
    if C != 1 << c or N // C < C:
        raise ValueError(f"cluster of {C} blocks cannot split a row of {N}")
    return c, ln


def _cols(t, *dims):
    """(M, k) table -> (M, *dims) (k ones and ones) to broadcast over a
    (…, M, …) view."""
    return t.reshape(t.shape[0], *dims)


def ntt_split_plain(x, psi_m, q32, qneg, C: int):
    """The forward NTT in the kernel's order over a cluster of C blocks:
    the c cross stages on each block's (a, r) values, the exchange of
    every value to the block of its chunk, the local stages on each chunk
    with the global twiddle index 2^lm + a·2^(lm−c) + local group."""
    *lead, M, N = x.shape
    c, ln = _split_dims(N, C)
    n, R = N // C, N // C // C
    # q, qn against (…, M, k, G, H, R) views; ql, qnl against (…, M, a, G, H)
    q, qn = _cols(q32, 1, 1, 1, 1), _cols(qneg, 1, 1, 1, 1)
    ql, qnl = q[..., 0], qn[..., 0]
    # owner layout (…, M, k, a, u): block k's C segments of R
    own = x.reshape(*lead, M, C, C, R).transpose(-3, -2)
    for lm in range(c):                       # t = N/2 … n: pairs along a
        G = 1 << lm
        v = own.reshape(*lead, M, C, G, 2, C // (2 * G), R)
        w = _cols(psi_m[:, G:2 * G], 1, G, 1, 1)
        hi = mm.montmul(v[..., 1, :, :], w, q, qn)
        own = torch.stack([mm.montadd(v[..., 0, :, :], hi, q),
                           mm.montsub(v[..., 0, :, :], hi, q)],
                          dim=-3).reshape(*lead, M, C, C, R)
    chunks = own.transpose(-3, -2).reshape(*lead, M, C, n)   # the exchange
    a = torch.arange(C, device=x.device)[:, None]
    for s in range(ln):                       # t = n/2 … 1 inside a chunk
        G = 1 << s
        idx = (1 << (c + s)) + (a << s) + torch.arange(G, device=x.device)
        v = chunks.reshape(*lead, M, C, G, 2, n // (2 * G))
        w = psi_m[:, idx.reshape(-1)].reshape(M, C, G, 1)
        hi = mm.montmul(v[..., 1, :], w, ql, qnl)
        chunks = torch.stack([mm.montadd(v[..., 0, :], hi, ql),
                              mm.montsub(v[..., 0, :], hi, ql)],
                             dim=-2).reshape(*lead, M, C, n)
    return chunks.reshape(*lead, M, N)


def intt_split_plain(x, psii_m, ninv_m, q32, qneg, C: int):
    """The inverse NTT in the kernel's order: the local stages on each
    chunk (t = 1 … n/2), the exchange of every value to the block owning
    its r, the c cross stages there (t = n … N/2) and the N^-1 factor."""
    *lead, M, N = x.shape
    c, ln = _split_dims(N, C)
    n, R = N // C, N // C // C
    q, qn = _cols(q32, 1, 1, 1, 1), _cols(qneg, 1, 1, 1, 1)
    ql, qnl = q[..., 0], qn[..., 0]
    chunks = x.reshape(*lead, M, C, n)
    a = torch.arange(C, device=x.device)[:, None]
    for bit in range(ln):                     # t = 2^bit inside a chunk
        G = n >> (bit + 1)
        idx = (N >> (bit + 1)) + a * G + torch.arange(G, device=x.device)
        v = chunks.reshape(*lead, M, C, G, 2, 1 << bit)
        w = psii_m[:, idx.reshape(-1)].reshape(M, C, G, 1)
        u0, u1 = v[..., 0, :], v[..., 1, :]
        chunks = torch.stack(
            [mm.montadd(u0, u1, ql),
             mm.montmul(mm.montsub(u0, u1, ql), w, ql, qnl)],
            dim=-2).reshape(*lead, M, C, n)
    # the exchange: owner layout (…, M, k, a, u)
    own = chunks.reshape(*lead, M, C, C, R).transpose(-3, -2)
    for bit in range(c):                      # t = n·2^bit: pairs along a
        G = C >> (bit + 1)
        v = own.reshape(*lead, M, C, G, 2, 1 << bit, R)
        w = _cols(psii_m[:, G:2 * G], 1, G, 1, 1)
        u0, u1 = v[..., 0, :, :], v[..., 1, :, :]
        own = torch.stack(
            [mm.montadd(u0, u1, q),
             mm.montmul(mm.montsub(u0, u1, q), w, q, qn)],
            dim=-3).reshape(*lead, M, C, C, R)
    own = mm.montmul(own, _cols(ninv_m, 1, 1, 1), ql, qnl)
    return own.transpose(-3, -2).reshape(*lead, M, N)


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------

def _check_tables(name, device, *pairs):
    """Each table's checks run once per (device, shape): the engine caches
    its basis views, so the same tensors come back on every call.  The
    result is kept on the tensor itself, so it lives and dies with it."""
    for t, shape in pairs:
        if getattr(t, "_fame_checked", None) != (device, shape):
            build.check_tables(name, device, (t, shape))
            t._fame_checked = (device, shape)


def _launch(name, fn, x, *tables):
    """x: (B, M, N) int32 on CUDA, rows contiguous (any batch stride);
    tables: the (M, N) twiddles, then (M, 1) constants."""
    build.check(name, x, torch.int32, rows_contiguous=True)
    B, M, N = x.shape
    logN = _logn(N)
    _check_tables(name, x.device, (tables[0], (M, N)),
                  *[(t, (M, 1)) for t in tables[1:]])
    logc = cluster_size(B * M, N).bit_length() - 1
    out = torch.empty((B, M, N), dtype=torch.int32, device=x.device)
    build.call(fn, x, x.stride(0), out, B, M, logN, logc, *tables)
    LAUNCHES[name] += 1
    return out


def ntt_cuda(x, psi_m, q32, qneg):
    return _launch("ntt", "ntt_launch", x, psi_m, q32, qneg)


def intt_cuda(x, psii_m, ninv_m, q32, qneg):
    return _launch("intt", "intt_launch", x, psii_m, ninv_m, q32, qneg)
