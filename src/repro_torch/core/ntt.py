"""Negacyclic NTT / iNTT over RNS limbs, in plain PyTorch.

Counterpart of ``repro/core/ntt.py``: the Longa–Naehrig iterative
formulation.  The forward NTT (Cooley–Tukey) takes natural-order
coefficients to *bit-reversed* evaluation order; the inverse
(Gentleman–Sande) takes them back.  All evaluation-domain data in the
port lives in bit-reversed order, as in the reference.

Shapes: x ``(..., M, N)`` int32 residues; twiddle tables ``(M, N)``;
moduli and constants ``(M, 1)``.  The CUDA kernels run the Montgomery
butterflies of ``ntt_mont_raw`` / ``intt_mont_raw`` split over a
thread-block cluster (``split_fwd_row`` / ``split_inv_row`` in
``csrc/common.cuh``; the standalone transforms are ``csrc/ntt.cu``).

``ntt`` / ``intt`` / ``ntt_mont`` / ``intt_mont`` are the named plain
transforms that code paths call (the engine's ``"xla"`` datapath, the
sharded schedule's plain-torch stages); each call adds one to ``CALLS``,
which the verifier's census reads (rule JX004: a program whose stages
are on the kernels calls none of them).  The kernels' plain versions
call the ``*_raw`` recursions and are not counted.
"""
from __future__ import annotations

import torch

from repro_torch.core import modmath as mm


def _as3(q):
    """(M, 1) column -> (M, 1, 1) for the (..., M, m, t) butterfly views."""
    return q[..., None]


def ntt_raw(x, psi_brv, q):
    """Forward negacyclic NTT on the u64 reference datapath.

    x: (..., M, N) natural order; psi_brv: (M, N) ψ^br(i); q: (M, 1) int64.
    Returns (..., M, N) in bit-reversed evaluation order."""
    N = x.shape[-1]
    m, t = 1, N
    q3 = _as3(q)
    while m < N:
        t //= 2
        xv = x.reshape(x.shape[:-1] + (m, 2, t))
        s = psi_brv[..., m:2 * m][..., None]
        u = xv[..., 0, :]
        v = mm.mulmod(xv[..., 1, :], s, q3)
        x = torch.stack([mm.addmod(u, v, q3), mm.submod(u, v, q3)], dim=-2)
        x = x.reshape(x.shape[:-3] + (N,))
        m *= 2
    return x


def intt_raw(x, psi_inv_brv, n_inv, q):
    """Inverse negacyclic NTT: bit-reversed eval order -> natural coeffs."""
    N = x.shape[-1]
    q3 = _as3(q)
    h, t = N // 2, 1
    while h >= 1:
        xv = x.reshape(x.shape[:-1] + (h, 2, t))
        s = psi_inv_brv[..., h:2 * h][..., None]
        u = xv[..., 0, :]
        v = xv[..., 1, :]
        x = torch.stack(
            [mm.addmod(u, v, q3), mm.mulmod(mm.submod(u, v, q3), s, q3)],
            dim=-2)
        x = x.reshape(x.shape[:-3] + (N,))
        t *= 2
        h //= 2
    return mm.mulmod(x, n_inv, q)


def ntt_mont_raw(x, psi_brv_mont, q32, qneg_inv):
    """Forward NTT on the u32 Montgomery datapath (twiddles in the
    Montgomery domain, data in the standard domain throughout)."""
    N = x.shape[-1]
    m, t = 1, N
    q3, qi3 = _as3(q32), _as3(qneg_inv)
    while m < N:
        t //= 2
        xv = x.reshape(x.shape[:-1] + (m, 2, t))
        s = psi_brv_mont[..., m:2 * m][..., None]
        u = xv[..., 0, :]
        v = mm.montmul(xv[..., 1, :], s, q3, qi3)
        x = torch.stack([mm.montadd(u, v, q3), mm.montsub(u, v, q3)], dim=-2)
        x = x.reshape(x.shape[:-3] + (N,))
        m *= 2
    return x


def intt_mont_raw(x, psi_inv_brv_mont, n_inv_mont, q32, qneg_inv):
    """Inverse NTT on the u32 Montgomery datapath."""
    N = x.shape[-1]
    q3, qi3 = _as3(q32), _as3(qneg_inv)
    h, t = N // 2, 1
    while h >= 1:
        xv = x.reshape(x.shape[:-1] + (h, 2, t))
        s = psi_inv_brv_mont[..., h:2 * h][..., None]
        u = xv[..., 0, :]
        v = xv[..., 1, :]
        x = torch.stack(
            [mm.montadd(u, v, q3),
             mm.montmul(mm.montsub(u, v, q3), s, q3, qi3)],
            dim=-2)
        x = x.reshape(x.shape[:-3] + (N,))
        t *= 2
        h //= 2
    return mm.montmul(x, n_inv_mont, q32, qneg_inv)


#: calls of the named transforms, by name (module docstring)
CALLS = {"ntt": 0, "intt": 0, "ntt_mont": 0, "intt_mont": 0}


def ntt(x, psi_brv, q):
    CALLS["ntt"] += 1
    return ntt_raw(x, psi_brv, q)


def intt(x, psi_inv_brv, n_inv, q):
    CALLS["intt"] += 1
    return intt_raw(x, psi_inv_brv, n_inv, q)


def ntt_mont(x, psi_brv_mont, q32, qneg_inv):
    CALLS["ntt_mont"] += 1
    return ntt_mont_raw(x, psi_brv_mont, q32, qneg_inv)


def intt_mont(x, psi_inv_brv_mont, n_inv_mont, q32, qneg_inv):
    CALLS["intt_mont"] += 1
    return intt_mont_raw(x, psi_inv_brv_mont, n_inv_mont, q32, qneg_inv)
