"""Per-limb negacyclic NTT / iNTT on the u32 Montgomery datapath —
counterpart of ``repro/kernels/ntt.py``.

``CkksEngine(datapath="pallas")`` runs every transform of its own (encode,
the keyswitch inside ``mult``, its ModDown, ``rescale``) through these.
Each has a plain PyTorch version (``core/ntt.py`` ``ntt_mont_raw`` /
``intt_mont_raw``, for CPU tensors and as the on-card reference) and a
CUDA kernel wrapper (``csrc/ntt.cu``; one launch counter each).

Shapes: x (B, M, N) int32 (u32 residues, standard domain); twiddles
(M, N) Montgomery; constants (M, 1).  The CUDA wrappers read x in place
through its batch stride (the engine passes row slices of larger
polynomials), and return a fresh contiguous (B, M, N).
"""
from __future__ import annotations

import torch

from repro_torch.core import ntt as core_ntt
from repro_torch.kernels import build
from repro_torch.kernels.basechange import _logn

#: launches per kernel, counted by the wrapper right where it launches
LAUNCHES = {"ntt": 0, "intt": 0}


def ntt_plain(x, psi_m, q32, qneg):
    """Natural-order coefficients -> bit-reversed evaluation order."""
    return core_ntt.ntt_mont_raw(x, psi_m, q32, qneg)


def intt_plain(x, psii_m, ninv_m, q32, qneg):
    """Bit-reversed evaluation order -> natural-order coefficients."""
    return core_ntt.intt_mont_raw(x, psii_m, ninv_m, q32, qneg)


def _launch(name, fn, x, *tables):
    """x: (B, M, N) int32 on CUDA, rows contiguous (any batch stride);
    tables: the (M, N) twiddles, then (M, 1) constants."""
    build.check(name, x, torch.int32, rows_contiguous=True)
    B, M, N = x.shape
    logN = _logn(N)
    build.check_tables(name, x.device, (tables[0], (M, N)),
                       *[(t, (M, 1)) for t in tables[1:]])
    out = torch.empty((B, M, N), dtype=torch.int32, device=x.device)
    build.call(fn, x, x.stride(0), out, B, M, logN, *tables)
    LAUNCHES[name] += 1
    return out


def ntt_cuda(x, psi_m, q32, qneg):
    return _launch("ntt", "ntt_launch", x, psi_m, q32, qneg)


def intt_cuda(x, psii_m, ninv_m, q32, qneg):
    return _launch("intt", "intt_launch", x, psii_m, ninv_m, q32, qneg)
