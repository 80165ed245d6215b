"""Standalone HPS base conversion on the u32 Montgomery datapath —
counterpart of ``repro/kernels/baseconv.py`` (``baseconv``).

Shapes: x (|S|, N) int32; hat_inv_m / q_own / qneg_own (|S|, 1);
W_m (|T|, |S|) Montgomery; D_mod_m / q_gen / qneg_gen (|T|, 1);
inv_d (|S|, 1) float.  Returns (|T|, N) residues over the target basis.

The overflow correction is the TPU kernel's float32 one,
``v = floor(Σ_i f32(y_i)·f32(inv_d_i) + 0.5e-6)``, not the float64 of
``core/rns.py`` ``base_conv`` and the fused kernels: with 28–30-bit primes
the f32 rounding error of the sum is the size of the epsilon, so the order
of the sum decides bits.  Both versions sum left to right over the source
limbs: the plain one by an explicit float32 loop (``torch.sum``'s order on
CUDA is unspecified), the kernel (``csrc/baseconv.cu``) with
``__fmul_rn``/``__fadd_rn`` and no FMA contraction.  The float64 oracle
``kernels/ref.py`` ``baseconv_ref`` may differ from both by one ``v``.
"""
from __future__ import annotations

import torch

from repro_torch.core import modmath as mm
from repro_torch.kernels import build

LAUNCHES = {"baseconv": 0}

#: the TPU kernel's epsilon, a float32 (it is a weakly typed Python float
#: added to a float32 sum there)
CORRECTION_EPS_F32 = 0.5e-6


def floor_count_f32(y, inv_d):
    """v = floor(Σ_i f32(y_i)·f32(inv_d_i) + eps) in float32, i ascending.
    y: (S, N) int; inv_d: (S, 1) float.  Returns (N,) int64."""
    inv = inv_d.to(torch.float32)
    s = y[0].to(torch.float32) * inv[0]
    for i in range(1, y.shape[0]):
        s = s + y[i].to(torch.float32) * inv[i]
    eps = torch.tensor(CORRECTION_EPS_F32, dtype=torch.float32, device=y.device)
    return torch.floor(s + eps).to(torch.int64)


def baseconv_plain(x, hat_inv_m, q_own, qneg_own, W_m, D_mod_m, inv_d, q_gen,
                   qneg_gen):
    y = mm.montmul(x, hat_inv_m, q_own, qneg_own)                 # (S, N)
    v = floor_count_f32(y, inv_d)                                 # (N,)
    prod = mm.montmul(y[None], W_m[:, :, None], q_gen[:, None],
                      qneg_gen[:, None])                          # (T, S, N)
    acc = mm.montsum(prod, q_gen, axis=1)                         # (T, N)
    corr = mm.montmul(v[None], D_mod_m, q_gen, qneg_gen)
    return mm.montsub(acc, corr, q_gen)


def baseconv_cuda(x, hat_inv_m, q_own, qneg_own, W_m, D_mod_m, inv_d, q_gen,
                  qneg_gen):
    name = "baseconv"
    build.check(name, x, torch.int32)
    if x.dim() != 2:
        raise ValueError(f"{name}: x of shape {tuple(x.shape)}, want (|S|, N)")
    S, N = x.shape
    T = W_m.shape[0]
    dev = x.device
    build.check_tables(name, dev, (hat_inv_m, (S, 1)), (q_own, (S, 1)),
                       (qneg_own, (S, 1)), (W_m, (T, S)), (D_mod_m, (T, 1)),
                       (q_gen, (T, 1)), (qneg_gen, (T, 1)))
    build.check_tables(name, dev, (inv_d, (S, 1)), dtype=torch.float64)
    out = torch.empty((T, N), dtype=torch.int32, device=dev)
    build.call("baseconv_launch", x, hat_inv_m, q_own, qneg_own, W_m, D_mod_m,
               inv_d, q_gen, qneg_gen, out, S, T, N)
    LAUNCHES[name] += 1
    return out
