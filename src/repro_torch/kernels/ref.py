"""Plain oracles for every kernel of ``kernels/ops.py`` — counterpart of
``repro/kernels/ref.py``.

They are written as the reference's oracles are (loops over rotations and
digits, a float64 BaseConv correction), independent of the kernels' plain
versions, which repeat each kernel's own arithmetic.  Shapes and argument
orders are the reference's; residues are int32 tensors.
"""
from __future__ import annotations

import torch

from repro_torch.core import modmath as mm
from repro_torch.core import ntt as core_ntt


def modmul_ref(x, y, q32, qneg):
    """Element-wise Montgomery product, limb-batched."""
    return mm.montmul(x, y, q32, qneg)


def modadd_ref(x, y, q32):
    return mm.montadd(x, y, q32)


def ntt_ref(x, psi_m, q32, qneg):
    return core_ntt.ntt_mont_raw(x, psi_m, q32, qneg)


def intt_ref(x, psii_m, ninv_m, q32, qneg):
    return core_ntt.intt_mont_raw(x, psii_m, ninv_m, q32, qneg)


def automorph_ref(x, perm):
    return x[..., torch.as_tensor(perm, dtype=torch.int64, device=x.device)]


def fused_hlt_ref(digits, c0e, c1e, u_mont, rk0, rk1, perms, q32, qneg,
                  id_idx: int):
    """Oracle for the fused Automorph→KeyIP→DiagIP datapath with one
    identity entry.  digits (β, M, N); c0e/c1e (M, N); u_mont (d, M, N);
    rk0/rk1 (d, β, M, N); perms (d, N).  Returns acc0, acc1 (M, N)."""
    is_id = [t == id_idx for t in range(rk0.shape[0])]
    return fused_hlt_masked_ref(digits, c0e, c1e, u_mont, rk0, rk1, perms,
                                is_id, q32, qneg)


def fused_hlt_masked_ref(digits, c0e, c1e, u_mont, rk0, rk1, perms, is_id,
                         q32, qneg):
    """``fused_hlt_ref`` with an is_id mask (d,): any number of identity
    (z = 0 or padding) entries."""
    d, nb = rk0.shape[0], rk0.shape[1]
    acc0 = torch.zeros_like(c0e)
    acc1 = torch.zeros_like(c1e)
    for t in range(d):
        pm = perms[t].to(torch.int64)
        dig_rot = digits[..., pm]
        c0r = c0e[..., pm]
        k0 = torch.zeros_like(acc0)
        k1 = torch.zeros_like(acc1)
        for j in range(nb):
            k0 = mm.montadd(k0, mm.montmul(dig_rot[j], rk0[t, j], q32, qneg),
                            q32)
            k1 = mm.montadd(k1, mm.montmul(dig_rot[j], rk1[t, j], q32, qneg),
                            q32)
        if bool(is_id[t]):
            t0, t1 = c0e, c1e
        else:
            t0, t1 = mm.montadd(k0, c0r, q32), k1
        acc0 = mm.montadd(acc0, mm.montmul(u_mont[t], t0, q32, qneg), q32)
        acc1 = mm.montadd(acc1, mm.montmul(u_mont[t], t1, q32, qneg), q32)
    return acc0, acc1


def fused_hlt_batched_ref(digits, c0e, c1e, u_mont, rk0, rk1, perms, is_id,
                          q32, qneg):
    """Batched oracle: a loop of single-ciphertext oracles over the leading
    axis B.  Returns (acc0, acc1), each (B, M, N)."""
    outs = [fused_hlt_masked_ref(digits[b], c0e[b], c1e[b], u_mont[b],
                                 rk0[b], rk1[b], perms[b], is_id[b, :, 0],
                                 q32, qneg)
            for b in range(digits.shape[0])]
    return (torch.stack([o[0] for o in outs]),
            torch.stack([o[1] for o in outs]))


def baseconv_ref(x, hat_inv_m, W_m, D_mod_m, inv_d, q_own, qneg_own, q_gen,
                 qneg_gen):
    """HPS base conversion on the u32 Montgomery path with the float64
    correction ``floor(Σ y_i·inv_d_i + 1e-9)`` (the kernel's is float32).
    x (|S|, N); W_m (|T|, |S|, 1).  Returns (|T|, N)."""
    y = mm.montmul(x, hat_inv_m, q_own, qneg_own)
    v = torch.floor((y.to(torch.float64) * inv_d).sum(dim=0) + 1e-9
                    ).to(torch.int64)
    prod = mm.montmul(y[None], W_m, q_gen[:, None], qneg_gen[:, None])
    acc = prod[:, 0]
    for i in range(1, prod.shape[1]):
        acc = mm.montadd(acc, prod[:, i], q_gen)
    corr = mm.montmul(v[None], D_mod_m, q_gen, qneg_gen)
    return mm.montsub(acc, corr, q_gen)
