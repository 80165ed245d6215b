"""MO-HLT rotation datapath — counterpart of ``repro/kernels/fused_hlt.py``
``fused_hlt_indexed`` (slot-indexed batch), ``fused_hlt`` (one
ciphertext) and ``fused_hlt_batched`` (a stacked batch, no dedup).

Per batch element b (hoisting product ``ct_slots[b]``, diagonal set
``diag_slots[b]``) and every rotation r of that set: Automorph (gather by
``perms``) → KeyIP (β Montgomery MACs against the rotation-key rows) →
DiagIP (× diagonal), accumulated over all d rotations; ``is_id`` entries
bypass KeyIP with (P·c0, P·c1).

Shapes: digits (H, β, M, N); c0e/c1e (H, M, N); u (S, d, M, N);
rk0/rk1 (S, d, β, M, N); perms (S, d, N) int32; is_id (S, d, 1) int32;
ct_slots/diag_slots (B,) int32; q32/qneg (M, 1).  Both versions return
one (2, B, M, N) tensor — acc0 then acc1 — so the merged ModDown after it
runs over all 2·B polynomials in one launch.

``fused_hlt`` is the same function for one ciphertext and one diagonal
set: digits (β, M, N); c0e/c1e (M, N); u (d, M, N); rk0/rk1 (d, β, M, N);
perms (d, N); is_id (d, 1).  It returns one (2, M, N) tensor, which
unpacks as (acc0, acc1).  Its CUDA form is a second entry point of
``csrc/fused_hlt.cu`` running the same device body with both slots 0,
counted apart from the indexed one.

``fused_hlt_batched`` is the indexed function on operands stacked per
batch element: digits (B, β, M, N); c0e/c1e (B, M, N); u (B, d, M, N);
rk0/rk1 (B, d, β, M, N); perms (B, d, N); is_id (B, d, 1) — batch element
b reads slot b of every operand.  It returns one (2, B, M, N) tensor.  Its
CUDA form is the third entry point of ``csrc/fused_hlt.cu``, with its own
counter, so the three paths can be told apart.
"""
from __future__ import annotations

import torch

from repro_torch.core import modmath as mm
from repro_torch.kernels import build

LAUNCHES = {"fused_hlt_indexed": 0, "fused_hlt": 0, "fused_hlt_batched": 0}


def fused_hlt_indexed_plain(digits, c0e, c1e, u, rk0, rk1, perms, is_id,
                            ct_slots, diag_slots, q32, qneg):
    B = ct_slots.shape[0]
    _, nbeta, M, N = digits.shape
    d = u.shape[1]
    out = torch.empty((2, B, M, N), dtype=torch.int32, device=digits.device)
    cts = ct_slots.tolist()
    dgs = diag_slots.tolist()
    ids = is_id[..., 0].tolist()
    for b in range(B):
        h, s = cts[b], dgs[b]
        dig, c0, c1 = digits[h], c0e[h], c1e[h]
        a0 = torch.zeros((M, N), dtype=torch.int32, device=digits.device)
        a1 = torch.zeros_like(a0)
        for r in range(d):
            if ids[s][r]:
                t0, t1 = c0, c1
            else:
                pm = perms[s, r].to(torch.int64)
                dig_rot = dig[..., pm]                       # Automorph
                k0 = mm.montsum(mm.montmul(dig_rot, rk0[s, r], q32, qneg),
                                q32, axis=0)                 # KeyIP
                k1 = mm.montsum(mm.montmul(dig_rot, rk1[s, r], q32, qneg),
                                q32, axis=0)
                t0 = mm.montadd(k0, c0[:, pm], q32)
                t1 = k1
            a0 = mm.montadd(a0, mm.montmul(u[s, r], t0, q32, qneg), q32)
            a1 = mm.montadd(a1, mm.montmul(u[s, r], t1, q32, qneg), q32)
        out[0, b] = a0
        out[1, b] = a1
    return out


def fused_hlt_indexed_cuda(digits, c0e, c1e, u, rk0, rk1, perms, is_id,
                           ct_slots, diag_slots, q32, qneg):
    H, nbeta, M, N = digits.shape
    S, d = u.shape[:2]
    B = ct_slots.shape[0]
    name = "fused_hlt_indexed"
    dev = digits.device
    build.check(name, digits, torch.int32)
    build.check_tables(name, dev, (c0e, (H, M, N)), (c1e, (H, M, N)),
                       (u, (S, d, M, N)), (rk0, (S, d, nbeta, M, N)),
                       (rk1, (S, d, nbeta, M, N)), (perms, (S, d, N)),
                       (is_id, (S, d, 1)), (ct_slots, (B,)),
                       (diag_slots, (B,)), (q32, (M, 1)), (qneg, (M, 1)))
    out = torch.empty((2, B, M, N), dtype=torch.int32, device=dev)
    build.call("fused_hlt_indexed_launch", digits, c0e, c1e, u, rk0, rk1,
               perms, is_id, ct_slots, diag_slots, q32, qneg, out, B, nbeta,
               M, N, d)
    LAUNCHES[name] += 1
    return out


def fused_hlt_plain(digits, c0e, c1e, u, rk0, rk1, perms, is_id, q32, qneg):
    zero = torch.zeros((1,), dtype=torch.int32, device=digits.device)
    return fused_hlt_indexed_plain(
        digits[None], c0e[None], c1e[None], u[None], rk0[None], rk1[None],
        perms[None], is_id[None], zero, zero, q32, qneg)[:, 0]


def fused_hlt_cuda(digits, c0e, c1e, u, rk0, rk1, perms, is_id, q32, qneg):
    nbeta, M, N = digits.shape
    d = u.shape[0]
    name = "fused_hlt"
    dev = digits.device
    build.check(name, digits, torch.int32)
    build.check_tables(name, dev, (c0e, (M, N)), (c1e, (M, N)),
                       (u, (d, M, N)), (rk0, (d, nbeta, M, N)),
                       (rk1, (d, nbeta, M, N)), (perms, (d, N)),
                       (is_id, (d, 1)), (q32, (M, 1)), (qneg, (M, 1)))
    out = torch.empty((2, M, N), dtype=torch.int32, device=dev)
    build.call("fused_hlt_launch", digits, c0e, c1e, u, rk0, rk1, perms,
               is_id, q32, qneg, out, nbeta, M, N, d)
    LAUNCHES[name] += 1
    return out


def fused_hlt_batched_plain(digits, c0e, c1e, u, rk0, rk1, perms, is_id, q32,
                            qneg):
    slots = torch.arange(digits.shape[0], dtype=torch.int32,
                         device=digits.device)
    return fused_hlt_indexed_plain(digits, c0e, c1e, u, rk0, rk1, perms,
                                   is_id, slots, slots, q32, qneg)


def fused_hlt_batched_cuda(digits, c0e, c1e, u, rk0, rk1, perms, is_id, q32,
                           qneg):
    B, nbeta, M, N = digits.shape
    d = u.shape[1]
    name = "fused_hlt_batched"
    dev = digits.device
    build.check(name, digits, torch.int32)
    build.check_tables(name, dev, (c0e, (B, M, N)), (c1e, (B, M, N)),
                       (u, (B, d, M, N)), (rk0, (B, d, nbeta, M, N)),
                       (rk1, (B, d, nbeta, M, N)), (perms, (B, d, N)),
                       (is_id, (B, d, 1)), (q32, (M, 1)), (qneg, (M, 1)))
    out = torch.empty((2, B, M, N), dtype=torch.int32, device=dev)
    build.call("fused_hlt_batched_launch", digits, c0e, c1e, u, rk0, rk1,
               perms, is_id, q32, qneg, out, B, nbeta, M, N, d)
    LAUNCHES[name] += 1
    return out
