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

The kernel (one device body behind the three entry points) gives each
block an output tile of :func:`tile_size` coefficients and a group of
:func:`limb_group` limbs.  A Galois permutation in bit-reversed evaluation
order maps every aligned output tile onto one aligned source tile; for
such a rotation the block copies that source tile of the digit and c0 rows
to shared memory and gathers there ("staged"), for any other permutation
it gathers from device memory.  :func:`fused_hlt_tiled_plain` (tests only)
runs that indexing in torch and counts the paths as the kernel does; set
:data:`PATHS` to count them on the card.
"""
from __future__ import annotations

import torch

from repro_torch.core import modmath as mm
from repro_torch.kernels import build

LAUNCHES = {"fused_hlt_indexed": 0, "fused_hlt": 0, "fused_hlt_batched": 0}

#: None, or an int32 CUDA tensor of 3 to which every launch of the three
#: kernels adds its (block, rotation) pairs that took the staged gather,
#: the device-memory gather and the identity bypass
PATHS = None

#: largest output tile a block owns
MAX_TILE = 256


def tile_size(N: int) -> int:
    return min(MAX_TILE, N)


def limb_group(M: int, d: int) -> int:
    """Limbs g a block of the kernel serves at M limbs and d rotations: 2
    where a block loops over many rotations, 1 where it runs a few and a
    smaller shared-memory stage lets more short-lived blocks share an SM
    (measured at the Set-B hemm's Step 1, d = 255, and Step 2, d = 2:
    PERF.md §6).  The kernel takes 1 … 8 (512 threads at a tile of 256)."""
    return min(2 if d > 4 else 1, M)


def stage_rows(nbeta: int) -> int:
    """Rows of T words one stage of the kernel's ring holds a limb: the β
    digit rows and c0 of the source tile, the diagonal, the 2β key rows
    (``csrc/fused_hlt.cu`` ``stage_rows``)."""
    return 3 * nbeta + 2


def smem_bytes(nbeta: int, N: int, g: int) -> int:
    """Dynamic shared memory one block of the three kernels allocates: two
    stages of g limbs × ``stage_rows(β)`` rows of T words, then three
    permutation rows of T (``csrc/fused_hlt.cu`` ``launch``).  It takes
    the place of the TPU kernel's VMEM ``working_set_rows``; it does not
    depend on d, since a block loops over every rotation."""
    return 4 * (2 * g * stage_rows(nbeta) + 3) * tile_size(N)


def tile_sources(perms, T: int):
    """perms (..., N) -> (..., N/T) int64: for each aligned output tile of
    T positions, the one aligned source tile all its positions come from,
    or -1 where they come from more than one (the kernel's vote)."""
    src = perms.to(torch.int64).reshape(*perms.shape[:-1], -1, T) // T
    one = (src == src[..., :1]).all(dim=-1)
    return torch.where(one, src[..., 0], torch.full_like(src[..., 0], -1))


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


def fused_hlt_tiled_plain(digits, c0e, c1e, u, rk0, rk1, perms, is_id,
                          ct_slots, diag_slots, q32, qneg, T=None, g=None):
    """``fused_hlt_indexed`` with the kernel's indexing (tests only): for
    each batch element, group of g limbs and output tile of T positions,
    every rotation either bypasses (is_id), gathers from the staged source
    tile at pm mod T (when the tile's positions all lie in one source
    tile) or gathers from the whole row.  Returns (out, [staged, gathered,
    identity]) with the paths counted per (block, rotation) as the
    kernel's ``paths``."""
    B = ct_slots.shape[0]
    _, nbeta, M, N = digits.shape
    d = u.shape[1]
    T = T or tile_size(N)
    g = g or limb_group(M, d)
    out = torch.empty((2, B, M, N), dtype=torch.int32, device=digits.device)
    paths = [0, 0, 0]
    cts, dgs = ct_slots.tolist(), diag_slots.tolist()
    ids = is_id[..., 0].tolist()
    srcs = tile_sources(perms, T).tolist()
    for b in range(B):
        h, s = cts[b], dgs[b]
        for l0 in range(0, M, g):
            lim = slice(l0, min(M, l0 + g))
            q, qn = q32[lim], qneg[lim]
            dig, c0, c1 = digits[h][:, lim], c0e[h][lim], c1e[h][lim]
            for tile in range(N // T):
                j = slice(tile * T, (tile + 1) * T)
                a0 = torch.zeros_like(c0[:, j])
                a1 = torch.zeros_like(a0)
                for r in range(d):
                    t_src = srcs[s][r][tile]
                    if ids[s][r]:
                        paths[2] += 1
                        t0, t1 = c0[:, j], c1[:, j]
                    else:
                        pm = perms[s, r, j].to(torch.int64)
                        if t_src >= 0:                  # the staged tile
                            paths[0] += 1
                            src = slice(t_src * T, (t_src + 1) * T)
                            dg = dig[..., src][..., pm % T]
                            c0g = c0[:, src][:, pm % T]
                        else:                           # the whole row
                            paths[1] += 1
                            dg, c0g = dig[..., pm], c0[:, pm]
                        rk = (rk0[s, r][:, lim, j], rk1[s, r][:, lim, j])
                        k0, k1 = (mm.montsum(mm.montmul(dg, k, q, qn), q,
                                             axis=0) for k in rk)
                        t0, t1 = mm.montadd(k0, c0g, q), k1
                    ur = u[s, r][lim, j]
                    a0 = mm.montadd(a0, mm.montmul(ur, t0, q, qn), q)
                    a1 = mm.montadd(a1, mm.montmul(ur, t1, q, qn), q)
                out[0, b, lim, j] = a0
                out[1, b, lim, j] = a1
    return out, paths


def _check_vectors(name, N, *tensors):
    """The kernel moves 4 coefficients a thread in 16-byte accesses."""
    if N % 4 != 0 or any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{name}: N = {N} or an operand's address is not "
                         f"16-byte aligned, as the kernel's loads need")


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
    _check_vectors(name, N, digits, c0e, c1e, u, rk0, rk1, perms)
    out = torch.empty((2, B, M, N), dtype=torch.int32, device=dev)
    build.call("fused_hlt_indexed_launch", digits, c0e, c1e, u, rk0, rk1,
               perms, is_id, ct_slots, diag_slots, q32, qneg, out, B, nbeta,
               M, N, d, limb_group(M, d), PATHS)
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
    _check_vectors(name, N, digits, c0e, c1e, u, rk0, rk1, perms)
    out = torch.empty((2, M, N), dtype=torch.int32, device=dev)
    build.call("fused_hlt_launch", digits, c0e, c1e, u, rk0, rk1, perms,
               is_id, q32, qneg, out, nbeta, M, N, d, limb_group(M, d), PATHS)
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
    _check_vectors(name, N, digits, c0e, c1e, u, rk0, rk1, perms)
    out = torch.empty((2, B, M, N), dtype=torch.int32, device=dev)
    build.call("fused_hlt_batched_launch", digits, c0e, c1e, u, rk0, rk1,
               perms, is_id, q32, qneg, out, B, nbeta, M, N, d,
               limb_group(M, d), PATHS)
    LAUNCHES[name] += 1
    return out
