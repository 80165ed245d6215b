#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its lines before the last:

1. build  — compile every CUDA kernel of ``src/repro_torch/csrc`` with nvcc
   (in parallel) and print the build time and the card's name and power
   limit;
2. kernels — call each of the eight kernel wrappers at the shapes the
   Set-B hemm 128×128×128 gives it (Step 1 and Step 2 of the batched and
   the unbatched program; the engine's NTT / iNTT at the rows one
   mult → rescale transforms, plus one call with a batch of 2) and hold
   its output array-equal (tolerance: exact, max_abs_err 0) against the
   plain PyTorch version on the same inputs; print the median CUDA-event
   time of both;
3. main — Set-B (logN 15, L 15, k 8, β 2), ``plan_hemm(128, 128, 128)``
   on ``CkksEngine(SET_B, datapath="pallas")``, keygen, encrypt,
   ``compile_hemm(schedule="pallas", rotation_chunk=1)``, a warm-up call,
   then the counted call (every kernel's launch counter is zeroed just
   before it and read just after, and must equal the path's expected
   counts) and a timed call; one more call with the engine on its
   ``"xla"`` lowering, array-equal; decrypt, require finite values of the
   right shape, and hold the product against numpy A·B within 0.05 once
   the reference algorithm's rescale bias is cancelled by the four sign
   combinations (±A, ±B); the raw max|C − A·B| and the fixed error are
   printed.  As a witness of that bias's cause, the same program with
   every floor division rounded (``round_divisions``, a diagnostic outside
   the port) must meet 0.05 unaided.  Then ``compile_hemm(...,
   batched=False)`` on the same keys and inputs: a counted call
   (``fused_hlt`` and ``baseconv_ntt`` instead of ``fused_hlt_indexed`` and
   ``hoist_db``) array-equal to the batched output, and a timed call;
4. cpu-vs-cuda — the ``fame-m-rt`` hemm on ``cuda`` and on ``cpu`` (plain
   versions), on both engine datapaths and both programs; all c0 and c1
   array-equal.

Then one line ``{"kernels": [...]}`` and, last, ``{"ok": true, "device":
{...}}``.  Any failure exits non-zero without the result line.  The script
imports nothing of JAX or of the ``repro`` package.
"""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time
import traceback

ROOT = pathlib.Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
INT32_OPS_PER_S = 67e12        # the data sheet's non-tensor 32-bit rate
TOL = 0.05                     # decrypted-product bound (the reference tests')


def log(*a):
    print(*a, flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


# ---------------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------------


def cuda_ms(fn, reps: int) -> float:
    """Median milliseconds of ``fn`` over ``reps`` CUDA-event-timed calls
    (after one warm-up call)."""
    import torch
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def bound(nbytes: float, nops: float) -> tuple:
    """(bound_ms, bound_by): the larger of bytes over HBM rate and 32-bit
    integer operations over the card's 32-bit rate."""
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, nops / INT32_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


MONTMUL_OPS = 4                # 32-bit multiplies per Montgomery product


def ntt_montmuls(N: int) -> int:
    return (N // 2) * (N.bit_length() - 1)


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def rand_residues(shape, q, gen):
    """Uniform residues mod the (M, 1) int32 column ``q`` broadcast along
    the limb axis (-2), made on the device."""
    import torch
    x = torch.randint(0, 1 << 30, shape, generator=gen, dtype=torch.int32,
                      device=q.device)
    return x % q


class KernelRecord:
    def __init__(self, name, source, replaces):
        self.name, self.source, self.replaces = name, source, replaces
        self.ms = self.plain_ms = 0.0
        self.nbytes = self.nops = 0.0
        self.max_abs_err = 0

    def add(self, label, kernel, plain, nbytes, nops, reps=5, plain_reps=1,
            weight=1):
        """Hold one call against its plain version and time both.
        ``weight`` is how many launches of this shape one hemm on the
        kernel's path makes; the record sums weight × (ms, plain ms, bytes,
        operations), one hemm's worth (0: checked and timed only)."""
        import torch
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        if got.shape != want.shape:
            raise AssertionError(f"{self.name} {label}: shape {tuple(got.shape)} "
                                 f"vs plain {tuple(want.shape)}")
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        self.max_abs_err = max(self.max_abs_err, err)
        if err != 0:
            raise AssertionError(f"{self.name} {label}: kernel differs from "
                                 f"its plain version (max_abs_err {err})")
        del got, want
        ms = cuda_ms(kernel, reps)
        pms = cuda_ms(plain, plain_reps)
        bms, by = bound(nbytes, nops)
        self.ms += weight * ms
        self.plain_ms += weight * pms
        self.nbytes += weight * nbytes
        self.nops += weight * nops
        log(f"[kernels] {self.name} {label}: equal to plain; {ms:.4f} ms "
            f"(plain {pms:.2f} ms, bound {bms:.4f} ms by {by}); "
            f"{weight} per hemm")

    def entry(self, launches: int) -> dict:
        bms, by = bound(self.nbytes, self.nops)
        return {"name": self.name, "route": "cuda", "source": self.source,
                "replaces": self.replaces, "launches": launches,
                "max_abs_err": self.max_abs_err, "ms": self.ms,
                "plain_ms": self.plain_ms, "bound_ms": bms, "bound_by": by,
                "library_ms": None}


def phase_kernels(eng, records, l: int):
    """Every kernel at the Set-B hemm 128^3 shapes: Step 1 and Step 2 of
    both programs, and the engine's transforms in one mult → rescale."""
    import numpy as np
    import torch
    from repro_torch.core import automorph
    from repro_torch.kernels import basechange as bc, fused_hlt as fh
    from repro_torch.kernels import ntt as kntt, ops

    p, dev = eng.params, eng.device
    N = p.N
    gen = torch.Generator(device=dev)
    gen.manual_seed(0xC0FFEE)
    steps = {1: dict(level=p.L, B=2), 2: dict(level=p.L - 1, B=2 * l)}

    for step, s in steps.items():
        level, B = s["level"], s["B"]
        full = eng.tools.digit_bases(level)[0][2]
        view = eng.basis(full)
        q_ext = view.moduli_u32
        M, nq = len(full), level + 1

        # -- hoist_db: the 2 unique ciphertexts of the step ---------------
        t = eng.fused_hoist_tables(level)
        c1s = rand_residues((2, nq, N), q_ext[:nq], gen)
        nbeta, alpha = t["nbeta"], t["alpha"]
        tabs = (t["psii_pad"], t["ninv_pad"], t["hat_pad"], t["q_pad"],
                t["qneg_pad"], t["w"], t["d"], t["inv_d"], t["psi_full"],
                t["q_full"], t["qneg_full"], t["mask"])
        kw = dict(nbeta=nbeta, alpha=alpha)
        # bytes: c1s read once, the nq iNTT twiddle rows, the M NTT twiddle
        # rows, the outputs written once; ops: the nq scaled iNTTs and, per
        # digit, the (M - na) generated limbs' BaseConv + NTT
        na = [min(alpha, nq - j * alpha) for j in range(nbeta)]
        hb = (2 * nq * N + nq * N + M * N + 2 * nbeta * M * N) * 4
        ho = MONTMUL_OPS * 2 * (nq * (ntt_montmuls(N) + 2 * N)
                                + sum((M - a) * (N * a + N + ntt_montmuls(N))
                                      for a in na))
        records["hoist_db"].add(
            f"step{step} B=2 nq={nq} M={M}",
            lambda: bc.hoist_db_cuda(c1s, *tabs, **kw),
            lambda: bc.hoist_db_plain(c1s, *tabs, **kw), hb, ho)

        # -- baseconv_ntt: the single hoist's second half; the unbatched
        #    program hoists 2 ciphertexts at each step's level ------------
        y = rand_residues((nbeta * alpha, N), t["q_pad"], gen)
        for j in range(nbeta):         # a short digit's rows are zero-padded
            y[j * alpha + na[j]:(j + 1) * alpha] = 0
        pt = rand_residues((M, N), q_ext, gen)
        btabs = (t["w"], t["d"], t["inv_d"], t["psi_full"], t["q_full"],
                 t["qneg_full"], pt, t["mask"])
        # bytes: the nq real y rows, the M twiddle rows, the nq own
        # passthrough rows, the outputs; ops: per digit the (M - na)
        # generated limbs' BaseConv + NTT
        records["baseconv_ntt"].add(
            f"step{step} nbeta={nbeta} alpha={alpha} M={M}",
            lambda: bc.baseconv_ntt_cuda(y, *btabs),
            lambda: bc.baseconv_ntt_plain(y, *btabs),
            (2 * nq * N + M * N + nbeta * M * N) * 4,
            MONTMUL_OPS * sum((M - a) * (N * a + N + ntt_montmuls(N))
                              for a in na), weight=2)
        del y, pt, btabs

        # -- merged ModDown: intt_scale + moddown_finish over 2·B polys ----
        mt = eng.fused_moddown_tables(level)
        P = 2 * B
        x_full = rand_residues((P, M, N), q_ext, gen)
        x_drop = x_full[:, mt["drop_idx"]]
        nd, R_out = x_drop.shape[1], mt["n_out"]
        itabs = (mt["psii_drop"], mt["ninv_drop"], mt["hat_drop"],
                 mt["q_drop"], mt["qneg_drop"])
        records["intt_scale"].add(
            f"step{step} P={P} rows={nd}",
            lambda: bc.intt_scale_cuda(x_drop, *itabs),
            lambda: bc.intt_scale_plain(x_drop, *itabs),
            (2 * P * nd * N + nd * N) * 4,
            MONTMUL_OPS * P * nd * (ntt_montmuls(N) + 2 * N))
        y = bc.intt_scale_cuda(x_drop, *itabs)
        x_out = x_full[:, :R_out]
        mtabs = (mt["w"], mt["d"], mt["inv_d"], mt["psi_out"], mt["p_inv"],
                 mt["q_out"], mt["qneg_out"])
        records["moddown_finish"].add(
            f"step{step} P={P} rows={R_out} nd={nd}",
            lambda: bc.moddown_finish_cuda(x_out, y, *mtabs),
            lambda: bc.moddown_finish_plain(x_out, y, *mtabs),
            (2 * P * R_out * N + P * nd * N + R_out * N) * 4,
            MONTMUL_OPS * P * R_out * (N * (nd + 2) + ntt_montmuls(N)))
        del x_full, x_drop, y, x_out

        # -- fused_hlt_indexed -------------------------------------------
        if step == 1:     # σ and τ: d = 255 each, real Galois permutations
            zsets = [tuple(128 * z for z in range(-127, 128)),
                     tuple(range(-127, 128))]
            ct_slots = [0, 1]
        else:             # 2·l = 256 sets of d = 2, off 2 hoisting products
            zsets = [(k % 128, k % 128 - 128) for k in range(256)]
            ct_slots = [0] * 128 + [1] * 128
        S, d, nbeta = len(zsets), len(zsets[0]), t["nbeta"]
        perms = torch.from_numpy(np.stack([np.stack([
            np.arange(N) if z == 0 else
            automorph.eval_perm(N, automorph.galois_elt_rot(z, N))
            for z in zs]) for zs in zsets]).astype(np.int32)).to(dev)
        is_id = torch.tensor([[[int(z == 0)] for z in zs] for zs in zsets],
                             dtype=torch.int32, device=dev)
        digits = rand_residues((2, nbeta, M, N), q_ext, gen)
        c0e = rand_residues((2, M, N), q_ext, gen)
        c1e = rand_residues((2, M, N), q_ext, gen)
        u = rand_residues((S, d, M, N), q_ext, gen)
        rk0 = rand_residues((S, d, nbeta, M, N), q_ext, gen)
        rk1 = rand_residues((S, d, nbeta, M, N), q_ext, gen)
        cts = torch.tensor(ct_slots, dtype=torch.int32, device=dev)
        dgs = torch.arange(S, dtype=torch.int32, device=dev)
        args = (digits, c0e, c1e, u, rk0, rk1, perms, is_id, cts, dgs,
                view.moduli_u32, view.qneg_inv)
        non_id = int(S * d - int(is_id.sum()))
        ids_per_b = [int(is_id[sl].sum()) for sl in range(S)]
        fb = (2 * (nbeta + 2) * M * N + S * d * M * N
              + non_id * (2 * nbeta * M * N + N) + S * d
              + 2 * B * M * N) * 4
        fo = MONTMUL_OPS * M * N * sum(
            (d - ids_per_b[sl]) * (2 * nbeta + 2) + ids_per_b[sl] * 2
            for sl in range(S))
        records["fused_hlt_indexed"].add(
            f"step{step} B={B} S={S} d={d} M={M}",
            lambda: fh.fused_hlt_indexed_cuda(*args),
            lambda: fh.fused_hlt_indexed_plain(*args), fb, fo, reps=3)

        # -- fused_hlt: one ciphertext and one diagonal set (slot 0 of each
        #    of the operands above); the unbatched program runs 2 at Step 1
        #    and 2·l at Step 2 -------------------------------------------
        one = (digits[0], c0e[0], c1e[0], u[0], rk0[0], rk1[0], perms[0],
               is_id[0], view.moduli_u32, view.qneg_inv)
        i0 = ids_per_b[0]
        records["fused_hlt"].add(
            f"step{step} d={d} M={M}",
            lambda: fh.fused_hlt_cuda(*one), lambda: fh.fused_hlt_plain(*one),
            ((nbeta + 2) * M * N + d * M * N
             + (d - i0) * (2 * nbeta * M * N + N) + d + 2 * M * N) * 4,
            MONTMUL_OPS * M * N * ((d - i0) * (2 * nbeta + 2) + i0 * 2),
            reps=3, weight=2 if step == 1 else 2 * l)
        del digits, c0e, c1e, u, rk0, rk1, perms, args, one
        torch.cuda.empty_cache()

    # -- ntt / intt: the engine's transforms in one mult → rescale at the
    #    products' level ℓ: per key-switch digit an iNTT of its own rows
    #    (a row slice of d2) and an NTT of the generated rows; per ModDown
    #    (2) an iNTT of the special rows (a row slice) and an NTT over
    #    Q_ℓ; per rescale (2) an iNTT of the last row and an NTT over
    #    Q_{ℓ-1}.  Weights: launches per hemm (l products).
    ell = p.L - 2
    spec = list(range(p.num_main, p.num_total))
    ext = list(range(ell + 1)) + spec
    xext = rand_residues((2, len(ext), N), eng.basis(ext).moduli_u32, gen)

    def rows(idx, B=1):
        """Input for the basis idx: a row slice of xext where idx is a run
        of ext, else fresh residues."""
        a = ext.index(idx[0])
        if ext[a:a + len(idx)] == list(idx):
            return xext[:B, a:a + len(idx)]
        return rand_residues((B, len(idx), N), eng.basis(idx).moduli_u32, gen)

    bases = eng.tools.digit_bases(ell)
    fwd = [(f"gen{j} ", gen_j, l) for j, (_, gen_j, _) in enumerate(bases)]
    fwd += [("Q_l ", list(range(ell + 1)), 2 * l),
            ("Q_l-1 ", list(range(ell)), 2 * l), ("ext B=2 ", ext, 0)]
    inv = [(f"own{j} ", list(own), l) for j, (own, _, _) in enumerate(bases)]
    inv += [("P ", spec, 2 * l), ("q_l ", [ell], 2 * l), ("ext B=2 ", ext, 0)]
    for name, cases in (("ntt", fwd), ("intt", inv)):
        for label, idx, weight in cases:
            v = eng.basis(idx)
            B = 2 if weight == 0 else 1
            x = rows(list(idx), B)
            if name == "ntt":
                tabs = (v.psi_brv_mont, v.moduli_u32, v.qneg_inv)
                kern, plain = kntt.ntt_cuda, kntt.ntt_plain
                nops = MONTMUL_OPS * B * len(idx) * ntt_montmuls(N)
            else:
                tabs = (v.psi_inv_brv_mont, v.n_inv_mont, v.moduli_u32,
                        v.qneg_inv)
                kern, plain = kntt.intt_cuda, kntt.intt_plain
                nops = MONTMUL_OPS * B * len(idx) * (ntt_montmuls(N) + N)
            records[name].add(
                f"level {ell} {label}rows={len(idx)}",
                lambda: kern(x, *tabs), lambda: plain(x, *tabs),
                (2 * B * len(idx) * N + len(idx) * N) * 4, nops,
                reps=20, plain_reps=3, weight=weight)
    ops.reset_launch_counts()


# ---------------------------------------------------------------------------
# phase 3: the main path at full size
# ---------------------------------------------------------------------------


def round_divisions(eng):
    """Diagnostic, not part of the port: make every floor division of an
    HEMMProgram round instead, by adding the polynomial whose every
    coefficient is ⌊D/2⌋ before the unchanged floor division by D, so that
    ⌊(x + ⌊D/2⌋)/D⌋ = round(x/D).  D is P·q_ℓ for the HLTs' merged
    ModDown+Rescale (the kernels) and q_ℓ for the product rescales.
    Returns a function that undoes the patch."""
    import math
    import torch
    from repro_torch.core import modmath as mm
    from repro_torch.core.ckks import Ciphertext
    from repro_torch.kernels import ops

    p, host = eng.params, eng.ctx.moduli_host
    spec = tuple(range(p.num_main, p.num_total))
    halves = {}

    def half(rows, D):
        """Eval-domain rows of the all-⌊D/2⌋ polynomial, and their moduli."""
        if (rows, D) not in halves:
            view = eng.basis(rows)
            coeff = torch.tensor([(D // 2) % host[i] for i in rows],
                                 dtype=torch.int32, device=eng.device)
            halves[rows, D] = (eng._ntt(coeff[:, None].expand(-1, p.N)
                                        .contiguous(), view), view.moduli)
        return halves[rows, D]

    floor_moddown, floor_rescale = ops.moddown_fused, eng.rescale

    def moddown_fused(x_full, t):
        level = x_full.shape[1] - p.k - 1
        h, q = half(tuple(range(level + 1)) + spec,
                    math.prod(host[i] for i in spec + (level,)))
        return floor_moddown(mm.addmod(x_full, h, q), t)

    def rescale(ct):
        h, q = half(tuple(range(ct.level + 1)), host[ct.level])
        return floor_rescale(Ciphertext(mm.addmod(ct.c0, h, q),
                                        mm.addmod(ct.c1, h, q), ct.level,
                                        ct.scale))

    ops.moddown_fused, eng.rescale = moddown_fused, rescale

    def undo():
        ops.moddown_fused = floor_moddown
        del eng.rescale
    return undo


def expected_launches(batched: bool, l: int) -> dict:
    """Kernel launches of one hemm call on each path (every other kernel
    of ``KERNELS`` launches 0 times)."""
    want = {k: 0 for k in KERNELS}
    want.update(ntt=6 * l, intt=6 * l)    # per product: 2 digits, 2 ModDowns,
    if batched:                           # 2 rescales × (iNTT + NTT)
        want.update(fused_hlt_indexed=2, hoist_db=2, intt_scale=2,
                    moddown_finish=2)
    else:   # 2 + 2·l single HLTs, 4 single hoists (Step 1, Step-2 hoist)
        want.update(fused_hlt=2 + 2 * l, baseconv_ntt=4,
                    intt_scale=4 + 2 + 2 * l, moddown_finish=2 + 2 * l)
    return want


STAGES = ["start", "step1", "step2_hoist", "step2", "mult_rescale"]


def staged_call(prog, ctA, ctB):
    """One program call with the device synchronised at each stage
    boundary; returns (output, {stage: ms})."""
    import torch
    marks = {}

    def hook(name):
        torch.cuda.synchronize()
        marks[name] = time.perf_counter()

    prog.stage_hook = hook
    try:
        out = prog(ctA, ctB)
    finally:
        prog.stage_hook = None
    stages = {k: (marks[k] - marks[STAGES[i]]) * 1e3
              for i, k in enumerate(STAGES[1:])}
    stages["hemm_total"] = (marks["mult_rescale"] - marks["start"]) * 1e3
    return out, stages


def counted_call(ctx, prog, ctA, ctB, batched: bool, l: int):
    """The path's counted call: every launch counter zeroed just before it
    and read just after, held against ``expected_launches``."""
    from repro_torch.kernels import ops
    h0 = ctx.counters["hlt_launches"]
    ops.reset_launch_counts()
    out, stages = staged_call(prog, ctA, ctB)
    launches = ops.launch_counts()
    hlts = ctx.counters["hlt_launches"] - h0
    want = expected_launches(batched, l)
    if launches != want or hlts != (2 if batched else 2 + 2 * l):
        raise AssertionError(f"{'batched' if batched else 'unbatched'} "
                             f"hemm launched {launches}, {hlts} HLTs; "
                             f"expected {want}")
    return out, stages, launches


def fmt(stages) -> str:
    return json.dumps({k: round(v, 3) for k, v in stages.items()})


def assert_ct_equal(a, b, what):
    import torch
    if not (torch.equal(a.c0, b.c0) and torch.equal(a.c1, b.c1)
            and a.level == b.level and a.scale == b.scale):
        raise AssertionError(f"{what}: ciphertexts differ")


def phase_main(params, shape):
    """Set-B hemm on the "pallas" engine: the batched program (counted,
    timed, once more on the "xla" engine, the four-sign and rounded-
    division checks), then the unbatched program on the same inputs.
    Returns the launch counts of each path's counted call."""
    import numpy as np
    import torch
    from repro_torch.core.ckks import CkksEngine
    from repro_torch.core.compile import HEContext, compile_hemm
    from repro_torch.core.hemm import decrypt_matrix, encrypt_matrix, plan_hemm

    m, l, n = shape
    rng = np.random.default_rng(20260)
    t0 = time.perf_counter()
    ctx = HEContext(CkksEngine(params, datapath="pallas"))
    plan = plan_hemm(ctx.eng, m, l, n)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    ctx.keygen(rng, rot_steps=plan.rot_steps)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    A = rng.uniform(-1, 1, (m, l))
    B = rng.uniform(-1, 1, (l, n))
    ctA = encrypt_matrix(ctx.eng, ctx.keys, A, rng)
    ctB = encrypt_matrix(ctx.eng, ctx.keys, B, rng)
    prog = compile_hemm(ctx, plan, schedule="pallas", rotation_chunk=1)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    log(f"[main] {params.name} hemm {m}x{l}x{n} on CkksEngine(datapath="
        f"\"pallas\"): plan {t1 - t0:.1f} s ({plan.total_rotations} "
        f"rotations), keygen {t2 - t1:.1f} s ({len(ctx.keys.galois)} Galois "
        f"keys), encrypt+compile {t3 - t2:.1f} s; arena "
        f"{ctx.arena.nbytes / 1e9:.2f} GB, step1 d={prog.plan.step1.d[0]} "
        f"d_pad={prog.plan.step1.d_pad}, step2 B={prog.plan.step2.batch}")

    prog(ctA, ctB)                                  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ctC, stages, launches = counted_call(ctx, prog, ctA, ctB, True, l)
    log(f"[main] batched counted call: launches {json.dumps(launches)}; "
        f"stage ms {fmt(stages)}")
    peak = torch.cuda.max_memory_allocated()
    _, st = staged_call(prog, ctA, ctB)
    log(f"[main] batched timed call: stage ms {fmt(st)}")
    # the same program with the engine's transforms on the plain int64 NTT
    ctx.eng.datapath = "xla"
    try:
        ctX, st = staged_call(prog, ctA, ctB)
    finally:
        ctx.eng.datapath = "pallas"
    assert_ct_equal(ctC, ctX, "batched hemm, \"pallas\" vs \"xla\" engine")
    log(f"[main] batched call on the \"xla\" engine: c0, c1 array-equal to "
        f"the \"pallas\" engine's; stage ms {fmt(st)}")
    # The reference's ModDown/Rescale divide by floor ((x - [x]_P)/P): a
    # -1/2 bias per coefficient that, at N = 2^15, lands in the few slots
    # whose root lies near ±1 (|Σ ζ^i| ≈ 2N/π) and adds up over the l
    # product rescales.  With a stage bias b, each product is (x + b1)·
    # (y + b2) + b3: the four sign combinations of the inputs cancel every
    # bias term in C(A,B) - C(-A,B) - C(A,-B) + C(-A,-B) = 4·A·B, which
    # must agree within the reference tests' tolerance; their mean is the
    # program's fixed (data-independent) error.
    ctnA = encrypt_matrix(ctx.eng, ctx.keys, -A, rng)
    ctnB = encrypt_matrix(ctx.eng, ctx.keys, -B, rng)
    outs = {"++": ctC, "-+": prog(ctnA, ctB), "+-": prog(ctA, ctnB),
            "--": prog(ctnA, ctnB)}
    dec = {}
    for k, ct in outs.items():
        v = decrypt_matrix(ctx.eng, ctx.keys, ct, m, n)
        if v.shape != (m, n) or not np.all(np.isfinite(v)):
            raise AssertionError(f"decrypted C({k}) is not finite / mis-shaped")
        dec[k] = v
    raw = np.abs(dec["++"] - A @ B)
    fixed = (dec["++"] + dec["-+"] + dec["+-"] + dec["--"]) / 4
    prod = (dec["++"] - dec["-+"] - dec["+-"] + dec["--"]) / 4
    err = float(np.abs(prod - A @ B).max())
    worst = np.unravel_index(int(raw.argmax()), raw.shape)
    log(f"[main] max|C - A·B| = {raw.max():.3e} at {tuple(map(int, worst))} "
        f"(entries > {TOL}: {int((raw > TOL).sum())} of {raw.size}; mean "
        f"{raw.mean():.3e}); fixed error: max {np.abs(fixed).max():.3e}, "
        f"there {fixed[worst]:+.3e}")
    log(f"[main] sign-combined max|C - A·B| = {err:.3e} (limit {TOL}); "
        f"output level {ctC.level}; peak device memory {peak / 1e9:.2f} GB")
    if not err <= TOL:
        raise AssertionError(f"decrypted product off by {err}")
    # Witness for the cause: the same program, the same inputs, with each
    # floor division made a rounded one, must meet the bound unaided.
    undo = round_divisions(ctx.eng)
    try:
        ctR = prog(ctA, ctB)
    finally:
        undo()
    vr = decrypt_matrix(ctx.eng, ctx.keys, ctR, m, n)
    rerr = np.abs(vr - A @ B)
    log(f"[main] rounded divisions: max|C - A·B| = {rerr.max():.3e} (limit "
        f"{TOL}); there {rerr[worst]:.3e}; entries > {TOL}: "
        f"{int((rerr > TOL).sum())}")
    if not rerr.max() <= TOL:
        raise AssertionError(f"rounded-division product off by {rerr.max()}")

    # the unbatched program: 2 + 2·l single HLTs on the same keys and inputs
    del prog, outs, ctX, ctR
    ctx.invalidate()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    uprog = compile_hemm(ctx, plan, schedule="pallas", rotation_chunk=1,
                         batched=False)
    torch.cuda.synchronize()
    log(f"[main] unbatched compile {time.perf_counter() - t0:.1f} s; arena "
        f"{ctx.arena.nbytes / 1e9:.2f} GB")
    ctU, stages, ulaunches = counted_call(ctx, uprog, ctA, ctB, False, l)
    assert_ct_equal(ctC, ctU, "unbatched vs batched hemm")
    log(f"[main] unbatched counted call: array-equal to the batched "
        f"program's output; launches {json.dumps(ulaunches)}; stage ms "
        f"{fmt(stages)}")
    _, st = staged_call(uprog, ctA, ctB)
    log(f"[main] unbatched timed call: stage ms {fmt(st)}")
    return launches, ulaunches


# ---------------------------------------------------------------------------
# phase 4: whole program on the kernels vs on the plain versions
# ---------------------------------------------------------------------------


def phase_cpu_vs_cuda():
    """fame-m-rt hemm 4×4×4 on cuda and on cpu, on both engine datapaths
    and both programs: all eight outputs array-equal."""
    import numpy as np
    from repro_torch.configs.fame_sets import FAME_VERIFY_SETS
    from repro_torch.core.ckks import CkksEngine
    from repro_torch.core.compile import HEContext, compile_hemm
    from repro_torch.core.hemm import decrypt_matrix, encrypt_matrix, plan_hemm
    from repro_torch.core.params import u32_numpy

    params = FAME_VERIFY_SETS["fame-m-rt"]
    m, l, n = 4, 4, 4
    outs = {}
    for dev in ("cuda", "cpu"):
        for dp in ("pallas", "xla"):
            rng = np.random.default_rng(9)
            ctx = HEContext(CkksEngine(params, device=dev, datapath=dp))
            plan = plan_hemm(ctx.eng, m, l, n)
            ctx.keygen(rng, rot_steps=plan.rot_steps)
            A = rng.uniform(-1, 1, (m, l))
            B = rng.uniform(-1, 1, (l, n))
            ctA = encrypt_matrix(ctx.eng, ctx.keys, A, rng)
            ctB = encrypt_matrix(ctx.eng, ctx.keys, B, rng)
            for batched in (True, False):
                ctC = compile_hemm(ctx, plan, schedule="pallas",
                                   rotation_chunk=2, batched=batched)(ctA, ctB)
                err = float(np.abs(decrypt_matrix(ctx.eng, ctx.keys, ctC, m, n)
                                   - A @ B).max())
                outs[dev, dp, batched] = (u32_numpy(ctC.c0), u32_numpy(ctC.c1),
                                          ctC.level, ctC.scale, err)
    first, want = next(iter(outs.items()))
    for key, got in outs.items():
        for i, part in enumerate(("c0", "c1")):
            np.testing.assert_array_equal(got[i], want[i],
                                          err_msg=f"fame-m-rt {part} {key} "
                                          f"vs {first}")
        if got[2:4] != want[2:4] or not got[4] <= TOL:
            raise AssertionError(f"fame-m-rt {key}: {got[2:]} vs {want[2:]}")
    log(f"[cpu-vs-cuda] fame-m-rt hemm 4x4x4: c0, c1 array-equal over "
        f"{{cuda, cpu}} x {{pallas, xla}} engine x {{batched, unbatched}} "
        f"({len(outs)} runs); max|C - A·B| = {want[4]:.3e}")


# ---------------------------------------------------------------------------


KERNELS = {
    "fused_hlt_indexed": ("src/repro_torch/csrc/fused_hlt.cu",
                          "src/repro/kernels/fused_hlt.py:222"),
    "hoist_db": ("src/repro_torch/csrc/hoist.cu",
                 "src/repro/kernels/basechange.py:223"),
    "intt_scale": ("src/repro_torch/csrc/intt_scale.cu",
                   "src/repro/kernels/basechange.py:63"),
    "moddown_finish": ("src/repro_torch/csrc/moddown.cu",
                       "src/repro/kernels/basechange.py:143"),
    "fused_hlt": ("src/repro_torch/csrc/fused_hlt.cu",
                  "src/repro/kernels/fused_hlt.py:108"),
    "baseconv_ntt": ("src/repro_torch/csrc/hoist.cu",
                     "src/repro/kernels/basechange.py:98"),
    "ntt": ("src/repro_torch/csrc/ntt.cu", "src/repro/kernels/ntt.py:38"),
    "intt": ("src/repro_torch/csrc/ntt.cu", "src/repro/kernels/ntt.py:56"),
}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs the port on a GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs.fame_sets import MM_BENCHMARKS
    from repro_torch.core.ckks import CkksEngine
    from repro_torch.core.params import SET_B
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    build.load()
    log(f"[build] {len(build.SIGNATURES)} kernels from "
        f"{len(list(build.CSRC.glob('*.cu')))} sources in "
        f"{time.perf_counter() - t0:.1f} s")
    for stem, out in build.BUILD_LOG.items():
        if isinstance(out, str):
            usage = [ln.split(":", 1)[-1].strip() for ln in out.splitlines()
                     if "registers" in ln or "spill" in ln]
            log(f"[build] {stem}.cu ptxas: {'; '.join(usage)}")
    smi = nvidia_smi()
    log(f"[build] card: {torch.cuda.get_device_name(0)}; torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")

    shape = MM_BENCHMARKS["set-b"]["type-iv"]
    records = {name: KernelRecord(name, *src) for name, src in KERNELS.items()}
    t0 = time.perf_counter()
    phase_kernels(CkksEngine(SET_B), records, shape[1])
    torch.cuda.empty_cache()
    log(f"[kernels] phase {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    batched, unbatched = phase_main(SET_B, shape)
    # each kernel's launches come from the counted call of the path that
    # runs it (ntt / intt: the batched main path; both paths run 6·l)
    launches = {k: batched[k] or unbatched[k] for k in KERNELS}
    torch.cuda.empty_cache()
    log(f"[main] phase {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    phase_cpu_vs_cuda()
    log(f"[cpu-vs-cuda] phase {time.perf_counter() - t0:.1f} s")

    print(json.dumps({"kernels": [r.entry(launches[name])
                                  for name, r in records.items()]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    except Exception:
        traceback.print_exc()
        rc = 1
    sys.exit(rc)
