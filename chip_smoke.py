#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its lines before the last:

1. build  — compile every CUDA kernel of ``src/repro_torch/csrc`` with nvcc
   (in parallel) and print the build time and the card's name and power
   limit;
2. kernels — call each of the twelve kernel wrappers at the shapes the
   Set-B hemm 128×128×128 gives it (Step 1 and Step 2 of the batched and
   the unbatched program; the engine's NTT / iNTT at the rows one
   mult → rescale transforms, plus one call with a batch of 2;
   ``fused_hlt_batched`` on the Step-1 and Step-2 indexed operands
   gathered per batch element, also held equal to ``fused_hlt_indexed``;
   ``modmul`` / ``modadd`` at the Step-1 extended basis and the level-15
   main basis; ``baseconv`` at one digit's ModUp and the merged ModDown at
   level 15, with a count of the residues where its float32 correction
   differs from the float64 oracle ``kernels/ref.py`` ``baseconv_ref``,
   printed as a finding; also, weight 0, at Set-C's ModUp 11 -> 33 and
   merged ModDown 13 -> 31 at N = 2^16, the 3 -> 4 case at N = 1001 and
   1004, and |S| = 44 -> 4; beside it the launch floor, a one-element
   in-place ``add_`` timed as the kernels are) and hold its output
   array-equal (tolerance:
   exact, max_abs_err 0) against the plain PyTorch version on the same
   inputs; print the median CUDA-event time of both.  The fused HLT
   kernels also run on random permutations (the device-memory gather,
   weight 0) beside the Galois tables (the staged source tile), with the
   (block, rotation) pairs of each path counted on the card and held
   against ``tile_sources``; ``intt_scale`` reads the merged ModDown's
   drop rows through its row table, and the Step-2 merged ModDown is timed
   against the gather it replaced; ``moddown_finish`` also at the
   unbatched shape (2 polynomials, weight 0: 258 launches of the unbatched
   hemm); ``ntt``/``intt``, ``moddown_finish``, ``intt_scale``,
   ``hoist_db`` and ``baseconv_ntt`` on Set-C rows (logN 16, weight 0)
   and at every cluster size 1-16 on Set-A rows; then the cluster sizes
   4, 8, 16 of ``moddown_finish`` and ``intt_scale`` at the Set-B Step-1,
   Step-2 and unbatched shapes (with ``intt`` alone over the same rows),
   of the hoist's BaseConv + NTT at Step 1 and the Step-2 hoist, and the
   limb groups 1, 2, 4, 8 of ``fused_hlt_indexed`` at Step 1 and Step 2,
   each checked and timed, and the Step-2 ``moddown_finish`` with one drop
   row and ``ntt`` alone over its rows;
   then the kernel API (``repro_torch.kernels.ops``, the path of
   ``modmul``, ``modadd``, ``baseconv`` and ``fused_hlt_batched``, as the
   reference's benchmarks call it): one counted run at those shapes, every
   counter zeroed just before it and read just after, each output held
   against the ``kernels/ref.py`` oracles;
3. main — Set-B (logN 15, L 15, k 8, β 2), ``plan_hemm(128, 128, 128)``
   on ``CkksEngine(SET_B, datapath="pallas")``, keygen, encrypt,
   ``compile_hemm(schedule="pallas", rotation_chunk=1)``, a warm-up call,
   then the counted call (every kernel's launch counter is zeroed just
   before it and read just after, and must equal the path's expected
   counts, and every non-identity rotation of the fused HLT kernels must
   take the staged source tile) and a timed call; one more call with the
   engine on its
   ``"xla"`` lowering, array-equal; decrypt, require finite values of the
   right shape, and hold the product against numpy A·B within 0.05 once
   the reference algorithm's rescale bias is cancelled by the four sign
   combinations (±A, ±B); the raw max|C − A·B| and the fixed error are
   printed.  As a witness of that bias's cause, the same program with
   every floor division rounded (``round_divisions``, a diagnostic outside
   the port) must meet 0.05 unaided.  Then ``compile_hemm(...,
   batched=False)`` on the same keys and inputs: a counted call
   (``fused_hlt`` and ``baseconv_ntt`` instead of ``fused_hlt_indexed`` and
   ``hoist_db``) array-equal to the batched output, and a timed call.
   Then the reference schedules at Set-B: the Step-1 σ HLT (d = 255,
   level 15) on ``mo`` and ``hoisted`` array-equal to the ``pallas``
   single and batched results, ``baseline`` within 1e-2 of ``hoisted``
   after decrypt (its maximum difference printed), the hoist's chain form
   against the fused hoist; and, with the engine on ``"xla"`` and
   ``HEContext(datapath="xla")`` over the same keys, the whole hemm on
   ``mo``, twice, with no kernel launch over either call: with the fused
   kernels' BaseConv epsilon over Steps 1–2 (``fused_eps``) array-equal to
   the batched ``pallas`` hemm, and with the reference's own chain
   epsilon its differing residues counted and its decrypted output within
   0.05 of the ``pallas`` hemm's; stage times printed for each.  And the
   cost model's compile of the same product, ``compile_hemm(ctx, plan)``
   with no schedule and no chunk: it must pick ``"pallas"``, batched, with
   d_pad = d, and be array-equal to the explicit program;
3b. blockmm — Set-B block MM through ``SecureMatmulEngine(SET_B,
   tile=64)`` (no schedule, no chunk) on ``CkksEngine(SET_B,
   datapath="pallas")``: A (100×120) · B (120×70), a ragged (2, 2, 2)
   grid of 64×64 tiles, l = 64, 512 products.  The cost model must pick
   ``"pallas"`` with d_pad = d and the ``BlockMMPlan`` report 2 HLT
   launches.  The counted call (launches as ``expected_launches`` for 512
   products, gather paths as ``tile_sources`` predicts) and a timed call
   through ``stage_hook``; the sequential loop (``batched=False``, 8
   unbatched tile hemms on ``fused_hlt`` / ``baseconv_ntt``, its launches
   counted too) array-equal to the batched output; the four-sign check
   (within 0.05 of A·B) with the raw error; one call with ``a_slots``
   aliasing a repeated A tile object array-equal to the unhinted call,
   its plan one hoisting product a stage lighter; peak device memory;
3c. set-c — Set-C (logN 16, L 31, k 12, β 3, unreduced), ``plan_hemm(32,
   32, 32)`` on ``CkksEngine(SET_C, datapath="pallas")``: keygen, the
   batched counted call (launches as ``expected_launches``, the gather
   paths as ``tile_sources`` predicts) and a timed call, the four-sign
   check, the unbatched program array-equal to the batched one, and the
   Step-1 σ HLT on ``mo`` with the engine and context on ``"xla"`` and the
   fused epsilon (no kernel launch) array-equal to the ``pallas`` one; the
   raw error, peak device memory and stage times printed;
3d. chain — Set-B, ``plan_hemm_chain(eng, (128,) * 5)``: a chain
   Y = X·W1·W2·W3 of three hemm 128³ hops at input levels 15, 12, 9 (an
   MLP block's depth; ``max_chain_depth`` at level 15, printed, is 5) on
   ``CkksEngine(SET_B, datapath="pallas")`` with
   ``HEContext(verify="error")``.  X and the weights come from a numpy
   seed, the weights with entries of standard deviation 1/√l.  First
   every kernel the later hops launch, at their own shapes, array-equal
   to its plain version on random residues (``chain_kernels``: the
   hoists, merged ModDowns and rotation kernels at levels 12, 11, 9 and
   8 — among them the one-prime Step-2 digit and the 17-limb ModDown of
   hop 3 — and the products' ntt / intt at levels 10 and 7, the
   single-digit key switch).  Keygen over ``chain.rot_steps``, ``compile_hemm_chain`` with no schedule (the
   cost model must pick ``("pallas",) * 3``), a warm-up call, then the
   counted call (launches as ``expected_launches`` summed over the hops,
   each with the key-switch digits at its products' level: 2, 2, 1;
   6 HLT and 4 program launches; the gather paths as ``tile_sources``
   predicts; no decrypt inside the call; every hop's (level, scale)
   equal to ``plan.hop_out``) with its peak device memory, and a timed
   call with each hop's stage times; the same chain with every hop
   unbatched (``fused_hlt`` / ``baseconv_ntt``, counted too) array-equal
   hop by hop; the decrypted output against numpy X·W1·W2·W3 within 0.05
   once the reference's rescale bias is cancelled by the call on −X with
   the same weight ciphertexts, the raw error printed; a 6-hop chain
   (level 18 needed) refused with ``VerificationError`` (LS001/LS003
   only) under ``"error"`` and ``ValueError`` under ``"warn"``, the
   arena, memo, counters and launches unchanged.  Phases 3, 3b, 3c, 3d
   and 3e each run ``verify_program`` on their programs: no
   error-severity diagnostic;
3e. serve — multi-tenant secure serving at Set-B through
   ``build_secure_serving`` (``ModelConfig(secure_layers=(0,))``, W0
   128×128 from a numpy seed with entries of standard deviation 1/√128,
   tile 64, ``he_max_sessions=2``, ``verify="error"``), on the pool's
   ``CkksEngine(SET_B, datapath="pallas")``.  Tenants A and B each
   submit 3 requests a step, two of them sharing a prompt: two groups,
   each a (3, 2, 2) block MM of 768 products.  Step 1 compiles; step 2
   (the rows negated) hits the program cache, and (y(x) − y(−x))/2 must
   be within 0.05 of x·W0 (the raw error printed); step 3 (B and C)
   creates tenant C; step 4 (B and C) evicts A, the coldest arena; step 5
   (A and B) recompiles A with its keys kept; step 6 runs A's requests of
   step 5 again on the same ciphertexts with one program per request
   (C evicted).  Every step's launches, cache hits / misses / stale drops
   and arena evictions are checked against the LRU policy's prediction,
   each all-hit step's program stage against ``expected_launches``, the
   batched rows array-equal to the per-request ones and to a loop of
   unbatched tile hemms (``SecureMatmulEngine.matmul_encrypted``) on the
   same ciphertexts, and one of A's result tiles must not decrypt under
   B's keys.  Printed: each flush's stage times (sessions, then encrypt /
   program / decrypt a group), its peak device memory, and the memory
   allocated and ``pool.live_arena_bytes`` around each eviction;
3f. lm — the dense LM serving path on ``internlm2-1.8b`` at full width
   (24 layers, d 2048, 16 heads, 8 KV heads, d_ff 8192, vocab 92544,
   bf16; random weights from a seeded generator on the card).  First
   ``repro_torch.launch.serve``'s ``main`` (4 requests of 8 new tokens,
   4 slots), each prefill and decode step timed, then prefill of 16
   tokens + 2 decode steps (batch 2) against one ``forward`` within the
   reference test's 6e-2.  Then layer 0 served under HE at Set-B:
   ``build_secure_serving`` (W0 2048 × 64 from a numpy seed, x·W0 of
   standard deviation 10 for an embedding row x, tile 64,
   ``verify="error"``) behind ``ContinuousBatcher(ServeConfig(max_batch=2,
   max_len=64, he_tile=64))``; three requests (tenants A, B, A) of 2
   tokens: steps 1–2 flush one (1, 32, 1) group of 2048 products a
   tenant (4096 Step-2 HLTs in the 6 chunks of
   ``costmodel.step2_chunk``; no allocator setting), steps 3–4 A's
   second request on A's cached program.  Checked:
   each step's program launches = groups = tenants in flight, cache hits
   and misses, step 2's groups' program stage against
   ``expected_launches`` for 2048 products and the chunks, the tokens equal to a
   plaintext ``ContinuousBatcher`` run of the same prompts, step 1's rows
   against the same rows on −x ((y(x) − y(−x))/2 within 5 % of
   max|x·W0|; the raw error printed), step 3's row array-equal to a loop
   of 32 unbatched tile hemms on the same ciphertexts; each flush's stage
   times and peak device memory printed;
3g. families — the other model families at full width, random weights
   from a seeded generator on the card.  ``granite-moe-3b-a800m`` (moe:
   32 layers, d 1536, 24 / 8 heads, 40 experts top-8, d_ff 512, vocab
   49155, bf16) through ``launch/serve.py``'s ``main`` as in 3f, prefill +
   2 decode steps against ``forward`` (dropless, capacity factor E/k: at
   the config's 1.25 the drops depend on the group, and that gap is
   printed), then layer 0 under HE at Set-B as in 3f (W0 1536 × 64) for
   one tenant: step 1 compiles, step 2 hits, each a (1, 24, 1) group of
   1536 products whose 3072 Step-2 HLTs run in 5 chunks; the same checks
   but the loop.  Then ``mamba2-780m`` (ssm), ``zamba2-2.7b`` (hybrid)
   and ``musicgen-large`` (audio, also on random frame embeddings through
   ``serve_prefill_step`` / ``serve_decode_step``) through ``main`` and
   the forward check;
3h. train — ``repro_torch.launch.train``'s ``main`` on ``internlm2-1.8b``
   at full width (bf16, remat on, seeded random weights on the card): 6
   steps of global batch 4 × 512 tokens with the launcher's optimizer
   (AdamW, lr 1e-3 after 20 warm-up steps), every kernel counter zeroed
   before and read after (the training path launches none: the
   reference's LM is plain ``jnp``); every step's loss and grad norm
   finite, its lr equal to ``lr_at``, the bf16 parameters equal to their
   float32 master cast to bf16; the loss curve, ms a step (CUDA events
   around each train step, the median after the first), tokens/s and
   ``max_memory_allocated`` printed.  Then 2 steps with 2 microbatches,
   whose first loss must be within 1e-3 of one batch's; no checkpoint
   at full width (≈ 30 GB).  Then the smoke config on the card under
   deterministic algorithms: 4 steps with a checkpoint every 2, a resume
   to step 6 (its line printed), the state and metrics equal to 6
   uninterrupted steps;
3i. sharded — the multi-device HE schedule on ranks that time-share the
   card (``repro_torch.launch.mesh.spawn``, gloo on ``cuda:0``; the parent
   frees its memory first and the ranks load the kernels it built).  Two
   ranks (data 1 × model 2): phase 3's Set-B hemm 128³ from phase 3's
   seed on ``schedule="sharded"`` under ``verify="error"`` (the census
   admits each HLT: 2 all-reduces, no other collective, no host sync, no
   int64 NTT), a warm-up, a counted call (kernel launches, the
   collectives' calls and bytes beside ``plan.collective_bytes``,
   ``max_memory_allocated``, stage ms) and a timed call; every rank's
   output array-equal to phase 3's one-device ``"pallas"`` output (so its
   decrypt is phase 3's), then ``"sharded_xla"`` array-equal to it, and a
   toy program whose body reads a value back to the host refused with
   JX003.  Four ranks (data 2 × model 2): a Set-B hemm 32³ and a σ/τ/σ
   HLT batch of 3 (padded to the 2 ct ranks) array-equal to the
   one-device program the parent ran first from the same seed.  Per rank
   the same numbers are printed; these are times of processes sharing
   one card, not a multi-GPU speed;
3j. lm-mesh — the LM's tensor, expert and data parallelism on ranks that
   share the card through gloo (the parent frees its memory and runs the
   one-device references first).  Two ranks (data 1 × model 2):
   ``internlm2-1.8b`` at full width in float32 through
   ``make_sharded_serve_steps`` (prefill + 2 decode logits within 1e-3 of
   one device) and the launcher's 4 requests (tokens equal); then
   ``launch/serve.py --tp 2`` in bf16, every decode step timed by CUDA
   events, its collectives and bytes held to the reckoned count
   (``decode_reckon``: 2 all-reduces a layer and the embedding's, the
   logits' all-gather) and
   the host time inside them, peak memory a rank; a toy secure layer
   whose ``he_mesh`` is the LM's mesh, array-equal to one device; then
   ``launch/train.py --tp 2``: 3 steps of 4 × 512 tokens, step 1's loss
   within 1e-3 of phase 3h's one-device first loss, ms a step, tokens/s,
   state and peak memory a rank.  Four ranks (data 2 × model 2): the
   dense, MoE and SSM smoke configs in float32, serving (logits, the
   gathered cache, tokens) and 2 train steps with 2 microbatches against
   one device on ``cuda``; then one train step of the MoE smoke config
   with 64 tokens a dispatch group, so a data rank's rows are whole
   groups: loss and state equal one device's, and no byte gathered over
   the batch axes inside the MoE.  The same four ranks as (data 1 ×
   model 4): the MoE smoke config (2 KV heads) serving from a cache of
   30 positions (4 does not divide it: 8 a rank), prompts prefilled in
   chunks of 6 and 5 (the second from ``cache_len`` 6), then 3 greedy
   decode steps: tokens equal, logits and the gathered cache within 1e-4
   of one device;
3k. costs — the compile-time cost reports.  ``launch/dryrun.py`` runs in
   a subprocess started with phase 3i, beside 3i–3j and phase 4 (its
   ``"fake"`` process group never meets the gloo groups of 3i / 3j; it
   needs no card), and is read after phase 4: ``--he set-b set-c`` and
   ``decode_32k`` for ``internlm2-1.8b``, ``granite-moe-3b-a800m`` (24
   heads on a model axis of 16: replicated attention),
   ``mamba2-780m``, ``zamba2-2.7b`` and ``musicgen-large`` on the pod
   mesh (256 fake ranks, fake tensors on ``cuda``); every record must
   be ``ok``, and an HE record's collective bytes the sharded plan's
   reckoning for a rank's share × chips; each record's dominant term,
   its three roofline terms (data-sheet seconds) and ``compile_s`` are
   printed.  Then, with both subprocesses ended, the same counter over
   ``internlm2-1.8b``'s bf16 decode step at phase 3f's shapes on the
   card, on real CUDA tensors
   and on fake tensors of the same shapes: equal dot FLOPs (the bytes
   printed beside each other), and the counts over the median step time
   (CUDA events) beside ``hlo_analysis.HW`` and the card's name and
   power limit.  And phase 3i's ranks' ``sharded_collectives`` of the
   Set-B hemm 128³ Step 2 on (data 1 × model 2): two all-reduces
   totalling ``plan.collective_bytes``.  Phases 3i–3j's printed times
   are taken beside the two subprocesses;
4. cpu-vs-cuda — run in a subprocess (``chip_smoke.py --cpu-vs-cuda``,
   which loads the parent's build) beside phases 3i–3j, whose parent only
   waits on its ranks; its lines are printed when it is read after 3j,
   before phase 3k's:
   the ``fame-m-rt`` hemm on ``cuda`` and on ``cpu`` (plain
   versions), on both engine datapaths, every schedule (``baseline``
   never batched), batched and not, and the fused schedule on both
   ``HEContext`` datapaths; every c0 and c1 array-equal to its ``cpu``
   twin, and all but ``baseline``'s array-equal to each other; then the
   ``fame-m-rt`` block MM (tile 4, A 6×5 · B 5×7, a (2, 2, 2) grid),
   batched and looped, on ``cuda`` and on ``cpu``, all array-equal; and
   the ``fame-m-chain`` depth-3 chain (4×4 · 4×4 · 4×4 · 4×4) on
   ``cuda`` and on ``cpu``, every hop's c0 and c1 array-equal; and the
   ``internlm2-1.8b`` smoke config in float32 on ``cuda`` and on ``cpu``
   from the same weights: ``forward`` logits within 1e-4, and a
   ``ContinuousBatcher`` with a toy secure layer (logN 6, tile 4, tenants
   A, B, A): tokens identical, secure rows and StepStats equal; and the
   ``llama-3.2-vision-90b`` smoke config (175 GB at full width) in
   float32 with a frontend for its cross-attention: ``forward``, prefill
   + 2 decode logits and the kv cache within 1e-4; and two train steps
   of the ``internlm2-1.8b``, ``granite-moe-3b-a800m`` (dropless) and
   ``mamba2-780m`` smoke configs in float32 from the same state: metrics
   and the new state within 1e-4 (the entries of a rounding-level
   gradient left out of the parameters' check, and counted).

Then one line ``{"kernels": [...]}`` (each kernel's launches on the main
path, ``launches_blockmm`` / ``launches_chain`` from the counted calls of
phases 3b and 3d, ``launches_serve`` from phase 3e's step 2, the
first flush with every program cached, ``launches_lm`` from phase
3f's secure step 2, likewise, ``launches_families`` from phase 3g's
secure step 2, ``launches_train`` from phase 3h's full-width run, and
``launches_sharded``: rank 0's launches over phase 3i's counted 2-rank
call, ``launches_lm_mesh``: rank 0's launches in phase 3j's secure run
on the LM's mesh) and,
last, ``{"ok": true, "device":
{...}}``.  Any failure exits non-zero without the result line.  The script
imports nothing of JAX or of the ``repro`` package.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import io
import json
import math
import os
import pathlib
import subprocess
import sys
import tempfile
import time
import traceback

ROOT = pathlib.Path(__file__).resolve().parent
T_START = time.perf_counter()
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


def device_ms(fn, call_ms: float) -> float:
    """Device milliseconds of one ``fn`` launch: ``fn`` captured k times in
    a CUDA graph (k back-to-back launches, k chosen so the graph runs
    ~2 ms), the graph replayed between CUDA events, the median of three
    replays divided by k.  Unlike ``cuda_ms``, which brackets one call from
    Python, this leaves out the host's time to issue the launch."""
    import math
    import torch
    k = max(1, min(50, math.ceil(2.0 / max(call_ms, 1e-3))))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(k):
            fn()
    graph.replay()
    times = []
    for _ in range(3):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / k)
    del graph
    times.sort()
    return times[1]


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
    def __init__(self, name, source, replaces, path="hemm"):
        self.name, self.source, self.replaces = name, source, replaces
        self.path = path            # what one unit of ``weight`` is
        self.ms = self.call_ms = self.plain_ms = 0.0
        self.nbytes = self.nops = 0.0
        self.max_abs_err = 0

    def add(self, label, kernel, plain, nbytes, nops, reps=5, plain_reps=1,
            weight=1):
        """Hold one call against its plain version and time both.
        ``weight`` is how many launches of this shape one run of the
        kernel's path (a hemm, or the kernel API's counted run) makes; the
        record sums weight × (ms, plain ms, bytes, operations), one run's
        worth (0: checked and timed only)."""
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
        call = cuda_ms(kernel, reps)
        ms = device_ms(kernel, call)
        pms = cuda_ms(plain, plain_reps)
        bms, by = bound(nbytes, nops)
        self.ms += weight * ms
        self.call_ms += weight * call
        self.plain_ms += weight * pms
        self.nbytes += weight * nbytes
        self.nops += weight * nops
        log(f"[kernels] {self.name} {label}: equal to plain; {ms:.4f} ms on "
            f"the device, {call:.4f} ms a call from Python (plain {pms:.2f} "
            f"ms, bound {bms:.4f} ms by {by}); {weight} per {self.path}")

    def entry(self, launches: int) -> dict:
        bms, by = bound(self.nbytes, self.nops)
        log(f"[kernels] {self.name}: {self.ms:.4f} ms on the device, "
            f"{self.call_ms:.4f} ms in calls from Python, per {self.path}")
        return {"name": self.name, "route": "cuda", "source": self.source,
                "replaces": self.replaces, "launches": launches,
                "max_abs_err": self.max_abs_err, "ms": self.ms,
                "plain_ms": self.plain_ms, "bound_ms": bms, "bound_by": by,
                "library_ms": None}


def rotation_tables(eng, step: int):
    """(perms (S, d, N), is_id (S, d, 1)) int32 on the device: the real
    Galois permutations of the Set-B hemm 128³'s diagonal sets at ``step``
    — Step 1: σ (z = 128·i) and τ (z = i), i in [-127, 127], d = 255;
    Step 2: the 2·l = 256 sets {k, k − 128}, d = 2."""
    import numpy as np
    import torch
    from repro_torch.core import automorph
    N = eng.params.N
    if step == 1:
        zsets = [tuple(128 * z for z in range(-127, 128)),
                 tuple(range(-127, 128))]
    else:
        zsets = [(k % 128, k % 128 - 128) for k in range(256)]
    perms = torch.from_numpy(np.stack([np.stack([
        np.arange(N) if z == 0 else
        automorph.eval_perm(N, automorph.galois_elt_rot(z, N))
        for z in zs]) for zs in zsets]).astype(np.int32)).to(eng.device)
    is_id = torch.tensor([[[int(z == 0)] for z in zs] for zs in zsets],
                         dtype=torch.int32, device=eng.device)
    return perms, is_id


def phase_kernels(eng, records, l: int):
    """Every kernel at the Set-B hemm 128^3 shapes: Step 1 and Step 2 of
    both programs, and the engine's transforms in one mult → rescale."""
    import torch
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
        ho = MONTMUL_OPS * 2 * (nq * (ntt_montmuls(N) + N)
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

        # -- merged ModDown: intt_scale + moddown_finish over 2·B polys;
        #    intt_scale reads the drop rows of x_full through its row table
        mt = eng.fused_moddown_tables(level)
        P = 2 * B
        x_full = rand_residues((P, M, N), q_ext, gen)
        drop = mt["drop_idx"]
        x_drop = x_full[:, drop]
        nd, R_out = x_drop.shape[1], mt["n_out"]
        itabs = (mt["psii_drop"], mt["ninv_drop"], mt["hat_drop"],
                 mt["q_drop"], mt["qneg_drop"])
        C = kntt.cluster_size(P * nd, N)
        records["intt_scale"].add(
            f"step{step} P={P} rows={nd} C={C} (row table)",
            lambda: bc.intt_scale_rows_cuda(x_full, drop, *itabs),
            lambda: bc.intt_scale_plain(x_full[:, drop], *itabs),
            (2 * P * nd * N + nd * N) * 4,
            MONTMUL_OPS * P * nd * (ntt_montmuls(N) + N))
        y = bc.intt_scale_cuda(x_drop, *itabs)
        x_out = x_full[:, :R_out]
        mtabs = (mt["w"], mt["d"], mt["inv_d"], mt["psi_out"], mt["p_inv"],
                 mt["q_out"], mt["qneg_out"])
        for P_, w_ in ((P, 1), (2, 0)):  # the batched launch; unbatched
            C = kntt.cluster_size(P_ * R_out, N)
            records["moddown_finish"].add(
                f"step{step} P={P_} rows={R_out} nd={nd} C={C}"
                + ("" if w_ else f" (unbatched shape: {2 if step == 1 else 2 * l}"
                   f" launches a hemm)"),
                lambda: bc.moddown_finish_cuda(x_out[:P_], y[:P_], *mtabs),
                lambda: bc.moddown_finish_plain(x_out[:P_], y[:P_], *mtabs),
                (2 * P_ * R_out * N + P_ * nd * N + R_out * N) * 4,
                MONTMUL_OPS * P_ * R_out * (N * (nd + 2) + ntt_montmuls(N)),
                weight=w_)
        if step == 2:
            moddown_gather(x_full, mt, itabs, mtabs)
        del x_full, x_drop, y, x_out

        # -- fused_hlt_indexed -------------------------------------------
        ct_slots = [0, 1] if step == 1 else [0] * 128 + [1] * 128
        perms, is_id = rotation_tables(eng, step)
        S, d, nbeta = perms.shape[0], perms.shape[1], t["nbeta"]
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
        # random permutations: no tile maps onto one source tile, so every
        # non-identity rotation gathers from device memory (weight 0)
        rperms = torch.argsort(torch.rand((S, d, N), generator=gen,
                                          device=dev), dim=-1).to(torch.int32)
        rargs = args[:6] + (rperms,) + args[7:]
        records["fused_hlt_indexed"].add(
            f"step{step} B={B} S={S} d={d} M={M} random permutations",
            lambda: fh.fused_hlt_indexed_cuda(*rargs),
            lambda: fh.fused_hlt_indexed_plain(*rargs), fb, fo, reps=3,
            weight=0)
        for kind, pm in (("Galois", perms), ("random", rperms)):
            check_paths(f"fused_hlt_indexed step{step} {kind}",
                        lambda: fh.fused_hlt_indexed_cuda(
                            *args[:6], pm, *args[7:]),
                        pm, is_id, dgs.tolist(), M, N,
                        staged_only=kind == "Galois")

        # -- fused_hlt_batched: the same batch on operands gathered per
        #    batch element (digits[ct_slots], u[diag_slots], ...); equal to
        #    its plain version and to fused_hlt_indexed on the same inputs
        bargs = (digits[cts.long()], c0e[cts.long()], c1e[cts.long()],
                 u[dgs.long()], rk0[dgs.long()], rk1[dgs.long()],
                 perms[dgs.long()], is_id[dgs.long()], view.moduli_u32,
                 view.qneg_inv)
        if not torch.equal(fh.fused_hlt_batched_cuda(*bargs),
                           fh.fused_hlt_indexed_cuda(*args)):
            raise AssertionError(f"fused_hlt_batched step{step} differs from "
                                 f"fused_hlt_indexed on the same inputs")
        records["fused_hlt_batched"].add(
            f"step{step} B={B} d={d} M={M} (= fused_hlt_indexed)",
            lambda: fh.fused_hlt_batched_cuda(*bargs),
            lambda: fh.fused_hlt_batched_plain(*bargs),
            fb + (B - 2) * (nbeta + 2) * M * N * 4, fo, reps=3)
        rbargs = bargs[:6] + (rperms[dgs.long()],) + bargs[7:]
        records["fused_hlt_batched"].add(
            f"step{step} B={B} d={d} M={M} random permutations",
            lambda: fh.fused_hlt_batched_cuda(*rbargs),
            lambda: fh.fused_hlt_batched_plain(*rbargs),
            fb + (B - 2) * (nbeta + 2) * M * N * 4, fo, reps=3, weight=0)
        del bargs, rbargs

        # -- fused_hlt: one ciphertext and one diagonal set (slot 0 of each
        #    of the operands above); the unbatched program runs 2 at Step 1
        #    and 2·l at Step 2 -------------------------------------------
        one = (digits[0], c0e[0], c1e[0], u[0], rk0[0], rk1[0], perms[0],
               is_id[0], view.moduli_u32, view.qneg_inv)
        i0 = ids_per_b[0]
        one_b = ((nbeta + 2) * M * N + d * M * N
                 + (d - i0) * (2 * nbeta * M * N + N) + d + 2 * M * N) * 4
        one_o = MONTMUL_OPS * M * N * ((d - i0) * (2 * nbeta + 2) + i0 * 2)
        records["fused_hlt"].add(
            f"step{step} d={d} M={M}",
            lambda: fh.fused_hlt_cuda(*one), lambda: fh.fused_hlt_plain(*one),
            one_b, one_o, reps=3, weight=2 if step == 1 else 2 * l)
        rone = one[:6] + (rperms[0],) + one[7:]
        records["fused_hlt"].add(
            f"step{step} d={d} M={M} random permutations",
            lambda: fh.fused_hlt_cuda(*rone), lambda: fh.fused_hlt_plain(*rone),
            one_b, one_o, reps=3, weight=0)
        del digits, c0e, c1e, u, rk0, rk1, perms, rperms, args, rargs, one
        del rone
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
            C = kntt.cluster_size(B * len(idx), N)
            label += f"C={C} blocks={C * B * len(idx)} "
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
    phase_kernels_split(records, gen)
    phase_kernels_elementwise(eng, records, gen)
    phase_kernels_shapes(eng, gen, l)
    ops.reset_launch_counts()


def expected_paths(perms, is_id, diag_slots, M: int, N: int) -> list:
    """[staged, gathered, identity] (block, rotation) pairs of one fused HLT
    launch whose batch element b runs diagonal set diag_slots[b]: per
    limb group and rotation, each tile whose positions come from one
    source tile is staged (``fused_hlt.tile_sources``)."""
    import torch
    from repro_torch.kernels import fused_hlt as fh
    T = fh.tile_size(N)
    groups = -(-M // fh.limb_group(M, perms.shape[1]))
    one = (fh.tile_sources(perms, T) >= 0).sum(dim=-1)        # (S, d)
    ids = is_id[..., 0] != 0
    slots = torch.as_tensor(diag_slots, device=perms.device).long()
    one, ids = one[slots], ids[slots]
    tiles = N // T
    return [groups * int(one[~ids].sum()),
            groups * int((tiles - one)[~ids].sum()),
            groups * tiles * int(ids.sum())]


def count_paths(fn) -> list:
    """[staged, gathered, identity] (block, rotation) pairs the fused HLT
    kernels count on the card over ``fn()``."""
    import torch
    from repro_torch.kernels import fused_hlt as fh
    fh.PATHS = torch.zeros(3, dtype=torch.int32, device="cuda")
    try:
        fn()
        torch.cuda.synchronize()
        return fh.PATHS.tolist()
    finally:
        fh.PATHS = None


def check_paths(label, fn, perms, is_id, diag_slots, M, N, staged_only):
    got = count_paths(fn)
    want = expected_paths(perms, is_id, diag_slots, M, N)
    if got != want or (staged_only and got[1] != 0):
        raise AssertionError(f"{label}: paths (staged, gathered, identity) "
                             f"{got}, expected {want}")
    log(f"[kernels] {label}: (block, rotation) pairs staged {got[0]}, "
        f"gathered from device memory {got[1]}, identity {got[2]} (as "
        f"tile_sources predicts)")


def moddown_gather(x_full, mt, itabs, mtabs):
    """The Step-2 merged ModDown (``ops.moddown_fused``: ``intt_scale``
    reading the drop rows in place through its row table, then
    ``moddown_finish``) against the same two launches after the gather
    ``x_full[:, drop_idx]`` that it replaced: equal outputs, device ms of
    both."""
    import torch
    from repro_torch.kernels import basechange as bc, ops

    def gather():
        y = bc.intt_scale_cuda(x_full[:, mt["drop_idx"]], *itabs)
        return bc.moddown_finish_cuda(x_full[:, :mt["n_out"]], y, *mtabs)

    def rows():
        return ops.moddown_fused(x_full, mt)
    if not torch.equal(rows(), gather()):
        raise AssertionError("moddown_fused with the row table differs from "
                             "the gathered form")
    P, M, N = x_full.shape
    log(f"[kernels] merged ModDown step 2 P={P} M={M}: with the row table "
        f"{device_ms(rows, cuda_ms(rows, 3)):.4f} ms on the device, after the "
        f"gather of {P} x {len(mt['drop_idx'])} rows "
        f"{device_ms(gather, cuda_ms(gather, 3)):.4f} ms (equal outputs)")


def moddown_parts(x, y, mtabs, logN: int):
    """What the Step-2 ``moddown_finish`` launch is made of, at C = 8: the
    same launch with one drop row (a BaseConv from nd = 1, held against
    its plain version), and ``ntt`` alone over the same P·R target rows."""
    import torch
    from repro_torch.kernels import basechange as bc, build, ntt as kntt
    P, R, _ = x.shape
    w, d, inv_d, psi, p_inv, q, qn = mtabs
    one = (w[:, :1].contiguous(), d, inv_d[:1].contiguous(), psi, p_inv, q,
           qn)
    y1 = y[:, :1].contiguous()

    def nd1():
        out = torch.empty_like(x)
        build.call("moddown_finish_launch", x, x.stride(0), y1, out, P, R, 1,
                   logN, 3, *one)
        return out

    def ntt():
        out = torch.empty_like(x)
        build.call("ntt_launch", x, x.stride(0), out, P, R, logN, 3, psi, q,
                   qn)
        return out
    if not (torch.equal(nd1(), bc.moddown_finish_plain(x, y1, *one))
            and torch.equal(ntt(), kntt.ntt_plain(x, psi, q, qn))):
        raise AssertionError("moddown_finish nd=1 or ntt over its rows "
                             "differs from plain")
    log(f"[kernels] moddown_finish step 2 P={P} R={R} C=8: with nd=1 "
        f"{device_ms(nd1, cuda_ms(nd1, 3)):.4f} ms on the device; ntt alone "
        f"over the same {P * R} rows {device_ms(ntt, cuda_ms(ntt, 3)):.4f} ms "
        f"(both equal to plain)")


def sweep_intt_scale(eng, gen, step, level: int, P: int):
    """``intt_scale`` of a merged ModDown's drop rows (P polynomials, read
    through the row table) over clusters of 4, 8 and 16, each equal to the
    plain version, device ms printed; and ``intt`` alone over as many rows
    at the wrapper's C (the split inverse without the row table and the
    scale)."""
    import torch
    from repro_torch.kernels import basechange as bc, build, ntt as kntt
    p = eng.params
    N = p.N
    mt = eng.fused_moddown_tables(level)
    full = eng.tools.digit_bases(level)[0][2]
    x_full = rand_residues((P, len(full), N), eng.basis(full).moduli_u32, gen)
    drop, nd = mt["drop_idx"], len(mt["drop_idx"])
    itabs = (mt["psii_drop"], mt["ninv_drop"], mt["hat_drop"], mt["q_drop"],
             mt["qneg_drop"])
    want = bc.intt_scale_plain(x_full[:, drop], *itabs)
    fold = bc._fold(*itabs[1:])
    times = []
    for logc in (2, 3, 4):
        def run(logc=logc):
            out = torch.empty((P, nd, N), dtype=torch.int32, device=x_full.device)
            build.call("intt_scale_launch", x_full, x_full.stride(0), drop,
                       out, P, nd, p.logN, logc, itabs[0], fold, itabs[3],
                       itabs[4])
            return out
        if not torch.equal(run(), want):
            raise AssertionError(f"intt_scale step {step} C={1 << logc} "
                                 f"differs from plain")
        times.append(f"C={1 << logc} {device_ms(run, cuda_ms(run, 3)):.4f}")
    C = kntt.cluster_size(P * nd, N)
    x_drop = x_full[:, drop]
    tabs = (itabs[0], itabs[1], itabs[3], itabs[4])

    def intt():
        return kntt.intt_cuda(x_drop, *tabs)
    if not torch.equal(intt(), kntt.intt_plain(x_drop, *tabs)):
        raise AssertionError(f"intt over the step {step} drop rows differs "
                             f"from plain")
    log(f"[kernels] intt_scale step {step} P={P} rows={nd} ({P * nd} rows): "
        f"equal to plain at every cluster size; device ms {', '.join(times)} "
        f"(wrapper: C={C}); intt alone over the gathered rows at C={C} "
        f"{device_ms(intt, cuda_ms(intt, 3)):.4f}")
    del x_full, x_drop, want


def sweep_hoist(eng, gen, step, level: int):
    """The hoist's BaseConv + NTT launch (``hoist_bc_ntt_launch``) of 2
    ciphertexts over clusters of 4, 8 and 16, each equal to the plain
    version, device ms printed."""
    import torch
    from repro_torch.kernels import basechange as bc, build, ntt as kntt
    p = eng.params
    N = p.N
    t = eng.fused_hoist_tables(level)
    nq, nbeta, alpha = t["nq"], t["nbeta"], t["alpha"]
    M = t["psi_full"].shape[0]
    c1s = rand_residues((2, nq, N), t["q_full"][:nq], gen)
    tabs = [t[k] for k in HOIST_KEYS]
    kw = dict(nbeta=nbeta, alpha=alpha)
    want = bc.hoist_db_plain(c1s, *tabs, **kw)
    y = bc.intt_scale_cuda(c1s, *(a[:nq] for a in tabs[:5]))
    times = []
    for logc in (2, 3, 4):
        def run(logc=logc):
            out = torch.empty((2, nbeta, M, N), dtype=torch.int32,
                              device=c1s.device)
            build.call("hoist_bc_ntt_launch", y, c1s, c1s.stride(0), out, 2,
                       nbeta, alpha, nq, M, p.logN, logc, *tabs[5:])
            return out
        if not torch.equal(run(), want):
            raise AssertionError(f"hoist_db step {step} C={1 << logc} differs "
                                 f"from plain")
        times.append(f"C={1 << logc} {device_ms(run, cuda_ms(run, 3)):.4f}")
    log(f"[kernels] hoist_db BaseConv+NTT launch step {step} B=2 nbeta={nbeta}"
        f" M={M} ({2 * nbeta * M} rows): equal to plain at every cluster "
        f"size; device ms {', '.join(times)} (wrapper: "
        f"C={kntt.cluster_size(2 * nbeta * M, N)})")


HOIST_KEYS = ("psii_pad", "ninv_pad", "hat_pad", "q_pad", "qneg_pad", "w",
              "d", "inv_d", "psi_full", "q_full", "qneg_full", "mask")


def phase_kernels_shapes(eng, gen, l: int):
    """The launch shapes the wrappers choose between, through the C entry
    points at the Set-B hemm's shapes, each output held equal to the plain
    version and its device time printed: ``moddown_finish`` and
    ``intt_scale`` over clusters of 4, 8 and 16 at Step 1 (4 polynomials),
    Step 2 (2·2·l) and the unbatched shape (2); the hoist's BaseConv + NTT
    the same way at Step 1 and at the Step-2 hoist; ``fused_hlt_indexed``
    with limb groups of 1, 2, 4 and 8 at Step 1 and Step 2 on the Galois
    tables."""
    import torch
    from repro_torch.kernels import basechange as bc, build, fused_hlt as fh
    from repro_torch.kernels import ntt as kntt

    p, dev = eng.params, eng.device
    N = p.N
    for step, level, P in ((1, p.L, 4), (2, p.L - 1, 4 * l),
                           ("unbatched", p.L - 1, 2)):
        mt = eng.fused_moddown_tables(level)
        R, nd = mt["n_out"], len(mt["drop_idx"])
        x = rand_residues((P, R, N), mt["q_out"], gen)
        y = rand_residues((P, nd, N), mt["q_drop"], gen)
        mtabs = (mt["w"], mt["d"], mt["inv_d"], mt["psi_out"], mt["p_inv"],
                 mt["q_out"], mt["qneg_out"])
        want = bc.moddown_finish_plain(x, y, *mtabs)
        times = []
        for logc in (2, 3, 4):
            def run(logc=logc):
                out = torch.empty_like(x)
                build.call("moddown_finish_launch", x, x.stride(0), y, out, P,
                           R, nd, p.logN, logc, *mtabs)
                return out
            if not torch.equal(run(), want):
                raise AssertionError(f"moddown_finish step {step} C="
                                     f"{1 << logc} differs from plain")
            times.append(f"C={1 << logc} {device_ms(run, cuda_ms(run, 3)):.4f}")
        log(f"[kernels] moddown_finish step {step} P={P} R={R} nd={nd}: equal "
            f"to plain at every cluster size; device ms {', '.join(times)} "
            f"(wrapper: C={kntt.cluster_size(P * R, N)})")
        if step == 2:
            moddown_parts(x, y, mtabs, p.logN)
        del x, y, want
        sweep_intt_scale(eng, gen, step, level, P)
    for step, level in ((1, p.L), ("2 hoist", p.L - 1)):
        sweep_hoist(eng, gen, step, level)
    for step, level, B in ((1, p.L, 2), (2, p.L - 1, 2 * l)):
        full = eng.tools.digit_bases(level)[0][2]
        view = eng.basis(full)
        M, nbeta = len(full), len(eng.tools.digit_bases(level))
        perms, is_id = rotation_tables(eng, step)
        S, d = perms.shape[:2]
        q = view.moduli_u32
        args = (rand_residues((2, nbeta, M, N), q, gen),
                rand_residues((2, M, N), q, gen),
                rand_residues((2, M, N), q, gen),
                rand_residues((S, d, M, N), q, gen),
                rand_residues((S, d, nbeta, M, N), q, gen),
                rand_residues((S, d, nbeta, M, N), q, gen), perms, is_id,
                torch.tensor([0, 1] if step == 1 else [0] * l + [1] * l,
                             dtype=torch.int32, device=dev),
                torch.arange(S, dtype=torch.int32, device=dev), q,
                view.qneg_inv)
        want = fh.fused_hlt_indexed_plain(*args)
        times = []
        for g in (1, 2, 4, 8):
            def run(g=g):
                out = torch.empty((2, B, M, N), dtype=torch.int32, device=dev)
                build.call("fused_hlt_indexed_launch", *args, out, B, nbeta,
                           M, N, d, g, None)
                return out
            if not torch.equal(run(), want):
                raise AssertionError(f"fused_hlt_indexed step {step} g={g} "
                                     f"differs from plain")
            times.append(f"g={g} {device_ms(run, cuda_ms(run, 3)):.4f}")
        log(f"[kernels] fused_hlt_indexed step {step} B={B} d={d} M={M}: "
            f"equal to plain at every limb group; device ms "
            f"{', '.join(times)} (wrapper: g={fh.limb_group(M, d)})")
        del args, want
        torch.cuda.empty_cache()


def phase_kernels_split(records, gen):
    """``ntt`` then ``intt`` on 4 rows of Set-C's moduli at logN 16 (a
    row of 256 KiB, more than one block's shared memory): each against its plain
    version (weight 0: checked and timed, no launch of the hemm), then the
    round trip must return the input.  Then both at every cluster size
    1-16 on Set-A rows, against the plain versions (tolerance: exact).
    Then ``moddown_finish`` the same way: on 4 Set-C polynomials, and at
    every cluster size on Set-A."""
    import numpy as np
    import torch
    from repro_torch.core.params import SET_A, SET_C, get_context
    from repro_torch.kernels import build, ntt as kntt

    v = get_context(SET_C, gen.device).slc(np.arange(4))
    N = SET_C.N
    x = rand_residues((1, 4, N), v.moduli_u32, gen)
    fwd = (v.psi_brv_mont, v.moduli_u32, v.qneg_inv)
    inv = (v.psi_inv_brv_mont, v.n_inv_mont, v.moduli_u32, v.qneg_inv)
    C = kntt.cluster_size(4, N)
    label = f"Set-C logN 16 rows=4 C={C} blocks={4 * C}"
    records["ntt"].add(label, lambda: kntt.ntt_cuda(x, *fwd),
                       lambda: kntt.ntt_plain(x, *fwd), 12 * 4 * N,
                       MONTMUL_OPS * 4 * ntt_montmuls(N), plain_reps=1,
                       weight=0)
    y = kntt.ntt_cuda(x, *fwd)
    records["intt"].add(label, lambda: kntt.intt_cuda(y, *inv),
                        lambda: kntt.intt_plain(y, *inv), 12 * 4 * N,
                        MONTMUL_OPS * 4 * (ntt_montmuls(N) + N),
                        plain_reps=1, weight=0)
    if not torch.equal(kntt.intt_cuda(y, *inv), x):
        raise AssertionError("Set-C ntt then intt does not return its input")
    log(f"[kernels] Set-C logN 16: intt(ntt(x)) == x on 4 rows")
    # every cluster size the kernels take, on Set-A rows (logN 13), through
    # the C entry points (the wrapper picks only 1, 8 or 16 on the paths)
    v = get_context(SET_A, gen.device).slc(np.arange(3))
    x = rand_residues((2, 3, SET_A.N), v.moduli_u32, gen)
    fwd = (v.psi_brv_mont, v.moduli_u32, v.qneg_inv)
    inv = (v.psi_inv_brv_mont, v.n_inv_mont, v.moduli_u32, v.qneg_inv)
    want, want_i = kntt.ntt_plain(x, *fwd), kntt.intt_plain(x, *inv)
    for logc in range(5):
        out, out_i, back = (torch.empty_like(x) for _ in range(3))
        build.call("ntt_launch", x, x.stride(0), out, 2, 3, SET_A.logN, logc,
                   *fwd)
        build.call("intt_launch", x, x.stride(0), out_i, 2, 3, SET_A.logN,
                   logc, *inv)
        build.call("intt_launch", out, out.stride(0), back, 2, 3, SET_A.logN,
                   logc, *inv)
        torch.cuda.synchronize()
        if not (torch.equal(out, want) and torch.equal(out_i, want_i)
                and torch.equal(back, x)):
            raise AssertionError(f"ntt/intt with a cluster of {1 << logc} "
                                 f"differ from their plain versions")
    log(f"[kernels] Set-A logN 13, B=2 x 3 rows: ntt, intt and the round "
        f"trip equal to the plain versions at every cluster size 1-16")

    # moddown_finish: 4 Set-C polynomials at level 31 (weight 0), tables
    # from RnsTools on Set-C's context (no keygen); then every cluster size
    # on Set-A's merged ModDown at level 4 through the C entry point
    from repro_torch.core.rns import RnsTools
    from repro_torch.kernels import basechange as bc
    for params, sizes in ((SET_C, None), (SET_A, range(5))):
        ctx = get_context(params, gen.device)
        mt = bc.to_device(bc.build_moddown_tables(ctx, RnsTools(ctx),
                                                  params.L), gen.device)
        R, nd, N = mt["n_out"], len(mt["drop_idx"]), params.N
        x = rand_residues((4, R, N), mt["q_out"], gen)
        y = rand_residues((4, nd, N), mt["q_drop"], gen)
        mtabs = (mt["w"], mt["d"], mt["inv_d"], mt["psi_out"], mt["p_inv"],
                 mt["q_out"], mt["qneg_out"])
        if sizes is None:
            C = kntt.cluster_size(4 * R, N)
            records["moddown_finish"].add(
                f"Set-C logN 16 P=4 rows={R} nd={nd} C={C}",
                lambda: bc.moddown_finish_cuda(x, y, *mtabs),
                lambda: bc.moddown_finish_plain(x, y, *mtabs),
                (2 * 4 * R * N + 4 * nd * N + R * N) * 4,
                MONTMUL_OPS * 4 * R * (N * (nd + 2) + ntt_montmuls(N)),
                plain_reps=1, weight=0)
            continue
        want = bc.moddown_finish_plain(x, y, *mtabs)
        for logc in sizes:
            out = torch.empty_like(x)
            build.call("moddown_finish_launch", x, x.stride(0), y, out, 4, R,
                       nd, params.logN, logc, *mtabs)
            torch.cuda.synchronize()
            if not torch.equal(out, want):
                raise AssertionError(f"moddown_finish with a cluster of "
                                     f"{1 << logc} differs from its plain "
                                     f"version")
        log(f"[kernels] Set-A logN 13, P=4 x {R} rows, nd={nd}: "
            f"moddown_finish equal to the plain version at every cluster "
            f"size 1-16")
    phase_kernels_hoist_split(records, gen)


def phase_kernels_hoist_split(records, gen):
    """``intt_scale``, ``hoist_db`` and ``baseconv_ntt`` at logN 16: on 4
    Set-C rows (the merged ModDown's first 4 drop rows at level 31, read
    through the row table) and on one Set-C ciphertext at level 31 (β 3,
    α 11, M 44), each against its plain version (weight 0).  Then each at
    every cluster size 1-16 on Set-A (logN 13) through the C entry points,
    at levels 4 and 3 (tolerance: exact)."""
    import torch
    from repro_torch.core.params import SET_A, SET_C, get_context
    from repro_torch.core.rns import RnsTools
    from repro_torch.kernels import basechange as bc, build, ntt as kntt

    for params in (SET_C, SET_A):
        ctx = get_context(params, gen.device)
        tools = RnsTools(ctx)
        N, logN = params.N, params.logN
        levels = (params.L,) if params is SET_C else (params.L, params.L - 1)
        for level in levels:
            t = bc.to_device(bc.build_hoist_tables(ctx, tools, level),
                             gen.device)
            mt = bc.to_device(bc.build_moddown_tables(ctx, tools, level),
                              gen.device)
            nq, nbeta, alpha = t["nq"], t["nbeta"], t["alpha"]
            M = t["psi_full"].shape[0]
            tabs = [t[k] for k in HOIST_KEYS]
            kw = dict(nbeta=nbeta, alpha=alpha)
            c1s = rand_residues((1, nq, N), t["q_full"][:nq], gen)
            x_full = rand_residues((1, M, N), t["q_full"], gen)
            y = rand_residues((nbeta * alpha, N), t["q_pad"], gen)
            y[nq:] = 0
            pt = rand_residues((M, N), t["q_full"], gen)
            btabs = (y, *tabs[5:11], pt, t["mask"])
            if params is SET_C:
                rows = mt["drop_idx"][:4].contiguous()
                itabs = tuple(mt[k][:4].contiguous() for k in (
                    "psii_drop", "ninv_drop", "hat_drop", "q_drop",
                    "qneg_drop"))
                C = kntt.cluster_size(4, N)
                records["intt_scale"].add(
                    f"Set-C logN 16 rows=4 C={C} (row table)",
                    lambda: bc.intt_scale_rows_cuda(x_full, rows, *itabs),
                    lambda: bc.intt_scale_plain(x_full[:, rows], *itabs),
                    (2 * 4 * N + 4 * N) * 4,
                    MONTMUL_OPS * 4 * (ntt_montmuls(N) + N), weight=0)
                na = [min(alpha, nq - j * alpha) for j in range(nbeta)]
                conv = sum((M - a) * (N * a + N + ntt_montmuls(N)) for a in na)
                records["hoist_db"].add(
                    f"Set-C logN 16 B=1 nq={nq} M={M} C="
                    f"{kntt.cluster_size(nbeta * M, N)}",
                    lambda: bc.hoist_db_cuda(c1s, *tabs, **kw),
                    lambda: bc.hoist_db_plain(c1s, *tabs, **kw),
                    (nq * N + nq * N + M * N + nbeta * M * N) * 4,
                    MONTMUL_OPS * (nq * (ntt_montmuls(N) + N) + conv),
                    weight=0)
                records["baseconv_ntt"].add(
                    f"Set-C logN 16 nbeta={nbeta} alpha={alpha} M={M} C="
                    f"{kntt.cluster_size(nbeta * M, N)}",
                    lambda: bc.baseconv_ntt_cuda(*btabs),
                    lambda: bc.baseconv_ntt_plain(*btabs),
                    (2 * nq * N + M * N + nbeta * M * N) * 4,
                    MONTMUL_OPS * conv, weight=0)
                del c1s, x_full, y, pt, btabs
                continue
            drop, nd = mt["drop_idx"], len(mt["drop_idx"])
            itabs = [mt[k] for k in ("psii_drop", "ninv_drop", "hat_drop",
                                     "q_drop", "qneg_drop")]
            want_i = bc.intt_scale_plain(x_full[:, drop], *itabs)
            want_h = bc.hoist_db_plain(c1s, *tabs, **kw)
            want_b = bc.baseconv_ntt_plain(*btabs)
            fold_i = bc._fold(*itabs[1:])
            fold_h = bc._fold(*tabs[1:5])
            for logc in range(5):
                out_i = torch.empty((1, nd, N), dtype=torch.int32,
                                    device=gen.device)
                build.call("intt_scale_launch", x_full, x_full.stride(0), drop,
                           out_i, 1, nd, logN, logc, itabs[0], fold_i,
                           itabs[3], itabs[4])
                yh = torch.empty_like(c1s)
                build.call("intt_scale_launch", c1s, c1s.stride(0), None, yh,
                           1, nq, logN, logc, tabs[0], fold_h, tabs[3], tabs[4])
                out_h = torch.empty_like(want_h)
                build.call("hoist_bc_ntt_launch", yh, c1s, c1s.stride(0),
                           out_h, 1, nbeta, alpha, nq, M, logN, logc,
                           *tabs[5:])
                out_b = torch.empty_like(want_b)
                build.call("baseconv_ntt_launch", y, pt, out_b, nbeta, alpha,
                           M, logN, logc, *tabs[5:11], t["mask"])
                torch.cuda.synchronize()
                if not (torch.equal(out_i, want_i) and torch.equal(out_h, want_h)
                        and torch.equal(out_b, want_b)):
                    raise AssertionError(f"intt_scale / hoist_db / baseconv_ntt "
                                         f"with a cluster of {1 << logc} differ "
                                         f"from their plain versions")
            log(f"[kernels] Set-A logN 13 level {level} (nq={nq}, nbeta="
                f"{nbeta}, M={M}, nd={nd}): intt_scale (row table), hoist_db "
                f"and baseconv_ntt equal to the plain versions at every "
                f"cluster size 1-16")


def api_shapes(eng) -> dict:
    """The kernel API's Set-B shapes: ``modmul`` / ``modadd`` over the
    Step-1 extended basis (24 limbs) and the level-15 main basis (16);
    ``baseconv`` from one digit's 8 limbs to the other 16 of the extended
    basis (ModUp), and from P ∪ {q_15} (9) to Q_14 (15) (merged ModDown)."""
    p = eng.params
    L = p.L
    spec = tuple(range(p.num_main, p.num_total))
    own, gen, full = eng.tools.digit_bases(L)[0]
    return dict(rows={"ext": full, "main": tuple(range(L + 1))},
                baseconv={"modup": (own, gen),
                          "moddown": (spec + (L,), tuple(range(L)))})


def baseconv_operands(eng, S, T):
    """(hat_inv_m, q_own, qneg_own, W_m, D_mod_m, inv_d, q_gen, qneg_gen) on
    the device: ``RnsTools``' tables in the Montgomery form the kernel
    takes (as the reference's kernel test builds them)."""
    import numpy as np
    import torch
    from repro_torch.core import modmath as mm
    from repro_torch.core.params import u32_tensor

    hat_inv, W, D_mod_t, inv_d = eng.tools._bc_tables(tuple(S), tuple(T))
    host = eng.ctx.moduli_host
    qs = np.array([host[i] for i in S], np.uint64)[:, None]
    qt = np.array([host[i] for i in T], np.uint64)[:, None]

    def qneg(q):
        return np.array([[mm.mont_constants(int(v))[0]] for v in q[:, 0]],
                        np.uint32)
    dev = eng.device
    return tuple(u32_tensor(a, dev) for a in (
        mm.to_mont_host_arr(hat_inv, qs), qs, qneg(qs),
        mm.to_mont_host_arr(W, qt), mm.to_mont_host_arr(D_mod_t, qt))) + (
        torch.as_tensor(inv_d, dtype=torch.float64, device=dev),
        u32_tensor(qt, dev), u32_tensor(qneg(qt), dev))


def phase_kernels_elementwise(eng, records, gen):
    """``modmul`` / ``modadd`` at the API's Set-B shapes against their
    plain versions, the launch floor of ``device_ms``, then
    ``phase_baseconv``."""
    from repro_torch.kernels import modmul as kmm
    N = eng.params.N
    shapes = api_shapes(eng)
    for label, idx in shapes["rows"].items():
        v = eng.basis(idx)
        M = len(idx)
        x = rand_residues((M, N), v.moduli_u32, gen)
        y = rand_residues((M, N), v.moduli_u32, gen)
        mm_args = (x, y, v.moduli_u32, v.qneg_inv)
        records["modmul"].add(
            f"{label} M={M}", lambda: kmm.modmul_cuda(*mm_args),
            lambda: kmm.modmul_plain(*mm_args), (3 * M * N + 2 * M) * 4,
            MONTMUL_OPS * M * N, reps=20, plain_reps=3)
        records["modadd"].add(
            f"{label} M={M}", lambda: kmm.modadd_cuda(x, y, v.moduli_u32),
            lambda: kmm.modadd_plain(x, y, v.moduli_u32),
            (3 * M * N + M) * 4, 2 * M * N, reps=20, plain_reps=3)
    floor = launch_floor_ms(eng.device)
    log(f"[kernels] launch floor: {floor:.4f} ms on the device (a one-element "
        f"in-place add_, captured and replayed as device_ms replays a "
        f"kernel)")
    phase_baseconv(eng, records, gen)


def launch_floor_ms(device) -> float:
    """Device ms of the least kernel: a one-element in-place ``add_``,
    timed exactly as ``device_ms`` times a kernel."""
    import torch
    z = torch.zeros(1, dtype=torch.int32, device=device)
    return device_ms(lambda: z.add_(1), cuda_ms(lambda: z.add_(1), 20))


#: ``baseconv``'s shapes beyond the kernel API's: the reference test's
#: 3 -> 4 case (Set-B moduli 0-2 -> 3, 4, p_0, p_1) at N that is a
#: multiple neither of 4 nor of the tile (word by word) and a multiple of
#: 4 but not of the tile (a partial tile of 16-byte columns), and the
#: widest source basis the reference allows (44 -> 4)
BASECONV_RAGGED_N = (1001, 1004)
BASECONV_WIDE = dict(logN=10, L=43, k=4, beta=4, scale_bits=29)


def baseconv_cases(eng) -> list:
    """[(label, engine, S, T, N, weight)]: the kernel API's two Set-B
    shapes on the Set-B engine ``eng`` (weight 1), then (weight 0) Set-C's
    ModUp (11 -> 33) and merged ModDown (13 -> 31) at N = 2^16 as
    ``api_shapes`` gives them on the Set-C engine, the 3 -> 4 case at each
    ``BASECONV_RAGGED_N``, and |S| = 44 -> |T| = 4 at Set-B's N."""
    from repro_torch.core.ckks import CkksEngine
    from repro_torch.core.params import SET_C, toy_params

    p = eng.params
    eng_c = CkksEngine(SET_C, device=eng.device)
    eng_w = CkksEngine(toy_params(**BASECONV_WIDE), device=eng.device)
    cases = [(label, eng, S, T, p.N, 1)
             for label, (S, T) in api_shapes(eng)["baseconv"].items()]
    cases += [(f"Set-C {label}", eng_c, S, T, SET_C.N, 0)
              for label, (S, T) in api_shapes(eng_c)["baseconv"].items()]
    cases += [("3 -> 4", eng, (0, 1, 2),
               (3, 4, p.num_main, p.num_main + 1), n, 0)
              for n in BASECONV_RAGGED_N]
    wp = eng_w.params
    cases.append(("wide", eng_w, tuple(range(wp.num_main)),
                  tuple(range(wp.num_main, wp.num_total)), p.N, 0))
    return cases


def phase_baseconv(eng, records, gen) -> None:
    """``baseconv`` against its plain version at ``baseconv_cases`` (row
    10's sum is the API shapes', weight 1), with a count of the output
    residues where it differs from the float64 oracle ``ref.baseconv_ref``
    (a finding, not a gate)."""
    from repro_torch.kernels import baseconv as kbc, ref
    for label, e, S, T, N, weight in baseconv_cases(eng):
        ns, nt = len(S), len(T)
        label = f"{label} |S|={ns} |T|={nt} N={N}"
        bargs = baseconv_operands(e, S, T)
        x = rand_residues((ns, N), bargs[1], gen)
        records["baseconv"].add(
            label, lambda: kbc.baseconv_cuda(x, *bargs),
            lambda: kbc.baseconv_plain(x, *bargs),
            ((ns + nt) * N + 5 * ns + nt * ns + 3 * nt) * 4,
            MONTMUL_OPS * N * (ns + ns * nt + nt) + 2 * ns * N,
            reps=20, plain_reps=3, weight=weight)
        got = kbc.baseconv_cuda(x, *bargs)
        h, q, qn, w, dm, inv, qg, qng = bargs
        diff = got != ref.baseconv_ref(x, h, w[:, :, None], dm, inv, q, qn,
                                       qg, qng)
        log(f"[kernels] baseconv {label}: finding, not a gate: "
            f"{int(diff.sum())} of {diff.numel()} output residues "
            f"({int(diff.any(dim=0).sum())} of {N} coefficients) differ from "
            f"the float64 oracle ref.baseconv_ref")


# ---------------------------------------------------------------------------
# the kernel API: the path of modmul, modadd, baseconv, fused_hlt_batched
# ---------------------------------------------------------------------------


def phase_api(eng) -> dict:
    """One counted run of ``repro_torch.kernels.ops`` at the Set-B shapes,
    every output held against the ``kernels/ref.py`` oracles (``baseconv``:
    against the float32 plain version, its own oracle being float64).
    Returns the launch counts of the run."""
    import torch
    from repro_torch.kernels import baseconv as kbc, ops, ref

    p, dev = eng.params, eng.device
    N = p.N
    gen = torch.Generator(device=dev)
    gen.manual_seed(0xAB1)
    shapes = api_shapes(eng)
    ins = {}
    for label, idx in shapes["rows"].items():
        v = eng.basis(idx)
        ins["rows", label] = (rand_residues((len(idx), N), v.moduli_u32, gen),
                              rand_residues((len(idx), N), v.moduli_u32, gen),
                              v.moduli_u32, v.qneg_inv)
    for label, (S, T) in shapes["baseconv"].items():
        bargs = baseconv_operands(eng, S, T)
        ins["bc", label] = (rand_residues((len(S), N), bargs[1], gen),) + bargs
    # fused_hlt_batched: Step 1's two sets of d = 255 at level 15, and
    # Step 2's 2·l sets of d = 2 at level 14
    for step, level in ((1, p.L), (2, p.L - 1)):
        view = eng.basis(eng.tools.digit_bases(level)[0][2])
        q = view.moduli_u32
        perms, is_id = rotation_tables(eng, step)
        B, d = perms.shape[:2]
        nbeta = len(eng.tools.digit_bases(level))
        M = q.shape[0]
        ins["fh", step] = (
            rand_residues((B, nbeta, M, N), q, gen),
            rand_residues((B, M, N), q, gen), rand_residues((B, M, N), q, gen),
            rand_residues((B, d, M, N), q, gen),
            rand_residues((B, d, nbeta, M, N), q, gen),
            rand_residues((B, d, nbeta, M, N), q, gen), perms, is_id, q,
            view.qneg_inv)
    torch.cuda.synchronize()

    ops.reset_launch_counts()                       # the counted run
    out = {}
    for key, a in ins.items():
        if key[0] == "rows":
            out[key] = (ops.modmul(*a), ops.modadd(*a[:3]))
        elif key[0] == "bc":
            out[key] = ops.baseconv(*a)
        else:
            out[key] = ops.fused_hlt_batched(*a)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    want = {k: 0 for k in KERNELS}
    want.update(modmul=2, modadd=2, baseconv=2, fused_hlt_batched=2)
    if launches != want:
        raise AssertionError(f"kernel API run launched {launches}; "
                             f"expected {want}")

    for key, a in ins.items():
        if key[0] == "rows":
            checks = ((out[key][0], ref.modmul_ref(*a)),
                      (out[key][1], ref.modadd_ref(*a[:3])))
        elif key[0] == "bc":
            checks = ((out[key], kbc.baseconv_plain(*a)),)
        else:
            checks = tuple(zip(out[key], ref.fused_hlt_batched_ref(*a)))
        for got, want_t in checks:
            if not torch.equal(got, want_t):
                raise AssertionError(f"kernel API {key}: output differs from "
                                     f"its oracle")
    log(f"[api] repro_torch.kernels.ops at Set-B shapes: outputs equal to the "
        f"kernels/ref.py oracles (baseconv: to its float32 plain version); "
        f"launches {json.dumps({k: v for k, v in launches.items() if v})}")
    return launches


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


def expected_launches(batched: bool, l: int, digits=2,
                      chunks: int = 2) -> dict:
    """Kernel launches of one hemm call on each path (every other kernel
    of ``KERNELS`` launches 0 times); ``digits``: the key-switch digits at
    the products' level (2 at Set-B, 3 at Set-C), or a sequence of them,
    one a hop of a chain of such hemms (the sum over the hops);
    ``chunks``: the batched HLT runs of a call, Step 1 and Step 2 each in
    ``costmodel.step2_chunk``'s chunks (``hlt_chunks``; 2 when neither
    batch reaches the budget)."""
    want = {k: 0 for k in KERNELS}
    for dg in ((digits,) if isinstance(digits, int) else digits):
        per = dg + 4                      # per product: the digits, 2
        add = dict(ntt=per * l, intt=per * l)   # ModDowns, 2 rescales,
        if batched:                       # each an iNTT + an NTT
            add.update(fused_hlt_indexed=chunks, hoist_db=2,
                       intt_scale=chunks, moddown_finish=chunks)
        else:   # 2 + 2·l single HLTs, 4 single hoists (Step 1, Step-2 hoist)
            add.update(fused_hlt=2 + 2 * l, baseconv_ntt=4,
                       intt_scale=4 + 2 + 2 * l, moddown_finish=2 + 2 * l)
        for k, v in add.items():
            want[k] += v
    return want


def hlt_chunks(prog) -> int:
    """The batched fused HLT runs of one call of a hemm or block-MM
    program: its Step-1 and Step-2 batches, each in the chunks of
    ``costmodel.step2_chunk``."""
    from repro_torch.core.costmodel import step2_chunk
    params = prog.ctx.eng.params
    return sum(-(-st.batch // step2_chunk(params, st.level, st.batch))
               for st in (prog.plan.step1, prog.plan.step2))


STAGES = ["start", "step1", "step2_hoist", "step2", "mult_rescale"]


def staged_call(prog, ctA, ctB, on_stage=None):
    """One program call with the device synchronised at each stage
    boundary (then ``on_stage(name)``, if given); returns (output,
    {stage: ms})."""
    import torch
    marks = {}

    def hook(name):
        torch.cuda.synchronize()
        marks[name] = time.perf_counter()
        if on_stage is not None:
            on_stage(name)

    prog.stage_hook = hook
    try:
        out = prog(ctA, ctB)
    finally:
        prog.stage_hook = None
    stages = {k: (marks[k] - marks[STAGES[i]]) * 1e3
              for i, k in enumerate(STAGES[1:])}
    stages["hemm_total"] = (marks["mult_rescale"] - marks["start"]) * 1e3
    return out, stages


def program_paths(prog) -> list:
    """[staged, gathered, identity] (block, rotation) pairs that
    ``tile_sources`` predicts for one call of a ``pallas`` HEMMProgram:
    the sum over its HLT launches (Step 1 and Step 2, batched or
    single) of ``expected_paths`` on each launch's operands."""
    eng = prog.ctx.eng
    runs = ((prog._step1, prog._step2) if getattr(prog.plan, "batched", True)
            else (*prog._step1, *prog._step2))
    total = [0, 0, 0]
    for run in runs:
        *_, perms, is_id = run._operands
        if run.plan.batch is None:          # one DiagSet's operands
            perms, is_id = perms[None], is_id[None]
        M = len(eng.tools.digit_bases(run.plan.level)[0][2])
        got = expected_paths(perms, is_id, run.plan.diag_slots, M,
                             eng.params.N)
        total = [a + b for a, b in zip(total, got)]
    return total


def counted_call(ctx, prog, ctA, ctB, batched: bool, l: int,
                 tag: str = "main"):
    """The path's counted call: every launch counter zeroed just before it
    and read just after, held against ``expected_launches`` for ``l``
    products (a block MM: its tile products, with ``ctA``/``ctB`` its tile
    grids); the fused HLT kernels' gather paths counted on the card and
    held against ``program_paths``."""
    from repro_torch.kernels import ops
    h0 = ctx.counters["hlt_launches"]
    ops.reset_launch_counts()
    res = {}
    paths = count_paths(lambda: res.update(zip(
        ("out", "stages"), staged_call(prog, ctA, ctB))))
    launches = ops.launch_counts()
    hlts = ctx.counters["hlt_launches"] - h0
    # the products run two levels below the program's inputs
    digits = len(ctx.eng.tools.digit_bases(prog.plan.level - 2))
    want = expected_launches(batched, l, digits)
    what = "batched" if batched else "unbatched"
    if launches != want or hlts != (2 if batched else 2 + 2 * l):
        raise AssertionError(f"{what} hemm launched {launches}, {hlts} HLTs; "
                             f"expected {want}")
    want_paths = program_paths(prog)
    if paths[1] != 0 or paths[0] == 0 or paths != want_paths:
        raise AssertionError(f"{what} hemm: fused HLT (block, rotation) "
                             f"pairs staged / gathered / identity {paths}, "
                             f"tile_sources predicts {want_paths}: a Galois "
                             f"rotation missed the staged tile")
    log(f"[{tag}] {what} counted call: fused HLT (block, rotation) pairs "
        f"staged {paths[0]}, gathered from device memory {paths[1]}, "
        f"identity {paths[2]} (as tile_sources predicts)")
    return res["out"], res["stages"], launches


def fmt(stages) -> str:
    return json.dumps({k: round(v, 3) for k, v in stages.items()})


def assert_ct_equal(a, b, what):
    import torch
    if not (torch.equal(a.c0, b.c0) and torch.equal(a.c1, b.c1)
            and a.level == b.level and a.scale == b.scale):
        raise AssertionError(f"{what}: ciphertexts differ")


def check_verified(tag: str, prog) -> None:
    """``verify_program`` on a compiled program (components included):
    no error-severity diagnostic."""
    from repro_torch.analysis import format_report, verify_program
    from repro_torch.analysis.diagnostics import errors
    diags = verify_program(prog)
    if errors(diags):
        raise AssertionError(f"{tag}: verify_program found errors:\n"
                             f"{format_report(diags)}")
    log(f"[{tag}] verify_program({type(prog).__name__}): {len(diags)} "
        f"finding(s), no error")


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
    rng = np.random.default_rng(MAIN_SEED)
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
    check_verified("main", prog)

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
    worst = four_signs(ctx, prog, A, B, ctA, ctB, ctC, rng,
                       f"output level {ctC.level}; peak device memory "
                       f"{peak / 1e9:.2f} GB")
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

    # the cost model's compile of the same product: no schedule, no chunk
    t0 = time.perf_counter()
    cprog = compile_hemm(ctx, plan)
    torch.cuda.synchronize()
    cms = time.perf_counter() - t0
    cp = cprog.plan
    if (cp.schedule, cp.batched) != ("pallas", True) or any(
            st.d_pad != max(st.d) for st in (cp.step1, cp.step2)):
        raise AssertionError(f"cost-model hemm compile: {cp.schedule}, "
                             f"batched {cp.batched}, d_pad "
                             f"{cp.step1.d_pad}/{cp.step2.d_pad}")
    ctD, st = staged_call(cprog, ctA, ctB)
    assert_ct_equal(ctC, ctD, "cost-model hemm vs the explicit program")
    log(f"[main] compile_hemm(ctx, plan) with no schedule or chunk: "
        f"\"{cp.schedule}\", batched, step1 d={max(cp.step1.d)} d_pad="
        f"{cp.step1.d_pad} chunk {cp.step1.chunk}, step2 d_pad="
        f"{cp.step2.d_pad}; compiled in {cms:.1f} s; c0, c1 array-equal to "
        f"the explicit program's; stage ms {fmt(st)}")
    del cprog, ctD

    # the unbatched program: 2 + 2·l single HLTs on the same keys and inputs
    del prog, ctX, ctR
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
    del uprog
    phase_schedules(ctx, plan, ctA, ctB, ctC)
    raw = float(np.abs(decrypt_matrix(ctx.eng, ctx.keys, ctC, m, n)
                       - A @ B).max())
    main = dict(c0=ctC.c0.cpu(), c1=ctC.c1.cpu(), level=ctC.level,
                scale=ctC.scale, err=raw, shape=shape, seed=MAIN_SEED)
    return launches, ulaunches, main


def four_signs(ctx, prog, A, B, ctA, ctB, ctC, rng, note: str,
               tag: str = "main"):
    """Decrypt ``ctC`` = prog(A, B) and the program's outputs on (−A, B),
    (A, −B), (−A, −B); require finite values of the right shape and the
    sign-combined product within ``TOL`` of numpy A·B; print the raw
    max|C − A·B| and the fixed error.  Returns the raw error's argmax.

    The reference's ModDown/Rescale divide by floor ((x - [x]_P)/P): a
    -1/2 bias per coefficient that, at N >= 2^15, lands in the few slots
    whose root lies near ±1 (|Σ ζ^i| ≈ 2N/π) and adds up over the l
    product rescales.  With a stage bias b, each product is (x + b1)·
    (y + b2) + b3: the four sign combinations of the inputs cancel every
    bias term in C(A,B) - C(-A,B) - C(A,-B) + C(-A,-B) = 4·A·B, which
    must agree within the reference tests' tolerance; their mean is the
    program's fixed (data-independent) error."""
    from repro_torch.core.hemm import decrypt_matrix, encrypt_matrix
    m, n = prog.mm_plan.m, prog.mm_plan.n
    ctnA = encrypt_matrix(ctx.eng, ctx.keys, -A, rng)
    ctnB = encrypt_matrix(ctx.eng, ctx.keys, -B, rng)
    outs = {"++": ctC, "-+": prog(ctnA, ctB), "+-": prog(ctA, ctnB),
            "--": prog(ctnA, ctnB)}
    return sign_check({k: decrypt_matrix(ctx.eng, ctx.keys, ct, m, n)
                       for k, ct in outs.items()}, A, B, note, tag)


def sign_check(dec, A, B, note: str, tag: str):
    """``four_signs``' check on the decrypted products ``dec`` of (A, B),
    (−A, B), (A, −B), (−A, −B) (keys "++", "-+", "+-", "--")."""
    import numpy as np
    for k, v in dec.items():
        if v.shape != (A.shape[0], B.shape[1]) or not np.all(np.isfinite(v)):
            raise AssertionError(f"decrypted C({k}) is not finite / mis-shaped")
    raw = np.abs(dec["++"] - A @ B)
    fixed = (dec["++"] + dec["-+"] + dec["+-"] + dec["--"]) / 4
    prod = (dec["++"] - dec["-+"] - dec["+-"] + dec["--"]) / 4
    err = float(np.abs(prod - A @ B).max())
    worst = np.unravel_index(int(raw.argmax()), raw.shape)
    log(f"[{tag}] max|C - A·B| = {raw.max():.3e} at {tuple(map(int, worst))} "
        f"(entries > {TOL}: {int((raw > TOL).sum())} of {raw.size}; mean "
        f"{raw.mean():.3e}); fixed error: max {np.abs(fixed).max():.3e}, "
        f"there {fixed[worst]:+.3e}")
    log(f"[{tag}] sign-combined max|C - A·B| = {err:.3e} (limit {TOL}); "
        f"{note}")
    if not err <= TOL:
        raise AssertionError(f"decrypted product off by {err}")
    return worst


def synced_ms(fn):
    """(fn(), milliseconds on the host clock between device syncs)."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


BASELINE_TOL = 1e-2      # baseline vs hoisted after decrypt (tests/test_hemm.py)


@contextlib.contextmanager
def fused_eps():
    """Diagnostic, not part of the port: while open, the BaseConv floor
    epsilon of the chain form (``core/rns.py`` ``base_conv``, the
    reference's +1e-9) is the fused kernels' (``kernels/basechange.py``
    ``CORRECTION_EPS``, the reference's 0.5e-6).  The two sites differ in
    nothing else: both sum y_i·(1/q_i) in float64 in ascending i without
    FMA.  Yields a function that restores the chain's epsilon early."""
    from repro_torch.core import rns
    from repro_torch.kernels import basechange
    chain = rns.BASE_CONV_EPS

    def restore():
        rns.BASE_CONV_EPS = chain
    rns.BASE_CONV_EPS = basechange.CORRECTION_EPS
    try:
        yield restore
    finally:
        restore()


def count_diff(a, b) -> int:
    return int((a != b).sum())


def phase_schedules(ctx, plan, ctA, ctB, ctC):
    """The reference schedules at Set-B.

    On the "pallas" engine, the Step-1 σ HLT (d = 255, level 15) off the
    fused hoist: ``mo`` and ``hoisted`` array-equal to the ``pallas`` single
    and batched results; ``baseline`` within ``BASELINE_TOL`` of ``hoisted``
    after decrypt.  The hoist's chain form against the fused hoist: its
    differing residues are counted (a finding), and with the fused kernels'
    BaseConv epsilon (``fused_eps``) it must be array-equal.

    Then the engine on "xla", ``HEContext(datapath="xla")`` over the same
    engine and keys, and the whole hemm on ``mo``, which launches no kernel
    (checked): with the fused kernels' epsilon over Steps 1–2 (the HLTs'
    hoists and merged ModDowns, every BaseConv the ``pallas`` program runs
    fused) it must be array-equal to the batched ``pallas`` hemm ``ctC``;
    with the reference's own chain epsilon its differing residues are
    counted and its decrypted output held within ``TOL`` of ``ctC``'s."""
    import numpy as np
    import torch
    from repro_torch.core.compile import HEContext, compile_hemm, compile_hlt
    from repro_torch.core.hemm import decrypt_matrix
    from repro_torch.core.hlt import hoist
    from repro_torch.kernels import ops

    eng, keys, level = ctx.eng, ctx.keys, ctA.level
    sigma = plan.ds_sigma

    def hlt(schedule, chunk, item):
        run = compile_hlt(ctx, sigma, level=level, schedule=schedule,
                          rotation_chunk=chunk)
        return synced_ms(lambda: run(item))

    hst, hms = synced_ms(lambda: hoist(eng, ctA, datapath="pallas"))
    single, pms = hlt("pallas", 1, hst)
    batched, bms = synced_ms(lambda: compile_hlt(
        ctx, [sigma, plan.ds_tau], level=level, schedule="pallas",
        rotation_chunk=1, ct_slots=(0, 1))([ctA, ctB])[0])
    hx, xms = synced_ms(lambda: hoist(eng, ctA, datapath="xla"))
    with fused_eps():
        hx_eps = hoist(eng, ctA, datapath="xla")
    if not torch.equal(hx_eps.digits, hst.digits):
        raise AssertionError("hoist: chain form with the fused epsilon "
                             "differs from the fused hoist at Set-B")
    log(f"[schedules] Set-B σ HLT d={sigma.d} level {level} on the \"pallas\" "
        f"engine: hoist fused {hms:.3f} ms, chain {xms:.3f} ms (digits: "
        f"{count_diff(hx.digits, hst.digits)} of {hst.digits.numel()} "
        f"residues differ; 0 with the fused epsilon); pallas single "
        f"{pms:.3f} ms after the hoist, batched σ+τ {bms:.3f} ms with its "
        f"hoist")
    del hx, hx_eps
    assert_ct_equal(single, batched, "σ HLT pallas single vs batched")
    outs = {}
    for schedule, chunk in (("mo", 8), ("hoisted", None)):
        outs[schedule], ms = hlt(schedule, chunk, hst)
        assert_ct_equal(single, outs[schedule], f"σ HLT {schedule} vs pallas")
        log(f"[schedules] σ HLT {schedule} (rotation_chunk={chunk}): "
            f"array-equal to pallas single and batched; {ms:.3f} ms after "
            f"the hoist")
    base, ms = hlt("baseline", None, ctA)
    vb = eng.decrypt_decode(base, keys)
    vh = eng.decrypt_decode(outs["hoisted"], keys)
    diff = float(np.abs(vb - vh).max())
    log(f"[schedules] σ HLT baseline ({sigma.d - 1} rotations, each a "
        f"KeySwitch): {ms:.3f} ms; max|baseline - hoisted| after decrypt "
        f"= {diff:.3e} over {vb.size} slots (limit {BASELINE_TOL})")
    if not diff <= BASELINE_TOL:
        raise AssertionError(f"baseline off hoisted by {diff}")
    del hst, single, batched, outs, base

    # the whole hemm with no kernel: "mo" on an "xla" engine and context
    xctx = HEContext(eng, keys, datapath="xla")
    prog = compile_hemm(xctx, plan, schedule="mo", rotation_chunk=8,
                        batched=True)
    runs = {}

    def counted_mo(on_stage=None):
        ops.reset_launch_counts()
        out = staged_call(prog, ctA, ctB, on_stage)
        launches = ops.launch_counts()
        if any(launches.values()):
            raise AssertionError(f"mo hemm on the \"xla\" engine launched "
                                 f"{launches}")
        return out

    eng.datapath = "xla"
    try:
        with fused_eps() as restore:
            # Steps 1-2 only: the products' BaseConvs are the same in both
            def at_stage(name):
                if name == "step2":
                    restore()
            runs["fused"] = counted_mo(at_stage)
        runs["reference"] = counted_mo()
    finally:
        eng.datapath = "pallas"
    ctF, st = runs["fused"]
    assert_ct_equal(ctC, ctF, "mo hemm on \"xla\" (fused epsilon) vs batched "
                    "pallas hemm")
    log(f"[schedules] hemm on mo, HEContext(datapath=\"xla\"), \"xla\" "
        f"engine, fused epsilon over Steps 1-2: 0 kernel launches; c0, c1 "
        f"array-equal to the batched pallas hemm; stage ms {fmt(st)}")
    ctM, st = runs["reference"]
    m, n = plan.m, plan.n
    dm = decrypt_matrix(eng, keys, ctM, m, n)
    dc = decrypt_matrix(eng, keys, ctC, m, n)
    ddiff = float(np.abs(dm - dc).max())
    nd = count_diff(ctM.c0, ctC.c0) + count_diff(ctM.c1, ctC.c1)
    log(f"[schedules] the same hemm with the chain's own epsilon (the "
        f"reference's arithmetic): 0 kernel launches; {nd} of "
        f"{2 * ctC.c0.numel()} output residues differ from the batched "
        f"pallas hemm; max|C_mo - C_pallas| after decrypt = {ddiff:.3e} "
        f"(limit {TOL}); stage ms {fmt(st)}")
    if not (ctM.level == ctC.level and ddiff <= TOL):
        raise AssertionError(f"mo hemm off the pallas hemm by {ddiff}")


# ---------------------------------------------------------------------------
# phase 3b: block MM over a tile grid at Set-B
# ---------------------------------------------------------------------------


def assert_grid_equal(a, b, what):
    for i, (ra, rb) in enumerate(zip(a, b, strict=True)):
        for j, (x, y) in enumerate(zip(ra, rb, strict=True)):
            assert_ct_equal(x, y, f"{what}, tile ({i}, {j})")


def phase_blockmm(params) -> dict:
    """Set-B block MM through ``SecureMatmulEngine`` (tile ``BLOCKMM_TILE``,
    no schedule, no chunk) on a ``"pallas"`` engine: A·B of the shapes
    ``BLOCKMM_SHAPES``, every dimension off the tile.  Checks the cost
    model's pick, the launches and gather paths of the counted call, the
    sequential loop against the batched program, the four-sign product and
    the aliasing hint; prints stage times and peak memory.  Returns the
    counted call's launches."""
    import numpy as np
    import torch
    from repro_torch.core.ckks import CkksEngine
    from repro_torch.core.compile import HEContext, compile_blockmm
    from repro_torch.kernels import ops
    from repro_torch.secure import SecureMatmulEngine

    (m, l), (_, n) = BLOCKMM_SHAPES
    rng = np.random.default_rng(20262)
    t0 = time.perf_counter()
    engine = SecureMatmulEngine(params, tile=BLOCKMM_TILE, ctx=HEContext(
        CkksEngine(params, datapath="pallas")))
    ctx, plan = engine.ctx, engine._plan
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    engine.keygen(rng)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    A = rng.uniform(-1, 1, (m, l))
    B = rng.uniform(-1, 1, (l, n))
    At, Bt = engine.encrypt_tiles(A, rng), engine.encrypt_tiles(B, rng)
    grid = (len(At), len(Bt), len(Bt[0]))
    # the program SecureMatmulEngine.matmul_encrypted runs (memoized)
    prog = compile_blockmm(ctx, plan, grid, level=At[0][0].level,
                           schedule=engine.schedule,
                           rotation_chunk=engine.rotation_chunk)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    bp = prog.plan
    products = bp.l * grid[0] * grid[1] * grid[2]
    log(f"[blockmm] {params.name} A {m}x{l} · B {l}x{n}, tile {plan.m} "
        f"(grid {grid}, l = {bp.l}, {products} products) through "
        f"SecureMatmulEngine on CkksEngine(datapath=\"pallas\"): plan "
        f"{t1 - t0:.1f} s, keygen {t2 - t1:.1f} s ({len(ctx.keys.galois)} "
        f"Galois keys), encrypt+compile {t3 - t2:.1f} s; arena "
        f"{ctx.arena.nbytes / 1e9:.2f} GB; cost model: \"{engine.schedule}\""
        f" / \"{bp.schedule}\", step1 B={bp.step1.batch} d="
        f"{max(bp.step1.d)} d_pad={bp.step1.d_pad}, step2 B="
        f"{bp.step2.batch} d={max(bp.step2.d)} d_pad={bp.step2.d_pad}; "
        f"hlt_launches {bp.hlt_launches} (naive {bp.hlt_launches_naive})")
    if (engine.schedule, bp.schedule, engine.batched) != ("pallas", "pallas",
                                                          True):
        raise AssertionError(f"block MM: the cost model picked "
                             f"{engine.schedule} / {bp.schedule}")
    if any(st.d_pad != max(st.d) for st in (bp.step1, bp.step2)):
        raise AssertionError("block MM: the cost model padded d")
    if grid != (2, 2, 2) or bp.hlt_launches != 2:
        raise AssertionError(f"block MM: grid {grid}, {bp.hlt_launches} "
                             f"HLT launches")
    check_verified("blockmm", prog)

    torch.cuda.reset_peak_memory_stats()
    C, stages, launches = counted_call(ctx, prog, At, Bt, True, products,
                                       "blockmm")
    peak = torch.cuda.max_memory_allocated()
    log(f"[blockmm] batched counted call: launches {json.dumps(launches)}; "
        f"stage ms {fmt(stages)}; peak device memory {peak / 1e9:.2f} GB")
    _, st = staged_call(prog, At, Bt)
    log(f"[blockmm] batched timed call: stage ms {fmt(st)}")

    # the sequential loop: one unbatched hemm per (i, j, k) tile pair
    ops.reset_launch_counts()
    loop, lms = synced_ms(lambda: engine.matmul_encrypted(At, Bt,
                                                          batched=False))
    llaunch = ops.launch_counts()
    digits = len(ctx.eng.tools.digit_bases(bp.level - 2))
    pairs = grid[0] * grid[1] * grid[2]
    want = {k: pairs * v
            for k, v in expected_launches(False, bp.l, digits).items()}
    if llaunch != want:
        raise AssertionError(f"block MM loop launched {llaunch}; expected "
                             f"{want}")
    assert_grid_equal(C, loop, "block MM loop vs batched")
    log(f"[blockmm] sequential loop ({pairs} unbatched tile hemms): "
        f"{lms:.3f} ms; launches {json.dumps(llaunch)}; every tile "
        f"array-equal to the batched program's")
    del loop

    # the four sign combinations cancel the reference's rescale bias
    nAt, nBt = engine.encrypt_tiles(-A, rng), engine.encrypt_tiles(-B, rng)
    outs = {"++": C, "-+": prog(nAt, Bt), "+-": prog(At, nBt),
            "--": prog(nAt, nBt)}
    sign_check({k: engine.decrypt_tiles(v, m, n) for k, v in outs.items()},
               A, B, f"output level {C[0][0].level}", "blockmm")
    del outs, nAt, nBt

    # a repeated A tile object, with and without the aliasing hint
    At2 = [list(At[0]), [At[0][0], At[1][1]]]
    hint = (0, 1, 0, 3)
    want_out = prog(At2, Bt)
    got = engine._matmul_encrypted_batched(At2, Bt, a_slots=hint)
    assert_grid_equal(want_out, got, "block MM with a_slots vs without")
    ap = compile_blockmm(ctx, plan, grid, level=At[0][0].level,
                         schedule=engine.schedule,
                         rotation_chunk=engine.rotation_chunk,
                         a_slots=hint).plan
    drops = (bp.step1.hoist_bytes - ap.step1.hoist_bytes,
             bp.step2.hoist_bytes - ap.step2.hoist_bytes)
    units = (bp.step1.hoist_bytes // 8, bp.step2.hoist_bytes // 8)
    if drops != units:
        raise AssertionError(f"a_slots: hoist bytes drop {drops}, one "
                             f"hoisting product a stage is {units}")
    log(f"[blockmm] a_slots={hint} on a repeated A tile: array-equal to the "
        f"unhinted call; plan hoist_bytes {bp.hoist_bytes} -> "
        f"{ap.hoist_bytes} (one hoisting product a stage: {units})")
    return launches


# ---------------------------------------------------------------------------
# phase 3c: the Set-C path
# ---------------------------------------------------------------------------


def phase_set_c(shape) -> None:
    """Set-C (logN 16, L 31, k 12, β 3; unreduced), the hemm ``shape`` on
    ``CkksEngine(SET_C, datapath="pallas")``: keygen, the batched program's
    counted call (launches held against ``expected_launches``, gather
    paths against ``program_paths``) and a timed call, the four-sign check
    with the raw error and the peak device memory printed; the unbatched
    program array-equal to the batched one (``baseconv_ntt``, ``fused_hlt``
    and the 2-polynomial ``intt_scale`` at logN 16); then the Step-1 σ HLT
    on ``mo`` with the engine and context on ``"xla"`` and the fused
    kernels' epsilon (``fused_eps``), which launches no kernel, array-equal
    to the ``pallas`` σ HLT: the kernel-free oracle at logN 16."""
    import numpy as np
    import torch
    from repro_torch.core.ckks import CkksEngine
    from repro_torch.core.compile import HEContext, compile_hemm, compile_hlt
    from repro_torch.core.hemm import encrypt_matrix, plan_hemm
    from repro_torch.core.hlt import hoist
    from repro_torch.core.params import SET_C
    from repro_torch.kernels import ops

    m, l, n = shape
    rng = np.random.default_rng(20261)
    t0 = time.perf_counter()
    ctx = HEContext(CkksEngine(SET_C, datapath="pallas"))
    eng = ctx.eng
    plan = plan_hemm(eng, m, l, n)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    ctx.keygen(rng, rot_steps=plan.rot_steps)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    A = rng.uniform(-1, 1, (m, l))
    B = rng.uniform(-1, 1, (l, n))
    ctA = encrypt_matrix(eng, ctx.keys, A, rng)
    ctB = encrypt_matrix(eng, ctx.keys, B, rng)
    prog = compile_hemm(ctx, plan, schedule="pallas", rotation_chunk=1)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    log(f"[set-c] {SET_C.name} (logN {SET_C.logN}, L {SET_C.L}, k {SET_C.k},"
        f" beta {SET_C.beta}) hemm {m}x{l}x{n} on CkksEngine(datapath="
        f"\"pallas\"): plan {t1 - t0:.1f} s ({plan.total_rotations} "
        f"rotations), keygen {t2 - t1:.1f} s ({len(ctx.keys.galois)} Galois "
        f"keys), encrypt+compile {t3 - t2:.1f} s; arena "
        f"{ctx.arena.nbytes / 1e9:.2f} GB, step1 d={prog.plan.step1.d[0]}, "
        f"step2 B={prog.plan.step2.batch}")
    check_verified("set-c", prog)
    prog(ctA, ctB)                                  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ctC, stages, launches = counted_call(ctx, prog, ctA, ctB, True, l, "set-c")
    peak = torch.cuda.max_memory_allocated()
    log(f"[set-c] batched counted call: launches {json.dumps(launches)}; "
        f"stage ms {fmt(stages)}")
    _, st = staged_call(prog, ctA, ctB)
    log(f"[set-c] batched timed call: stage ms {fmt(st)}")
    four_signs(ctx, prog, A, B, ctA, ctB, ctC, rng,
               f"output level {ctC.level}; peak device memory "
               f"{peak / 1e9:.2f} GB over the counted call", "set-c")

    del prog
    ctx.invalidate()
    torch.cuda.empty_cache()
    uprog = compile_hemm(ctx, plan, schedule="pallas", rotation_chunk=1,
                         batched=False)
    ctU, stages, ulaunches = counted_call(ctx, uprog, ctA, ctB, False, l,
                                          "set-c")
    assert_ct_equal(ctC, ctU, "Set-C unbatched vs batched hemm")
    log(f"[set-c] unbatched counted call: array-equal to the batched "
        f"program's output; launches {json.dumps(ulaunches)}; stage ms "
        f"{fmt(stages)}")
    del uprog, ctU
    ctx.invalidate()
    torch.cuda.empty_cache()

    level, sigma = ctA.level, plan.ds_sigma
    run = compile_hlt(ctx, sigma, level=level, schedule="pallas",
                      rotation_chunk=1)
    want, pms = synced_ms(lambda: run(hoist(eng, ctA, datapath="pallas")))
    xctx = HEContext(eng, ctx.keys, datapath="xla")
    xrun = compile_hlt(xctx, sigma, level=level, schedule="mo",
                       rotation_chunk=8)
    eng.datapath = "xla"
    try:
        with fused_eps():
            ops.reset_launch_counts()
            got, mms = synced_ms(lambda: xrun(ctA))
            xl = ops.launch_counts()
    finally:
        eng.datapath = "pallas"
    if any(xl.values()):
        raise AssertionError(f"Set-C σ HLT on mo, \"xla\" launched {xl}")
    assert_ct_equal(want, got, "Set-C σ HLT mo (\"xla\", fused epsilon) vs "
                    "pallas")
    log(f"[set-c] σ HLT d={sigma.d} level {level}: mo on the \"xla\" engine "
        f"and HEContext(datapath=\"xla\") with the fused epsilon, 0 kernel "
        f"launches, {mms:.3f} ms with its chain hoist; c0, c1 array-equal "
        f"to pallas (hoist + fused_hlt + merged ModDown), {pms:.3f} ms")


# ---------------------------------------------------------------------------
# phase 3d: a chain of hemm hops at Set-B
# ---------------------------------------------------------------------------


def chain_call(prog, ctX, w_cts):
    """One chain call with the device synchronised at each hop's stage
    boundaries; returns (hop outputs, [{stage: ms} per hop], total ms)."""
    import torch
    marks = {}

    def hook(h, name):
        torch.cuda.synchronize()
        marks[h, name] = time.perf_counter()

    prog.stage_hook = hook
    try:
        outs = prog.run_hops(ctX, w_cts)
    finally:
        prog.stage_hook = None
    hops = []
    for h in range(len(outs)):
        st = {k: (marks[h, k] - marks[h, STAGES[i]]) * 1e3
              for i, k in enumerate(STAGES[1:])}
        st["hemm_total"] = (marks[h, "mult_rescale"] - marks[h, "start"]) * 1e3
        hops.append(st)
    total = (marks[len(outs) - 1, "mult_rescale"] - marks[0, "start"]) * 1e3
    return outs, hops, total


def chain_counted(ctx, prog, ctX, w_cts, batched: bool, tag: str):
    """The chain's counted call: every launch counter zeroed just before it
    and read just after, held against ``expected_launches`` summed over the
    hops (each with the key-switch digits at its products' level), the
    context's HLT and program counts, the gather paths against
    ``program_paths`` over the hops, no decrypt inside the call, and each
    hop's output (level, scale) against the plan's trace exactly.
    Returns (hop outputs, launches)."""
    from repro_torch.kernels import ops
    plan = prog.plan
    eng = ctx.eng
    l = plan.shapes[0][1]
    digits = [len(eng.tools.digit_bases(lvl - 2)) for lvl in plan.hop_levels]
    c0, d0 = dict(ctx.counters), eng.op_counts["decrypts"]
    ops.reset_launch_counts()
    res = {}
    paths = count_paths(lambda: res.update(outs=prog.run_hops(ctX, w_cts)))
    launches = ops.launch_counts()
    hlts = ctx.counters["hlt_launches"] - c0["hlt_launches"]
    progs = ctx.counters["program_launches"] - c0["program_launches"]
    want = expected_launches(batched, l, digits)
    what = "batched" if batched else "unbatched"
    k = plan.k
    if launches != want or hlts != k * (2 if batched else 2 + 2 * l) \
            or progs != k + 1:
        raise AssertionError(f"{what} chain launched {launches}, {hlts} HLTs, "
                             f"{progs} programs; expected {want}")
    if eng.op_counts["decrypts"] != d0:
        raise AssertionError(f"{what} chain decrypted inside the call")
    want_paths = [sum(x) for x in zip(*(program_paths(hp)
                                        for hp in prog._hops))]
    if paths[1] != 0 or paths != want_paths:
        raise AssertionError(f"{what} chain: (block, rotation) pairs "
                             f"{paths}, tile_sources predicts {want_paths}")
    got = [(o.level, o.scale) for o in res["outs"]]
    if got != [(st.level, st.scale) for st in plan.hop_out]:
        raise AssertionError(f"{what} chain: hop outputs (level, scale) "
                             f"{got}, traced {plan.hop_out}")
    log(f"[{tag}] {what} counted call: key-switch digits per hop "
        f"{digits}; {hlts} HLT launches, {progs} program launches, 0 "
        f"decrypts; (block, rotation) pairs staged {paths[0]}, gathered "
        f"{paths[1]}, identity {paths[2]} (as tile_sources predicts); every "
        f"hop's (level, scale) equal to plan.hop_out")
    return res["outs"], launches


def chain_kernels(eng, l: int, levels) -> None:
    """The kernels of the chain's later hops at their own shapes, which no
    earlier phase runs, each held array-equal to its plain version on
    random residues: for each hop input level ℓ in ``levels``, the Step-1
    HLT at ℓ (2 ciphertexts) and the Step-2 HLT at ℓ − 1 (2·l), each with
    its hoist (``hoist_db``; ``baseconv_ntt``, the unbatched hoist), its
    merged ModDown (``intt_scale`` through its row table,
    ``moddown_finish`` at the batched and the unbatched shape) and its
    rotation kernel (``fused_hlt_indexed``; ``fused_hlt`` on one set) on
    the Galois tables; then the products' ``ntt`` / ``intt`` at ℓ − 2
    over every basis a mult → rescale transforms, each key-switch digit's
    own and generated rows included.  At ℓ = 9 these are the one-prime
    Step-2 digit (level 8: digits of 8 and 1 primes), the 18- and 17-limb
    ModDowns and the single-digit key switch at level 7."""
    import torch
    from repro_torch.kernels import basechange as bc, fused_hlt as fh
    from repro_torch.kernels import ntt as kntt

    p, dev = eng.params, eng.device
    N = p.N
    gen = torch.Generator(device=dev)
    gen.manual_seed(0xC4A1)

    def same(what, got, want):
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"chain kernels: {what} differs from its "
                                 f"plain version")

    for top in levels:
        for step, level, B in ((1, top, 2), (2, top - 1, 2 * l)):
            full = eng.tools.digit_bases(level)[0][2]
            view = eng.basis(full)
            q = view.moduli_u32
            M, nq = len(full), level + 1
            t = eng.fused_hoist_tables(level)
            nbeta, alpha = t["nbeta"], t["alpha"]
            na = [min(alpha, nq - j * alpha) for j in range(nbeta)]
            tag = f"step {step} level {level}"
            tabs = [t[k] for k in HOIST_KEYS]
            kw = dict(nbeta=nbeta, alpha=alpha)
            c1s = rand_residues((2, nq, N), q[:nq], gen)
            same(f"hoist_db {tag}", bc.hoist_db_cuda(c1s, *tabs, **kw),
                 bc.hoist_db_plain(c1s, *tabs, **kw))
            y = rand_residues((nbeta * alpha, N), t["q_pad"], gen)
            for j in range(nbeta):     # a short digit's rows are zero-padded
                y[j * alpha + na[j]:(j + 1) * alpha] = 0
            btabs = (t["w"], t["d"], t["inv_d"], t["psi_full"], t["q_full"],
                     t["qneg_full"], rand_residues((M, N), q, gen), t["mask"])
            same(f"baseconv_ntt {tag}", bc.baseconv_ntt_cuda(y, *btabs),
                 bc.baseconv_ntt_plain(y, *btabs))
            del c1s, y, btabs

            mt = eng.fused_moddown_tables(level)
            P, drop, R = 2 * B, mt["drop_idx"], mt["n_out"]
            x = rand_residues((P, M, N), q, gen)
            itabs = (mt["psii_drop"], mt["ninv_drop"], mt["hat_drop"],
                     mt["q_drop"], mt["qneg_drop"])
            ys = bc.intt_scale_rows_cuda(x, drop, *itabs)
            same(f"intt_scale {tag} P={P}", ys,
                 bc.intt_scale_plain(x[:, drop], *itabs))
            mtabs = (mt["w"], mt["d"], mt["inv_d"], mt["psi_out"],
                     mt["p_inv"], mt["q_out"], mt["qneg_out"])
            for P_ in (P, 2):
                same(f"moddown_finish {tag} P={P_}",
                     bc.moddown_finish_cuda(x[:P_, :R], ys[:P_], *mtabs),
                     bc.moddown_finish_plain(x[:P_, :R], ys[:P_], *mtabs))
            del x, ys

            perms, is_id = rotation_tables(eng, step)
            S, d = perms.shape[:2]
            args = (rand_residues((2, nbeta, M, N), q, gen),
                    rand_residues((2, M, N), q, gen),
                    rand_residues((2, M, N), q, gen),
                    rand_residues((S, d, M, N), q, gen),
                    rand_residues((S, d, nbeta, M, N), q, gen),
                    rand_residues((S, d, nbeta, M, N), q, gen), perms, is_id,
                    torch.tensor([0, 1] if step == 1 else [0] * l + [1] * l,
                                 dtype=torch.int32, device=dev),
                    torch.arange(S, dtype=torch.int32, device=dev), q,
                    view.qneg_inv)
            same(f"fused_hlt_indexed {tag}", fh.fused_hlt_indexed_cuda(*args),
                 fh.fused_hlt_indexed_plain(*args))
            one = tuple(a[0] for a in args[:8]) + args[10:]
            same(f"fused_hlt {tag}", fh.fused_hlt_cuda(*one),
                 fh.fused_hlt_plain(*one))
            del args, one
            torch.cuda.empty_cache()
            log(f"[chain] kernels at step {step}, level {level} (digits "
                f"{na}, {M} limbs, B={B}): hoist_db, baseconv_ntt, "
                f"intt_scale (P={P}, {len(drop)} drop rows), moddown_finish "
                f"(P={P} and 2, {R} rows), fused_hlt_indexed (S={S}, d={d}) "
                f"and fused_hlt equal to plain")

        ell = top - 2
        spec = list(range(p.num_main, p.num_total))
        bases = eng.tools.digit_bases(ell)
        fwd = [list(g) for _, g, _ in bases] + [list(range(ell + 1)),
                                                 list(range(ell))]
        inv = [list(o) for o, _, _ in bases] + [spec, [ell]]
        for name, cases in (("ntt", fwd), ("intt", inv)):
            for idx in cases:
                v = eng.basis(idx)
                x = rand_residues((1, len(idx), N), v.moduli_u32, gen)
                if name == "ntt":
                    tb = (v.psi_brv_mont, v.moduli_u32, v.qneg_inv)
                    kern, plain = kntt.ntt_cuda, kntt.ntt_plain
                else:
                    tb = (v.psi_inv_brv_mont, v.n_inv_mont, v.moduli_u32,
                          v.qneg_inv)
                    kern, plain = kntt.intt_cuda, kntt.intt_plain
                same(f"{name} level {ell} rows={len(idx)}", kern(x, *tb),
                     plain(x, *tb))
        log(f"[chain] kernels at the products' level {ell} ({len(bases)} "
            f"key-switch digit(s), own rows "
            f"{[len(o) for o, _, _ in bases]}): ntt over "
            f"{[len(i) for i in fwd]} rows and intt over "
            f"{[len(i) for i in inv]} rows equal to plain")


def phase_chain(params) -> dict:
    """Set-B chain Y = X·W1·W2·W3 of three hemm 128³ hops
    (``plan_hemm_chain`` on ``CHAIN_DIMS``) on ``CkksEngine(SET_B,
    datapath="pallas")`` with ``HEContext(verify="error")``: the cost
    model's schedules, a warm-up, the counted call (``chain_counted``), a
    timed call with each hop's stage times, the same chain with every hop
    unbatched (``fused_hlt`` / ``baseconv_ntt``) array-equal hop by hop,
    the product against numpy once the reference's rescale bias is
    cancelled by the call on −X, the rejection of a 6-hop chain with
    nothing built, and ``verify_program`` on the chain; before all of it,
    ``chain_kernels`` at the later hops' levels.  Returns the counted
    call's launches."""
    import numpy as np
    import torch
    from repro_torch.analysis import VerificationError, max_chain_depth
    from repro_torch.core.ckks import CkksEngine
    from repro_torch.core.compile import (HEContext, HEMMChainProgram,
                                          compile_hemm, compile_hemm_chain)
    from repro_torch.core.hemm import (decrypt_matrix, encrypt_matrix,
                                       plan_hemm_chain)
    from repro_torch.kernels import ops

    dims = CHAIN_DIMS
    m, l, n = dims[0], dims[1], dims[-1]
    rng = np.random.default_rng(20263)
    t0 = time.perf_counter()
    ctx = HEContext(CkksEngine(params, datapath="pallas"), verify="error")
    eng = ctx.eng
    chain = plan_hemm_chain(eng, dims)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    if any(hp is not chain.hops[0] for hp in chain.hops):
        raise AssertionError("chain hops of one shape do not share a plan")
    depth = max_chain_depth(eng.ctx.moduli_host, chain.hops[0],
                            level=params.L, scale=params.scale)
    chain_kernels(eng, l, [params.L - 3 * h for h in range(1, chain.k)])
    torch.cuda.synchronize()
    tk = time.perf_counter()
    log(f"[chain] chain_kernels {tk - t1:.1f} s")
    ctx.keygen(rng, rot_steps=chain.rot_steps)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    prog = compile_hemm_chain(ctx, chain)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    cp = prog.plan
    log(f"[chain] {params.name} chain {' x '.join(map(str, dims))} "
        f"({cp.k} hops of hemm {m}x{l}x{l}) on CkksEngine(datapath="
        f"\"pallas\"), HEContext(verify=\"error\"): plan {t1 - t0:.1f} s, "
        f"keygen {t2 - tk:.1f} s ({len(ctx.keys.galois)} Galois keys), "
        f"compile {t3 - t2:.1f} s; max_chain_depth at level {params.L}: "
        f"{depth}; schedules {cp.schedules}; hop input levels "
        f"{cp.hop_levels}, outputs {[(s.level, s.scale) for s in cp.hop_out]}"
        f"; operand bytes per hop {cp.hop_bytes} (arena "
        f"{ctx.arena.nbytes / 1e9:.2f} GB), hoist bytes {cp.hoist_bytes}")
    if cp.schedules != ("pallas",) * cp.k or cp.k != 3:
        raise AssertionError(f"chain: the cost model picked {cp.schedules}")
    if any(max(hp.step1.d) != hp.step1.d_pad or
           max(hp.step2.d) != hp.step2.d_pad for hp in cp.hops):
        raise AssertionError("chain: the cost model padded d")
    check_verified("chain", prog)

    # MLP-style weights: entries of standard deviation 1/√l keep every
    # hop's output of the order of X
    X = rng.uniform(-1, 1, (m, l))
    Ws = [rng.uniform(-1, 1, (dims[h + 1], dims[h + 2]))
          * np.sqrt(3.0 / dims[h + 1]) for h in range(cp.k)]
    ctX = encrypt_matrix(eng, ctx.keys, X, rng)
    w_cts = prog.encrypt_weights(Ws, rng)
    prog(ctX, w_cts)                                # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    outs, launches = chain_counted(ctx, prog, ctX, w_cts, True, "chain")
    peak = torch.cuda.max_memory_allocated()
    log(f"[chain] batched counted call: launches {json.dumps(launches)}; "
        f"peak device memory {peak / 1e9:.2f} GB over the call")
    _, hops, total = chain_call(prog, ctX, w_cts)
    for h, st in enumerate(hops):
        log(f"[chain] batched timed call, hop {h} (input level "
            f"{cp.hop_levels[h]}): stage ms {fmt(st)}")
    log(f"[chain] batched timed call: {total:.3f} ms for {cp.k} hops")

    # −X with the same weight ciphertexts: (Y(X) − Y(−X)) / 2 cancels the
    # data-independent part of the reference's floor-rescale bias
    ctN = encrypt_matrix(eng, ctx.keys, -X, rng)
    yp = decrypt_matrix(eng, ctx.keys, outs[-1], m, n)
    yn = decrypt_matrix(eng, ctx.keys, prog(ctN, w_cts), m, n)
    want = X
    for W in Ws:
        want = want @ W
    for y in (yp, yn):
        if y.shape != (m, n) or not np.all(np.isfinite(y)):
            raise AssertionError("decrypted chain output is not finite / "
                                 "mis-shaped")
    raw = float(np.abs(yp - want).max())
    err = float(np.abs((yp - yn) / 2 - want).max())
    log(f"[chain] max|Y - X·W1·W2·W3| = {raw:.3e} (|Y| up to "
        f"{np.abs(want).max():.3f}); sign-combined with -X: {err:.3e} "
        f"(limit {TOL}); output level {outs[-1].level}")
    if not err <= TOL:
        raise AssertionError(f"chain output off by {err}")

    # every hop unbatched (fused_hlt / baseconv_ntt), on the same keys
    uhops = [compile_hemm(ctx, hp, level=lvl, schedule="pallas",
                          batched=False)
             for hp, lvl in zip(chain.hops, cp.hop_levels, strict=True)]
    uprog = HEMMChainProgram(ctx, chain, dataclasses.replace(
        cp, hops=tuple(hp.plan for hp in uhops)), uhops)
    uouts, ulaunches = chain_counted(ctx, uprog, ctX, w_cts, False, "chain")
    for h, (a, b) in enumerate(zip(outs, uouts, strict=True)):
        assert_ct_equal(a, b, f"chain hop {h}, unbatched vs batched")
    _, uhops, utotal = chain_call(uprog, ctX, w_cts)
    log(f"[chain] unbatched: every hop array-equal to the batched chain's; "
        f"launches {json.dumps(ulaunches)}; timed call {utotal:.3f} ms, hop "
        f"stage ms {[fmt(st) for st in uhops]}")
    del uprog, uouts

    # a chain deeper than the modulus chain: refused before anything builds
    deep = plan_hemm_chain(eng, (m,) * (REJECT_HOPS + 2))
    before = (len(ctx.arena), len(ctx._compiled), dict(ctx.counters))
    ops.reset_launch_counts()
    try:
        compile_hemm_chain(ctx, deep)
    except VerificationError as e:
        rules = {d.rule for d in e.diagnostics if d.severity == "error"}
    else:
        raise AssertionError(f"a {REJECT_HOPS}-hop chain compiled")
    ctx.verify = "warn"
    try:
        compile_hemm_chain(ctx, deep)
    except ValueError as e:
        why = str(e).split(":")[0]
    else:
        raise AssertionError(f"a {REJECT_HOPS}-hop chain compiled under warn")
    finally:
        ctx.verify = "error"
    after = (len(ctx.arena), len(ctx._compiled), dict(ctx.counters))
    if not rules or not rules <= {"LS001", "LS003"} or after != before \
            or any(ops.launch_counts().values()):
        raise AssertionError(f"{REJECT_HOPS}-hop chain: error rules {rules}; "
                             f"arena/memo/counters {before} -> {after}; "
                             f"launches {ops.launch_counts()}")
    log(f"[chain] {REJECT_HOPS}-hop chain (needs level {3 * REJECT_HOPS}): "
        f"VerificationError with error rules {sorted(rules)} under "
        f"\"error\", ValueError ({why}) under \"warn\"; arena, memo, "
        f"counters and launches unchanged")
    return launches


def cpu_vs_cuda_chain():
    """The fame-m-chain depth-3 chain 4×4 · 4×4 · 4×4 · 4×4 on cuda and on
    cpu (``HEContext(verify="error")`` on a ``"pallas"`` engine): every
    hop's c0 and c1 array-equal, the output within ``TOL`` of numpy."""
    import numpy as np
    from repro_torch.configs.fame_sets import FAME_CHAIN_SETS
    from repro_torch.core.ckks import CkksEngine
    from repro_torch.core.compile import HEContext, compile_hemm_chain
    from repro_torch.core.hemm import (decrypt_matrix, encrypt_matrix,
                                       plan_hemm_chain)
    from repro_torch.core.params import u32_numpy

    params = FAME_CHAIN_SETS["fame-m-chain"]
    dims = (4,) * 5
    outs = {}
    for dev in ("cuda", "cpu"):
        rng = np.random.default_rng(11)
        ctx = HEContext(CkksEngine(params, device=dev, datapath="pallas"),
                        verify="error")
        chain = plan_hemm_chain(ctx.eng, dims)
        ctx.keygen(rng, rot_steps=chain.rot_steps)
        prog = compile_hemm_chain(ctx, chain)
        X = rng.uniform(-0.5, 0.5, (4, 4))
        Ws = [rng.uniform(-0.5, 0.5, (4, 4)) for _ in range(3)]
        hops = prog.run_hops(encrypt_matrix(ctx.eng, ctx.keys, X, rng),
                             prog.encrypt_weights(Ws, rng))
        err = float(np.abs(decrypt_matrix(ctx.eng, ctx.keys, hops[-1], 4, 4)
                           - X @ Ws[0] @ Ws[1] @ Ws[2]).max())
        if not err <= TOL:
            raise AssertionError(f"fame-m-chain chain on {dev}: off by {err}")
        outs[dev] = [(u32_numpy(ct.c0), u32_numpy(ct.c1), ct.level, ct.scale)
                     for ct in hops]
    for h, (g, w) in enumerate(zip(outs["cuda"], outs["cpu"], strict=True)):
        np.testing.assert_array_equal(g[0], w[0], err_msg=f"hop {h} c0")
        np.testing.assert_array_equal(g[1], w[1], err_msg=f"hop {h} c1")
        if g[2:] != w[2:]:
            raise AssertionError(f"fame-m-chain hop {h}: {g[2:]} vs {w[2:]}")
    log(f"[cpu-vs-cuda] fame-m-chain chain 4x4x4x4x4 (3 hops, schedules "
        f"{prog.plan.schedules}): every hop's c0, c1 array-equal on cuda and "
        f"cpu; max|Y - X·W1·W2·W3| = {err:.3e}")


# ---------------------------------------------------------------------------
# phase 3e: multi-tenant secure serving at Set-B
# ---------------------------------------------------------------------------


def key_bytes(keys) -> int:
    """Device bytes of one tenant's keyset (secret, relinearisation key
    and every Galois key)."""
    ts = [keys.s_eval, keys.evk_mult.k0, keys.evk_mult.k1]
    for k in keys.galois.values():
        ts += [k.k0, k.k1]
    return sum(t.numel() * t.element_size() for t in ts)


def serve_rows(rng, n: int) -> list:
    """One tenant's ``SERVE_REQUESTS`` activation rows: the first two
    share a prompt (equal content, separate arrays)."""
    x = rng.uniform(-1, 1, n)
    return [x, x.copy()] + [rng.uniform(-1, 1, n)
                            for _ in range(SERVE_REQUESTS - 2)]


def serve_flush(serving, calls, tag: str):
    """Submit ``calls`` and flush once (``traced_flush``)."""
    for c in calls:
        serving.batcher.submit(c)
    return traced_flush(serving, f"[serve] {tag}", serving.batcher.flush)


def traced_flush(serving, tag: str, flush):
    """Run ``flush`` (the batcher's flush, or the original one where it is
    wrapped) with the device synchronised at each stage the batcher marks;
    print the stage times and memory after ``tag``.  Returns (rows, StepStats, the launch
    counts over the whole flush, the program stage's launches of each
    group, the flush's peak device memory)."""
    import torch
    from repro_torch.kernels import ops
    bat = serving.batcher
    marks, counts = [], []

    def hook(name):
        torch.cuda.synchronize()
        marks.append((name, time.perf_counter()))
        counts.append(ops.launch_counts())

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    bat.stage_hook = hook
    t0 = time.perf_counter()
    try:
        res = flush()
    finally:
        bat.stage_hook = None
    torch.cuda.synchronize()
    total = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated()
    launches = ops.launch_counts()
    st = bat.steps[-1]
    prev = t0
    groups, program = [], []
    for i, (name, t) in enumerate(marks):
        if name == "encrypt":
            groups.append({})
        if name != "sessions":
            groups[-1][name] = (t - prev) * 1e3
        if name == "program":
            program.append({k: counts[i][k] - counts[i - 1][k]
                            for k in counts[i]})
        prev = t
    log(f"{tag}: {st.n_calls} calls, {st.n_groups} groups, program "
        f"launches {st.program_launches}, HLT launches {st.hlt_launches}, "
        f"tiles {st.n_tiles} ({st.n_uniq_tiles} unique), cache hits "
        f"{st.cache_hits} misses {st.cache_misses}; flush {total:.3f} ms "
        f"(sessions {(marks[0][1] - t0) * 1e3:.3f}; per group ms "
        f"{[fmt(g) for g in groups]}); peak device memory "
        f"{peak / 1e9:.2f} GB; memory allocated after "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB, live arenas "
        f"{serving.pool.live_arena_bytes / 1e9:.2f} GB")
    return res, st, launches, program, peak


def phase_serve(params) -> dict:
    """Multi-tenant secure serving at Set-B through
    ``build_secure_serving`` (``ModelConfig(secure_layers=(0,))``, W0
    ``SERVE_DIM``², tile ``BLOCKMM_TILE``, ``he_max_sessions``
    ``SERVE_MAX_LIVE``, ``verify="error"``): tenants A, B and C, each
    submitting ``SERVE_REQUESTS`` requests a step, two of them sharing a
    prompt.  Steps: A + B (compile), A + B on −x (cache hits; the sign
    check), B + C (C's keygen), B + C (A, the coldest arena, evicted),
    A + B (A recompiled, keys kept), A's requests of that step again with
    one program per request on the same ciphertexts (C evicted); then
    A's requests as a loop of unbatched tile hemms on the same
    ciphertexts, and one of A's result tiles under B's keys.  Returns the
    launches of the first all-hit step's flush."""
    import numpy as np
    import torch
    from repro_torch.models import ModelConfig
    from repro_torch.serve import SecureCall, ServeConfig, build_secure_serving

    n, R = SERVE_DIM, SERVE_REQUESTS
    rng = np.random.default_rng(20264)
    W0 = rng.standard_normal((n, n)) / np.sqrt(n)
    cfg = ModelConfig(name="serve-set-b", family="dense", num_layers=1,
                      d_model=n, num_heads=2, d_ff=4 * n, vocab_size=256,
                      secure_layers=(0,))
    scfg = ServeConfig(he_tile=BLOCKMM_TILE, he_max_sessions=SERVE_MAX_LIVE)
    serving = build_secure_serving(cfg, scfg, {0: W0}, rng, he_params=params,
                                   verify="error")
    pool, cache, bat = serving.pool, serving.cache, serving.batcher
    if pool.eng.datapath != "pallas":
        raise AssertionError("the serving pool's engine is not on "
                             "\"pallas\"")

    # each arena eviction: memory allocated and live arena bytes around it
    evicted = []
    evict = pool._evict_cold

    def traced_evict():
        before = {t: s.stats.arena_evictions
                  for t, s in pool._sessions.items()}
        torch.cuda.synchronize()
        m0, a0 = torch.cuda.memory_allocated(), pool.live_arena_bytes
        evict()
        who = [t for t, s in pool._sessions.items()
               if s.stats.arena_evictions > before[t]]
        if not who:
            return
        torch.cuda.synchronize()
        m1, a1 = torch.cuda.memory_allocated(), pool.live_arena_bytes
        evicted.append(who)
        freed, dropped = m0 - m1, a0 - a1
        log(f"[serve] arena eviction of {who}: memory allocated "
            f"{m0 / 1e9:.3f} -> {m1 / 1e9:.3f} GB (freed {freed / 1e9:.3f});"
            f" pool.live_arena_bytes {a0 / 1e9:.3f} -> {a1 / 1e9:.3f} GB "
            f"(dropped {dropped / 1e9:.3f}); "
            + ("the evicted operands stay resident: the stale program in "
               "HEProgramCache still holds them" if freed < dropped / 2
               else "the evicted operands were freed"))

    pool._evict_cold = traced_evict

    def calls(tenant, rows, first):
        return [SecureCall(first + r, 0, x, tenant=tenant)
                for r, x in enumerate(rows)]

    def check(st, tag, groups, hits, misses, evictions, stale, who=None,
              per_request=False):
        """The step's StepStats and the pool's and cache's eviction
        counts as the LRU policy predicts them (``who``: the tenants whose
        arena this step evicted)."""
        launches = R * groups if per_request else groups
        got = (st.n_groups, st.program_launches, st.hlt_launches,
               st.cache_hits, st.cache_misses, pool.evictions,
               cache.evictions)
        want = (groups, launches, 2 * launches, hits, misses, evictions,
                stale)
        if got != want or not st.n_uniq_tiles < st.n_tiles:
            raise AssertionError(f"serve {tag}: (groups, launches, HLT "
                                 f"launches, hits, misses, arena evictions, "
                                 f"stale programs dropped) {got}, expected "
                                 f"{want}; tiles {st.n_tiles} unique "
                                 f"{st.n_uniq_tiles}")
        if who is not None and evicted[-1] != who:
            raise AssertionError(f"serve {tag}: evicted {evicted[-1]}, "
                                 f"expected {who}")

    def program_launches_exact(program, tag):
        """Each group's program stage: the block MM's launches for its
        l·R·gl·gn tile products, as ``expected_launches`` counts them."""
        sess = pool._sessions["B"]
        level = sess.linears[0]._w_tiles[0][0].level
        digits = len(sess.ctx.eng.tools.digit_bases(level - 2))
        g = -(-n // BLOCKMM_TILE)
        want = expected_launches(True, BLOCKMM_TILE * R * g * g, digits)
        for g in program:
            if g != want:
                raise AssertionError(f"serve {tag}: a group's program "
                                     f"launched {g}; expected {want}")

    t0 = time.perf_counter()
    rows = {t: serve_rows(rng, n) for t in "AB"}
    res1, st, _, _, peak1 = serve_flush(
        serving, calls("A", rows["A"], 0) + calls("B", rows["B"], R),
        "step 1, A + B (compile)")
    check(st, "step 1", 2, 0, 2, 0, 0)
    sa, sb = pool._sessions["A"], pool._sessions["B"]
    keys_a = sa.keys
    log(f"[serve] keys a tenant {key_bytes(keys_a) / 1e9:.3f} GB "
        f"({len(keys_a.galois)} Galois keys); arena a tenant "
        f"{sa.ctx.arena.nbytes / 1e9:.3f} GB; cost model \"{sa.engine.schedule}\"")
    if sa.engine.schedule != "pallas":
        raise AssertionError(f"serve: the cost model picked "
                             f"{sa.engine.schedule}")

    res2, st, launches, program, _ = serve_flush(
        serving, calls("A", [-x for x in rows["A"]], 0)
        + calls("B", [-x for x in rows["B"]], R),
        "step 2, A + B on -x (cache hits)")
    check(st, "step 2", 2, 2, 0, 0, 0)
    program_launches_exact(program, "step 2")
    log(f"[serve] step 2 launches {json.dumps(launches)}")
    raw = err = 0.0
    for t, first in (("A", 0), ("B", R)):
        for r, x in enumerate(rows[t]):
            yp, yn = res1[(first + r, 0)], res2[(first + r, 0)]
            if yp.shape != (n,) or not np.all(np.isfinite(yp)):
                raise AssertionError("serve: output row not finite / "
                                     "mis-shaped")
            raw = max(raw, float(np.abs(yp - x @ W0).max()))
            err = max(err, float(np.abs((yp - yn) / 2 - x @ W0).max()))
    log(f"[serve] max|y - x·W0| = {raw:.3e} over {2 * R} rows; "
        f"sign-combined with -x: {err:.3e} (limit {TOL})")
    if not err <= TOL:
        raise AssertionError(f"serving output off by {err}")

    rows3 = {t: serve_rows(rng, n) for t in "BC"}
    _, st, _, _, _ = serve_flush(
        serving, calls("B", rows3["B"], 0) + calls("C", rows3["C"], R),
        "step 3, B + C (C's keygen)")
    check(st, "step 3", 2, 1, 1, 0, 0)
    _, st, _, program, _ = serve_flush(
        serving, calls("B", rows3["B"], 0) + calls("C", rows3["C"], R),
        "step 4, B + C (A's arena evicted)")
    check(st, "step 4", 2, 2, 0, 1, 0, who=["A"])
    program_launches_exact(program, "step 4")

    rows5 = {t: serve_rows(rng, n) for t in "AB"}
    a_calls = calls("A", rows5["A"], 0)
    state = bat.rng.bit_generator.state
    res5, st, _, _, _ = serve_flush(
        serving, a_calls + calls("B", rows5["B"], R),
        "step 5, A + B (A recompiled)")
    check(st, "step 5", 2, 1, 1, 1, 1)
    if pool._sessions["A"].keys is not keys_a or sa.stats.keygens != 1:
        raise AssertionError("serve: tenant A re-keyed, or its stale "
                             "program was not dropped")

    # A's group again, one program per request, on the same ciphertexts
    bat.rng.bit_generator.state = state
    bat.batch_requests = False
    try:
        res6, st, _, _, _ = serve_flush(
            serving, a_calls, "step 6, A per request (C's arena evicted)")
    finally:
        bat.batch_requests = True
    check(st, "step 6", 1, 2, 1, 2, 1, who=["C"], per_request=True)
    for c in a_calls:
        if not np.array_equal(res6[(c.request_id, 0)],
                              res5[(c.request_id, 0)]):
            raise AssertionError("serve: per-request row differs from the "
                                 "batched one")

    # ... and as a loop of unbatched tile hemms (SecureLinear's engine)
    bat.rng.bit_generator.state = state
    lin = sa.linears[0]
    gl, gn = len(lin._w_tiles), len(lin._w_tiles[0])
    A_tiles, _, _ = bat._encrypt_group(sa, a_calls, gl)
    tl = time.perf_counter()
    out = None
    for r, c in enumerate(a_calls):
        out = sa.engine.matmul_encrypted([A_tiles[r]], lin._w_tiles,
                                         batched=False)
        y = np.concatenate([sa.decrypt_row(out[0][j], BLOCKMM_TILE)
                            for j in range(gn)])
        if not np.array_equal(y, res5[(c.request_id, 0)]):
            raise AssertionError("serve: the loop's row differs from the "
                                 "batched one")
    torch.cuda.synchronize()
    loop_ms = (time.perf_counter() - tl) * 1e3
    want = a_calls[-1].x @ W0
    under_b = np.concatenate([sb.decrypt_row(out[0][j], BLOCKMM_TILE)
                              for j in range(gn)])
    iso = float(np.abs(under_b - want).max())
    log(f"[serve] batched rows array-equal to the per-request programs' "
        f"and to a loop of {R * gl * gn} unbatched tile hemms "
        f"({loop_ms:.3f} ms); A's result under B's keys off by {iso:.3e}")
    if not iso > 1.0:
        raise AssertionError(f"serve: tenant B's keys decrypt tenant A's "
                             f"result (error {iso})")
    for tenant, sess in pool._sessions.items():
        if sess.ctx._compiled:
            check_verified(f"serve {tenant}", next(
                p for p in sess.ctx._compiled.values()
                if type(p).__name__ == "BlockMMProgram"))
    log(f"[serve] pool {json.dumps(pool.report())}; cache "
        f"{json.dumps(cache.report())}; first flush peak "
        f"{peak1 / 1e9:.2f} GB; steps {time.perf_counter() - t0:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# phase 3f: the dense LM serving path, internlm2-1.8b at full width
# ---------------------------------------------------------------------------


def timed_calls(fn, ms: list):
    """``fn`` wrapped to append each call's milliseconds (the device
    synchronised before and after) to ``ms``."""
    import torch

    def wrapper(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        return out
    return wrapper


def serve_vs_forward(cfg, params, seq) -> list:
    """Prefill of all but the last 2 positions of ``seq`` (token ids, or
    the audio family's float frame embeddings) and two decode steps
    against one ``forward`` over them all: finite logits of the right
    shape; per step (max|diff|, max of |diff| / (LM_TOL + LM_TOL·|logit|),
    max|logit|), a ratio above 1 being outside the reference test's
    bound."""
    import torch
    from repro_torch.models import transformer as tf
    from repro_torch.serve import serve_decode_step, serve_prefill_step
    B, S = seq.shape[0], seq.shape[1] - 2
    if seq.is_floating_point():
        full, _ = tf.forward(cfg, params, None, embeds=seq)
    else:
        full, _ = tf.forward(cfg, params, seq)
    cache = tf.init_cache(cfg, B, S + 8)
    lg, cache = serve_prefill_step(cfg, params, seq[:, :S], cache)
    pairs = [(lg, full[:, S - 1])]
    for i in range(2):
        lg, cache = serve_decode_step(cfg, params, seq[:, S + i:S + i + 1],
                                      cache, S + i)
        pairs.append((lg, full[:, S + i]))
    out = []
    for got, want in pairs:
        got = got[:, 0]
        if got.shape != (B, cfg.vocab_size) or \
                not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{cfg.name}: logits {tuple(got.shape)} not "
                                 f"finite or mis-shaped")
        d = (got - want).abs()
        out.append((float(d.max()),
                    float((d / (LM_TOL + LM_TOL * want.abs())).max()),
                    float(want.abs().max())))
    return out


def lm_forward_check(cfg, params, tag: str, frames: bool = False) -> None:
    """Prefill of ``LM_CHECK_S`` positions and two decode steps (batch 2)
    against one ``forward`` (``serve_vs_forward``) on the same weights in
    float32, which must be within the reference test's ``LM_TOL``, and as
    served in the config's dtype, whose gap is printed: at full width
    bf16 rounding alone takes a few logits just past that bound (PERF.md
    §6).  A MoE is checked dropless (capacity factor E/k), as the
    reference's smoke configs are: below that, which (token, expert)
    pairs a group drops depends on the group's tokens, so the serve path
    is not the train path; its gap at the config's own capacity factor is
    printed.  ``frames``: random frame embeddings instead of token ids
    (the audio family's float input)."""
    import torch
    B, S = 2, LM_CHECK_S
    dev = params["embed"].device
    gen = torch.Generator(device=dev).manual_seed(1)
    if frames:
        seq = torch.randn((B, S + 2, cfg.d_model), generator=gen, device=dev)
    else:
        seq = torch.randint(0, cfg.vocab_size, (B, S + 2), generator=gen,
                            device=dev)
    check = cfg
    if cfg.capacity_factor * cfg.experts_per_token < cfg.num_experts:
        check = dataclasses.replace(
            cfg, capacity_factor=cfg.num_experts / cfg.experts_per_token)
    f32 = _to(params, torch.float32)
    got = {"float32": serve_vs_forward(
        dataclasses.replace(check, dtype="float32"), f32, seq)}
    del f32
    got[cfg.dtype] = serve_vs_forward(check, params, seq)
    if check is not cfg:
        got[f"{cfg.dtype} at capacity factor {cfg.capacity_factor}"] = \
            serve_vs_forward(cfg, params, seq)
    what = "frame embeddings" if frames else "tokens"
    for dtype, steps in got.items():
        log(f"[{tag}] {cfg.name} {dtype}: prefill {S} {what} + 2 decode "
            f"steps vs forward (B {B}): max|diff| "
            f"{['%.3e' % e for e, _, _ in steps]}, ratio to {LM_TOL} + "
            f"{LM_TOL}·|logit| {['%.3f' % r for _, r, _ in steps]} "
            f"(max|logit| {max(m for _, _, m in steps):.3f})")
    if not all(r <= 1 for _, r, _ in got["float32"]):
        raise AssertionError(f"{cfg.name}: float32 serve path off forward: "
                             f"{got['float32']}")


def lm_plaintext(arch: str, tag: str):
    """``launch/serve.py``'s ``main`` on ``arch`` at full width on the card
    (``LM_REQUESTS`` requests of ``LM_MAX_NEW`` tokens), its prefill and
    decode calls timed; then ``lm_forward_check`` on its weights.
    Returns (cfg, params)."""
    import torch
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import transformer as tf
    prefill_ms, decode_ms = [], []
    orig = tf.prefill, tf.decode_step
    tf.prefill = timed_calls(orig[0], prefill_ms)
    tf.decode_step = timed_calls(orig[1], decode_ms)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        b = launch_serve.main(["--arch", arch, "--requests",
                               str(LM_REQUESTS), "--max-new",
                               str(LM_MAX_NEW)])
    finally:
        tf.prefill, tf.decode_step = orig
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    cfg, params = b.cfg, b.params
    want = [LM_MAX_NEW + 1] * LM_REQUESTS
    got = [len(b.results[r]) for r in sorted(b.results)]
    if got != want or not all(0 <= t < cfg.vocab_size
                              for r in b.results.values() for t in r):
        raise AssertionError(f"{arch}: tokens per request {got}, expected "
                             f"{want}")
    if len(prefill_ms) != LM_REQUESTS or len(decode_ms) != LM_MAX_NEW:
        raise AssertionError(f"{arch}: {len(prefill_ms)} prefills and "
                             f"{len(decode_ms)} decode steps")
    log(f"[{tag}] {cfg.name} ({cfg.family}): {cfg.num_layers} layers, d "
        f"{cfg.d_model}, {cfg.num_heads} heads ({cfg.kv_heads} KV), d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab_size}, {cfg.dtype}: "
        f"{cfg.param_count() / 1e9:.3f} G parameters, "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")
    log(f"[{tag}] launch/serve.py main on {arch}: {LM_REQUESTS} requests, "
        f"{len(decode_ms)} decode steps (batch {b.scfg.max_batch}) in "
        f"{total:.1f} s with weight init; prefill ms a request "
        f"{['%.3f' % t for t in prefill_ms]}; ms a decode step "
        f"{['%.3f' % t for t in decode_ms]} (median "
        f"{sorted(decode_ms)[len(decode_ms) // 2]:.3f}); peak "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    del b
    lm_forward_check(cfg, params, tag)
    return cfg, params


def _to(tree, where):
    """Every tensor of a parameter tree ``.to(where)``: a device or a
    dtype."""
    if isinstance(tree, dict):
        return {k: _to(v, where) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, where) for v in tree]
    return tree.to(where)


def lm_secure(cfg0, params, he_params, spec: dict) -> dict:
    """Layer 0 of the full-width model served under HE at Set-B: W0
    (d_model × ``LM_SECURE_OUT``, one output tile) from a numpy seed,
    scaled so that x·W0 has standard deviation ``LM_SECURE_STD`` for an
    embedding row x; ``build_secure_serving`` (tile ``BLOCKMM_TILE``,
    ``verify="error"``) behind a ``ContinuousBatcher`` of 2 slots.
    ``spec`` (``LM_SECURE`` / ``FAM_SECURE``): the requests' prompt
    lengths and tenants, their new tokens, each flush's (groups, hits,
    misses), the hit flush whose groups' program launches are held
    against ``expected_launches`` (Step 2 in ``hlt_chunks`` chunks), and
    the flush, if any, held against a loop of unbatched tile hemms.
    Returns the hit flush's launches."""
    import numpy as np
    import torch
    from repro_torch.serve import (ContinuousBatcher, SecureCall,
                                   ServeConfig, build_secure_serving)

    tag = spec["tag"]
    cfg = dataclasses.replace(cfg0, secure_layers=(0,))
    d, t = cfg.d_model, BLOCKMM_TILE
    rng = np.random.default_rng(20266)
    x_std = 1.0 / np.sqrt(cfg.vocab_size)     # dense_init of the embedding
    W0 = rng.standard_normal((d, LM_SECURE_OUT)) * (
        LM_SECURE_STD / (np.sqrt(d) * x_std))
    scfg = ServeConfig(max_batch=2, max_len=64, he_tile=t)
    serving = build_secure_serving(cfg, scfg, {0: W0}, rng,
                                   he_params=he_params, verify="error")
    pool, cache, bat = serving.pool, serving.cache, serving.batcher
    if pool.eng.datapath != "pallas":
        raise AssertionError("the serving pool's engine is not on "
                             "\"pallas\"")
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in spec["prompts"]]
    b = ContinuousBatcher(cfg, scfg, params, secure=serving)
    for p, tenant in zip(prompts, spec["tenants"], strict=True):
        b.submit(p, spec["max_new"], tenant=tenant)

    flushes = []
    real_flush = bat.flush

    def flush():
        calls = list(bat._pending)
        state = bat.rng.bit_generator.state
        res, st, launches, program, peak = traced_flush(
            serving, f"[{tag}] step {len(flushes) + 1}", real_flush)
        flushes.append(dict(calls=calls, state=state, res=res, st=st,
                            launches=launches, program=program, peak=peak))
        return res

    bat.flush = flush
    step_ms = []
    t0 = time.perf_counter()
    try:
        while True:
            ts = time.perf_counter()
            if not b.step():
                break
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - ts) * 1e3)
    finally:
        bat.flush = real_flush
    log(f"[{tag}] secure serving: {len(step_ms)} steps in "
        f"{time.perf_counter() - t0:.1f} s; ms a step (flush + decode) "
        f"{['%.1f' % x for x in step_ms]}")

    # each step: one program a tenant in flight; hits and misses as the
    # cache predicts
    got = []
    for f in flushes:
        st = f["st"]
        tenants = len({c.tenant for c in f["calls"]})
        if not st.program_launches == st.n_groups == tenants or \
                st.hlt_launches != 2 * st.n_groups:
            raise AssertionError(f"{tag}: {st}")
        got.append((st.n_groups, st.cache_hits, st.cache_misses))
    if got != spec["want"]:
        raise AssertionError(f"{tag}: (groups, hits, misses) a step {got}, "
                             f"expected {spec['want']}")
    sa = pool._sessions[spec["tenants"][0]]
    lin = sa.linears[0]
    gl, gn = len(lin._w_tiles), len(lin._w_tiles[0])
    level = lin._w_tiles[0][0].level
    digits = len(sa.ctx.eng.tools.digit_bases(level - 2))
    prog = next(p for p in sa.ctx._compiled.values()
                if type(p).__name__ == "BlockMMProgram")
    chunks = hlt_chunks(prog)
    want_prog = expected_launches(True, t * gl * gn, digits, chunks)
    hit = flushes[spec["hit"]]
    for g in hit["program"]:
        if g != want_prog:
            raise AssertionError(f"{tag} step {spec['hit'] + 1}: a group's "
                                 f"program launched {g}; expected "
                                 f"{want_prog}")
    log(f"[{tag}] grid (1, {gl}, {gn}) a request, {t * gl * gn} products "
        f"and {prog.plan.step2.batch} Step-2 HLTs a group, Step 1 and 2 in "
        f"{chunks} chunks; step {spec['hit'] + 1}'s groups launched exactly "
        f"{json.dumps(want_prog)}; keys a tenant "
        f"{key_bytes(sa.keys) / 1e9:.3f} GB, arena "
        f"{sa.ctx.arena.nbytes / 1e9:.3f} GB; peak a flush "
        f"{['%.2f' % (f['peak'] / 1e9) for f in flushes]} GB "
        f"(80.92 GB for the internlm2-1.8b group before Step 2 ran in "
        f"chunks, with expandable segments)")

    # the secure layer is a side output: the tokens of a plaintext run
    plain = ContinuousBatcher(cfg0, scfg, params)
    for p in prompts:
        plain.submit(p, spec["max_new"])
    while plain.step():
        pass
    if plain.results != b.results:
        raise AssertionError(f"{tag}: secure run's tokens {b.results} "
                             f"differ from the plaintext run's "
                             f"{plain.results}")

    # error: every row raw; step 1's rows against the same rows negated
    raw = 0.0
    for f in flushes:
        for c in f["calls"]:
            y = f["res"][(c.request_id, 0)]
            if y.shape != (LM_SECURE_OUT,) or not np.all(np.isfinite(y)):
                raise AssertionError(f"{tag}: output row not finite / "
                                     f"mis-shaped")
            raw = max(raw, float(np.abs(y - c.x @ W0).max()))
    for c in flushes[0]["calls"]:
        bat.submit(SecureCall(c.request_id, 0, -c.x, c.tenant))
    neg, _, _, _, _ = traced_flush(serving, f"[{tag}] step 1's rows on -x",
                                   bat.flush)
    err = scale = 0.0
    for c in flushes[0]["calls"]:
        want_y = c.x @ W0
        y = (flushes[0]["res"][(c.request_id, 0)]
             - neg[(c.request_id, 0)]) / 2
        err = max(err, float(np.abs(y - want_y).max()))
        scale = max(scale, float(np.abs(want_y).max()))
    log(f"[{tag}] max|x·W0| {scale:.3f} (std {LM_SECURE_STD} by design); "
        f"raw max|y - x·W0| {raw:.3e} over every row; sign-cancelled with "
        f"-x {err:.3e} ({err / scale:.3%} of max|x·W0|, limit "
        f"{LM_ERR_SHARE:.0%})")
    if not err <= LM_ERR_SHARE * scale:
        raise AssertionError(f"{tag}: secure output off by {err}")

    if spec["loop"] is not None:
        # a hit flush (one group) as a loop of tile hemms (fused_hlt /
        # baseconv_ntt) on the same ciphertexts
        from repro_torch.kernels import ops
        f3 = flushes[spec["loop"]]
        bat.rng.bit_generator.state = f3["state"]
        A_tiles, _, _ = bat._encrypt_group(sa, f3["calls"], gl)
        ops.reset_launch_counts()
        tl = time.perf_counter()
        out = sa.engine.matmul_encrypted(A_tiles, lin._w_tiles,
                                         batched=False)
        for r, c in enumerate(f3["calls"]):
            y = np.concatenate([sa.decrypt_row(out[r][j], LM_SECURE_OUT)
                                for j in range(gn)])
            if not np.array_equal(y, f3["res"][(c.request_id, 0)]):
                raise AssertionError(f"{tag}: the loop's row differs from "
                                     f"the batched one")
        torch.cuda.synchronize()
        loop = ops.launch_counts()
        if not (loop["fused_hlt"] and loop["baseconv_ntt"]) or \
                loop["fused_hlt_indexed"]:
            raise AssertionError(f"{tag}: the loop launched {loop}")
        log(f"[{tag}] step {spec['loop'] + 1}'s row array-equal to a loop "
            f"of {gl * gn} unbatched tile hemms on the same ciphertexts "
            f"({(time.perf_counter() - tl):.1f} s; fused_hlt "
            f"{loop['fused_hlt']}, baseconv_ntt {loop['baseconv_ntt']} "
            f"launches)")
    check_verified(f"{tag} {spec['tenants'][0]}", prog)
    log(f"[{tag}] pool {json.dumps(pool.report())}; cache "
        f"{json.dumps(cache.report())}")
    return hit["launches"]


def phase_lm(he_params) -> dict:
    """Phase 3f: ``lm_plaintext`` on ``LM_ARCH`` then ``lm_secure`` on its
    weights.  Returns the launches of the secure path's step-2 flush."""
    cfg, params = lm_plaintext(LM_ARCH, "lm")
    return lm_secure(cfg, params, he_params, LM_SECURE)


def phase_families(he_params) -> dict:
    """Phase 3g: the non-dense families at full width.  ``FAM_ARCH`` (the
    MoE) through ``lm_plaintext`` and under HE (``FAM_SECURE``: one
    tenant, a compile step then a hit); then each of ``FAM_PLAIN``
    through ``lm_plaintext`` alone, the audio model's check also on frame
    embeddings.  Returns the launches of the secure path's hit flush."""
    import torch
    cfg, params = lm_plaintext(FAM_ARCH, "fam")
    launches = lm_secure(cfg, params, he_params, FAM_SECURE)
    for arch in FAM_PLAIN:
        del params
        gc.collect()
        torch.cuda.empty_cache()
        cfg, params = lm_plaintext(arch, "fam")
        if cfg.family == "audio":
            lm_forward_check(cfg, params, "fam", frames=True)
    return launches


def cpu_vs_cuda_lm():
    """The ``LM_ARCH`` smoke config in float32 served on cuda and on cpu
    from the same weights: ``forward`` logits within 1e-4; then a
    ``ContinuousBatcher`` with a toy secure layer (logN 6, tile 4, tenants
    A, B, A): tokens identical, every secure row and StepStats equal."""
    import numpy as np
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.params import toy_params
    from repro_torch.models import transformer as tf
    from repro_torch.serve import (ContinuousBatcher, ServeConfig,
                                   build_secure_serving)

    cfg = dataclasses.replace(get_smoke_config(LM_ARCH), dtype="float32",
                              secure_layers=(0,))
    cpu = tf.init_params(cfg, torch.Generator().manual_seed(3))
    params = {"cpu": cpu, "cuda": _to(cpu, "cuda")}
    tokens = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 18))
    logits = {dev: tf.forward(cfg, p, torch.as_tensor(tokens, device=dev))[0]
              .cpu().numpy() for dev, p in params.items()}
    np.testing.assert_allclose(logits["cuda"], logits["cpu"], rtol=1e-4,
                               atol=1e-4)
    runs = {}
    for dev, p in params.items():
        rng = np.random.default_rng(11)
        W = rng.standard_normal((cfg.d_model, 4)) * 0.4
        scfg = ServeConfig(max_batch=2, max_len=32, he_tile=4)
        serving = build_secure_serving(
            cfg, scfg, {0: W}, rng, device=dev,
            he_params=toy_params(logN=6, L=4, k=3, beta=2))
        b = ContinuousBatcher(cfg, scfg, p, secure=serving)
        for n, tenant in zip((5, 7, 6), "ABA"):
            b.submit(rng.integers(0, cfg.vocab_size, n).astype(np.int32), 2,
                     tenant=tenant)
        while b.step():
            pass
        runs[dev] = (b.results, b.secure_results,
                     [dataclasses.asdict(s) for s in serving.batcher.steps])
    (tok_g, rows_g, st_g), (tok_c, rows_c, st_c) = runs["cuda"], runs["cpu"]
    if tok_g != tok_c or st_g != st_c:
        raise AssertionError(f"{LM_ARCH} smoke: tokens or StepStats differ "
                             f"between cuda and cpu")
    n = 0
    for rid, outs in rows_c.items():
        for g, c in zip(rows_g[rid], outs, strict=True):
            np.testing.assert_array_equal(g[0], c[0])
            n += 1
    log(f"[cpu-vs-cuda] {cfg.name} (float32): forward logits within 1e-4 "
        f"(max|diff| {float(np.abs(logits['cuda'] - logits['cpu']).max()):.3e}"
        f"); secure serving (toy logN 6, tile 4, tenants A, B, A): tokens "
        f"identical, {n} rows array-equal, {len(st_c)} steps' StepStats "
        f"equal")



def cpu_vs_cuda_vlm():
    """The ``VLM_ARCH`` smoke config (175 GB at full width) in float32 on
    cuda and on cpu from the same weights, with a frontend (B, T,
    frontend_dim) for its cross-attention: ``forward`` logits, prefill +
    two decode steps' logits and the kv cache within 1e-4."""
    import numpy as np
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import transformer as tf

    cfg = dataclasses.replace(get_smoke_config(VLM_ARCH), dtype="float32")
    cpu = tf.init_params(cfg, torch.Generator().manual_seed(4))
    rng = np.random.default_rng(4)
    B, S = 2, 16
    tokens = rng.integers(0, cfg.vocab_size, (B, S + 2))
    front = rng.standard_normal((B, cfg.frontend_tokens, cfg.frontend_dim),
                                dtype=np.float32)
    outs = {}
    for dev, p in (("cpu", cpu), ("cuda", _to(cpu, "cuda"))):
        tok = torch.as_tensor(tokens, device=dev)
        fe = torch.as_tensor(front, device=dev)
        full, _ = tf.forward(cfg, p, tok, frontend=fe)
        cache = tf.init_cache(cfg, B, S + 8, device=dev)
        lg, cache = tf.prefill(cfg, p, tok[:, :S], cache, frontend=fe)
        steps = [lg]
        for i in range(2):
            lg, cache = tf.decode_step(cfg, p, tok[:, S + i:S + i + 1], cache,
                                       S + i, frontend=fe)
            steps.append(lg)
        outs[dev] = [t.cpu().numpy() for t in
                     [full] + steps + [cache["kv"]["k"], cache["kv"]["v"]]]
    diff = 0.0
    for g, c in zip(outs["cuda"], outs["cpu"], strict=True):
        np.testing.assert_allclose(g, c, rtol=1e-4, atol=1e-4)
        diff = max(diff, float(np.abs(g - c).max()))
    np.testing.assert_allclose(outs["cpu"][3][:, 0], outs["cpu"][0][:, S + 1],
                               rtol=LM_TOL, atol=LM_TOL)
    log(f"[cpu-vs-cuda] {cfg.name} (float32, frontend {front.shape}): "
        f"forward, prefill + 2 decode logits and the kv cache within 1e-4 "
        f"(max|diff| {diff:.3e}); the last decode step within {LM_TOL} of "
        f"forward")

# ---------------------------------------------------------------------------
# phase 3h: the training stack, internlm2-1.8b trained at full width
# ---------------------------------------------------------------------------


def cuda_timed(fn, events: list):
    """``fn`` wrapped to record a pair of CUDA events around each call,
    appended to ``events`` (read after a synchronize: no sync here)."""
    import torch

    def wrapper(*args, **kw):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = fn(*args, **kw)
        b.record()
        events.append((a, b))
        return out
    return wrapper


def run_launcher(argv: list, events=None):
    """``repro_torch.launch.train``'s ``main(argv)`` with its printed lines
    logged, each train step timed by ``cuda_timed`` into ``events`` when
    given.  Returns (the ``TrainRun``, the printed text)."""
    from repro_torch.launch import train as launch_train
    orig = launch_train.train_step
    if events is not None:
        launch_train.train_step = cuda_timed(orig, events)
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            run = launch_train.main(argv)
    finally:
        launch_train.train_step = orig
    for line in buf.getvalue().splitlines():
        log(f"[train]   {line}")
    return run, buf.getvalue()


def check_train_run(run, steps: int, what: str) -> list:
    """A launcher run to ``steps``: every step's loss and grad norm finite,
    its lr equal to ``lr_at`` (float32 against float64, within 1e-6), the
    parameters equal to their float32 master cast to their dtype, the
    state's step ``steps``.  Returns the losses."""
    import torch
    from repro_torch.train.optimizer import lr_at
    from repro_torch.tree import leaves
    if len(run.metrics) != steps - run.start:
        raise AssertionError(f"{what}: {len(run.metrics)} steps run")
    losses = []
    for i, m in enumerate(run.metrics, start=run.start + 1):
        loss, gnorm, lr = (float(m[k]) for k in ("loss", "grad_norm", "lr"))
        want = lr_at(run.tcfg.opt, i)
        if not (math.isfinite(loss) and math.isfinite(gnorm)) or \
                abs(lr - want) > 1e-6 * want:
            raise AssertionError(f"{what}: step {i} loss {loss}, grad norm "
                                 f"{gnorm}, lr {lr} (lr_at {want})")
        losses.append(loss)
    for p, mst in zip(leaves(run.state["params"]),
                      leaves(run.state["opt"]["master"]), strict=True):
        if not torch.equal(p, mst.to(p.dtype)):
            raise AssertionError(f"{what}: a parameter is not its master "
                                 f"cast to {p.dtype}")
    if int(run.state["opt"]["step"]) != steps:
        raise AssertionError(f"{what}: state step "
                             f"{int(run.state['opt']['step'])}")
    return losses


def train_full_width() -> tuple:
    """``launch/train.py``'s ``main`` on ``TRAIN_ARCH`` at full width:
    ``TRAIN_STEPS`` steps of global batch ``TRAIN_BATCH`` × ``TRAIN_SEQ``
    tokens (remat on, as the config says), each step and its optimizer
    update timed with CUDA events, every kernel counter zeroed before and
    read after; then ``TRAIN_MB_STEPS`` steps with 2
    microbatches, whose first loss (before any update, same weights) must
    be within ``TRAIN_MB_RTOL`` of the first run's.  No checkpoint is
    written (≈ 30 GB at full width).  Returns the kernel launches and the
    first loss."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.train import train_step as ts_mod
    args = ["--arch", TRAIN_ARCH, "--global-batch", str(TRAIN_BATCH),
            "--seq", str(TRAIN_SEQ), "--ckpt-every", str(TRAIN_STEPS + 1)]
    with tempfile.TemporaryDirectory() as tmp:
        events, opt_events = [], []
        orig = ts_mod.apply_updates
        ts_mod.apply_updates = cuda_timed(orig, opt_events)
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        try:
            run, _ = run_launcher(args + ["--steps", str(TRAIN_STEPS),
                                          "--ckpt-dir", tmp], events)
        finally:
            ts_mod.apply_updates = orig
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
        launches = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        losses = check_train_run(run, TRAIN_STEPS, TRAIN_ARCH)
        gnorms = [float(m["grad_norm"]) for m in run.metrics]
        cfg = run.cfg
        ms = [a.elapsed_time(b) for a, b in events]
        steady = sorted(ms[1:])
        med = steady[len(steady) // 2]
        opt_ms = [a.elapsed_time(b) for a, b in opt_events]
        log(f"[train] {cfg.name}: {cfg.num_layers} layers, d {cfg.d_model}, "
            f"{cfg.num_heads} heads ({cfg.kv_heads} KV), d_ff {cfg.d_ff}, "
            f"vocab {cfg.vocab_size}, {cfg.dtype}, remat {cfg.remat}: "
            f"{cfg.param_count() / 1e9:.3f} G parameters; state resident "
            f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")
        log(f"[train] launch/train.py main, {TRAIN_STEPS} steps of "
            f"{TRAIN_BATCH} x {TRAIN_SEQ} tokens in {total:.1f} s with "
            f"weight init: loss {['%.4f' % x for x in losses]}; grad norm "
            f"{['%.4f' % x for x in gnorms]}; ms a step (CUDA events) "
            f"{['%.3f' % x for x in ms]}, median after the warm-up step "
            f"{med:.3f} ({TRAIN_BATCH * TRAIN_SEQ / med * 1e3:.1f} tokens/s), "
            f"of which apply_updates {['%.3f' % x for x in opt_ms]}; "
            f"peak {peak / 1e9:.2f} GB (max_memory_allocated); kernel "
            f"launches {sum(launches.values())}")
        del run
        gc.collect()
        torch.cuda.empty_cache()
        run2, _ = run_launcher(args + ["--steps", str(TRAIN_MB_STEPS),
                                       "--microbatches", "2",
                                       "--ckpt-dir", tmp])
        mb = check_train_run(run2, TRAIN_MB_STEPS, f"{TRAIN_ARCH} x2")
        if os.listdir(tmp):
            raise AssertionError(f"checkpoints written: {os.listdir(tmp)}")
    del run2
    gc.collect()
    torch.cuda.empty_cache()
    rel = abs(mb[0] - losses[0]) / abs(losses[0])
    log(f"[train] 2 microbatches, {TRAIN_MB_STEPS} steps: loss "
        f"{['%.4f' % x for x in mb]}; first loss {mb[0]:.6f} vs {losses[0]:.6f}"
        f" in one batch (relative {rel:.3e}, bound {TRAIN_MB_RTOL})")
    if not rel <= TRAIN_MB_RTOL:
        raise AssertionError(f"microbatches: first loss {mb[0]} vs "
                             f"{losses[0]}")
    return launches, losses[0]


def train_resume() -> None:
    """The launcher at ``TRAIN_ARCH``'s smoke config on cuda, under
    ``torch.use_deterministic_algorithms`` (the embedding's backward
    accumulates atomically otherwise; cuBLAS asks for
    ``CUBLAS_WORKSPACE_CONFIG``, set for this phase only): 4 steps with a
    checkpoint every 2, then a resume to step 6, against 6 uninterrupted
    steps: the resume line printed, the state and every step's metrics
    equal."""
    import torch
    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.tree import leaves_with_paths
    smoke = ["--arch", TRAIN_ARCH, "--smoke", "--global-batch", "4",
             "--seq", "64"]
    cublas = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            a, b = os.path.join(tmp, "a"), os.path.join(tmp, "b")
            first, _ = run_launcher(smoke + ["--steps", "4", "--ckpt-every",
                                             "2", "--ckpt-dir", a])
            saved = sorted(ckpt.all_steps(a))
            resumed, out = run_launcher(smoke + ["--steps", "6",
                                                 "--ckpt-every", "2",
                                                 "--ckpt-dir", a])
            whole, _ = run_launcher(smoke + ["--steps", "6", "--ckpt-every",
                                             "100", "--ckpt-dir", b])
    finally:
        torch.use_deterministic_algorithms(False)
        if cublas is None:
            del os.environ["CUBLAS_WORKSPACE_CONFIG"]
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = cublas
    if saved != [2, 4] or resumed.start != 4 or \
            "[train] elastic resume from step 4" not in out:
        raise AssertionError(f"resume: checkpoints {saved}, start "
                             f"{resumed.start}")
    check_train_run(resumed, 6, "resumed")
    got, want = leaves_with_paths(resumed.state), leaves_with_paths(whole.state)
    if [p for p, _ in got] != [p for p, _ in want] or not all(
            torch.equal(x, y) for (_, x), (_, y) in zip(got, want)):
        raise AssertionError("resumed state differs from the uninterrupted "
                             "run's")
    for i, (x, y) in enumerate(zip(first.metrics + resumed.metrics,
                                   whole.metrics, strict=True)):
        if any(not torch.equal(x[k], y[k]) for k in y):
            raise AssertionError(f"step {i}: metrics differ after resume")
    log(f"[train] {TRAIN_ARCH} smoke on cuda (deterministic algorithms): 4 "
        f"steps, checkpoints {saved}, resumed from step 4 to 6: state "
        f"({len(got)} leaves) and 6 steps' metrics equal to an uninterrupted "
        f"run")


def phase_train() -> tuple:
    """Phase 3h: ``train_full_width`` then ``train_resume``.  Returns the
    kernel launches of the full-width run and its first loss."""
    launches, first_loss = train_full_width()
    train_resume()
    return launches, first_loss


# ---------------------------------------------------------------------------
# phase 3i: the multi-device HE schedule on ranks that share the card
# ---------------------------------------------------------------------------


def sharded_rank(spec: dict) -> dict:
    """One rank of phase 3i (``launch.mesh.spawn`` runs it on every rank,
    gloo on ``cuda:0``): the Set-B hemm of ``spec["shape"]`` on
    ``CkksEngine(SET_B, datapath="pallas")`` from ``spec["seed"]`` (the
    one-device run's seed, so keys and ciphertexts are its own), compiled
    ``schedule="sharded"`` under ``verify="error"`` on a (data × model)
    mesh; a warm-up call, a counted call (kernel launches, the
    collectives' bytes, peak memory, stage ms) and a timed one.  Options:
    ``xla``, the same hemm on ``"sharded_xla"`` after the context is
    invalidated; ``batch3``, a 3-wide σ/τ/σ HLT batch on the ct ranks;
    ``pad4``, the limb-padding case (:func:`sharded_pad_rank`);
    ``planted``, a toy program whose body reads a value back to the host,
    which the census must refuse (JX003).  Returns the outputs on the host
    and the numbers."""
    import warnings

    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.analysis import VerificationError, census
    from repro_torch.analysis.diagnostics import VerificationWarning
    from repro_torch.core import hlt_dist
    from repro_torch.core.ckks import CkksEngine
    from repro_torch.core.compile import HEContext, compile_hemm, compile_hlt
    from repro_torch.core.hemm import decrypt_matrix, encrypt_matrix, plan_hemm
    from repro_torch.core.params import SET_B, toy_params
    from repro_torch.distributed import collectives
    from repro_torch.kernels import build, ops
    from repro_torch.launch.mesh import make_mesh_for

    warnings.simplefilter("ignore", VerificationWarning)   # AR004 at data 2
    stems = sorted({s for s, _ in build.SIGNATURES.values()})
    missing = [s for s in stems if not build._lib_path(s).exists()]
    if missing:
        raise RuntimeError(f"rank {dist.get_rank()}: the parent did not build "
                           f"{missing}; a rank never builds")
    build.load()
    mesh = make_mesh_for(dist.get_world_size(), spec["model"], device="cuda",
                         backend="gloo")
    m, l, n = spec["shape"]
    t0 = time.perf_counter()
    rng = np.random.default_rng(spec["seed"])
    ctx = HEContext(CkksEngine(SET_B, datapath="pallas"), mesh=mesh,
                    verify="error")
    plan = plan_hemm(ctx.eng, m, l, n)
    ctx.keygen(rng, rot_steps=plan.rot_steps)
    A, B = rng.uniform(-1, 1, (m, l)), rng.uniform(-1, 1, (l, n))
    ctA = encrypt_matrix(ctx.eng, ctx.keys, A, rng)
    ctB = encrypt_matrix(ctx.eng, ctx.keys, B, rng)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    prog = compile_hemm(ctx, plan, schedule="sharded")
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    cen = [census.take_census(run)["collectives"]
           for run in (prog._step1, prog._step2)]
    prog(ctA, ctB)                                  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    collectives.reset()
    ctC, stages = staged_call(prog, ctA, ctB)
    launches = ops.launch_counts()
    coll = dict(counts=dict(collectives.COUNTS), bytes=dict(collectives.BYTES))
    peak = torch.cuda.max_memory_allocated()
    _, timed = staged_call(prog, ctA, ctB)
    if spec.get("step2_coll"):      # phase 3k: Step 2's collectives
        ctA0, ctB0 = prog._step1([ctA, ctB])
        st = prog._step2.sharded_collectives([ctA0] * l + [ctB0] * l)
        step2_coll = dict(total=st.total_bytes, by_op=st.by_op,
                          count=st.count, largest=st.largest, batch=2 * l,
                          plan=prog._step2.plan.collective_bytes)
    err = float(np.abs(decrypt_matrix(ctx.eng, ctx.keys, ctC, m, n)
                       - A @ B).max())
    out = dict(rank=dist.get_rank(), coords=dict(mesh.coords),
               c0=ctC.c0.cpu(), c1=ctC.c1.cpu(), level=ctC.level,
               scale=ctC.scale, stages=stages, timed=timed, peak=peak,
               launches=launches, coll=coll, census=cen,
               plan_coll=prog.plan.collective_bytes,
               setup_s=t1 - t0, compile_s=t2 - t1, err=err,
               layouts=[hoist_layout(run) for run in (prog._step1,
                                                      prog._step2)])
    if spec.get("step2_coll"):
        out["step2_coll"] = step2_coll
    if spec.get("batch3"):
        run = compile_hlt(ctx, [plan.ds_sigma, plan.ds_tau, plan.ds_sigma],
                          schedule="sharded")
        out["batch3"] = [(o.c0.cpu(), o.c1.cpu())
                         for o in run([ctA, ctB, ctB])]
        out["b_pad"] = int(run._slot_tables["diag"].shape[0])
    if spec.get("pad4"):
        out["pad4"] = sharded_pad_rank("cuda")
    if spec.get("xla"):
        del prog
        ctx.invalidate()
        gc.collect()
        torch.cuda.empty_cache()
        xprog = compile_hemm(ctx, plan, schedule="sharded_xla")
        ctX, out["stages_xla"] = staged_call(xprog, ctA, ctB)
        out["xla_equal"] = bool(torch.equal(ctX.c0, ctC.c0)
                                and torch.equal(ctX.c1, ctC.c1))
        out["xla_peak"] = torch.cuda.max_memory_allocated()
        del xprog, ctX
    if spec.get("planted"):
        tctx = HEContext(CkksEngine(toy_params(logN=10, L=4, k=3, beta=2),
                                    datapath="pallas"), mesh=mesh,
                         verify="error")
        tplan = plan_hemm(tctx.eng, 4, 4, 4)
        tctx.keygen(np.random.default_rng(1), rot_steps=tplan.rot_steps)
        orig = hlt_dist.make_sharded_hlt_fn

        def planted(*a, **k):
            body = orig(*a, **k)

            def reads_back(args):
                res = body(args)
                res[0].sum().item()        # a device-to-host read
                return res
            return reads_back
        hlt_dist.make_sharded_hlt_fn = planted
        try:
            compile_hlt(tctx, [tplan.ds_sigma, tplan.ds_tau],
                        schedule="sharded")
            out["planted"] = None
        except VerificationError as e:
            out["planted"] = sorted({d.rule for d in e.diagnostics})
        finally:
            hlt_dist.make_sharded_hlt_fn = orig
    return out


def sharded_pad_rank(device: str) -> dict:
    """The limb-padding case of phase 3i, on a (data 1 × model 4) mesh of
    the spawned ranks: a toy hemm (``PAD_PARAMS``, ``PAD_SHAPE``) whose
    extended bases (M = 6 at Step 1, 5 at Step 2) 4 ranks do not divide,
    so the last rank's rows are all padding (a copy of the last modulus,
    zero operands), compiled ``"sharded"`` under ``verify="error"`` and
    held array-equal to the one-device ``"pallas"`` hemm of the same
    engine, keys and ciphertexts.  Returns the row layout, the kernel
    launches of the sharded call, and whether the outputs are equal."""
    import numpy as np
    import torch
    from repro_torch.core.ckks import CkksEngine
    from repro_torch.core.compile import HEContext, compile_hemm
    from repro_torch.core.hemm import encrypt_matrix, plan_hemm
    from repro_torch.core.params import toy_params
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh_for

    mesh = make_mesh_for(4, 4, device=device, backend="gloo")
    m, l, n = PAD_SHAPE
    rng = np.random.default_rng(SHARDED_SEED4)
    ctx = HEContext(CkksEngine(toy_params(**PAD_PARAMS), device=device,
                               datapath="pallas"), mesh=mesh,
                    verify="error")
    plan = plan_hemm(ctx.eng, m, l, n)
    ctx.keygen(rng, rot_steps=plan.rot_steps)
    ctA = encrypt_matrix(ctx.eng, ctx.keys, rng.uniform(-1, 1, (m, l)), rng)
    ctB = encrypt_matrix(ctx.eng, ctx.keys, rng.uniform(-1, 1, (l, n)), rng)
    prog = compile_hemm(ctx, plan, schedule="sharded")
    ops.reset_launch_counts()
    got = prog(ctA, ctB)
    launches = {k: v for k, v in ops.launch_counts().items() if v}
    one = compile_hemm(HEContext(ctx.eng, ctx.keys), plan,
                       schedule="pallas")(ctA, ctB)
    tabs = [run._sharded[0] for run in (prog._step1, prog._step2)]
    return dict(M=[t.M for t in tabs], M_pad=[t.M_pad for t in tabs],
                rows_loc=[t.rows_loc for t in tabs],
                model_rank=ctx.model_rank, launches=launches,
                equal=bool(torch.equal(got.c0, one.c0)
                           and torch.equal(got.c1, one.c1)
                           and (got.level, got.scale)
                           == (one.level, one.scale)))


def hoist_layout(run) -> str:
    """The hoist layout a sharded HLT takes for its hint's aliasing: the
    unique inputs on every rank ("dedup") unless they outnumber a ct
    rank's share of the batch ("element")."""
    b_loc = run._slot_tables["diag"].shape[0] // run.ctx.n_ct
    return "element" if run.plan.n_ct_slots > b_loc else "dedup"


def sharded_reference(params, shape, seed: int) -> dict:
    """The one-device ``"pallas"`` hemm and σ/τ/σ batch that the 4-rank run
    of phase 3i is held to, from the same seed; residues on the host."""
    import numpy as np
    import torch
    from repro_torch.core.ckks import CkksEngine
    from repro_torch.core.compile import HEContext, compile_hemm, compile_hlt
    from repro_torch.core.hemm import encrypt_matrix, plan_hemm
    m, l, n = shape
    rng = np.random.default_rng(seed)
    ctx = HEContext(CkksEngine(params, datapath="pallas"))
    plan = plan_hemm(ctx.eng, m, l, n)
    ctx.keygen(rng, rot_steps=plan.rot_steps)
    A, B = rng.uniform(-1, 1, (m, l)), rng.uniform(-1, 1, (l, n))
    ctA = encrypt_matrix(ctx.eng, ctx.keys, A, rng)
    ctB = encrypt_matrix(ctx.eng, ctx.keys, B, rng)
    ctC = compile_hemm(ctx, plan, schedule="pallas")(ctA, ctB)
    run = compile_hlt(ctx, [plan.ds_sigma, plan.ds_tau, plan.ds_sigma],
                      schedule="pallas")
    out = dict(c0=ctC.c0.cpu(), c1=ctC.c1.cpu(), level=ctC.level,
               scale=ctC.scale,
               batch3=[(o.c0.cpu(), o.c1.cpu()) for o in run([ctA, ctB, ctB])])
    del ctx, plan, run, ctA, ctB, ctC
    gc.collect()
    torch.cuda.empty_cache()
    return out


def check_rank_output(tag: str, got: dict, want: dict) -> None:
    import torch
    if not (torch.equal(got["c0"], want["c0"])
            and torch.equal(got["c1"], want["c1"])
            and (got["level"], got["scale"]) == (want["level"],
                                                 want["scale"])):
        raise AssertionError(f"[{tag}] rank {got['rank']}: the sharded hemm "
                             f"differs from the one-device \"pallas\" one")


def check_pad_rank(p: dict) -> None:
    """The limb-padding case of one rank: rows past M on the last ranks,
    every kernel of the sharded body launched, outputs array-equal."""
    r = p["model_rank"]
    pad_rows = [max(0, min(loc, (r + 1) * loc - mm))
                for mm, loc in zip(p["M"], p["rows_loc"], strict=True)]
    if p["M"] != [6, 5] or p["M_pad"] != [8, 8]:
        raise AssertionError(f"limb padding: M {p['M']}, M_pad {p['M_pad']}")
    missing = [k for k in PAD_KERNELS if not p["launches"].get(k)]
    if missing:
        raise AssertionError(f"limb padding, model rank {r}: {missing} not "
                             f"launched ({p['launches']})")
    if not p["equal"]:
        raise AssertionError(f"limb padding, model rank {r}: the sharded "
                             f"hemm differs from the one-device one")
    log(f"[sharded4-pad] model rank {r} of 4: M {p['M']} -> M_pad "
        f"{p['M_pad']}, rows a rank {p['rows_loc']}, padding rows on this "
        f"rank {pad_rows}; launches {json.dumps(p['launches'])}; array-equal "
        f"to the one-device \"pallas\" hemm")


def log_rank(tag: str, r: dict) -> None:
    gb = 1e9
    log(f"[{tag}] rank {r['rank']} {r['coords']}: setup (plan, keygen, "
        f"encrypt) {r['setup_s']:.1f} s, compile {r['compile_s']:.1f} s "
        f"(census included); hoist layouts Step 1 / Step 2 "
        f"{r['layouts']}; counted call stage ms {fmt(r['stages'])}; timed "
        f"call {fmt(r['timed'])}; peak {r['peak'] / gb:.2f} GB "
        f"(max_memory_allocated of this rank); collectives "
        f"{json.dumps(r['coll']['counts'])}, bytes all-reduced "
        f"{r['coll']['bytes']['all_reduce']} (plan.collective_bytes "
        f"{r['plan_coll']}), gathered {r['coll']['bytes']['all_gather']}; "
        f"census of Step 1 / Step 2 {r['census']}; launches "
        f"{json.dumps({k: v for k, v in r['launches'].items() if v})}; "
        f"raw max|C - A·B| {r['err']:.4e}")


def phase_sharded(params, main: dict) -> dict:
    """Phase 3i: the multi-device schedule on ranks that time-share the
    card through gloo.  Two ranks (data 1 × model 2): the Set-B hemm 128³
    of phase 3 on ``"sharded"``, array-equal on every rank to phase 3's
    one-device ``"pallas"`` output (``main``), and on ``"sharded_xla"``
    array-equal to it; the census of every HLT launch (2 all-reduces, no
    other collective) and a planted host read refused as JX003.  Four
    ranks (data 2 × model 2): the Set-B hemm 32³ and a σ/τ/σ batch of 3
    (padded to the 2 ct ranks), array-equal to the one-device program;
    then the same ranks as (data 1 × model 4): the limb-padding case
    (:func:`sharded_pad_rank`) on the kernels.  Returns rank 0's kernel
    launches over the 2-rank counted call, and the 2 ranks' results
    (phase 3k reads their ``sharded_collectives`` of Step 2)."""
    # the 4-rank product is 32³, which keeps the phase near its budget of
    # 150 s (PERF.md §6)
    import torch
    from repro_torch.launch.mesh import spawn
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ref4 = sharded_reference(params, SHARDED_SHAPE4, SHARDED_SEED4)
    log(f"[sharded] one-device reference, hemm {SHARDED_SHAPE4} and the "
        f"σ/τ/σ batch: {time.perf_counter() - t0:.1f} s; memory allocated "
        f"by the parent now {torch.cuda.memory_allocated() / 1e9:.3f} GB")

    t0 = time.perf_counter()
    outs = spawn(sharded_rank, 2, dict(model=2, shape=main["shape"],
                                       seed=main["seed"], xla=True,
                                       planted=True, step2_coll=True),
                 device="cuda", backend="gloo", timeout=600)
    log(f"[sharded] 2 ranks (data 1 × model 2, gloo, both on cuda:0): "
        f"{time.perf_counter() - t0:.1f} s")
    for r in outs:
        check_rank_output("sharded", r, main)
        log_rank("sharded", r)
        if r["census"] != [{"all_reduce": 2}] * 2:
            raise AssertionError(f"rank {r['rank']}: census {r['census']}")
        if r["coll"]["counts"]["all_reduce"] != 4:
            raise AssertionError(f"rank {r['rank']}: collectives "
                                 f"{r['coll']['counts']}")
        if not r["xla_equal"]:
            raise AssertionError(f"rank {r['rank']}: \"sharded_xla\" differs "
                                 f"from \"sharded\"")
        if r["planted"] != ["JX003"]:
            raise AssertionError(f"rank {r['rank']}: a planted host read "
                                 f"drew {r['planted']}, not JX003")
        if r["err"] != main["err"]:
            raise AssertionError(f"rank {r['rank']}: decrypt error "
                                 f"{r['err']} vs phase 3's {main['err']}")
        log(f"[sharded] rank {r['rank']}: c0, c1 array-equal to phase 3's "
            f"one-device \"pallas\" hemm; \"sharded_xla\" array-equal, stage "
            f"ms {fmt(r['stages_xla'])}, peak {r['xla_peak'] / 1e9:.2f} GB; "
            f"a planted host read refused with {r['planted']}")

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    outs4 = spawn(sharded_rank, 4, dict(model=2, shape=SHARDED_SHAPE4,
                                        seed=SHARDED_SEED4, batch3=True,
                                        pad4=True),
                  device="cuda", backend="gloo", timeout=600)
    log(f"[sharded] 4 ranks (data 2 × model 2, gloo, all on cuda:0): "
        f"{time.perf_counter() - t0:.1f} s")
    for r in outs4:
        check_rank_output("sharded4", r, ref4)
        for i, (g, w) in enumerate(zip(r["batch3"], ref4["batch3"],
                                       strict=True)):
            if not (torch.equal(g[0], w[0]) and torch.equal(g[1], w[1])):
                raise AssertionError(f"rank {r['rank']}: σ/τ/σ batch element "
                                     f"{i} differs from the one-device one")
        if r["b_pad"] != 4:
            raise AssertionError(f"rank {r['rank']}: batch 3 padded to "
                                 f"{r['b_pad']}")
        log_rank("sharded4", r)
        log(f"[sharded4] rank {r['rank']}: hemm and the σ/τ/σ batch (padded "
            f"to {r['b_pad']} over 2 ct ranks) array-equal to the one-device "
            f"\"pallas\" program")
        check_pad_rank(r["pad4"])
    log("[sharded] these times are of ranks that time-share one card "
        "through a host-side collective: not a multi-GPU speed")
    return outs[0]["launches"], outs


# ---------------------------------------------------------------------------
# phase 3j: the LM's tensor, expert and data parallelism on ranks that share
# the card
# ---------------------------------------------------------------------------


def lm_serve_steps(cfg, params, steps, device, batch: int, max_len: int):
    """Prefill LM_MESH_PROMPT tokens of ``batch`` seeded prompts, then
    LM_MESH_DECODE uniform decode steps, through ``steps`` (a prefill and
    a decode function, ``make_sharded_serve_steps``' or one device's):
    the logits of each on the host, and the cache."""
    import numpy as np
    import torch
    from repro_torch.models import transformer as tf
    tok = torch.as_tensor(np.random.default_rng(LM_MESH_SEED).integers(
        0, cfg.vocab_size, (batch, LM_MESH_PROMPT + LM_MESH_DECODE)),
        device=device)
    prefill, decode = steps[:2]
    cache = tf.init_cache(cfg, batch, max_len, device=device)
    out = []
    with torch.no_grad():
        lg, cache = prefill(params, tok[:, :LM_MESH_PROMPT], cache)
        out.append(lg.float().cpu())
        for i in range(LM_MESH_DECODE):
            s = LM_MESH_PROMPT + i
            lg, cache = decode(params, tok[:, s:s + 1], cache, s)
            out.append(lg.float().cpu())
    return out, cache


def one_device_serve_steps(cfg):
    from repro_torch.serve.engine import serve_decode_step, serve_prefill_step
    return (lambda p, t, c, start=0: serve_prefill_step(cfg, p, t, c, start),
            lambda p, t, c, q: serve_decode_step(cfg, p, t, c, q))


def lm_launcher_tokens(cfg, params) -> dict:
    """``launch/serve.py``'s traffic (4 requests of 8 seeded tokens, 8 new
    each, a batcher of 4 slots × 128) on ``params``: the tokens by
    request."""
    import numpy as np
    from repro_torch.serve.engine import ContinuousBatcher, ServeConfig
    b = ContinuousBatcher(cfg, ServeConfig(max_batch=4, max_len=128), params)
    rng = np.random.default_rng(0)
    for _ in range(LM_REQUESTS):
        b.submit(rng.integers(0, cfg.vocab_size, size=8).astype(np.int32),
                 max_new=LM_MAX_NEW)
    while b.step():
        pass
    return b.results


def lm_mesh_secure(cfg, params, he_mesh, device) -> dict:
    """The ``LM_ARCH`` smoke config in float32 with layer 0 under HE (toy
    CKKS ``LM_MESH_TOY``, tile 4, a seeded d_model × 4 W), one request of
    6 tokens decoding 2 more, the secure tier's contexts on ``he_mesh``
    (None: one device): tokens, secure rows, the programs' schedules and
    the kernel launches of the run."""
    import numpy as np
    from repro_torch.core.params import toy_params
    from repro_torch.kernels import ops
    from repro_torch.serve.engine import (ContinuousBatcher, ServeConfig,
                                          build_secure_serving)
    cfg = dataclasses.replace(cfg, secure_layers=(0,))
    rng = np.random.default_rng(7)
    W = rng.standard_normal((cfg.d_model, 4)) * 0.05
    scfg = ServeConfig(max_batch=2, max_len=32, he_tile=4, he_mesh=he_mesh)
    secure = build_secure_serving(cfg, scfg, {0: W}, rng,
                                  he_params=toy_params(**LM_MESH_TOY),
                                  device=device)
    b = ContinuousBatcher(cfg, scfg, params, secure=secure)
    rid = b.submit(np.arange(6, dtype=np.int32) * 5, 2)
    ops.reset_launch_counts()
    while b.step():
        pass
    return dict(tokens=b.results[rid],
                rows=[out[0] for out in b.secure_results[rid]],
                schedules=sorted({prog._step1.plan.schedule for prog, _
                                  in secure.cache._entries.values()}),
                launches=ops.launch_counts())


def lm_smoke_run(arch: str, device, steps_fn=None) -> dict:
    """An ``LM_MESH_SMOKE`` config in float32 on ``device`` (one device, or
    this rank of the current mesh when ``steps_fn`` makes its sharded
    steps): prefill + decode logits, the cache (gathered whole on a mesh),
    the launcher's tokens, and ``LM_MESH_SMOKE_STEPS`` train steps of the
    launcher's optimizer on the global batches (a rank's rows): metrics
    and the state (gathered whole)."""
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.data.pipeline import DataConfig, device_batch, synth_batch
    from repro_torch.distributed import sharding as sh
    from repro_torch.models import transformer as tf
    from repro_torch.train import train_step as ts
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.tree import leaves
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    params = tf.init_params(cfg, torch.Generator(device=device).manual_seed(0))
    batch, max_len = 4, 32
    steps = (steps_fn(cfg, params, batch, max_len) if steps_fn
             else one_device_serve_steps(cfg) + (None,))
    logits, cache = lm_serve_steps(cfg, params, steps, device, batch,
                                   max_len)
    if steps[2] is not None:
        cache = {g: {n: steps[2][g][n].gather(c) for n, c in t.items()}
                 for g, t in cache.items()}
    out = dict(logits=logits, tokens=lm_launcher_tokens(cfg, params),
               cache={g: {n: c.float().cpu() for n, c in t.items()}
                      for g, t in cache.items()})
    tcfg = ts.TrainConfig(microbatches=2, opt=OptConfig(**TRAIN_OPT))
    state = ts.init_train_state(cfg, tcfg,
                                torch.Generator(device=device).manual_seed(0))
    R = sh.ranks()
    metrics = []
    for step in range(LM_MESH_SMOKE_STEPS):
        b = device_batch(cfg, synth_batch(cfg, DataConfig(
            global_batch=4, seq_len=64), step), device)
        if R is not None and R.D > 1:
            b = {k: v.chunk(R.D)[R.d] for k, v in b.items()}
        state, m = ts.train_step(cfg, tcfg, state, b)
        metrics.append({k: float(v) for k, v in m.items()})
    if R is not None:
        pl = ts.param_shardings(cfg, ts.abstract_train_state(cfg, tcfg),
                                sh.get_rules())
        state = [q.gather(t) for t, q in zip(leaves(state), leaves(pl))]
    else:
        state = leaves(state)
    out.update(metrics=metrics, state=[t.float().cpu() for t in state])
    return out


def lm_moe_groups_run(device) -> dict:
    """Phase 3j (a): one train step of the ``LM_MESH_MOE`` smoke config in
    float32 with ``LM_MESH_GROUP`` tokens a dispatch group, so that a data
    rank's rows of the global batch (4 × 64 tokens: 2 rows a rank on
    data 2) are whole groups, on one device or this rank of the current
    mesh (its rows): the metrics, the state (gathered whole) and the
    bytes of every all-gather over the batch axes inside ``moe_forward``
    (forward and the backward's recompute)."""
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.data.pipeline import DataConfig, device_batch, synth_batch
    from repro_torch.distributed import collectives
    from repro_torch.distributed import sharding as sh
    from repro_torch.models import moe
    from repro_torch.train import train_step as ts
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.tree import leaves
    cfg = dataclasses.replace(get_smoke_config(LM_MESH_MOE), dtype="float32")
    tcfg = ts.TrainConfig(opt=OptConfig(**TRAIN_OPT))
    R = sh.ranks()
    b = device_batch(cfg, synth_batch(cfg, DataConfig(
        global_batch=4, seq_len=64), 0), device)
    if R is not None and R.D > 1:
        b = {k: v.chunk(R.D)[R.d] for k, v in b.items()}
    gathers, inside = [], [0]
    saved = moe.moe_forward, collectives.all_gather, moe.GROUP

    def counted_forward(*args, **kw):
        inside[0] += 1
        try:
            return saved[0](*args, **kw)
        finally:
            inside[0] -= 1

    def counted_gather(t, group, size):
        if inside[0] and R is not None and group is R.batch_group:
            gathers.append(size * t.numel() * t.element_size())
        return saved[1](t, group, size)
    moe.moe_forward, collectives.all_gather = counted_forward, counted_gather
    moe.GROUP = LM_MESH_GROUP
    try:
        state = ts.init_train_state(
            cfg, tcfg, torch.Generator(device=device).manual_seed(0))
        state, m = ts.train_step(cfg, tcfg, state, b)
    finally:
        moe.moe_forward, collectives.all_gather, moe.GROUP = saved
    if R is not None:
        pl = ts.param_shardings(cfg, ts.abstract_train_state(cfg, tcfg),
                                sh.get_rules())
        state = [q.gather(t) for t, q in zip(leaves(state), leaves(pl))]
    else:
        state = leaves(state)
    return dict(metrics={k: float(v) for k, v in m.items()},
                state=[t.float().cpu() for t in state], gathers=gathers)


def lm_odd_cache_run(device, steps_fn=None) -> dict:
    """Phase 3j (b): the ``LM_MESH_MOE`` smoke config in float32 (its 2 KV
    heads do not split a model axis of 4) serving 4 seeded prompts from a
    cache of ``LM_MESH_ODD_L`` positions (4 does not divide it): each
    prompt prefilled in the ``LM_MESH_CHUNKS`` chunks, the second from
    ``cache_len`` = the first's length, then ``LM_MESH_ODD_NEW`` greedy
    decode steps; on one device or this rank of the current mesh
    (``steps_fn`` makes its sharded steps): the greedy tokens, every
    step's logits, the cache (gathered whole) and the rank's block's
    shape."""
    import numpy as np
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import transformer as tf
    cfg = dataclasses.replace(get_smoke_config(LM_MESH_MOE), dtype="float32")
    params = tf.init_params(cfg, torch.Generator(device=device).manual_seed(0))
    batch, n0 = 4, LM_MESH_CHUNKS[0]
    steps = (steps_fn(cfg, params, batch, LM_MESH_ODD_L) if steps_fn
             else one_device_serve_steps(cfg) + (None,))
    prefill, decode, pl = steps
    tok = torch.as_tensor(np.random.default_rng(LM_MESH_SEED).integers(
        0, cfg.vocab_size, (batch, sum(LM_MESH_CHUNKS))), device=device)
    cache = tf.init_cache(cfg, batch, LM_MESH_ODD_L, device=device)
    logits, new = [], []
    with torch.no_grad():
        _, cache = prefill(params, tok[:, :n0], cache)
        lg, cache = prefill(params, tok[:, n0:], cache, start=n0)
        pos = sum(LM_MESH_CHUNKS)
        for _ in range(LM_MESH_ODD_NEW):
            logits.append(lg.float().cpu())
            nxt = lg[:, -1].argmax(-1, keepdim=True)
            new.append(nxt.cpu())
            lg, cache = decode(params, nxt, cache, pos)
            pos += 1
        logits.append(lg.float().cpu())
    local = tuple(cache["kv"]["k"].shape)
    if pl is not None:
        cache = {g: {n: pl[g][n].gather(c) for n, c in t.items()}
                 for g, t in cache.items()}
    return dict(tokens=torch.cat(new, 1).tolist(), logits=logits,
                local=local, cache={g: {n: c.float().cpu()
                                        for n, c in t.items()}
                                    for g, t in cache.items()})


def check_moe_groups(r: dict, want: dict) -> None:
    """Phase 3j (a) on a rank of (data 2 × model 2) against one device:
    the metrics within LM_MESH_SMOKE_TOL, the state within it but for at
    most LM_MESH_FLIPS of its entries, no byte gathered over the batch
    axes inside the MoE."""
    got = r["moe_groups"]
    err = max(abs(got["metrics"][k] - w) / max(1.0, abs(w))
              for k, w in want["metrics"].items())
    far = sum(int(((g - w).abs() > LM_MESH_SMOKE_TOL).sum())
              for g, w in zip(got["state"], want["state"], strict=True))
    total = sum(w.numel() for w in want["state"])
    if got["gathers"] or err > LM_MESH_SMOKE_TOL or \
            far > LM_MESH_FLIPS * total:
        raise AssertionError(f"[lm-mesh-groups] rank {r['rank']}: MoE "
                             f"gathers over the batch axes {got['gathers']},"
                             f" metrics error {err}, state entries off {far}"
                             f" of {total}")
    log(f"[lm-mesh-groups] rank {r['rank']} {r['coords']} {LM_MESH_MOE} "
        f"(float32 smoke, {LM_MESH_GROUP} tokens a dispatch group: 2 whole "
        f"groups a data rank): one train step, loss "
        f"{got['metrics']['loss']:.6f}, aux {got['metrics']['aux_loss']:.6f};"
        f" metrics max relative err {err:.3e} (bound {LM_MESH_SMOKE_TOL}); "
        f"state max err {_max_err(got['state'], want['state']):.3e}, {far} "
        f"of {total} entries past the bound; bytes the MoE gathered over "
        f"the batch axes: {sum(got['gathers'])} in {len(got['gathers'])} "
        f"all-gathers")


def check_odd_cache(r: dict, want: dict) -> None:
    """Phase 3j (b) on a rank of (data 1 × model 4) against one device:
    the greedy tokens equal, the logits and the gathered cache within
    LM_MESH_SMOKE_TOL, a rank's block ⌈LM_MESH_ODD_L / 4⌉ positions."""
    got = r["odd"]
    errs = dict(logits=_max_err(got["logits"], want["logits"]),
                cache=max(float((got["cache"][g][n] - c).abs().max())
                          for g, t in want["cache"].items()
                          for n, c in t.items()))
    shapes = all(got["cache"][g][n].shape == c.shape
                 for g, t in want["cache"].items() for n, c in t.items())
    block = -(-LM_MESH_ODD_L // 4)
    if got["tokens"] != want["tokens"] or not shapes or \
            got["local"][3] != block or \
            not all(e <= LM_MESH_SMOKE_TOL for e in errs.values()):
        raise AssertionError(f"[lm-mesh-odd] rank {r['rank']}: tokens equal "
                             f"{got['tokens'] == want['tokens']}, errors "
                             f"{errs}, whole shapes equal {shapes}, local "
                             f"{got['local']}")
    log(f"[lm-mesh-odd] rank {r['rank']} {r['odd_coords']} {LM_MESH_MOE} "
        f"(float32 smoke, 2 KV heads on model 4): a cache of "
        f"{LM_MESH_ODD_L} positions, {block} a rank (block {got['local']}), "
        f"prompts prefilled in chunks of {list(LM_MESH_CHUNKS)} (the second "
        f"from cache_len {LM_MESH_CHUNKS[0]}), {LM_MESH_ODD_NEW} greedy "
        f"decode steps: tokens equal to one device's; logits / gathered "
        f"cache max err {errs['logits']:.3e} / {errs['cache']:.3e} (bound "
        f"{LM_MESH_SMOKE_TOL})")


@contextlib.contextmanager
def collective_clock(seconds: list):
    """``torch.distributed.all_reduce`` / ``all_gather`` timed on the host
    clock while the block runs, summed into ``seconds[0]`` (gloo copies a
    CUDA tensor to the host and back inside the call)."""
    import torch.distributed as dist
    saved = {n: getattr(dist, n) for n in ("all_reduce", "all_gather")}

    def timed(fn):
        def wrapper(*args, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                seconds[0] += time.perf_counter() - t0
        return wrapper
    for n, fn in saved.items():
        setattr(dist, n, timed(fn))
    try:
        yield seconds
    finally:
        for n, fn in saved.items():
            setattr(dist, n, fn)


def timed_decode(events: list, counts: list):
    """``models.transformer.decode_step`` wrapped: CUDA events around each
    call, the collectives it issued (calls and bytes by kind) and the
    host seconds spent inside them."""
    import torch
    from repro_torch.distributed import collectives
    from repro_torch.models import transformer as tf
    orig = tf.decode_step

    def wrapper(*args, **kw):
        collectives.reset()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        with collective_clock([0.0]) as secs:
            a.record()
            out = orig(*args, **kw)
            b.record()
        events.append((a, b))
        counts.append((dict(collectives.COUNTS), dict(collectives.BYTES),
                       secs[0]))
        return out
    return orig, wrapper


def lm_mesh_rank(spec: dict) -> dict:
    """One rank of phase 3j (``launch.mesh.spawn``, gloo on ``cuda:0``).

    ``full``: on (data 1 × model 2), ``LM_ARCH`` at full width in float32
    through ``make_sharded_serve_steps`` (prefill + decode logits) and the
    launcher's traffic (tokens); then ``launch/serve.py`` ``--tp 2`` in
    the config's bf16 with every decode step timed by CUDA events and its
    collectives counted; then the toy secure layer on this mesh; then
    ``launch/train.py`` ``--tp 2``: ``LM_MESH_TRAIN_STEPS`` steps of
    ``TRAIN_BATCH`` × ``TRAIN_SEQ`` tokens, each timed.  ``smoke``: on
    (data 2 × model 2), ``lm_smoke_run`` of each ``LM_MESH_SMOKE``
    config and ``lm_moe_groups_run``, then on the same ranks as (data 1 ×
    model 4) ``lm_odd_cache_run``."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.distributed import collectives
    from repro_torch.distributed import sharding as sh
    from repro_torch.kernels import build
    from repro_torch.launch import serve as launch_serve
    from repro_torch.launch import train as launch_train
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.models import transformer as tf
    from repro_torch.serve.engine import make_sharded_serve_steps
    from repro_torch.train import train_step as ts_mod
    from repro_torch.tree import leaves

    build.load()                   # the parent built every kernel
    mesh = make_mesh_for(dist.get_world_size(), spec["model"],
                         device=spec["device"], backend="gloo")
    sh.set_rules(sh.make_rules(mesh))
    dev = mesh.device
    out = dict(rank=mesh.rank, coords=dict(mesh.coords))

    def sharded_steps(cfg, params, batch, max_len):
        return make_sharded_serve_steps(cfg, mesh, params, batch, max_len)

    if spec["kind"] == "smoke":
        for arch in LM_MESH_SMOKE:
            out[arch] = lm_smoke_run(arch, dev, sharded_steps)
        out["moe_groups"] = lm_moe_groups_run(dev)
        # the same ranks as (data 1 × model 4): no second spawn
        mesh4 = make_mesh_for(dist.get_world_size(), 4,
                              device=spec["device"], backend="gloo")
        sh.set_rules(sh.make_rules(mesh4))
        out["odd"] = lm_odd_cache_run(
            dev, lambda cfg, params, batch, max_len: make_sharded_serve_steps(
                cfg, mesh4, params, batch, max_len))
        out["odd_coords"] = dict(mesh4.coords)
        return out

    # float32 at full width: the one-device run's logits and tokens
    cfg32 = dataclasses.replace(get_config(LM_ARCH), dtype="float32")
    t0 = time.perf_counter()
    p = tf.init_params(cfg32, torch.Generator(device=dev).manual_seed(0))
    out["f32_params_gb"] = sum(t.numel() * t.element_size()
                               for t in leaves(p)) / 1e9
    out["f32_logits"], _ = lm_serve_steps(
        cfg32, p, sharded_steps(cfg32, p, LM_REQUESTS, 128), dev,
        LM_REQUESTS, 128)
    out["f32_tokens"] = lm_launcher_tokens(cfg32, p)
    out["f32_s"] = time.perf_counter() - t0
    del p
    gc.collect()
    torch.cuda.empty_cache()

    # bf16 through the launcher, every decode step timed and counted
    events, counts = [], []
    orig, wrapper = timed_decode(events, counts)
    tf.decode_step = wrapper
    torch.cuda.reset_peak_memory_stats()
    buf = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            b = launch_serve.main(["--arch", LM_ARCH, "--tp",
                                   str(spec["model"]), "--backend", "gloo",
                                   "--device", spec["device"],
                                   "--requests", str(LM_REQUESTS),
                                   "--max-new", str(LM_MAX_NEW)])
        torch.cuda.synchronize()
    finally:
        tf.decode_step = orig
    out["serve_s"] = time.perf_counter() - t0
    out["serve_out"] = buf.getvalue().strip()
    out["decode_ms"] = [a.elapsed_time(c) for a, c in events]
    out["decode_coll"] = counts
    out["serve_peak"] = torch.cuda.max_memory_allocated()
    out["bf16_tokens"] = b.results
    del b
    gc.collect()
    torch.cuda.empty_cache()

    # the toy secure layer on the LM's mesh
    from repro_torch.configs import get_smoke_config
    smoke = dataclasses.replace(get_smoke_config(LM_ARCH), dtype="float32")
    ps = tf.init_params(smoke, torch.Generator(device=dev).manual_seed(0))
    out["secure"] = lm_mesh_secure(smoke, ps, mesh, dev)
    del ps
    gc.collect()
    torch.cuda.empty_cache()

    # training through the launcher
    events = []
    orig_step = ts_mod.train_step
    ts_mod.train_step = cuda_timed(orig_step, events)
    torch.cuda.reset_peak_memory_stats()
    collectives.reset()
    buf = io.StringIO()
    t0 = time.perf_counter()
    try:
        with tempfile.TemporaryDirectory() as tmp, \
                contextlib.redirect_stdout(buf), \
                collective_clock([0.0]) as train_secs:
            run = launch_train.main(
                ["--arch", TRAIN_ARCH, "--tp", str(spec["model"]),
                 "--backend", "gloo", "--device", spec["device"],
                 "--steps", str(LM_MESH_TRAIN_STEPS),
                 "--global-batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ),
                 "--ckpt-every", str(LM_MESH_TRAIN_STEPS + 1),
                 "--ckpt-dir", tmp])
        torch.cuda.synchronize()
    finally:
        ts_mod.train_step = orig_step
    out["train_s"] = time.perf_counter() - t0
    out["train_out"] = buf.getvalue().strip()
    out["train_ms"] = [a.elapsed_time(c) for a, c in events]
    out["train_peak"] = torch.cuda.max_memory_allocated()
    out["train_losses"] = [float(m["loss"]) for m in run.metrics]
    out["train_gnorm"] = [float(m["grad_norm"]) for m in run.metrics]
    out["train_coll"] = (dict(collectives.COUNTS), dict(collectives.BYTES),
                         train_secs[0])
    out["state_gb"] = sum(t.numel() * t.element_size()
                          for t in leaves(run.state)) / 1e9
    return out


def _max_err(got: list, want: list) -> float:
    return max(float((g - w).abs().max()) for g, w in zip(got, want,
                                                          strict=True))


def check_lm_smoke(r: dict, want: dict, arch: str) -> None:
    """A rank's smoke-config run against one device's: logits, cache and
    metrics within LM_MESH_SMOKE_TOL, the tokens equal, the train state
    within it but for at most LM_MESH_FLIPS of its entries (AdamW moves
    an entry of a rounding-level gradient by ±lr on its sign)."""
    got = r[arch]
    errs = dict(logits=_max_err(got["logits"], want["logits"]),
                cache=max(float((got["cache"][g][n] - c).abs().max())
                          for g, t in want["cache"].items()
                          for n, c in t.items()),
                metrics=max(abs(g[k] - w[k]) / max(1.0, abs(w[k]))
                            for g, w in zip(got["metrics"], want["metrics"])
                            for k in w))
    far = sum(int(((g - w).abs() > LM_MESH_SMOKE_TOL).sum())
              for g, w in zip(got["state"], want["state"], strict=True))
    total = sum(w.numel() for w in want["state"])
    if got["tokens"] != want["tokens"] or far > LM_MESH_FLIPS * total or \
            not all(e <= LM_MESH_SMOKE_TOL for e in errs.values()):
        raise AssertionError(f"[lm-mesh4] rank {r['rank']} {arch}: tokens "
                             f"equal {got['tokens'] == want['tokens']}, "
                             f"errors {errs}, state entries off {far} of "
                             f"{total}")
    log(f"[lm-mesh4] rank {r['rank']} {r['coords']} {arch} (float32 smoke, "
        f"cuda): logits / cache / metrics max err "
        f"{', '.join('%.3e' % e for e in errs.values())} (bound "
        f"{LM_MESH_SMOKE_TOL}); state max err "
        f"{_max_err(got['state'], want['state']):.3e}, {far} of {total} "
        f"entries past the bound; tokens equal to one device's")


def decode_reckon(cfg, model: int, batch: int) -> tuple:
    """(calls, bytes) by kind of the collectives of one decode step of a
    dense ``cfg`` on (data 1 × ``model``), every partial sum in float32:
    a layer's attention adds an all-reduce after its row-parallel ``wo``
    (none when its heads do not split: ``attn_replicated``) and, over a
    sequence-split cache (KV heads that do not split), the
    flash-decoding maximum and sum (and, with split Q heads, all-gathers
    of q and of ``wk`` / ``wv`` where their columns split); the MLP an
    all-reduce when ``d_ff`` splits; the
    vocab-parallel embedding an all-reduce and the logits an
    all-gather."""
    from repro_torch.models.common import attn_replicated
    L, d, H, hd = cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.hdim
    calls = dict(all_reduce=0, all_reduce_max=0, all_gather=0)
    nbytes = dict(calls)

    def add(kind, n, b):
        calls[kind] += n
        nbytes[kind] += n * b
    whole = attn_replicated(cfg, model)
    if not whole:
        add("all_reduce", L, batch * d * 4)
    if cfg.kv_heads % model:
        add("all_reduce_max", L, batch * H * 4)
        add("all_reduce", L, batch * H * (hd + 1) * 4)
        if not whole:
            add("all_gather", L, batch * H * hd * 4)
            if cfg.kv_heads * hd % model == 0:   # wk / wv gathered whole
                add("all_gather", 2 * L, d * cfg.kv_heads * hd * 4)
    if cfg.d_ff % model == 0:
        add("all_reduce", L, batch * d * 4)
    if cfg.vocab_size % model == 0:
        add("all_reduce", 1, batch * d * 4)
        add("all_gather", 1, batch * cfg.vocab_size * 4)
    return ({k: v for k, v in calls.items() if v},
            {k: v for k, v in nbytes.items() if v})


def phase_lm_mesh(first_loss: float, device: str = "cuda") -> dict:
    """Phase 3j: the LM's tensor, expert and data parallelism on ranks
    that time-share the card through gloo.  The parent frees its memory,
    runs the one-device references (``LM_ARCH`` at full width in float32:
    prefill + decode logits and the launcher's tokens; the toy secure
    layer; the ``LM_MESH_SMOKE`` configs), then two ranks (data 1 × model
    2) run ``lm_mesh_rank``'s full-width serving (float32 tokens equal,
    logits within LM_MESH_LOGIT_TOL; then bf16, timed), the secure layer
    on the LM's mesh (array-equal) and ``LM_MESH_TRAIN_STEPS`` train
    steps (step 1's loss within LM_MESH_LOSS_RTOL of phase 3h's one-device
    first loss ``first_loss``), and four ranks (data 2 × model 2) the
    smoke configs, serving and training, against one device, all on
    ``device``, with one train step of the MoE smoke config whose rows a
    data rank are whole dispatch groups (``lm_moe_groups_run``: no
    gather over the batch axes inside the MoE); then the same four ranks
    as (data 1 × model 4) serve the MoE smoke config from a cache whose
    length 4 does not divide, a prompt prefilled in two chunks
    (``lm_odd_cache_run``).  Returns rank 0's kernel launches in the
    secure run on the LM's mesh."""
    import torch
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.launch.mesh import spawn
    from repro_torch.models import transformer as tf
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cfg32 = dataclasses.replace(get_config(LM_ARCH), dtype="float32")
    p = tf.init_params(cfg32, torch.Generator(device=device).manual_seed(0))
    want_logits, _ = lm_serve_steps(cfg32, p, one_device_serve_steps(cfg32)
                                    + (None,), device, LM_REQUESTS, 128)
    want_tokens = lm_launcher_tokens(cfg32, p)
    del p
    gc.collect()
    torch.cuda.empty_cache()
    smoke = dataclasses.replace(get_smoke_config(LM_ARCH), dtype="float32")
    ps = tf.init_params(smoke, torch.Generator(device=device).manual_seed(0))
    want_secure = lm_mesh_secure(smoke, ps, None, device)
    del ps
    want_smoke = {arch: lm_smoke_run(arch, device) for arch in LM_MESH_SMOKE}
    want_groups = lm_moe_groups_run(device)
    want_odd = lm_odd_cache_run(device)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[lm-mesh] one-device references (full width f32, the secure toy, "
        f"the smoke configs): {time.perf_counter() - t0:.1f} s; memory "
        f"allocated by the parent now "
        f"{torch.cuda.memory_allocated() / 1e9:.3f} GB")

    t0 = time.perf_counter()
    outs = spawn(lm_mesh_rank, 2, dict(kind="full", model=2, device=device),
                 device=device, backend="gloo", timeout=600)
    log(f"[lm-mesh] 2 ranks (data 1 × model 2, gloo, both on cuda:0): "
        f"{time.perf_counter() - t0:.1f} s")
    cfg = get_config(LM_ARCH)
    # a decode step runs the batcher's 4 slots
    reckon, reckon_bytes = decode_reckon(cfg, 2, 4)
    for r in outs:
        err = _max_err(r["f32_logits"], want_logits)
        if r["f32_tokens"] != want_tokens or not err <= LM_MESH_LOGIT_TOL:
            raise AssertionError(f"[lm-mesh] rank {r['rank']}: float32 "
                                 f"tokens equal "
                                 f"{r['f32_tokens'] == want_tokens}, logits "
                                 f"max err {err}")
        if r["bf16_tokens"] != outs[0]["bf16_tokens"]:
            raise AssertionError(f"[lm-mesh] rank {r['rank']}: bf16 tokens "
                                 f"differ from rank 0's")
        steady = r["decode_coll"]
        bad = [c for c, _, _ in steady
               if {k: v for k, v in c.items() if v} != reckon]
        if bad:
            raise AssertionError(f"[lm-mesh] rank {r['rank']}: decode-step "
                                 f"collectives {bad[0]}, reckoned {reckon}")
        byte = steady[-1][1]
        if {k: byte[k] for k in reckon_bytes} != reckon_bytes:
            raise AssertionError(f"[lm-mesh] rank {r['rank']}: decode-step "
                                 f"bytes {byte}, reckoned {reckon_bytes}")
        ms = sorted(r["decode_ms"][1:])
        log(f"[lm-mesh] rank {r['rank']} {r['coords']}: {LM_ARCH} full width "
            f"float32 ({r['f32_params_gb']:.2f} GB of parameters a rank): "
            f"prefill + {LM_MESH_DECODE} decode logits max err {err:.3e} "
            f"(bound {LM_MESH_LOGIT_TOL}), the launcher's {LM_REQUESTS} "
            f"requests' tokens equal to one device's ({r['f32_s']:.1f} s)")
        log(f"[lm-mesh] rank {r['rank']}: launch/serve.py --tp 2 (bf16): "
            f"{r['serve_out']!r} in {r['serve_s']:.1f} s; decode step ms "
            f"(CUDA events) {['%.2f' % x for x in r['decode_ms']]}, median "
            f"after the first {ms[len(ms) // 2]:.2f}, of which inside the "
            f"collectives (host clock) "
            f"{['%.2f' % (c[2] * 1e3) for c in steady]}; collectives a decode "
            f"step {json.dumps({k: v for k, v in steady[-1][0].items() if v})}"
            f" (reckoned {json.dumps(reckon)}), bytes "
            f"{json.dumps({k: v for k, v in byte.items() if v})} (reckoned "
            f"{json.dumps(reckon_bytes)}); peak {r['serve_peak'] / 1e9:.2f} "
            f"GB (max_memory_allocated of this rank)")
        sec = r["secure"]
        if sec["schedules"] != ["sharded"] or \
                sec["tokens"] != want_secure["tokens"] or \
                len(sec["rows"]) != len(want_secure["rows"]) or not all(
                    (g == w).all() for g, w in zip(sec["rows"],
                                                   want_secure["rows"])):
            raise AssertionError(f"[lm-mesh] rank {r['rank']}: the secure "
                                 f"layer on the LM mesh differs from one "
                                 f"device ({sec['schedules']})")
        log(f"[lm-mesh] rank {r['rank']}: toy secure layer (logN "
            f"{LM_MESH_TOY['logN']}, tile 4) with he_mesh = the LM's mesh: "
            f"schedule {sec['schedules']}, {len(sec['rows'])} secure rows "
            f"and the tokens array-equal to one device's; launches "
            f"{json.dumps({k: v for k, v in sec['launches'].items() if v})}")
        losses = r["train_losses"]
        rel = abs(losses[0] - first_loss) / abs(first_loss)
        if not (rel <= LM_MESH_LOSS_RTOL
                and all(math.isfinite(x) for x in losses + r["train_gnorm"])):
            raise AssertionError(f"[lm-mesh] rank {r['rank']}: train losses "
                                 f"{losses} (phase 3h's first {first_loss})")
        tms = sorted(r["train_ms"][1:])
        med = tms[len(tms) // 2]
        tc, tb, tsec = r["train_coll"]
        log(f"[lm-mesh] rank {r['rank']}: launch/train.py --tp 2, "
            f"{LM_MESH_TRAIN_STEPS} steps of {TRAIN_BATCH} x {TRAIN_SEQ} "
            f"tokens in {r['train_s']:.1f} s with weight init: loss "
            f"{['%.6f' % x for x in losses]} (step 1 vs phase 3h's one-device "
            f"{first_loss:.6f}: relative {rel:.3e}, bound "
            f"{LM_MESH_LOSS_RTOL}); grad norm "
            f"{['%.4f' % x for x in r['train_gnorm']]}; ms a step (CUDA "
            f"events) {['%.1f' % x for x in r['train_ms']]}, median after "
            f"the first {med:.1f} ({TRAIN_BATCH * TRAIN_SEQ / med * 1e3:.1f} "
            f"tokens/s of the global batch); state {r['state_gb']:.2f} GB a "
            f"rank, peak {r['train_peak'] / 1e9:.2f} GB (max_memory_allocated"
            f" of this rank); collectives over the run "
            f"{json.dumps({k: v for k, v in tc.items() if v})}, bytes "
            f"{json.dumps({k: v for k, v in tb.items() if v})}, "
            f"{tsec:.1f} s inside them (host clock, with weight init)")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    outs4 = spawn(lm_mesh_rank, 4, dict(kind="smoke", model=2,
                                        device=device),
                  device=device, backend="gloo", timeout=600)
    log(f"[lm-mesh4] 4 ranks (data 2 × model 2, gloo, all on cuda:0): "
        f"{time.perf_counter() - t0:.1f} s")
    for r in outs4:
        for arch in LM_MESH_SMOKE:
            check_lm_smoke(r, want_smoke[arch], arch)
        check_moe_groups(r, want_groups)
        check_odd_cache(r, want_odd)
    log("[lm-mesh] these times are of ranks that time-share one card "
        "through a host-side collective: not a multi-GPU speed")
    return outs[0]["secure"]["launches"]


# ---------------------------------------------------------------------------
# phase 3k: the compile-time cost reports
# ---------------------------------------------------------------------------


class Background:
    """A command run beside the phases in a subprocess of its own, its
    output in a log file of ``directory``; ``wait`` waits
    for it, raises with the log's tail unless it exited 0 and returns the
    log; ``stop`` kills it if it still runs."""

    def __init__(self, tag: str, argv: list, directory: str):
        self.tag = tag
        self.dir = directory
        self.out = open(os.path.join(self.dir, "log.txt"), "w")
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [str(ROOT / "src")] + [p for p in [os.environ.get("PYTHONPATH")]
                                   if p]))
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(argv, stdout=self.out,
                                     stderr=subprocess.STDOUT, env=env,
                                     cwd=ROOT)

    def wait(self, timeout: float) -> str:
        ended = self.proc.poll() is not None
        try:
            rc = self.proc.wait(timeout=timeout)
        finally:
            self.stop()
        with open(os.path.join(self.dir, "log.txt")) as f:
            text = f.read()
        if rc != 0:
            raise AssertionError(f"[{self.tag}] the subprocess exited {rc}:"
                                 f"\n{text[-4000:]}")
        log(f"[{self.tag}] the subprocess {'had ended' if ended else 'ended'}"
            f" when read, {time.perf_counter() - self.t0:.1f} s after its "
            f"start")
        return text

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        self.out.close()


def dryrun_job(device: str = "cuda") -> Background:
    """Phase 3k's ``launch/dryrun.py`` on ``COST_HE_SETS`` and
    ``COST_ARCHS`` × ``COST_SHAPE`` on the pod mesh, in a subprocess
    (its fake process group never meets phases 3i / 3j's gloo groups)
    started with phase 3i: it needs no card (fake tensors on
    ``cuda``)."""
    out = tempfile.mkdtemp(prefix="chip_smoke_dryrun_")
    return Background("costs", [
        sys.executable, "-m", "repro_torch.launch.dryrun", "--he",
        *COST_HE_SETS, "--arch", *COST_ARCHS, "--shape", COST_SHAPE,
        "--mesh", "pod", "--device", device, "--out", out], out)


def dryrun_records(job: Background) -> dict:
    """The dry-run job's records, once it exited 0."""
    job.wait(COST_WAIT_S)
    recs = {}
    for name in sorted(os.listdir(job.dir)):
        if name.endswith(".json"):
            with open(os.path.join(job.dir, name)) as f:
                recs[name[:-len(".json")]] = json.load(f)
    log(f"[costs] the dry-run cells' compile_s sum to "
        f"{sum(r.get('compile_s', 0) for r in recs.values()):.1f}")
    return recs


def check_cost_records(recs: dict) -> None:
    """Every record ``ok``, one for each cell; an HE record's collective
    bytes are the sharded plan's reckoning for a rank's share (one
    ciphertext, 16 model ranks) × chips.  Prints each record's dominant
    term, its three roofline terms (data-sheet seconds, not measurements)
    and ``compile_s``."""
    from repro_torch.core.costmodel import sharded_collective_bytes
    from repro_torch.core.params import PAPER_SETS
    want = ([f"{h}__he__pod" for h in COST_HE_SETS]
            + [f"{a}__{COST_SHAPE}__pod" for a in COST_ARCHS])
    if sorted(recs) != sorted(want):
        raise AssertionError(f"[costs] records {sorted(recs)}, expected "
                             f"{sorted(want)}")
    for name in want:
        r = recs[name]
        if not r.get("ok"):
            raise AssertionError(f"[costs] {name}: {r.get('error')}\n"
                                 f"{r.get('traceback', '')}")
        t = r["roofline"]
        log(f"[costs] {name}: dominant {r['dominant']}; roofline terms "
            f"(data-sheet seconds a card) compute {t['compute_s']:.4e}, "
            f"memory {t['memory_s']:.4e}, collective "
            f"{t['collective_s']:.4e}; compile_s {r['compile_s']}; flops "
            f"{r['flops_total']:.4e}, HBM bytes {r['hbm_bytes_total']:.4e}, "
            f"collective bytes {r['collective_bytes_total']} over "
            f"{r['chips']} chips; memory a rank {r['memory_analysis']}")
        if name.startswith("he-mm-"):
            p = PAPER_SETS[r["arch"][len("he-mm-"):]]
            reckon = sharded_collective_bytes(p, n_model=16, ctb=1) \
                * r["chips"]
            if r["collective_bytes_total"] != reckon:
                raise AssertionError(
                    f"[costs] {name}: collective bytes "
                    f"{r['collective_bytes_total']}, the plan's reckoning "
                    f"{reckon}")


def own_step_counts(smi: str, device: str = "cuda") -> None:
    """The cost counter over ``LM_ARCH``'s bf16 decode step at phase 3f's
    shapes (``launch/serve.py``'s batcher: 4 slots, a 128-long cache,
    per-slot positions) on the card, on one device: on real CUDA tensors
    and again on fake tensors of the same shapes.  The dot FLOPs must be
    equal; the bytes are printed beside each other.  Then the counts over
    the median step time (CUDA events), beside ``hlo_analysis.HW``."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.configs import get_config
    from repro_torch.distributed import hlo_analysis, hlo_cost
    from repro_torch.models import transformer as tf
    from repro_torch.tree import tree_map
    cfg = get_config(LM_ARCH)
    B, S = LM_REQUESTS, COST_CACHE
    pos = [LM_COST_POS + i for i in range(B)]
    gen = torch.Generator(device=device).manual_seed(COST_SEED)
    params = tf.init_params(cfg, gen)
    cache = tf.init_cache(cfg, B, S, device=device)
    tok = torch.randint(0, cfg.vocab_size, (B, 1), device=device,
                        generator=gen)
    where = torch.tensor(pos, device=device)

    def step():
        with torch.no_grad():
            return tf.decode_step(cfg, params, tok, cache, where)

    ms = []
    for _ in range(COST_STEPS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        step()
        b.record()
        torch.cuda.synchronize()
        ms.append(a.elapsed_time(b))
    with hlo_cost.count() as real:
        step()
    torch.cuda.synchronize()
    with FakeTensorMode(allow_non_fake_inputs=True):
        fp = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                               device=device), params)
        fc = tf.init_cache(cfg, B, S, device=device)
        ftok = torch.empty((B, 1), dtype=tok.dtype, device=device)
        fpos = torch.empty((B,), dtype=where.dtype, device=device)
        with torch.no_grad(), hlo_cost.count() as fake:
            tf.decode_step(cfg, fp, ftok, fc, fpos)
    rc, fk = real.cost(), fake.cost()
    if rc.flops != fk.flops or rc.flops <= 0:
        raise AssertionError(f"[costs] decode step dot FLOPs: real "
                             f"{rc.flops}, fake {fk.flops}")
    med = sorted(ms[1:])[len(ms[1:]) // 2]
    hw = hlo_analysis.HW
    log(f"[costs] {LM_ARCH} bf16 decode step on one card (batch {B}, a "
        f"{S}-long cache, positions {pos}): counted on real CUDA tensors "
        f"{rc.flops:.6e} dot FLOPs, {rc.bytes_accessed:.6e} bytes; on fake "
        f"tensors of the same shapes {fk.flops:.6e} FLOPs (equal), "
        f"{fk.bytes_accessed:.6e} bytes (difference "
        f"{rc.bytes_accessed - fk.bytes_accessed:.0f}); elementwise "
        f"elements {rc.int_elem_ops:.6e} / {fk.int_elem_ops:.6e}")
    log(f"[costs] the step's median {med:.3f} ms (CUDA events, "
        f"{COST_STEPS} steps, the first left out: "
        f"{['%.3f' % t for t in ms]}): {rc.flops / med / 1e9:.4f} TFLOP/s "
        f"against the data sheet's {hw['peak_flops_bf16'] / 1e12:.0f} "
        f"(bf16 dense), {rc.bytes_accessed / med / 1e9:.4f} TB/s of counted"
        f" (unfused) bytes against {hw['hbm_bw'] / 1e12:.2f}; the card: "
        f"{smi}")
    del params, cache, fp, fc


def check_sharded_collectives(r: dict) -> None:
    """Phase 3i's ``sharded_collectives`` of the Set-B hemm's Step 2 on
    (data 1 × model 2): two all-reduces, totalling
    ``plan.collective_bytes``."""
    c = r["step2_coll"]
    if c["total"] != c["plan"] or c["count"] != 2 or \
            c["by_op"] != {"all-reduce": c["plan"]}:
        raise AssertionError(f"[costs] rank {r['rank']}: Step 2's "
                             f"sharded_collectives {c}")
    log(f"[costs] rank {r['rank']}: sharded_collectives of the Set-B hemm "
        f"128³ Step 2 ({c['batch']} HLTs) on (data 1 × model 2): "
        f"{c['count']} all-reduces, {c['total']:.0f} bytes a rank sends = "
        f"plan.collective_bytes {c['plan']}; the largest "
        f"{c['largest'][:2]}")


def phase_costs(job: Background, sharded_r: list, smi: str) -> None:
    """Phase 3k: the dry-run records, the sharded program's collectives
    and the counts on the card's own step (timed once both subprocesses
    have ended)."""
    check_cost_records(dryrun_records(job))
    for r in sharded_r:
        check_sharded_collectives(r)
    own_step_counts(smi)


# ---------------------------------------------------------------------------
# phase 4: whole program on the kernels vs on the plain versions
# ---------------------------------------------------------------------------


def phase_cpu_vs_cuda():
    """fame-m-rt hemm 4×4×4 on cuda and on cpu, on both engine datapaths,
    every schedule batched and not (``baseline`` never batched) and the
    fused schedule on both ``HEContext`` datapaths: each output array-equal
    to its cpu twin, and all but ``baseline``'s array-equal to each other
    (``baseline`` rounds differently)."""
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
            xctx = HEContext(ctx.eng, ctx.keys, datapath="xla")
            for c, schedule in ((ctx, "pallas"), (xctx, "pallas"),
                                (ctx, "mo"), (ctx, "hoisted"),
                                (ctx, "baseline")):
                for batched in (True, False):
                    if schedule == "baseline" and batched:
                        continue
                    ctC = compile_hemm(c, plan, schedule=schedule,
                                       rotation_chunk=2,
                                       batched=batched)(ctA, ctB)
                    err = float(np.abs(decrypt_matrix(ctx.eng, ctx.keys, ctC,
                                                      m, n) - A @ B).max())
                    key = (dev, dp, c.datapath, schedule, batched)
                    outs[key] = (u32_numpy(ctC.c0), u32_numpy(ctC.c1),
                                 ctC.level, ctC.scale, err)
    for group in ("fused", "baseline"):
        runs = {k: v for k, v in outs.items()
                if (k[3] == "baseline") == (group == "baseline")}
        first, want = next(iter(runs.items()))
        for key, got in runs.items():
            for i, part in enumerate(("c0", "c1")):
                np.testing.assert_array_equal(got[i], want[i],
                                              err_msg=f"fame-m-rt {part} "
                                              f"{key} vs {first}")
            if got[2:4] != want[2:4] or not got[4] <= TOL:
                raise AssertionError(f"fame-m-rt {key}: {got[2:]} vs "
                                     f"{want[2:]}")
        log(f"[cpu-vs-cuda] fame-m-rt hemm 4x4x4, {group}: c0, c1 array-equal "
            f"over {len(runs)} runs ({{cuda, cpu}} x {{pallas, xla}} engine x "
            f"{sorted({(k[3], k[2], k[4]) for k in runs})}); max|C - A·B| = "
            f"{want[4]:.3e}")
    cpu_vs_cuda_blockmm(params)
    cpu_vs_cuda_chain()
    cpu_vs_cuda_lm()
    cpu_vs_cuda_vlm()
    cpu_vs_cuda_train()


def cpu_vs_cuda_train():
    """One ``train_step`` then a second, in float32, of each of
    ``TRAIN_CPU_ARCHS``' smoke configs (the MoE's is dropless) on cuda and
    on cpu from the same state, with the launcher's optimizer: metrics
    within 1e-4, and the new state — step, m, v everywhere; master
    weights and parameters where every step's cpu gradient is at least
    1e-6 · max|g| of its leaf (Adam's first steps move the others by ±lr
    on the sign of a rounding-level gradient; the count is printed) —
    within rtol = atol = 1e-4."""
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.data.pipeline import DataConfig, device_batch, synth_batch
    from repro_torch.train import train_step as ts
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.tree import leaves

    def close(x, y):
        return torch.allclose(x.cpu(), y, rtol=1e-4, atol=1e-4)

    for arch in TRAIN_CPU_ARCHS:
        cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
        if cfg.family == "moe" and \
                cfg.capacity_factor * cfg.experts_per_token < cfg.num_experts:
            raise AssertionError(f"{arch}: the smoke config drops tokens")
        tcfg = ts.TrainConfig(opt=OptConfig(**TRAIN_OPT))
        cpu = ts.init_train_state(cfg, tcfg, torch.Generator().manual_seed(6))
        states = {"cuda": _to(cpu, "cuda"), "cpu": cpu}
        keep = None
        for step in range(2):
            host = synth_batch(cfg, DataConfig(global_batch=4, seq_len=32),
                               step)
            _, grads = ts.value_and_grad(cfg, states["cpu"]["params"],
                                         device_batch(cfg, host, "cpu"))
            big = [g.abs() >= 1e-6 * g.abs().max() for g in grads]
            keep = big if keep is None else [k & b for k, b in zip(keep, big)]
            metrics = {}
            for dev in states:
                states[dev], metrics[dev] = ts.train_step(
                    cfg, tcfg, states[dev], device_batch(cfg, host, dev))
            for k, want in metrics["cpu"].items():
                if not close(metrics["cuda"][k], want):
                    raise AssertionError(f"{arch} step {step}: {k} "
                                         f"{float(metrics['cuda'][k])} vs "
                                         f"{float(want)}")
        got, want = states["cuda"], states["cpu"]
        if not int(got["opt"]["step"]) == int(want["opt"]["step"]) == 2:
            raise AssertionError(f"{arch}: step")
        diff, left_out = 0.0, 0
        for name in ("m", "v"):
            for x, y in zip(leaves(got["opt"][name]), leaves(want["opt"][name]),
                            strict=True):
                if not close(x, y):
                    raise AssertionError(f"{arch}: {name} off cpu")
        for x_tree, y_tree in ((got["params"], want["params"]),
                               (got["opt"]["master"], want["opt"]["master"])):
            for x, y, k in zip(leaves(x_tree), leaves(y_tree), keep,
                               strict=True):
                left_out += int((~k).sum())
                if not close(x[k.cuda()], y[k]):
                    raise AssertionError(f"{arch}: parameters off cpu")
                diff = max(diff, float((x.cpu()[k] - y[k]).abs().max()))
        log(f"[cpu-vs-cuda] {cfg.name} (float32): 2 train steps, metrics "
            f"within 1e-4, step / m / v and the parameters and master "
            f"within 1e-4 (max|diff| {diff:.3e}; {left_out} entries of "
            f"|g| < 1e-6·max|g| left out)")


def cpu_vs_cuda_blockmm(params):
    """The fame-m-rt block MM (tile 4, A 6×5 · B 5×7: a (2, 2, 2) grid)
    through ``SecureMatmulEngine`` on a ``"pallas"`` engine, batched and
    looped, on cuda and on cpu: every tile array-equal."""
    import numpy as np
    from repro_torch.core.ckks import CkksEngine
    from repro_torch.core.compile import HEContext
    from repro_torch.core.params import u32_numpy
    from repro_torch.secure import SecureMatmulEngine

    outs = {}
    for dev in ("cuda", "cpu"):
        rng = np.random.default_rng(10)
        engine = SecureMatmulEngine(params, tile=4, ctx=HEContext(
            CkksEngine(params, device=dev, datapath="pallas")))
        engine.keygen(rng)
        A = rng.uniform(-1, 1, (6, 5))
        B = rng.uniform(-1, 1, (5, 7))
        At, Bt = engine.encrypt_tiles(A, rng), engine.encrypt_tiles(B, rng)
        for batched in (True, False):
            C = engine.matmul_encrypted(At, Bt, batched=batched)
            err = float(np.abs(engine.decrypt_tiles(C, 6, 7) - A @ B).max())
            if not err <= TOL:
                raise AssertionError(f"fame-m-rt block MM {dev} batched "
                                     f"{batched}: off A·B by {err}")
            outs[dev, batched] = [(u32_numpy(ct.c0), u32_numpy(ct.c1),
                                   ct.level, ct.scale)
                                  for row in C for ct in row]
    first, want = next(iter(outs.items()))
    for key, got in outs.items():
        for g, w in zip(got, want, strict=True):
            np.testing.assert_array_equal(g[0], w[0])
            np.testing.assert_array_equal(g[1], w[1])
            if g[2:] != w[2:]:
                raise AssertionError(f"fame-m-rt block MM {key} vs {first}")
    log(f"[cpu-vs-cuda] fame-m-rt block MM 6x5 · 5x7 (tile 4, grid (2, 2, "
        f"2)): c0, c1 array-equal over {sorted(outs)} (device, batched)")


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
    "fused_hlt_batched": ("src/repro_torch/csrc/fused_hlt.cu",
                          "src/repro/kernels/fused_hlt.py:162"),
    "baseconv": ("src/repro_torch/csrc/baseconv.cu",
                 "src/repro/kernels/baseconv.py:39"),
    "modmul": ("src/repro_torch/csrc/modmul.cu",
               "src/repro/kernels/modmul.py:39"),
    "modadd": ("src/repro_torch/csrc/modmul.cu",
               "src/repro/kernels/modmul.py:56"),
}

#: the Set-C hemm: Table III's Set-C shape is 160³, whose ~636 rotation
#: keys of ~69 MB alone exceed the card's 80 GB; 32³ takes ~124 (PERF.md §4)
SET_C_SHAPE = (32, 32, 32)

#: the Set-B block MM: 64 is the largest power-of-two tile that
#: 3·tile² ≤ 2·slots admits at Set-B; both products' dimensions are off
#: the tile, so the grid is (2, 2, 2)
BLOCKMM_TILE = 64
BLOCKMM_SHAPES = ((100, 120), (120, 70))

#: the Set-B chain: three hops of the main path's hemm 128³ (an MLP
#: block's depth; level 15 affords 5 hops of 3 levels), and the depth of
#: the chain that must be refused (6 hops need level 18)
CHAIN_DIMS = (128,) * 5
REJECT_HOPS = 6

#: the serving phase: the secure layer's W0 is SERVE_DIM² (a (R, 2, 2) grid
#: of block-MM tiles a group), SERVE_REQUESTS requests a tenant a step, at
#: most SERVE_MAX_LIVE tenant arenas
SERVE_DIM = 128
SERVE_REQUESTS = 3
SERVE_MAX_LIVE = 2

#: phase 3f: launch/serve.py's traffic on LM_ARCH at full width, and the
#: prefill + decode vs forward check (S tokens, the reference test's bound)
LM_ARCH = "internlm2-1.8b"
LM_REQUESTS, LM_MAX_NEW = 4, 8
LM_CHECK_S = 16
LM_TOL = 6e-2
#: its secure layer: W0 d_model × LM_SECURE_OUT (one output tile), x·W0 of
#: standard deviation LM_SECURE_STD for an embedding row x; the bound on
#: the sign-cancelled error, a share of max|x·W0|
LM_SECURE_OUT = 64
LM_SECURE_STD = 10.0
LM_ERR_SHARE = 0.05
#: ``lm_secure``'s traffic on LM_ARCH: three requests (tenants A, B, A) of
#: 2 tokens on 2 slots; steps 1-2 flush one (1, 32, 1) group a tenant,
#: steps 3-4 A's second request on A's cached program (step 3 also as a
#: loop of tile hemms)
LM_SECURE = dict(tag="lm", prompts=(8, 10, 9), tenants=("A", "B", "A"),
                 max_new=2, want=[(2, 0, 2), (2, 2, 0), (1, 1, 0), (1, 1, 0)],
                 hit=1, loop=2)

#: phase 3g: the MoE at full width, plaintext and under HE (one tenant:
#: a compile step, then a hit; a (1, 24, 1) group), then the other
#: families that fit one card at full width, plaintext
FAM_ARCH = "granite-moe-3b-a800m"
FAM_SECURE = dict(tag="fam", prompts=(8,), tenants=("A",), max_new=2,
                  want=[(1, 0, 1), (1, 1, 0)], hit=1, loop=None)
FAM_PLAIN = ("mamba2-780m", "zamba2-2.7b", "musicgen-large")
#: phase 4: the vlm (175 GB at full width) as its smoke config
VLM_ARCH = "llama-3.2-vision-90b"

#: phase 3h: launch/train.py on TRAIN_ARCH at full width, TRAIN_STEPS steps
#: of TRAIN_BATCH × TRAIN_SEQ tokens, then TRAIN_MB_STEPS with 2
#: microbatches; their first losses agree within TRAIN_MB_RTOL (bf16
#: logits from products blocked for another batch size)
TRAIN_ARCH = "internlm2-1.8b"
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 6, 4, 512
TRAIN_MB_STEPS = 2
TRAIN_MB_RTOL = 1e-3
#: phase 4: train steps on cuda vs cpu, with the launcher's optimizer
TRAIN_CPU_ARCHS = ("internlm2-1.8b", "granite-moe-3b-a800m", "mamba2-780m")
TRAIN_OPT = dict(lr=1e-3, warmup_steps=20, total_steps=TRAIN_STEPS)

#: phase 3i: the 4-rank run's Set-B product and seed (the 2-rank run takes
#: phase 3's hemm 128³ and its seed)
SHARDED_SHAPE4 = (32, 32, 32)
#: phase 3i's limb-padding case: M = L+1+k = 6 extended limbs at Step 1
#: (5 at Step 2) on 4 limb ranks, so the last rank holds padding rows only
PAD_PARAMS = dict(logN=10, L=3, k=2, beta=2)
PAD_SHAPE = (4, 4, 4)
#: the kernels of the sharded body that the padded rows go through
PAD_KERNELS = ("intt_scale", "baseconv_ntt", "fused_hlt_indexed",
               "moddown_finish")
#: phase 3's seed (keys, A, B), which phase 3i's 2-rank run repeats
MAIN_SEED = 20260
SHARDED_SEED4 = 20261

#: phase 3j: the LM on (data 1 × model 2) ranks sharing the card: a float32
#: check of LM_MESH_PROMPT tokens then LM_MESH_DECODE decode steps of
#: LM_REQUESTS seeded prompts (logits within LM_MESH_LOGIT_TOL of one
#: device: summation order only, over 24 layers), LM_MESH_TRAIN_STEPS
#: train steps (step 1's loss within LM_MESH_LOSS_RTOL of phase 3h's,
#: bf16); then (data 2 × model 2) the smoke configs in float32 within
#: LM_MESH_SMOKE_TOL, LM_MESH_SMOKE_STEPS train steps each
LM_MESH_SEED = 20262
LM_MESH_PROMPT, LM_MESH_DECODE = 8, 2
LM_MESH_LOGIT_TOL = 1e-3
LM_MESH_TRAIN_STEPS = 3
LM_MESH_LOSS_RTOL = 1e-3
LM_MESH_SMOKE = ("internlm2-1.8b", "granite-moe-3b-a800m", "mamba2-780m")
LM_MESH_SMOKE_TOL = 1e-4
LM_MESH_FLIPS = 1e-3
LM_MESH_SMOKE_STEPS = 2
LM_MESH_TOY = dict(logN=6, L=4, k=3, beta=2)
#: phase 3j (a) and (b): the MoE smoke config; a dispatch group of 64
#: tokens makes a data rank's 2 rows of 64 whole groups; a cache of 30
#: positions (4 does not divide it), prompts of 6 + 5 tokens, 3 new
LM_MESH_MOE = "granite-moe-3b-a800m"
LM_MESH_GROUP = 64
LM_MESH_ODD_L, LM_MESH_CHUNKS, LM_MESH_ODD_NEW = 30, (6, 5), 3

#: kernels whose path is the kernel API (``phase_api``), not the hemm
API_KERNELS = ("fused_hlt_batched", "baseconv", "modmul", "modadd")

#: phase 3k: the dry-run's cells (the pod mesh), the decode step counted on
#: the card (phase 3f's batcher: a 128-long cache), its steps timed
COST_HE_SETS = ("set-b", "set-c")
COST_ARCHS = ("internlm2-1.8b", "granite-moe-3b-a800m", "mamba2-780m",
              "zamba2-2.7b", "musicgen-large")
COST_SHAPE = "decode_32k"
COST_CACHE = 128
LM_COST_POS = 9
COST_STEPS = 11
COST_SEED = 20263
COST_WAIT_S = 300
#: phase 4 runs beside phases 3i-3j (~35 s alone) on CPU_THREADS of the
#: host's cores, as does phase 3k's dry-run; the longest waits for them
#: after 3j
CPU_WAIT_S = 300
CPU_THREADS = 2


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs the port on a GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build
    if sys.argv[1:] == ["--cpu-vs-cuda"]:     # phase 4, run by the parent
        torch.set_num_threads(CPU_THREADS)    # beside the ranks of 3i-3j
        build.load()                          # the parent's build
        phase_cpu_vs_cuda()
        return 0

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
    jobs = {}
    try:
        return run_phases(smi, jobs)
    finally:
        for job in jobs.values():
            job.stop()


def run_phases(smi: str, jobs: dict) -> int:
    """Phases 2 to 4 (module docstring), then the result lines."""
    import torch
    from repro_torch.configs.fame_sets import MM_BENCHMARKS
    from repro_torch.core.ckks import CkksEngine
    from repro_torch.core.params import SET_B

    shape = MM_BENCHMARKS["set-b"]["type-iv"]
    records = {name: KernelRecord(name, *src, path="kernel-API run"
                                  if name in API_KERNELS else "hemm")
               for name, src in KERNELS.items()}
    t0 = time.perf_counter()
    eng = CkksEngine(SET_B)
    phase_kernels(eng, records, shape[1])
    torch.cuda.empty_cache()
    api = phase_api(eng)
    del eng
    torch.cuda.empty_cache()
    log(f"[kernels] phase {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    batched, unbatched, main_out = phase_main(SET_B, shape)
    # each kernel's launches come from the counted call of the path that
    # runs it (ntt / intt: the batched main path; both paths run 6·l; the
    # API kernels: the kernel API's counted run)
    launches = {k: api[k] if k in API_KERNELS else batched[k] or unbatched[k]
                for k in KERNELS}
    torch.cuda.empty_cache()
    log(f"[main] phase {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    gc.collect()        # the Set-B context and its programs form a cycle
    torch.cuda.empty_cache()
    blockmm = phase_blockmm(SET_B)
    log(f"[blockmm] phase {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    phase_set_c(SET_C_SHAPE)
    torch.cuda.empty_cache()
    log(f"[set-c] phase {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    chain = phase_chain(SET_B)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[chain] phase {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    serve = phase_serve(SET_B)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[serve] phase {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    lm = phase_lm(SET_B)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[lm] phase {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    families = phase_families(SET_B)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[fam] phase {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    train, first_loss = phase_train()
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[train] phase {time.perf_counter() - t0:.1f} s")

    # phase 3k's dry-run and phase 4 (checks only, no timing) in
    # subprocesses beside phases 3i-3j, whose parent waits on its ranks
    jobs["dryrun"] = dryrun_job()
    jobs["cpu"] = Background(
        "cpu-vs-cuda", [sys.executable, str(ROOT / "chip_smoke.py"),
                        "--cpu-vs-cuda"],
        tempfile.mkdtemp(prefix="chip_smoke_cpu_"))
    log("[sharded] phases 3i-3j run beside two subprocesses (phase 3k's "
        "dry-run, phase 4): their times are taken beside them")
    t0 = time.perf_counter()
    sharded, sharded_ranks = phase_sharded(SET_B, main_out)
    del main_out
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[sharded] phase {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    lm_mesh = phase_lm_mesh(first_loss)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[lm-mesh] phase {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    for line in jobs["cpu"].wait(CPU_WAIT_S).splitlines():
        if line.startswith("[cpu-vs-cuda]"):
            log(line)
    log(f"[cpu-vs-cuda] waited {time.perf_counter() - t0:.1f} s for it")

    t0 = time.perf_counter()
    phase_costs(jobs["dryrun"], sharded_ranks, smi)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[costs] phase {time.perf_counter() - t0:.1f} s")
    log(f"[smoke] whole command {time.perf_counter() - T_START:.1f} s")

    print(json.dumps({"kernels": [
        dict(r.entry(launches[name]), launches_blockmm=blockmm[name],
             launches_chain=chain[name], launches_serve=serve[name],
             launches_lm=lm[name], launches_families=families[name],
             launches_train=train[name], launches_sharded=sharded[name],
             launches_lm_mesh=lm_mesh.get(name, 0))
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
