"""Plan → compile → execute for HE matmul on one device — counterpart of
the single-device schedules of ``repro/core/compile.py``::

    ctx = HEContext(CkksEngine(params))           # CUDA unless told "cpu"
    plan = plan_hemm(ctx.eng, m, l, n)
    ctx.keygen(rng, rot_steps=plan.rot_steps)
    prog = compile_hemm(ctx, plan, schedule="pallas", rotation_chunk=8)
    ctC = prog(ctA, ctB)

``schedule`` is one of ``SCHEDULES``: the fused ``"pallas"`` (the kernels)
or a reference schedule ``"baseline"`` / ``"hoisted"`` / ``"mo"``
(``core/hlt.py``).  On ``"pallas"``, ``compile_hlt`` compiles one DiagSet
(a single-ciphertext HLT: one ``fused_hlt`` launch) or a sequence of them
(a slot-indexed batch: one ``fused_hlt_indexed`` launch); a reference
schedule runs a batch as a loop of single executions.
``compile_hemm(..., batched=False)`` builds Algorithm 2 from 2 + 2·l
single HLTs instead of two batched ones (``baseline`` is never batched).

``HEContext(datapath=)`` picks the lowering of the fused schedule's hoist
and merged ModDown+Rescale: ``"pallas"`` (default) the fused kernels,
``"xla"`` the chains on the engine's own transforms.  The reference
schedules always hoist by the chain; their ModDown follows the engine's
datapath.  So on an ``"xla"`` engine, ``schedule="mo"`` launches no kernel.

The port has no cost model yet, so ``schedule`` is explicit, and so is
``rotation_chunk`` on ``"pallas"``: it sets the d-padding (d_pad is the
next multiple of the chunk), while the CUDA kernel loops over all d_pad
rotations itself.  On the reference schedules ``rotation_chunk=None``
means d, as in the reference (``mo`` runs that many rotations a step).
``HEContext`` owns all precompute: the operand arena (one slot per unique
DiagSet at a compile point) and the compile memo; ``invalidate()`` (run by
``keygen``) drops both, and compiled objects from before refuse to run.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Union

import torch

from repro_torch.core import hlt as hlt_mod
from repro_torch.core.ckks import Ciphertext, CkksEngine, Keys
from repro_torch.core.hlt import (SCHEDULES, DiagSet, Hoisted, hoist,
                                  hoist_batched)
from repro_torch.kernels import ops


class _StrongKey:
    """Dict key by object identity holding a strong reference (an id can
    never be recycled while the entry exists)."""

    __slots__ = ("obj",)

    def __init__(self, obj):
        self.obj = obj

    def __hash__(self):
        return id(self.obj)

    def __eq__(self, other):
        return isinstance(other, _StrongKey) and self.obj is other.obj


class OperandArena:
    """Device-resident operand store: ONE slot per unique operand group."""

    def __init__(self):
        self._entries: dict = {}

    def slot(self, kind: str, obj, extra: tuple, builder):
        """Return ``(slot_id, value)`` for the key, building it on miss."""
        key = (kind, _StrongKey(obj), extra)
        hit = self._entries.get(key)
        if hit is None:
            hit = (len(self._entries), builder())
            self._entries[key] = hit
        return hit

    def get(self, kind: str, obj, extra: tuple):
        """The value stored for the key, or None."""
        hit = self._entries.get((kind, _StrongKey(obj), extra))
        return None if hit is None else hit[1]

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def nbytes(self) -> int:
        total = 0
        for _, value in self._entries.values():
            for t in value:
                total += t.numel() * t.element_size()
        return total

    def clear(self) -> None:
        self._entries.clear()


class HEContext:
    """Engine + keys + operand arena: owns all precompute.

    ``datapath`` picks the fused schedule's hoist and merged ModDown+Rescale
    lowering: ``"pallas"`` the fused kernels, ``"xla"`` the chains on the
    engine's transforms (the rotation datapath stays on its kernel).

    ``counters`` are monotonic lifetime statistics (not reset by
    ``invalidate``): ``hlt_launches`` counts CompiledHLT calls (one
    rotation-datapath launch each) and ``program_launches`` counts
    HEMMProgram calls."""

    DATAPATHS = ("pallas", "xla")

    def __init__(self, eng: CkksEngine, keys: Optional[Keys] = None,
                 datapath: str = "pallas"):
        if datapath not in self.DATAPATHS:
            raise ValueError(f"datapath={datapath!r} not in {self.DATAPATHS}")
        self.datapath = datapath
        self.eng = eng
        self.keys = keys
        self.arena = OperandArena()
        self._compiled: dict = {}
        self._generation = 0
        self.counters = {"hlt_launches": 0, "program_launches": 0}

    @classmethod
    def create(cls, params, rng, rot_steps: Sequence[int] = (),
               device=None) -> "HEContext":
        ctx = cls(CkksEngine(params, device=device))
        ctx.keygen(rng, rot_steps=rot_steps)
        return ctx

    def keygen(self, rng, rot_steps: Sequence[int] = ()) -> Keys:
        """Generate fresh keys and invalidate every cached operand."""
        self.keys = self.eng.keygen(rng, rot_steps=rot_steps)
        self.invalidate()
        return self.keys

    def invalidate(self) -> None:
        """Drop every arena operand and compiled program; compiled objects
        from before refuse to run."""
        self.arena.clear()
        self._compiled.clear()
        self._generation += 1

    def _check_generation(self, gen: int) -> None:
        if gen != self._generation:
            raise RuntimeError(
                "stale compiled object: its HEContext was invalidated "
                "(re-keygen?) after compilation — recompile")


# Context pool for the deprecated shims (``hlt()``, ``hlt_batched()``): one
# context per (engine, keys) pair, keyed by strong identity, least recently
# used first out, so a long-lived process does not keep every pair alive.
_LEGACY_CONTEXTS: dict = {}
_LEGACY_POOL_MAX = 8


def legacy_context(eng: CkksEngine, keys: Keys) -> HEContext:
    """Pooled HEContext for the deprecated shims (LRU)."""
    key = (_StrongKey(eng), _StrongKey(keys))
    ctx = _LEGACY_CONTEXTS.pop(key, None)
    if ctx is None:
        ctx = HEContext(eng, keys)
        while len(_LEGACY_CONTEXTS) >= _LEGACY_POOL_MAX:
            _LEGACY_CONTEXTS.pop(next(iter(_LEGACY_CONTEXTS)))
    _LEGACY_CONTEXTS[key] = ctx
    return ctx


def _check_schedule(schedule: str, rotation_chunk) -> Optional[int]:
    if schedule not in SCHEDULES:
        raise ValueError(f"schedule={schedule!r}: the port runs only "
                         f"{SCHEDULES} (no cost model yet)")
    if rotation_chunk is None and schedule != "pallas":
        return None                     # the reference's rule: chunk = d
    if not isinstance(rotation_chunk, int) or rotation_chunk < 1:
        raise ValueError(f"rotation_chunk={rotation_chunk!r}: pass a "
                         "positive int (no cost model yet)")
    return rotation_chunk


# ---------------------------------------------------------------------------
# compile_hlt -> CompiledHLT
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class HLTPlan:
    """One compiled HLT: ``batch`` is ``None`` for a single-ciphertext
    compile, else the batch size.  ``datapath`` is the lowering of the hoist
    and merged ModDown (the context's on ``"pallas"``, ``"xla"`` for the
    reference schedules).  ``d`` holds each batch element's real diagonal
    count and ``d_pad`` the common padded rotation count (a ``chunk``
    multiple); ``diag_slots`` maps batch index -> unique diagonal-set slot;
    ``ct_slots`` is the compile-time input-aliasing hint (``None`` =
    unknown until call time)."""

    schedule: str
    datapath: str
    level: int
    batch: Optional[int]
    nbeta: int
    chunk: int
    d: tuple
    d_pad: int
    diag_slots: tuple
    n_diag_slots: int
    operand_bytes: int
    ct_slots: Optional[tuple] = None
    n_ct_slots: Optional[int] = None


def _dedup_by_identity(items):
    """Batch elements -> (unique_items, slots), first-appearance order."""
    local, uniq, slots = {}, [], []
    for it in items:
        k = id(it)
        if k not in local:
            local[k] = len(uniq)
            uniq.append(it)
        slots.append(local[k])
    return uniq, slots


def _pallas_operands(ctx: HEContext, uniq, batch, level: int, nbeta: int,
                     d_pad: int) -> tuple:
    """The fused kernels' Montgomery operands: one DiagSet's arena slot as it
    stands (a single compile), or one stacked tensor per operand with each
    unique DiagSet built straight into its slice (the arena keeps views of
    it), or copied there when an earlier compile already built it."""
    eng = ctx.eng
    extra = (level, nbeta, d_pad)
    if batch is None:
        return ctx.arena.slot(
            "pallas_operands", uniq[0], extra,
            lambda: hlt_mod._build_pallas_operands(
                eng, uniq[0], ctx.keys, level, nbeta, d_pad))[1]
    operands = tuple(
        torch.zeros((len(uniq),) + s, dtype=torch.int32, device=eng.device)
        for s in hlt_mod.operand_shapes(eng, level, nbeta, d_pad))
    for s, ds in enumerate(uniq):
        dst = tuple(t[s] for t in operands)
        got = ctx.arena.get("pallas_operands", ds, extra)
        if got is None:
            ctx.arena.slot(
                "pallas_operands", ds, extra,
                lambda ds=ds, dst=dst: hlt_mod._build_pallas_operands(
                    eng, ds, ctx.keys, level, nbeta, d_pad, out=dst))
        else:
            for a, b in zip(dst, got, strict=True):
                a.copy_(b)
    return operands


def compile_hlt(ctx: HEContext, diags: Union[DiagSet, Sequence[DiagSet]], *,
                level: int, schedule: str,
                rotation_chunk: Optional[int] = None,
                ct_slots: Optional[Sequence[int]] = None) -> "CompiledHLT":
    """Compile an HLT.  ``diags``: one DiagSet (a single-ciphertext compile)
    or a sequence of DiagSets, one per batch element (duplicates share one
    operand slot).  Memoized on the context."""
    if ctx.keys is None:
        raise RuntimeError("HEContext has no keys; call ctx.keygen()")
    chunk_req = _check_schedule(schedule, rotation_chunk)
    single = isinstance(diags, DiagSet)
    diag_list = [diags] if single else list(diags)
    batch = None if single else len(diag_list)
    if not diag_list:
        raise ValueError("batched compile needs at least one DiagSet")
    eng = ctx.eng
    if ct_slots is not None:
        if len(ct_slots) != len(diag_list):
            raise ValueError(f"ct_slots has {len(ct_slots)} entries for "
                             f"{len(diag_list)} DiagSets")
        remap: dict = {}
        ct_slots = tuple(remap.setdefault(s, len(remap)) for s in ct_slots)
    # the context's knob covers the fused schedule only; the reference
    # schedules always hoist by the chain
    datapath = ctx.datapath if schedule == "pallas" else "xla"
    memo_key = ("hlt", schedule, level, batch, rotation_chunk, ct_slots,
                datapath, tuple(_StrongKey(ds) for ds in diag_list))
    hit = ctx._compiled.get(memo_key)
    if hit is not None:
        return hit

    nbeta = len(eng.tools.digit_bases(level))
    d_list = tuple(ds.d for ds in diag_list)
    d_max = max(d_list)
    chunk = d_max if chunk_req is None else max(1, min(chunk_req, d_max))
    d_pad = -(-d_max // chunk) * chunk
    uniq, slots = _dedup_by_identity(diag_list)
    operands = (_pallas_operands(ctx, uniq, batch, level, nbeta, d_pad)
                if schedule == "pallas" else ())
    op_bytes = sum(t.numel() * t.element_size() for t in operands)
    plan = HLTPlan(
        schedule=schedule, datapath=datapath, level=level, batch=batch,
        nbeta=nbeta, chunk=chunk, d=d_list, d_pad=d_pad,
        diag_slots=tuple(slots), n_diag_slots=len(uniq),
        operand_bytes=op_bytes, ct_slots=ct_slots,
        n_ct_slots=None if ct_slots is None else len(set(ct_slots)))
    run = CompiledHLT(ctx, plan, tuple(diag_list), operands)
    ctx._compiled[memo_key] = run
    return run


class CompiledHLT:
    """A compiled HLT: call a single compile with one ciphertext or
    hoisting product, a batched one with a sequence of them (repeated
    objects share one hoisting slot).  ``baseline`` takes ciphertexts
    only: it has no hoisting product."""

    def __init__(self, ctx: HEContext, plan: HLTPlan, diag_list, operands):
        self.ctx = ctx
        self.plan = plan
        self._diags = diag_list
        self._operands = operands       # "pallas": one DiagSet's, or stacked
        self._diag_slots = (None if plan.batch is None else
                            torch.tensor(plan.diag_slots, dtype=torch.int32,
                                         device=ctx.eng.device))
        self._gen = ctx._generation

    def _hoist_items(self, items):
        """Dedupe by object identity, hoist the unique ciphertexts in ONE
        batched call on the plan's datapath, return (unique_hoisted,
        ct_slots)."""
        uniq, slots = _dedup_by_identity(items)
        todo = [i for i, it in enumerate(uniq) if not isinstance(it, Hoisted)]
        hoisted = list(uniq)
        for i, h in zip(todo, hoist_batched(self.ctx.eng,
                                            [uniq[i] for i in todo],
                                            datapath=self.plan.datapath),
                        strict=True):
            hoisted[i] = h
        for h in hoisted:
            self._check_level(h)
        return hoisted, slots

    def _check_level(self, item) -> None:
        if item.level != self.plan.level:
            raise ValueError(f"input level {item.level}, compiled for "
                             f"{self.plan.level}")

    def _moddown(self, acc):
        """Merged ModDown+Rescale of (P, M_ext, N) accumulators on the
        plan's datapath -> (P, ℓ, N)."""
        eng, level = self.ctx.eng, self.plan.level
        if self.plan.datapath == "pallas":
            return ops.moddown_fused(acc, eng.fused_moddown_tables(level))
        return torch.stack([eng._mod_down_eval(a, level, drop_last=True,
                                               datapath="xla") for a in acc])

    def __call__(self, items):
        self.ctx._check_generation(self._gen)
        self.ctx.counters["hlt_launches"] += 1
        if self.plan.batch is None:
            return self._run_single(items, self._diags[0])
        items = list(items)
        if len(items) != self.plan.batch:
            raise ValueError(f"{len(items)} inputs for a batch of "
                             f"{self.plan.batch}")
        if self.plan.schedule == "pallas":
            return self._run_batched_pallas(items)
        # reference schedules: a loop of single executions (oracle path)
        return [self._run_single(it, ds)
                for it, ds in zip(items, self._diags, strict=True)]

    def _run_batched_pallas(self, items) -> list:
        eng, plan = self.ctx.eng, self.plan
        hoisted, ct_slots = self._hoist_items(items)
        digits = torch.stack([h.digits for h in hoisted])
        c0e = torch.stack([h.c0_ext for h in hoisted])
        c1e = torch.stack([h.c1_ext for h in hoisted])
        view = eng.basis(eng.tools.digit_bases(plan.level)[0][2])
        acc = ops.fused_hlt_indexed(
            digits, c0e, c1e, *self._operands,
            torch.tensor(ct_slots, dtype=torch.int32, device=eng.device),
            self._diag_slots, view.moduli_u32, view.qneg_inv)
        B = plan.batch
        down = self._moddown(acc.reshape((2 * B,) + acc.shape[2:]))
        q_ell = eng.ctx.moduli_host[plan.level]
        return [Ciphertext(down[b], down[B + b], plan.level - 1,
                           hoisted[ct_slots[b]].scale * ds.scale / q_ell)
                for b, ds in enumerate(self._diags)]

    def _run_single(self, item, ds: DiagSet) -> Ciphertext:
        """One HLT on the plan's schedule.  ``pallas``: hoist (unless given a
        hoisting product), one ``fused_hlt``, and the merged ModDown+Rescale
        over both output polynomials."""
        ctx, eng, plan = self.ctx, self.ctx.eng, self.plan
        if plan.schedule == "baseline":
            if not isinstance(item, Ciphertext):
                raise TypeError("schedule='baseline' has no hoisting "
                                "product; pass Ciphertexts")
            self._check_level(item)
            return hlt_mod._hlt_baseline(eng, item, ds, ctx.keys)
        hst = item if isinstance(item, Hoisted) else \
            hoist(eng, item, datapath=plan.datapath)
        self._check_level(hst)
        if plan.schedule == "hoisted":
            return hlt_mod._hlt_hoisted(eng, hst, ds, ctx.keys)
        if plan.schedule == "mo":
            return hlt_mod._hlt_mo(eng, hst, ds, ctx.keys, plan.chunk)
        view = eng.basis(eng.tools.digit_bases(plan.level)[0][2])
        acc = ops.fused_hlt(hst.digits, hst.c0_ext, hst.c1_ext,
                            *self._operands, view.moduli_u32, view.qneg_inv)
        down = self._moddown(acc)
        q_ell = eng.ctx.moduli_host[plan.level]
        return Ciphertext(down[0], down[1], plan.level - 1,
                          hst.scale * ds.scale / q_ell)


# ---------------------------------------------------------------------------
# compile_hemm -> HEMMProgram
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class HEMMPlan:
    """Compile summary for one HE MM: Step 1 (σ, τ) and Step 2 (2·l ε/ω),
    as one batched launch each (``batched``) or as 2 + 2·l single HLTs
    (``step1`` / ``step2`` then describe the first HLT of each step); the
    program consumes 3 levels from ``level``."""

    m: int
    l: int
    n: int
    schedule: str
    level: int
    batched: bool
    step1: HLTPlan
    step2: HLTPlan


class HEMMProgram:
    """A compiled Algorithm-2 HE MM: ``prog(ctA, ctB) -> ctC``.

    Batched: Step 1 runs {σ(A), τ(B)} as one batched HLT and Step 2 all 2·l
    HLTs as one batched HLT off the 2 unique hoisting products (on
    ``"pallas"`` one slot-indexed launch each; a reference schedule loops
    inside the batch).  Not batched: σ(A) and τ(B) are two single HLTs,
    each output is hoisted once (``baseline``: not at all), and the 2·l
    single HLTs of Step 2 reuse those two products.  Then l × (mult →
    rescale) and add."""

    def __init__(self, ctx: HEContext, mm_plan, plan: HEMMPlan, step1, step2):
        self.ctx = ctx
        self.mm_plan = mm_plan
        self.plan = plan
        self._step1 = step1         # CompiledHLT, or a tuple of 2 if unbatched
        self._step2 = step2         # CompiledHLT, or a tuple of 2·l
        self._gen = ctx._generation
        #: optional callable(stage_name) run at each stage boundary of a
        #: call ("start", "step1", "step2_hoist", "step2", "mult_rescale");
        #: a timer sets it, synchronises the device and reads its clock
        self.stage_hook: Optional[Callable[[str], None]] = None

    def _mark(self, name: str) -> None:
        if self.stage_hook is not None:
            self.stage_hook(name)

    def __call__(self, ctA: Ciphertext, ctB: Ciphertext) -> Ciphertext:
        self.ctx._check_generation(self._gen)
        self.ctx.counters["program_launches"] += 1
        eng, keys, p = self.ctx.eng, self.ctx.keys, self.mm_plan
        if not ctA.level == ctB.level == self.plan.level:
            raise ValueError(f"input levels {ctA.level}, {ctB.level}; "
                             f"compiled for {self.plan.level}")
        self._mark("start")
        if self.plan.batched:
            ctA0, ctB0 = self._step1([ctA, ctB])
            self._mark("step1")
            hstA, hstB = hoist_batched(eng, [ctA0, ctB0],
                                       datapath=self.plan.step2.datapath)
            self._mark("step2_hoist")
            outs = self._step2([hstA] * p.l + [hstB] * p.l)
        else:
            s1a, s1b = self._step1
            ctA0, ctB0 = s1a(ctA), s1b(ctB)
            self._mark("step1")
            if self.plan.schedule == "baseline":
                inA, inB = ctA0, ctB0       # no hoisting product
            else:       # hoist once, reuse across all l Step-2 HLTs per input
                dp = self.plan.step2.datapath
                inA, inB = hoist(eng, ctA0, dp), hoist(eng, ctB0, dp)
            self._mark("step2_hoist")
            outs = ([run(inA) for run in self._step2[:p.l]]
                    + [run(inB) for run in self._step2[p.l:]])
        self._mark("step2")
        acc: Optional[Ciphertext] = None
        for k in range(p.l):
            prod = eng.rescale(eng.mult(outs[k], outs[p.l + k], keys))
            acc = prod if acc is None else eng.add(acc, prod)
        self._mark("mult_rescale")
        return acc


def compile_hemm(ctx: HEContext, plan, *, schedule: str,
                 rotation_chunk: Optional[int] = None,
                 level: Optional[int] = None,
                 batched: bool = True) -> HEMMProgram:
    """Compile Algorithm 2 for a HeMMPlan into a reusable HEMMProgram
    (memoized on the context: same plan -> same program).  ``baseline``
    is never batched: it has no hoisting product to share."""
    if ctx.keys is None:
        raise RuntimeError("HEContext has no keys; call ctx.keygen()")
    _check_schedule(schedule, rotation_chunk)
    level = ctx.eng.params.L if level is None else level
    batched = bool(batched) and schedule != "baseline"
    memo_key = ("hemm", _StrongKey(plan), schedule, level, rotation_chunk,
                batched)
    hit = ctx._compiled.get(memo_key)
    if hit is not None:
        return hit
    step2_sets = list(plan.ds_eps) + list(plan.ds_omega)
    if batched:
        step1 = compile_hlt(ctx, [plan.ds_sigma, plan.ds_tau], level=level,
                            schedule=schedule, rotation_chunk=rotation_chunk,
                            ct_slots=(0, 1))
        step2 = compile_hlt(ctx, step2_sets, level=level - 1,
                            schedule=schedule, rotation_chunk=rotation_chunk,
                            ct_slots=(0,) * plan.l + (1,) * plan.l)
        s1_plan, s2_plan = step1.plan, step2.plan
    else:
        c = lambda ds, lv: compile_hlt(ctx, ds, level=lv, schedule=schedule,
                                       rotation_chunk=rotation_chunk)
        step1 = (c(plan.ds_sigma, level), c(plan.ds_tau, level))
        step2 = tuple(c(ds, level - 1) for ds in step2_sets)
        s1_plan, s2_plan = step1[0].plan, step2[0].plan
    prog = HEMMProgram(
        ctx, plan,
        HEMMPlan(m=plan.m, l=plan.l, n=plan.n, schedule=schedule, level=level,
                 batched=batched, step1=s1_plan, step2=s2_plan),
        step1, step2)
    ctx._compiled[memo_key] = prog
    return prog
