"""Plan → compile → execute for HE matmul on one device — counterpart of
the single-device ``"pallas"`` batched path of ``repro/core/compile.py``::

    ctx = HEContext(CkksEngine(params))           # CUDA unless told "cpu"
    plan = plan_hemm(ctx.eng, m, l, n)
    ctx.keygen(rng, rot_steps=plan.rot_steps)
    prog = compile_hemm(ctx, plan, schedule="pallas", rotation_chunk=8)
    ctC = prog(ctA, ctB)

The port has no cost model yet, so ``schedule`` must be ``"pallas"`` and
``rotation_chunk`` is explicit; it sets the d-padding (d_pad is the next
multiple of the chunk), while the CUDA kernel loops over all d_pad
rotations itself.  ``HEContext`` owns all precompute: the operand arena
(one slot per unique DiagSet at a compile point) and the compile memo;
``invalidate()`` (run by ``keygen``) drops both, and compiled objects from
before refuse to run.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import torch

from repro_torch.core import hlt as hlt_mod
from repro_torch.core.ckks import Ciphertext, CkksEngine, Keys
from repro_torch.core.hlt import DiagSet, Hoisted, hoist_batched
from repro_torch.kernels import ops

SCHEDULES = ("pallas",)


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

    ``counters`` are monotonic lifetime statistics (not reset by
    ``invalidate``): ``hlt_launches`` counts CompiledHLT calls (one
    slot-indexed rotation-datapath launch each) and ``program_launches``
    counts HEMMProgram calls."""

    def __init__(self, eng: CkksEngine, keys: Optional[Keys] = None):
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


def _check_schedule(schedule: str, rotation_chunk) -> int:
    if schedule not in SCHEDULES:
        raise ValueError(f"schedule={schedule!r}: the port runs only "
                         f"{SCHEDULES} (no cost model yet)")
    if not isinstance(rotation_chunk, int) or rotation_chunk < 1:
        raise ValueError(f"rotation_chunk={rotation_chunk!r}: pass a "
                         "positive int (no cost model yet)")
    return rotation_chunk


# ---------------------------------------------------------------------------
# compile_hlt -> CompiledHLT
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class HLTPlan:
    """One compiled batched HLT.  ``d`` holds each batch element's real
    diagonal count and ``d_pad`` the common padded rotation count (a
    ``chunk`` multiple); ``diag_slots`` maps batch index -> unique
    diagonal-set slot; ``ct_slots`` is the compile-time input-aliasing hint
    (``None`` = unknown until call time)."""

    schedule: str
    level: int
    batch: int
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


def compile_hlt(ctx: HEContext, diags: Sequence[DiagSet], *, level: int,
                schedule: str, rotation_chunk: int,
                ct_slots: Optional[Sequence[int]] = None) -> "CompiledHLT":
    """Compile a batched HLT over one DiagSet per batch element (duplicates
    share one operand slot).  Memoized on the context."""
    if ctx.keys is None:
        raise RuntimeError("HEContext has no keys; call ctx.keygen()")
    chunk_req = _check_schedule(schedule, rotation_chunk)
    if isinstance(diags, DiagSet):
        raise TypeError("the port compiles batched HLTs only: pass a "
                        "sequence of DiagSets")
    diag_list = list(diags)
    if not diag_list:
        raise ValueError("batched compile needs at least one DiagSet")
    eng = ctx.eng
    if ct_slots is not None:
        if len(ct_slots) != len(diag_list):
            raise ValueError(f"ct_slots has {len(ct_slots)} entries for "
                             f"{len(diag_list)} DiagSets")
        remap: dict = {}
        ct_slots = tuple(remap.setdefault(s, len(remap)) for s in ct_slots)
    memo_key = ("hlt", schedule, level, rotation_chunk, ct_slots,
                tuple(_StrongKey(ds) for ds in diag_list))
    hit = ctx._compiled.get(memo_key)
    if hit is not None:
        return hit

    nbeta = len(eng.tools.digit_bases(level))
    d_list = tuple(ds.d for ds in diag_list)
    d_max = max(d_list)
    chunk = max(1, min(chunk_req, d_max))
    d_pad = -(-d_max // chunk) * chunk
    uniq, slots = _dedup_by_identity(diag_list)
    # the kernel reads one stacked tensor per operand; each unique DiagSet
    # is built straight into its slice (the arena keeps views of it), or
    # copied there when an earlier compile already built it
    operands = tuple(
        torch.zeros((len(uniq),) + s, dtype=torch.int32, device=eng.device)
        for s in hlt_mod.operand_shapes(eng, level, nbeta, d_pad))
    for s, ds in enumerate(uniq):
        dst = tuple(t[s] for t in operands)
        extra = (level, nbeta, d_pad)
        got = ctx.arena.get("pallas_operands", ds, extra)
        if got is None:
            ctx.arena.slot("pallas_operands", ds, extra,
                           lambda ds=ds, dst=dst: hlt_mod._build_pallas_operands(
                               eng, ds, ctx.keys, level, nbeta, d_pad, out=dst))
        else:
            for a, b in zip(dst, got, strict=True):
                a.copy_(b)
    op_bytes = sum(t.numel() * t.element_size() for t in operands)
    plan = HLTPlan(
        schedule=schedule, level=level, batch=len(diag_list), nbeta=nbeta,
        chunk=chunk, d=d_list, d_pad=d_pad, diag_slots=tuple(slots),
        n_diag_slots=len(uniq),
        operand_bytes=op_bytes, ct_slots=ct_slots,
        n_ct_slots=None if ct_slots is None else len(set(ct_slots)))
    run = CompiledHLT(ctx, plan, tuple(diag_list), operands)
    ctx._compiled[memo_key] = run
    return run


class CompiledHLT:
    """A compiled batched HLT: call with a sequence of ciphertexts or
    hoisting products (repeated objects share one hoisting slot)."""

    def __init__(self, ctx: HEContext, plan: HLTPlan, diag_list, operands):
        self.ctx = ctx
        self.plan = plan
        self._diags = diag_list
        self._operands = operands       # stacked per unique slot
        self._diag_slots = torch.tensor(plan.diag_slots, dtype=torch.int32,
                                        device=ctx.eng.device)
        self._gen = ctx._generation

    def _hoist_items(self, items):
        """Dedupe by object identity, hoist the unique ciphertexts in ONE
        batched call, return (unique_hoisted, ct_slots)."""
        uniq, slots = _dedup_by_identity(items)
        todo = [i for i, it in enumerate(uniq) if not isinstance(it, Hoisted)]
        hoisted = list(uniq)
        for i, h in zip(todo, hoist_batched(self.ctx.eng, [uniq[i] for i in todo]),
                        strict=True):
            hoisted[i] = h
        for h in hoisted:
            if h.level != self.plan.level:
                raise ValueError(f"input level {h.level}, compiled for "
                                 f"{self.plan.level}")
        return hoisted, slots

    def __call__(self, items) -> list:
        self.ctx._check_generation(self._gen)
        self.ctx.counters["hlt_launches"] += 1
        items = list(items)
        if len(items) != self.plan.batch:
            raise ValueError(f"{len(items)} inputs for a batch of "
                             f"{self.plan.batch}")
        return self._run_batched_pallas(items)

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
        down = ops.moddown_fused(acc.reshape((2 * B,) + acc.shape[2:]),
                                 eng.fused_moddown_tables(plan.level))
        q_ell = eng.ctx.moduli_host[plan.level]
        return [Ciphertext(down[b], down[B + b], plan.level - 1,
                           hoisted[ct_slots[b]].scale * ds.scale / q_ell)
                for b, ds in enumerate(self._diags)]


# ---------------------------------------------------------------------------
# compile_hemm -> HEMMProgram
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class HEMMPlan:
    """Compile summary for one HE MM: Step 1 (σ, τ) and Step 2 (2·l ε/ω)
    as one batched launch each; the program consumes 3 levels from
    ``level``."""

    m: int
    l: int
    n: int
    schedule: str
    level: int
    step1: HLTPlan
    step2: HLTPlan


class HEMMProgram:
    """A compiled Algorithm-2 HE MM: ``prog(ctA, ctB) -> ctC``.

    Step 1 runs {σ(A), τ(B)} as one batched HLT; Step 2 runs all 2·l HLTs
    as one slot-indexed HLT off the 2 unique hoisting products; then
    l × (mult → rescale) and add."""

    def __init__(self, ctx: HEContext, mm_plan, plan: HEMMPlan,
                 step1: CompiledHLT, step2: CompiledHLT):
        self.ctx = ctx
        self.mm_plan = mm_plan
        self.plan = plan
        self._step1 = step1
        self._step2 = step2
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
        ctA0, ctB0 = self._step1([ctA, ctB])
        self._mark("step1")
        hstA, hstB = hoist_batched(eng, [ctA0, ctB0])
        self._mark("step2_hoist")
        outs = self._step2([hstA] * p.l + [hstB] * p.l)
        self._mark("step2")
        acc: Optional[Ciphertext] = None
        for k in range(p.l):
            prod = eng.rescale(eng.mult(outs[k], outs[p.l + k], keys))
            acc = prod if acc is None else eng.add(acc, prod)
        self._mark("mult_rescale")
        return acc


def compile_hemm(ctx: HEContext, plan, *, schedule: str, rotation_chunk: int,
                 level: Optional[int] = None) -> HEMMProgram:
    """Compile Algorithm 2 for a HeMMPlan into a reusable HEMMProgram
    (memoized on the context: same plan -> same program)."""
    if ctx.keys is None:
        raise RuntimeError("HEContext has no keys; call ctx.keygen()")
    _check_schedule(schedule, rotation_chunk)
    level = ctx.eng.params.L if level is None else level
    memo_key = ("hemm", _StrongKey(plan), schedule, level, rotation_chunk)
    hit = ctx._compiled.get(memo_key)
    if hit is not None:
        return hit
    step1 = compile_hlt(ctx, [plan.ds_sigma, plan.ds_tau], level=level,
                        schedule=schedule, rotation_chunk=rotation_chunk,
                        ct_slots=(0, 1))
    step2 = compile_hlt(ctx, list(plan.ds_eps) + list(plan.ds_omega),
                        level=level - 1, schedule=schedule,
                        rotation_chunk=rotation_chunk,
                        ct_slots=(0,) * plan.l + (1,) * plan.l)
    prog = HEMMProgram(
        ctx, plan,
        HEMMPlan(m=plan.m, l=plan.l, n=plan.n, schedule=schedule, level=level,
                 step1=step1.plan, step2=step2.plan),
        step1, step2)
    ctx._compiled[memo_key] = prog
    return prog
