"""Plan → compile → execute for HE matmul on one device — counterpart of
the single-device schedules of ``repro/core/compile.py``::

    ctx = HEContext(CkksEngine(params))           # CUDA unless told "cpu"
    plan = plan_hemm(ctx.eng, m, l, n)
    ctx.keygen(rng, rot_steps=plan.rot_steps)
    prog = compile_hemm(ctx, plan)                # the cost model picks
    ctC = prog(ctA, ctB)
    prog.plan                                     # schedule, chunk, d_pad,
                                                  # byte and rotation counts

``schedule`` is one of ``SCHEDULES``: the fused ``"pallas"`` (the kernels),
a reference schedule ``"baseline"`` / ``"hoisted"`` / ``"mo"``
(``core/hlt.py``), or the multi-device ``"sharded"`` / ``"sharded_xla"``
(``core/hlt_dist.py``: the fused kernels, or plain torch, on each rank's
limb rows and ciphertext block of ``HEContext(mesh=)``; without a mesh
one rank holds everything).  On ``"pallas"``, ``compile_hlt`` compiles one DiagSet
(a single-ciphertext HLT: one ``fused_hlt`` launch) or a sequence of them
(a slot-indexed batch: one ``fused_hlt_indexed`` launch); a reference
schedule runs a batch as a loop of single executions.
``compile_hemm(..., batched=False)`` builds Algorithm 2 from 2 + 2·l
single HLTs instead of two batched ones (``baseline`` is never batched).
``compile_blockmm`` runs a whole (gm, gl, gn) grid of single-ciphertext
tiles as two batched HLTs (``BlockMMProgram``), and
``compile_hemm_chain`` a chain Y = X·W1·…·Wk of hemm hops with no
decrypt between them (``HEMMChainProgram``; the plan is
``core/hemm.py`` ``plan_hemm_chain``).

``HEContext(datapath=)`` picks the lowering of the fused schedule's hoist
and merged ModDown+Rescale: ``"pallas"`` (default) the fused kernels,
``"xla"`` the chains on the engine's own transforms.  The reference
schedules always hoist by the chain; their ModDown follows the engine's
datapath.  So on an ``"xla"`` engine, ``schedule="mo"`` launches no kernel.

``schedule=None`` lets the cost model pick (``core/costmodel.py``
``select_schedule``): ``"pallas"`` wherever the fused kernels take the
parameter set, else ``"mo"``, and with a mesh ``"sharded"`` where its
per-rank bytes are fewer; ``plan.schedule`` records the pick.
``rotation_chunk=None`` means chunk = d on every schedule: on
``"pallas"`` the chunk only sets the d-padding (d_pad is the next
multiple of the chunk) while the CUDA kernel loops over all d_pad
rotations itself, so the cost model's pick is no padding; ``mo`` runs
that many rotations a step.

``HEContext(verify=)`` runs the static verifier (``repro_torch.analysis``)
on every compiled program before the memo stores it: ``"warn"``
(default) warns, ``"error"`` raises ``VerificationError``, ``"off"``
skips it; every memo key carries the mode.  ``HEContext`` owns all
precompute: the operand arena (one slot per unique DiagSet at a compile
point) and the compile memo; ``invalidate()`` (run by ``keygen``) drops
both, and compiled objects from before refuse to run.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.analysis import verify as _verify
from repro_torch.analysis.diagnostics import VerificationError
from repro_torch.analysis.level_scale import trace_chain
from repro_torch.core import hlt as hlt_mod
from repro_torch.core import hlt_dist
from repro_torch.core import trace as _trace
from repro_torch.core.ckks import Ciphertext, CkksEngine, Keys
from repro_torch.core.costmodel import (SMEM_PER_BLOCK, hlt_hoist_bytes,
                                        hlt_stage_costs, loop_chunk,
                                        pick_rotation_chunk,
                                        select_chain_schedules,
                                        select_schedule,
                                        sharded_collective_bytes, step2_chunk)
from repro_torch.core.hlt import (SCHEDULES, DiagSet, Hoisted, hoist,
                                  hoist_batched)
from repro_torch.distributed import collectives, hlo_analysis
from repro_torch.distributed.sharding import logical_axis_size, make_rules
from repro_torch.kernels import ops
from repro_torch.launch.mesh import Mesh, check_mesh


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
        return sum(t.numel() * t.element_size()
                   for _, value in self._entries.values()
                   for t in _tensors(value))

    def clear(self) -> None:
        self._entries.clear()


def _tensors(value):
    """The tensors in an arena value (nested tuples, lists and dicts)."""
    if isinstance(value, torch.Tensor):
        yield value
    elif isinstance(value, dict):
        for v in value.values():
            yield from _tensors(v)
    elif isinstance(value, (tuple, list)):
        for v in value:
            yield from _tensors(v)


class HEContext:
    """Engine + keys + operand arena: owns all precompute.

    ``datapath`` picks the fused schedule's hoist and merged ModDown+Rescale
    lowering: ``"pallas"`` the fused kernels, ``"xla"`` the chains on the
    engine's transforms (the rotation datapath stays on its kernel).

    ``verify`` is the static verifier's mode (``repro_torch.analysis``)
    every compile runs through: ``"warn"`` (default) emits
    VerificationWarning findings, ``"error"`` raises VerificationError on
    error-severity findings, ``"off"`` skips verification.

    ``smem_headroom`` is the fraction of one block's shared memory
    (``costmodel.SMEM_PER_BLOCK``, 227 KB) the fused kernels may take:
    the cost model picks ``"pallas"`` only where they fit it, and the
    verifier's VM001 checks every fused launch of a compile against it.
    A launch allocates exactly its footprint, so the default is 1.0.  It
    is the twin of the reference's ``HEContext(vmem_headroom=)``, threaded
    into every HLTPlan as that one is, so that the reference's
    over-budget VM001 case has a counterpart on the port.

    ``counters`` are monotonic lifetime statistics (not reset by
    ``invalidate``): ``hlt_launches`` counts CompiledHLT calls (one
    rotation-datapath launch each) and ``program_launches`` counts
    program calls (HEMMProgram, BlockMMProgram, HEMMChainProgram).  A
    program call and ``keygen`` open a ``core/trace.py`` scope on them, so
    the spans ``he.call``, ``he.loop_chunk``, ``he.key_switch``,
    ``he.rescale`` and ``he.keygen`` add their ``.ns``, ``.calls`` and
    ``.h2d`` keys here.

    ``mesh`` (``launch/mesh.py`` :class:`~repro_torch.launch.mesh.Mesh`,
    this process one of its ranks) makes the ``"sharded"`` schedules
    multi-device: limbs over the ``model`` ranks (``n_model``), the
    ciphertext batch over ``pod`` × ``data`` (``n_ct``), per
    ``distributed/sharding.py``'s rules; the cost model sees the sizes and
    may pick ``"sharded"`` on its own.  Every rank compiles and calls the
    same programs on the same inputs.  The engine's device must be of the
    mesh's type; an object that is not a mesh is refused."""

    VERIFY_MODES = ("error", "warn", "off")
    DATAPATHS = ("pallas", "xla")

    def __init__(self, eng: CkksEngine, keys: Optional[Keys] = None,
                 datapath: str = "pallas", verify: str = "warn",
                 smem_headroom: float = 1.0, mesh: Optional[Mesh] = None):
        if check_mesh(mesh) is not None and \
                mesh.device.type != eng.device.type:
            raise ValueError(f"engine on {eng.device}, mesh on "
                             f"{mesh.device}")
        if datapath not in self.DATAPATHS:
            raise ValueError(f"datapath={datapath!r} not in {self.DATAPATHS}")
        if verify not in self.VERIFY_MODES:
            raise ValueError(f"verify={verify!r} not in {self.VERIFY_MODES}")
        if not smem_headroom > 0:
            raise ValueError(f"smem_headroom={smem_headroom!r}: a positive "
                             "fraction of a block's shared memory")
        self.datapath = datapath
        self.verify = verify
        self.smem_headroom = float(smem_headroom)
        self.eng = eng
        self.keys = keys
        self.arena = OperandArena()
        self._compiled: dict = {}
        self._pipelines: dict = {}
        self._generation = 0
        self.counters = {"hlt_launches": 0, "program_launches": 0}
        self.mesh = mesh
        self.rules = make_rules(mesh)
        self.n_model = logical_axis_size(self.rules, "limbs")
        self.n_ct = logical_axis_size(self.rules, "ct_batch")
        self.n_devices = self.n_model * self.n_ct
        # this rank's place: its limb block and its ciphertext block
        self.limb_axes = hlt_dist._physical_axes(self.rules, "limbs")
        self.ct_axes = hlt_dist._physical_axes(self.rules, "ct_batch")
        self.model_rank = 0 if mesh is None else mesh.index(self.limb_axes)
        self.ct_rank = 0 if mesh is None else mesh.index(self.ct_axes)

    @classmethod
    def create(cls, params, rng, rot_steps: Sequence[int] = (),
               device=None, mesh: Optional[Mesh] = None) -> "HEContext":
        if device is None and mesh is not None:
            device = mesh.device
        ctx = cls(CkksEngine(params, device=device), mesh=mesh)
        ctx.keygen(rng, rot_steps=rot_steps)
        return ctx

    @property
    def smem_bytes(self) -> float:
        """The fused kernels' per-block budget: ``smem_headroom`` × 227 KB."""
        return self.smem_headroom * SMEM_PER_BLOCK

    def keygen(self, rng, rot_steps: Sequence[int] = ()) -> Keys:
        """Generate fresh keys and invalidate every cached operand (span
        ``he.keygen``)."""
        with _trace.scope(self.counters), _trace.span("he.keygen"):
            self.keys = self.eng.keygen(rng, rot_steps=rot_steps)
        self.invalidate()
        return self.keys

    def invalidate(self) -> None:
        """Drop every arena operand and compiled program; compiled objects
        from before refuse to run."""
        self.arena.clear()
        self._compiled.clear()
        self._pipelines.clear()
        self._generation += 1

    def _check_generation(self, gen: int) -> None:
        if gen != self._generation:
            raise RuntimeError(
                "stale compiled object: its HEContext was invalidated "
                "(re-keygen?) after compilation — recompile")

    def _program_call(self, gen: int):
        """A program call compiled at generation ``gen``: checked, counted
        in ``program_launches``, and run in a trace scope on ``counters``
        (the call's index is its count)."""
        self._check_generation(gen)
        self.counters["program_launches"] += 1
        return _trace.scope(self.counters, self.counters["program_launches"])

    def _sharded_pipeline(self, tabs, rank_tabs, d_pad: int, nbeta: int,
                          datapath: str = "pallas",
                          chunk: Optional[int] = None,
                          hoist_layout: str = "dedup",
                          stages: str = "pallas"):
        """The rank's body of the sharded program at one compile point
        (``hlt_dist.make_sharded_hlt_fn``), built once."""
        key = ("sharded", datapath, stages, hoist_layout, tabs.level,
               tabs.n_model, d_pad, nbeta, chunk)
        fn = self._pipelines.get(key)
        if fn is None:
            fn = hlt_dist.make_sharded_hlt_fn(
                tabs, self.rules, rank_tabs, d_pad=d_pad, nbeta=nbeta,
                datapath=datapath, chunk=chunk, hoist_layout=hoist_layout,
                stages=stages)
            self._pipelines[key] = fn
        return fn


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


def _check_schedule(schedule: str, rotation_chunk) -> None:
    if schedule not in SCHEDULES:
        raise ValueError(f"schedule={schedule!r} is not one of {SCHEDULES}")
    if rotation_chunk is not None and (not isinstance(rotation_chunk, int)
                                       or rotation_chunk < 1):
        raise ValueError(f"rotation_chunk={rotation_chunk!r}: a positive "
                         "int, or None for the cost model's pick")


def _canonical_slots(slots, n: int, what: str) -> tuple:
    """An aliasing hint renumbered in first-appearance order."""
    if len(slots) != n:
        raise ValueError(f"{what} has {len(slots)} entries for {n} elements")
    remap: dict = {}
    return tuple(remap.setdefault(s, len(remap)) for s in slots)


# ---------------------------------------------------------------------------
# compile_hlt -> CompiledHLT
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class HLTPlan:
    """One compiled HLT, as the cost model and the compile sized it.

    ``batch`` is ``None`` for a single-ciphertext compile, else the batch
    size.  ``datapath`` is the lowering of the hoist and merged ModDown
    (the context's on ``"pallas"``, ``"xla"`` for the reference
    schedules).  ``d`` holds each batch element's real diagonal count and
    ``d_pad`` the common padded rotation count (a ``chunk`` multiple);
    ``rotations`` counts the real rotations an execution runs.

    ``diag_slots`` maps batch index -> unique diagonal-set slot;
    ``ct_slots`` is the compile-time input-aliasing hint (``None`` =
    unknown until call time) and ``n_ct_slots`` its unique count: the
    hoisting products an execution stores.  ``operand_bytes`` /
    ``operand_bytes_naive`` are the key and diagonal bytes after / before
    the slot dedup, ``hoist_bytes`` / ``hoist_bytes_naive`` the same for
    hoisting products (u32 words, ``costmodel.hlt_hoist_bytes``; 0 on
    ``baseline``, which does not hoist).  ``stage_costs`` holds the
    per-stage counts of ``costmodel.hlt_stage_costs``.
    ``collective_bytes`` is the cross-device traffic the cost model
    predicts for one execution (``costmodel.sharded_collective_bytes``, 0
    off the sharded schedules) and ``n_model`` / ``n_ct`` the mesh
    factorization the compile saw (1 and 1 off them).  Under ``"sharded"``
    ``operand_bytes`` counts the operands of every rank together, as the
    reference's global arrays.  ``smem_headroom`` is the fraction
    of a block's shared memory the compile allowed the fused kernels
    (``HEContext.smem_headroom``; the verifier's VM001 reads it)."""

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
    rotations: int
    operand_bytes: int
    operand_bytes_naive: int
    stage_costs: dict
    collective_bytes: int = 0
    n_model: int = 1
    n_ct: int = 1
    ct_slots: Optional[tuple] = None
    n_ct_slots: Optional[int] = None
    hoist_bytes: int = 0
    hoist_bytes_naive: int = 0
    smem_headroom: float = 1.0

    @property
    def dedup_factor(self) -> float:
        """Key/diagonal operand-memory reduction of the slot dedup (≥ 1)."""
        return self.operand_bytes_naive / max(1, self.operand_bytes)


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


def _sharded_operands(ctx: HEContext, uniq, level: int, nbeta: int,
                      d_pad: int, tabs) -> tuple:
    """The rank's row block of the stacked operands of the unique
    DiagSets (``hlt_mod._build_pallas_operands(limbs=)``), one stacked
    tensor per operand; rows past the basis are zero."""
    eng = ctx.eng
    lo = ctx.model_rank * tabs.rows_loc
    operands = tuple(
        torch.zeros((len(uniq),) + s, dtype=torch.int32, device=eng.device)
        for s in hlt_mod.operand_shapes(eng, level, nbeta, d_pad,
                                        rows=tabs.rows_loc))
    for s, ds in enumerate(uniq):
        hlt_mod._build_pallas_operands(
            eng, ds, ctx.keys, level, nbeta, d_pad,
            out=tuple(t[s] for t in operands),
            limbs=(lo, lo + tabs.rows_loc))
    return operands


def compile_hlt(ctx: HEContext, diags: Union[DiagSet, Sequence[DiagSet]], *,
                level: Optional[int] = None, schedule: Optional[str] = None,
                rotation_chunk: Optional[int] = None,
                ct_slots: Optional[Sequence[int]] = None) -> "CompiledHLT":
    """Compile an HLT.  ``diags``: one DiagSet (a single-ciphertext compile)
    or a sequence of DiagSets, one per batch element (duplicates share one
    operand slot).  ``level`` defaults to the top; ``schedule=None`` and
    ``rotation_chunk=None`` defer to the cost model.  ``ct_slots`` is an
    optional aliasing hint (equal ids: the same ciphertext will be passed)
    that sizes the plan's hoist accounting (and, sharded, pre-builds the
    slot table of that pattern); execution re-derives the aliasing from
    object identity.  Memoized on the context."""
    if ctx.keys is None:
        raise RuntimeError("HEContext has no keys; call ctx.keygen()")
    single = isinstance(diags, DiagSet)
    diag_list = [diags] if single else list(diags)
    batch = None if single else len(diag_list)
    if not diag_list:
        raise ValueError("batched compile needs at least one DiagSet")
    eng = ctx.eng
    level = eng.params.L if level is None else level
    if ct_slots is not None:
        ct_slots = _canonical_slots(ct_slots, len(diag_list), "ct_slots")
    nbeta = len(eng.tools.digit_bases(level))
    d_list = tuple(ds.d for ds in diag_list)
    d_max = max(d_list)
    if schedule is None:
        schedule = select_schedule(
            eng.params, nbeta=nbeta, smem_bytes=ctx.smem_bytes,
            n_model=ctx.n_model, n_ct=ctx.n_ct, d=d_max,
            ctb=batch if batch is not None else 1,
            n_uniq=None if ct_slots is None else len(set(ct_slots)))
    _check_schedule(schedule, rotation_chunk)
    sharded = schedule.startswith("sharded")
    # the context's knob covers the fused schedules only; the reference
    # schedules and the sharded_xla baseline always hoist by the chain
    datapath = ctx.datapath if schedule in ("pallas", "sharded") else "xla"
    memo_key = ("hlt", schedule, level, batch, rotation_chunk, ct_slots,
                ctx.verify, datapath,
                tuple(_StrongKey(ds) for ds in diag_list))
    hit = ctx._compiled.get(memo_key)
    if hit is not None:
        return hit

    chunk = (pick_rotation_chunk(d_max) if rotation_chunk is None
             else min(rotation_chunk, d_max))
    d_pad = -(-d_max // chunk) * chunk
    uniq, slots = _dedup_by_identity(diag_list)
    ctb = 1 if batch is None else batch
    # the ct table's aliasing: the hint's, all distinct without one
    pattern = ct_slots or tuple(range(ctb))
    sharded_tabs = slot_tables = None
    if sharded:
        # the tables of this rank and the stacked operands of its rows;
        # the slot tables padded to the ct-axis multiple (arena-owned)
        _, sharded_tabs = ctx.arena.slot(
            "sharded_tables", eng, (level, ctx.n_model),
            lambda: _build_sharded_tables(ctx, level))
        operands = _sharded_operands(ctx, uniq, level, nbeta, d_pad,
                                     sharded_tabs[0])
        b_pad = -(-ctb // ctx.n_ct) * ctx.n_ct
        _, slot_tables = ctx.arena.slot(
            "sharded_slot_tables", eng, (level, tuple(slots), pattern, b_pad),
            lambda: hlt_dist.build_slot_tables(slots, pattern, b_pad,
                                               device=eng.device))
    else:
        operands = (_pallas_operands(ctx, uniq, batch, level, nbeta, d_pad)
                    if schedule == "pallas" else ())
        if schedule == "pallas" and batch is not None:
            slot_tables = hlt_dist.build_slot_tables(slots, pattern, batch,
                                                     device=eng.device)
    n_model, n_ct = (ctx.n_model, ctx.n_ct) if sharded else (1, 1)
    # every rank holds its rows of the operands: the plan counts them all
    op_bytes = n_model * sum(t.numel() * t.element_size() for t in operands)
    # one hoisting product per unique input (the hint; all distinct without
    # one), none on baseline, one an element on sharded_xla
    m_ext = len(eng.tools.digit_bases(level)[0][2])
    h_unit = int(hlt_hoist_bytes(eng.params, nbeta=nbeta, n_limbs_ext=m_ext))
    n_ct_slots = None if ct_slots is None else len(set(ct_slots))
    n_hoist = (ctb if n_ct_slots is None or schedule == "sharded_xla"
               else n_ct_slots)
    hoists = schedule != "baseline"
    plan = HLTPlan(
        schedule=schedule, datapath=datapath, level=level, batch=batch,
        nbeta=nbeta, chunk=chunk, d=d_list, d_pad=d_pad,
        diag_slots=tuple(slots), n_diag_slots=len(uniq),
        rotations=sum(d_list), operand_bytes=op_bytes,
        operand_bytes_naive=(op_bytes if batch is None else
                             op_bytes // len(uniq) * len(diag_list)),
        stage_costs=hlt_stage_costs(
            eng.params, d=d_max, d_pad=d_pad, nbeta=nbeta, chunk=chunk,
            n_limbs_ext=m_ext, n_model=n_model, ctb=ctb, n_hoist=n_hoist),
        # the all-reduce moves the padded batch, not the logical one
        collective_bytes=(sharded_collective_bytes(
            eng.params, n_model=n_model, ctb=-(-ctb // n_ct) * n_ct)
            if sharded else 0),
        n_model=n_model, n_ct=n_ct,
        ct_slots=ct_slots, n_ct_slots=n_ct_slots,
        hoist_bytes=h_unit * n_hoist if hoists else 0,
        hoist_bytes_naive=h_unit * ctb if hoists else 0,
        smem_headroom=ctx.smem_headroom)
    run = CompiledHLT(ctx, plan, tuple(diag_list), operands,
                      sharded_tabs=sharded_tabs, slot_tables=slot_tables)
    # the verifier runs before the memo store, so a rejected compile is
    # never cached; the memo key carries ctx.verify
    _verify.enforce(ctx, run)
    ctx._compiled[memo_key] = run
    return run


def _build_sharded_tables(ctx: HEContext, level: int) -> tuple:
    """(ShardTables, this rank's tables on the engine's device)."""
    tabs = hlt_dist.build_shard_tables(ctx.eng.params, level, ctx.n_model)
    return tabs, hlt_dist.rank_tables(tabs, ctx.model_rank, ctx.eng.device)


class CompiledHLT:
    """A compiled HLT: call a single compile with one ciphertext or
    hoisting product, a batched one with a sequence of them (repeated
    objects share one hoisting slot).  ``baseline`` and the sharded
    schedules take ciphertexts only (the sharded program hoists inside,
    on each rank's rows)."""

    def __init__(self, ctx: HEContext, plan: HLTPlan, diag_list, operands,
                 sharded_tabs=None, slot_tables=None):
        self.ctx = ctx
        self.plan = plan
        self._diags = diag_list
        self._operands = operands       # "pallas": one DiagSet's, or stacked
        self._sharded = sharded_tabs    # (ShardTables, rank tables) | None
        # {"diag", "ct"}: the element -> slot tables of a batched "pallas"
        # or a sharded compile (padded to the ct-axis multiple), the ct
        # table of the hint's aliasing (all distinct without one): a call
        # with that aliasing copies nothing to the device
        self._slot_tables = slot_tables
        self._diag_slots = (slot_tables["diag"] if plan.schedule == "pallas"
                            and slot_tables else None)
        self._ct_pattern = plan.ct_slots or tuple(range(plan.batch or 1))
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
        return eng._mod_down_eval(acc, level, drop_last=True, datapath="xla")

    def __call__(self, items):
        self.ctx._check_generation(self._gen)
        self.ctx.counters["hlt_launches"] += 1
        return self._execute(items)

    def _execute(self, items):
        """One execution, uncounted (the verifier's census runs this)."""
        single = self.plan.batch is None
        if self.plan.schedule.startswith("sharded"):
            outs = self._run_sharded([items] if single else
                                     self._batch_items(items))
            return outs[0] if single else outs
        if single:
            return self._run_single(items, self._diags[0])
        items = self._batch_items(items)
        if self.plan.schedule == "pallas":
            return self._run_batched_pallas(items)
        # reference schedules: a loop of single executions (oracle path)
        return [self._run_single(it, ds)
                for it, ds in zip(items, self._diags, strict=True)]

    def _batch_items(self, items) -> list:
        items = list(items)
        if len(items) != self.plan.batch:
            raise ValueError(f"{len(items)} inputs for a batch of "
                             f"{self.plan.batch}")
        return items

    def _slot_tensor(self, ct_slots, b_pad: int) -> torch.Tensor:
        """The fused kernel's hoist-slot table for a call's aliasing,
        padded to ``b_pad`` elements with slot 0: the compile-time table
        when the aliasing is the hint's, else a fresh one."""
        if tuple(ct_slots) == self._ct_pattern:
            return self._slot_tables["ct"]
        _trace.h2d()
        return torch.tensor(list(ct_slots) + [0] * (b_pad - len(ct_slots)),
                            dtype=torch.int32, device=self.ctx.eng.device)

    def _run_batched_pallas(self, items) -> list:
        eng, plan = self.ctx.eng, self.plan
        hoisted, ct_slots = self._hoist_items(items)
        digits = torch.stack([h.digits for h in hoisted])
        c0e = torch.stack([h.c0_ext for h in hoisted])
        c1e = torch.stack([h.c1_ext for h in hoisted])
        view = eng.basis(eng.tools.digit_bases(plan.level)[0][2])
        slots = self._slot_tensor(ct_slots, plan.batch)
        q_ell = eng.ctx.moduli_host[plan.level]
        B = plan.batch
        size = step2_chunk(eng.params, plan.level, B)
        out = []
        # consecutive chunks bound the transients (fused output, drop
        # rows, result); each reads the whole stacked hoist
        for s in range(0, B, size):
            e = min(B, s + size)
            # (2, b, M, N) -> (2·b, M, N); freed once ModDown has read it
            down = self._moddown(ops.fused_hlt_indexed(
                digits, c0e, c1e, *self._operands, slots[s:e],
                self._diag_slots[s:e], view.moduli_u32,
                view.qneg_inv).flatten(0, 1))
            out += [Ciphertext(down[i], down[e - s + i], plan.level - 1,
                               hoisted[ct_slots[s + i]].scale
                               * self._diags[s + i].scale / q_ell)
                    for i in range(e - s)]
        return out

    # -- the sharded schedules ---------------------------------------------

    @property
    def _datapath(self) -> str:
        """The sharded body's datapath: the fused kernels, or plain torch
        on ``sharded_xla``."""
        return "xla" if self.plan.schedule == "sharded_xla" else "pallas"

    def _rank_rows(self, c) -> torch.Tensor:
        """(H, ℓ+1, N) main rows -> (H, rows_loc, N): this rank's block of
        the rows zero-extended to the padded extended basis."""
        tabs = self._sharded[0]
        lo = self.ctx.model_rank * tabs.rows_loc
        out = torch.zeros((c.shape[0], tabs.rows_loc, c.shape[-1]),
                          dtype=torch.int32, device=c.device)
        n = max(0, min(tabs.rows_loc, c.shape[1] - lo))
        out[:, :n] = c[:, lo:lo + n]
        return out

    def _stack_local(self, items, lo: int, hi: int) -> tuple:
        """c0, c1 (hi-lo, ℓ+1, N) of the batch elements lo..hi-1, zero
        ciphertexts past the batch."""
        its = items[lo:min(hi, len(items))]
        c0 = torch.stack([it.c0 for it in its])
        c1 = torch.stack([it.c1 for it in its])
        if hi - lo > len(its):
            z = c0.new_zeros((hi - lo - len(its),) + tuple(c0.shape[1:]))
            c0, c1 = torch.cat([c0, z]), torch.cat([c1, z])
        return c0, c1

    def _sharded_args(self, items):
        """The rank's argument dict of the sharded body and its hoist
        layout.  Fused: dedupe the batch by identity and hoist whichever
        is fewer a rank, the H unique ciphertexts ("dedup", global hoist
        slots; the compile-time table when the aliasing matches the hint)
        or the rank's B_loc elements ("element", local slots).  Padding
        elements alias slot 0 (dedup) or are zero ciphertexts (element);
        their outputs are dropped.  ``sharded_xla``: the rank's elements,
        zero ciphertexts past the batch."""
        plan, ctx = self.plan, self.ctx
        for it in items:
            if not isinstance(it, Ciphertext):
                raise TypeError("the sharded schedules hoist inside the "
                                "program: pass Ciphertexts, not hoisting "
                                "products")
            self._check_level(it)
        diag_tab = self._slot_tables["diag"]
        b_loc = diag_tab.shape[0] // ctx.n_ct    # one ct rank's share
        lo, hi = ctx.ct_rank * b_loc, (ctx.ct_rank + 1) * b_loc
        u, rk0, rk1, perms, is_id = self._operands
        common = dict(u=u, rk0=rk0, rk1=rk1, perms=perms, is_id=is_id,
                      slots=diag_tab[lo:hi])
        if self._datapath == "xla":
            c0, c1 = self._stack_local(items, lo, hi)
            return dict(c0f=self._rank_rows(c0), c1f=self._rank_rows(c1),
                        c1rep=c1, **common), "dedup"
        uniq, ct_slots = _dedup_by_identity(items)
        if len(uniq) > b_loc:
            # a mostly distinct batch: replicating the uniques would make
            # each ct rank hoist more than its share
            c0, c1 = self._stack_local(items, lo, hi)
            ct_tab = torch.arange(b_loc, dtype=torch.int32, device=c0.device)
            return dict(c0u=self._rank_rows(c0), c1u=self._rank_rows(c1),
                        c1rep=c1, ct_slots=ct_tab, **common), "element"
        ct_tab = self._slot_tensor(ct_slots, diag_tab.shape[0])
        c0u = torch.stack([it.c0 for it in uniq])
        c1u = torch.stack([it.c1 for it in uniq])
        return dict(c0u=self._rank_rows(c0u), c1u=self._rank_rows(c1u),
                    c1rep=c1u, ct_slots=ct_tab[lo:hi], **common), "dedup"

    def _sharded_body(self, items):
        """The rank's body on a batch: its (B_loc, rows_loc, N) blocks of
        both output polynomials (the collective census runs this)."""
        tabs, rank_tabs = self._sharded
        args, layout = self._sharded_args(items)
        fn = self.ctx._sharded_pipeline(tabs, rank_tabs, self.plan.d_pad,
                                        self.plan.nbeta, self._datapath,
                                        self.plan.chunk, layout,
                                        self.plan.datapath)
        return fn(args)

    def _gather(self, out0, out1) -> torch.Tensor:
        """The ranks' output blocks -> (2, B_pad, M_pad, N) on every rank:
        an all-gather over the limb ranks, then one over the ct ranks."""
        ctx = self.ctx
        out = torch.stack([out0, out1])                 # (2, B_loc, rows, N)
        if ctx.n_model > 1:
            out = torch.cat(collectives.all_gather(
                out, ctx.mesh.group(ctx.limb_axes), ctx.n_model), dim=2)
        if ctx.n_ct > 1:
            out = torch.cat(collectives.all_gather(
                out, ctx.mesh.group(ctx.ct_axes), ctx.n_ct), dim=1)
        return out

    def _run_sharded(self, items) -> list:
        plan = self.plan
        full = self._gather(*self._sharded_body(items))
        lvl = plan.level
        q_ell = self.ctx.eng.ctx.moduli_host[lvl]
        return [Ciphertext(full[0, b, :lvl], full[1, b, :lvl], lvl - 1,
                           it.scale * ds.scale / q_ell)
                for b, (it, ds) in enumerate(zip(items, self._diags,
                                                 strict=True))]

    def sharded_collectives(self, items) -> hlo_analysis.CollectiveStats:
        """The collectives of one run of this rank's sharded body on
        ``items`` (``_run_sharded``'s pipeline, without the output
        gather that follows it): the counterpart of the reference's
        ``sharded_hlo``, whose HLO text its ``collective_stats`` reads.
        With one ct rank the total is ``plan.collective_bytes``."""
        if not self.plan.schedule.startswith("sharded"):
            raise ValueError(f"schedule {self.plan.schedule!r} is not "
                             f"sharded")
        self.ctx._check_generation(self._gen)
        items = ([items] if self.plan.batch is None
                 else self._batch_items(items))
        with collectives.scope() as events:
            self._sharded_body(items)
        return hlo_analysis.collective_stats(events)

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


def _stack(cts) -> Ciphertext:
    """Ciphertexts of one level -> one batch (the first one's scale)."""
    return Ciphertext(torch.stack([ct.c0 for ct in cts]),
                      torch.stack([ct.c1 for ct in cts]), cts[0].level,
                      cts[0].scale)


def product_sums(ctx: HEContext, groups, step2_batch: int) -> list:
    """Σ_k rescale(mult(a_k, b_k)) for each group of (a, b) ciphertext
    pairs: the residues of the per-product loop, in chunks.

    The products of all groups, group after group, run as batched
    ``mult`` → ``rescale`` in consecutive chunks of
    ``costmodel.loop_chunk`` (sized from the Step 2 of ``step2_batch``
    HLTs whose transients the chunk stays within); each chunk's products
    are summed per group (``CkksEngine.sum``) into that group's
    accumulator.  A product's scale is a.scale·b.scale / q_ℓ, as the
    engine's, and a sum's the largest of its terms', as ``add``'s.  Span
    ``he.loop_chunk`` a chunk."""
    eng = ctx.eng
    pairs = [(g, a, b) for g, grp in enumerate(groups) for a, b in grp]
    size = loop_chunk(eng.params, pairs[0][1].level, len(pairs), step2_batch)
    acc: list = [None] * len(groups)
    for lo in range(0, len(pairs), size):
        with _trace.span("he.loop_chunk"):
            for g, part in _chunk_sums(ctx, pairs[lo:lo + size]):
                acc[g] = part if acc[g] is None else eng.add(acc[g], part)
    return acc


def _chunk_sums(ctx: HEContext, chunk) -> list:
    """One chunk of (group, a, b) products as one batch: [(group, the sum
    of the chunk's products of that group)], the batch freed on return."""
    eng = ctx.eng
    q_ell = eng.ctx.moduli_host[chunk[0][1].level]
    prod = eng.rescale(eng.mult(_stack([a for _, a, _ in chunk]),
                                _stack([b for _, _, b in chunk]), ctx.keys))
    out, i = [], 0
    while i < len(chunk):                   # the chunk's run of each group
        g, j = chunk[i][0], i
        while j < len(chunk) and chunk[j][0] == g:
            j += 1
        out.append((g, eng.sum(Ciphertext(
            prod.c0[i:j], prod.c1[i:j], prod.level,
            max(a.scale * b.scale / q_ell for _, a, b in chunk[i:j])))))
        i = j
    return out


def _stage_sum(name: str) -> property:
    return property(lambda plan: getattr(plan.step1, name)
                    + getattr(plan.step2, name),
                    doc=f"``HLTPlan.{name}`` summed over Step 1 and Step 2.")


class _StageSums:
    """A program plan's per-execution totals over its two HLT stages
    ``step1`` and ``step2``: real rotations, key/diagonal operand bytes
    and hoisting-product bytes after and before the slot dedup, and
    predicted cross-device bytes (0 off the sharded schedules)."""

    rotations = _stage_sum("rotations")
    operand_bytes = _stage_sum("operand_bytes")
    operand_bytes_naive = _stage_sum("operand_bytes_naive")
    hoist_bytes = _stage_sum("hoist_bytes")
    hoist_bytes_naive = _stage_sum("hoist_bytes_naive")
    collective_bytes = _stage_sum("collective_bytes")


@dataclasses.dataclass(frozen=True)
class HEMMPlan(_StageSums):
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
    depth: int = 3


#: mark -> the profiler range it opens until the next mark
#: (``trace.ranges``); the last mark opens none
STAGE_RANGES = {"start": "he.step1", "step1": "he.step2_hoist",
                "step2_hoist": "he.step2", "step2": "he.loop"}


class HEMMProgram:
    """A compiled Algorithm-2 HE MM: ``prog(ctA, ctB) -> ctC``.

    Batched: Step 1 runs {σ(A), τ(B)} as one batched HLT and Step 2 all 2·l
    HLTs as one batched HLT off the 2 unique hoisting products (on
    ``"pallas"`` one slot-indexed launch each; a reference schedule loops
    inside the batch; the sharded schedules hoist inside their program,
    so Step 2 takes Step 1's ciphertexts).  Not batched: σ(A) and τ(B)
    are two single HLTs, each output is hoisted once (``baseline`` and
    the sharded schedules: not here), and the 2·l single HLTs of Step 2
    reuse those two products.  Then l × (mult → rescale) and add, on
    every rank of a mesh."""

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
        """The stage hook, outside the stage's profiler range."""
        _trace.stage(None)
        if self.stage_hook is not None:
            self.stage_hook(name)
        _trace.stage(STAGE_RANGES.get(name))

    def __call__(self, ctA: Ciphertext, ctB: Ciphertext) -> Ciphertext:
        """One call (``HEContext._program_call``), span ``he.call``."""
        with self.ctx._program_call(self._gen), _trace.span("he.call"):
            return self._run(ctA, ctB)

    def _run(self, ctA: Ciphertext, ctB: Ciphertext) -> Ciphertext:
        eng, p = self.ctx.eng, self.mm_plan
        if not ctA.level == ctB.level == self.plan.level:
            raise ValueError(f"input levels {ctA.level}, {ctB.level}; "
                             f"compiled for {self.plan.level}")
        self._mark("start")
        sharded = self.plan.schedule.startswith("sharded")
        if self.plan.batched:
            ctA0, ctB0 = self._step1([ctA, ctB])
            self._mark("step1")
            if sharded:             # the program hoists on each rank's rows
                inA, inB = ctA0, ctB0
            else:
                inA, inB = hoist_batched(eng, [ctA0, ctB0],
                                         datapath=self.plan.step2.datapath)
            self._mark("step2_hoist")
            outs = self._step2([inA] * p.l + [inB] * p.l)
        else:
            s1a, s1b = self._step1
            ctA0, ctB0 = s1a(ctA), s1b(ctB)
            self._mark("step1")
            if self.plan.schedule == "baseline" or sharded:
                inA, inB = ctA0, ctB0       # no hoisting product here
            else:       # hoist once, reuse across all l Step-2 HLTs per input
                dp = self.plan.step2.datapath
                inA, inB = hoist(eng, ctA0, dp), hoist(eng, ctB0, dp)
            self._mark("step2_hoist")
            outs = ([run(inA) for run in self._step2[:p.l]]
                    + [run(inB) for run in self._step2[p.l:]])
        self._mark("step2")
        acc, = product_sums(self.ctx, [list(zip(outs[:p.l], outs[p.l:]))],
                            2 * p.l)
        self._mark("mult_rescale")
        return acc


def compile_hemm(ctx: HEContext, plan, *, schedule: Optional[str] = None,
                 rotation_chunk: Optional[int] = None,
                 level: Optional[int] = None,
                 batched: Optional[bool] = None) -> HEMMProgram:
    """Compile Algorithm 2 for a HeMMPlan into a reusable HEMMProgram
    (memoized on the context: same plan -> same program).
    ``schedule=None`` / ``rotation_chunk=None`` defer to the cost model;
    ``batched=None`` batches on the fused and the sharded schedules.
    ``baseline`` is never batched: it has no hoisting product to share."""
    if ctx.keys is None:
        raise RuntimeError("HEContext has no keys; call ctx.keygen()")
    eng = ctx.eng
    level = eng.params.L if level is None else level
    if schedule is None:
        # Step 2 (2·l HLTs off 2 unique inputs) dominates
        schedule = select_schedule(
            eng.params, nbeta=len(eng.tools.digit_bases(level)),
            smem_bytes=ctx.smem_bytes, n_model=ctx.n_model, n_ct=ctx.n_ct,
            d=plan.ds_sigma.d, ctb=2 * plan.l, n_uniq=2)
    _check_schedule(schedule, rotation_chunk)
    if batched is None:
        batched = schedule in ("pallas", "sharded", "sharded_xla")
    batched = bool(batched) and schedule != "baseline"
    memo_key = ("hemm", _StrongKey(plan), schedule, level, rotation_chunk,
                batched, ctx.verify)
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
    _verify.enforce(ctx, prog)
    ctx._compiled[memo_key] = prog
    return prog


# ---------------------------------------------------------------------------
# compile_blockmm -> BlockMMProgram (the whole tile grid as two HLT launches)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BlockMMPlan(_StageSums):
    """Compile summary for one block HE MM over a (gm, gl, gn) grid of
    single-ciphertext tiles, C[i][j] = Σ_k A[i][k]·B[k][j]; ``m``/``l``/
    ``n`` are the tile's dimensions.  The grid runs as two slot-indexed HLT
    launches: Step 1 transforms every A and B tile, Step 2 runs all
    l·(gm·gl + gl·gn) ε/ω HLTs.  ``hlt_launches_naive`` is what a loop of
    per-tile-pair HEMMPrograms would launch."""

    m: int
    l: int
    n: int
    grid: tuple                         # (gm, gl, gn)
    schedule: str
    level: int                          # input level; output is level - 3
    step1: HLTPlan
    step2: HLTPlan
    depth: int = 3

    @property
    def hlt_launches(self) -> int:
        """HLT launches per execution: always 2."""
        return 2

    @property
    def hlt_launches_naive(self) -> int:
        """Launches of a loop of batched per-tile-pair HEMMPrograms."""
        gm, gl, gn = self.grid
        return 2 * gm * gl * gn



class BlockMMProgram:
    """A compiled block HE MM: ``prog(A_tiles, B_tiles) -> C_tiles``.

    ``A_tiles`` is a gm×gl and ``B_tiles`` a gl×gn list of lists of tile
    ciphertexts (``SecureMatmulEngine.encrypt_tiles``); the result is the
    gm×gn grid of accumulated products.  Repeated tile objects are
    transformed once in Step 1 and hoisted once for Step 2: execution
    re-derives the aliasing from object identity.  Then l·gm·gl·gn
    mult → rescale products, summed per output tile."""

    def __init__(self, ctx: HEContext, mm_plan, plan: BlockMMPlan,
                 step1: CompiledHLT, step2: CompiledHLT):
        self.ctx = ctx
        self.mm_plan = mm_plan          # the per-tile HeMMPlan
        self.plan = plan
        self._step1 = step1
        self._step2 = step2
        self._gen = ctx._generation
        #: optional callable(stage_name), as ``HEMMProgram.stage_hook``
        self.stage_hook: Optional[Callable[[str], None]] = None

    def _mark(self, name: str) -> None:
        if self.stage_hook is not None:
            self.stage_hook(name)

    def __call__(self, A_tiles, B_tiles) -> list:
        """One call (``HEContext._program_call``)."""
        with self.ctx._program_call(self._gen):
            return self._run(A_tiles, B_tiles)

    def _run(self, A_tiles, B_tiles) -> list:
        eng, p = self.ctx.eng, self.mm_plan
        gm, gl, gn = self.plan.grid
        if len(A_tiles) != gm or any(len(r) != gl for r in A_tiles):
            raise ValueError(f"A tiles are not a {gm}x{gl} grid")
        if len(B_tiles) != gl or any(len(r) != gn for r in B_tiles):
            raise ValueError(f"B tiles are not a {gl}x{gn} grid")
        ik = [(i, k) for i in range(gm) for k in range(gl)]
        kj = [(k, j) for k in range(gl) for j in range(gn)]
        nA, nB = len(ik), len(kj)
        items1 = ([A_tiles[i][k] for i, k in ik]
                  + [B_tiles[k][j] for k, j in kj])
        self._mark("start")
        # Step 1: every tile in one launch; the outputs of repeated input
        # objects are aliased to one output object (they are bit-identical)
        # so that Step 2 hoists each unique tile once
        _, slots1 = _dedup_by_identity(items1)
        outs = self._step1(items1)
        first: dict = {}
        outs = [outs[first.setdefault(s, b)] for b, s in enumerate(slots1)]
        self._mark("step1")
        if self.plan.schedule == "baseline" or \
                self.plan.schedule.startswith("sharded"):
            hst = outs      # no hoisting product, or hoisted in the program
        else:
            uniq, uslots = _dedup_by_identity(outs)
            hu = hoist_batched(eng, uniq, datapath=self.plan.step2.datapath)
            hst = [hu[s] for s in uslots]
        self._mark("step2_hoist")
        # Step 2: all l·(nA + nB) ε/ω HLTs in one launch, k-major
        items2 = ([hst[t] for _ in range(p.l) for t in range(nA)]
                  + [hst[nA + t] for _ in range(p.l) for t in range(nB)])
        res = self._step2(items2)
        self._mark("step2")
        # C[i][j] = Σ_kk Σ_k A'_kk[i][k]·B'_kk[k][j], one group a tile
        A = lambda kk, i, k: res[kk * nA + i * gl + k]             # noqa: E731
        B = lambda kk, k, j: res[p.l * nA + kk * nB + k * gn + j]  # noqa: E731
        sums = product_sums(self.ctx, [
            [(A(kk, i, k), B(kk, k, j)) for kk in range(p.l)
             for k in range(gl)] for i in range(gm) for j in range(gn)],
            len(items2))
        self._mark("mult_rescale")
        return [sums[i * gn:(i + 1) * gn] for i in range(gm)]


def compile_blockmm(ctx: HEContext, plan, grid, *,
                    level: Optional[int] = None,
                    schedule: Optional[str] = None,
                    rotation_chunk: Optional[int] = None,
                    a_slots: Optional[Sequence[int]] = None,
                    b_slots: Optional[Sequence[int]] = None
                    ) -> BlockMMProgram:
    """Compile a (gm, gl, gn) block MM over single-ciphertext tiles into a
    reusable BlockMMProgram: the whole grid as two slot-indexed launches.

    ``plan`` is the tile's HeMMPlan (``plan_hemm`` at the tile shape).
    ``a_slots`` / ``b_slots`` are optional aliasing hints over the
    row-major gm·gl A tiles / gl·gn B tiles (equal ids: the same tile
    object will be passed); like ``compile_hlt``'s ``ct_slots`` they size
    the plan's hoist accounting, and execution re-derives the aliasing
    from identity.  ``schedule=None`` defers to the cost model with the
    full Step-2 batch.  Memoized on the context."""
    if ctx.keys is None:
        raise RuntimeError("HEContext has no keys; call ctx.keygen()")
    eng = ctx.eng
    gm, gl, gn = grid = tuple(int(g) for g in grid)
    if min(grid) < 1:
        raise ValueError(f"grid {grid}: every dimension must be >= 1")
    level = eng.params.L if level is None else level
    nA, nB = gm * gl, gl * gn
    a_slots = (tuple(range(nA)) if a_slots is None
               else _canonical_slots(a_slots, nA, "a_slots"))
    b_slots = (tuple(range(nB)) if b_slots is None
               else _canonical_slots(b_slots, nB, "b_slots"))
    off = max(a_slots) + 1
    slots1 = a_slots + tuple(off + s for s in b_slots)
    if schedule is None:
        schedule = select_schedule(
            eng.params, nbeta=len(eng.tools.digit_bases(level)),
            smem_bytes=ctx.smem_bytes, n_model=ctx.n_model, n_ct=ctx.n_ct,
            d=plan.ds_sigma.d, ctb=plan.l * (nA + nB),
            n_uniq=len(set(slots1)))
    _check_schedule(schedule, rotation_chunk)
    memo_key = ("blockmm", _StrongKey(plan), grid, schedule, level,
                rotation_chunk, a_slots, b_slots, ctx.verify)
    hit = ctx._compiled.get(memo_key)
    if hit is not None:
        return hit
    step1 = compile_hlt(
        ctx, [plan.ds_sigma] * nA + [plan.ds_tau] * nB, level=level,
        schedule=schedule, rotation_chunk=rotation_chunk, ct_slots=slots1)
    # Step 2's batch is k-major: every A element of iteration k, then the
    # next k; all B elements after all A (BlockMMProgram indexes by it)
    step2_sets = ([plan.ds_eps[k] for k in range(plan.l) for _ in range(nA)]
                  + [plan.ds_omega[k] for k in range(plan.l)
                     for _ in range(nB)])
    slots2 = (tuple(a_slots[t] for _ in range(plan.l) for t in range(nA))
              + tuple(off + b_slots[t] for _ in range(plan.l)
                      for t in range(nB)))
    step2 = compile_hlt(ctx, step2_sets, level=level - 1, schedule=schedule,
                        rotation_chunk=rotation_chunk, ct_slots=slots2)
    prog = BlockMMProgram(
        ctx, plan,
        BlockMMPlan(m=plan.m, l=plan.l, n=plan.n, grid=grid,
                    schedule=schedule, level=level,
                    step1=step1.plan, step2=step2.plan),
        step1, step2)
    _verify.enforce(ctx, prog)
    ctx._compiled[memo_key] = prog
    return prog


# ---------------------------------------------------------------------------
# compile_hemm_chain -> HEMMChainProgram (Y = X·W1·…·Wk, no decrypt)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class HEMMChainPlan:
    """Compile summary of a chain of hemm hops.

    ``dims = (m, l, n1, …, nk)``: hop h multiplies the running m×dims[h+1]
    ciphertext by a dims[h+1]×dims[h+2] weight.  ``hop_levels`` are the
    hops' input levels (``level − 3h``: a hemm consumes 3); ``hop_out``
    the (level, scale) ``trace_chain`` predicts at each hop's output,
    which execution meets exactly; ``schedules`` the per-hop schedules
    (``costmodel.select_chain_schedules`` unless one is forced)."""

    dims: tuple
    shapes: tuple                       # (m, l, n) per hop
    schedules: tuple
    level: int                          # the chain's input level
    hop_levels: tuple                   # input level per hop
    hop_out: tuple                      # predicted CtState out of each hop
    repack: str                         # "fold" | "explicit"
    hops: tuple                         # HEMMPlan per hop

    @property
    def k(self) -> int:
        """Hops (matrix products) in the chain."""
        return len(self.hops)

    @property
    def out_level(self) -> int:
        """Level of the chain's output (``level − 3k``)."""
        return self.hop_out[-1].level

    @property
    def rotations(self) -> int:
        """Real rotations of one execution, over every hop."""
        return sum(h.rotations for h in self.hops)

    @property
    def hop_bytes(self) -> tuple:
        """Each hop's deduped key and diagonal operand bytes."""
        return tuple(h.operand_bytes for h in self.hops)

    @property
    def operand_bytes(self) -> int:
        """Key and diagonal operand bytes of the whole chain."""
        return sum(self.hop_bytes)

    @property
    def hoist_bytes(self) -> int:
        """Hoisting-product bytes after the ct-slot dedup (each hop's
        Step 2 stores 2 products, never 2·l)."""
        return sum(h.hoist_bytes for h in self.hops)

    @property
    def collective_bytes(self) -> int:
        """Predicted cross-device bytes an execution: 2 merged-ModDown
        all-reduces a hop under the sharded schedule, nothing between hops
        (the re-pack is the identity, mult/rescale/add are limb-local)."""
        return sum(h.collective_bytes for h in self.hops)


class HEMMChainProgram:
    """A compiled chain: ``prog(ctX, [ctW1, …, ctWk]) -> ctY`` with
    Y = X·W1·…·Wk under encryption, no decrypt between the hops.

    Hop h's column-major m×n output fills slots [0, m·n) and is hop h+1's
    σ input as it stands (the identity re-pack, ``core/hemm.py``
    ``ChainRepack``), so each intermediate stays a ciphertext at the
    traced (level, scale).  The weights enter at their hops' input levels
    (:meth:`encrypt_weights`).

    One call adds k+1 to ``program_launches`` (the chain and each hop's
    HEMMProgram) and, on batched hops, 2·k to ``hlt_launches``; the
    engine's ``op_counts["decrypts"]`` does not move.

    ``stage_hook``: an optional callable(hop, stage_name), set on each
    hop's HEMMProgram for the call (``HEMMProgram.stage_hook``)."""

    def __init__(self, ctx: HEContext, chain, plan: HEMMChainPlan, hops):
        self.ctx = ctx
        self.chain = chain                  # core/hemm.py HeMMChainPlan
        self.plan = plan
        self._hops = tuple(hops)            # HEMMProgram per hop
        self._gen = ctx._generation
        self.stage_hook: Optional[Callable[[int, str], None]] = None

    def encrypt_weights(self, Ws, rng) -> list:
        """Encrypt W1..Wk at their hops' input levels with the parameter
        set's scale: the weight states the compile's trace took, so
        execution meets ``plan.hop_out`` exactly."""
        from repro_torch.core.hemm import encrypt_matrix
        plan = self.plan
        if len(Ws) != plan.k:
            raise ValueError(f"{len(Ws)} weights for {plan.k} hops")
        cts = []
        for W, (_, l, n), lvl in zip(Ws, plan.shapes, plan.hop_levels,
                                     strict=True):
            W = np.asarray(W, dtype=np.float64)
            if W.shape != (l, n):
                raise ValueError(f"weight of shape {W.shape}, the hop "
                                 f"takes {(l, n)}")
            cts.append(encrypt_matrix(self.ctx.eng, self.ctx.keys, W, rng,
                                      level=lvl))
        return cts

    def run_hops(self, ctX: Ciphertext, weights) -> list:
        """Run the chain and return every hop's output (the last is the
        chain's); one call (``HEContext._program_call``)."""
        with self.ctx._program_call(self._gen):
            return self._run_hops(ctX, weights)

    def _run_hops(self, ctX: Ciphertext, weights) -> list:
        plan = self.plan
        if ctX.level != plan.level:
            raise ValueError(f"input level {ctX.level}, compiled for "
                             f"{plan.level}")
        if len(weights) != plan.k:
            raise ValueError(f"{len(weights)} weights for {plan.k} hops")
        ct, outs = ctX, []
        for h, (prog, ctW) in enumerate(zip(self._hops, weights,
                                            strict=True)):
            if ctW.level != plan.hop_levels[h]:
                raise ValueError(
                    f"hop {h} weight at level {ctW.level}, the chain takes "
                    f"{plan.hop_levels[h]} (encrypt_weights encrypts there)")
            if self.stage_hook is None:
                ct = prog(ct, ctW)
            else:       # the hop programs are memoised and shared
                saved = prog.stage_hook
                prog.stage_hook = (lambda name, h=h:
                                   self.stage_hook(h, name))
                try:
                    ct = prog(ct, ctW)
                finally:
                    prog.stage_hook = saved
            outs.append(ct)
        return outs

    def __call__(self, ctX: Ciphertext, weights) -> Ciphertext:
        return self.run_hops(ctX, weights)[-1]


def compile_hemm_chain(ctx: HEContext, chain, *, level: Optional[int] = None,
                       schedule: Optional[str] = None,
                       rotation_chunk: Optional[int] = None
                       ) -> HEMMChainProgram:
    """Compile a chain (``core/hemm.py`` ``plan_hemm_chain``) into a
    reusable HEMMChainProgram.

    The compile traces first: ``trace_chain`` runs over the hop plans
    before anything is built.  A chain deeper than the modulus chain
    allows (input ``level`` < 3·k: the trace's LS001/LS003 findings) never
    returns a program: ``VerificationError`` with the trace's diagnostics
    under ``ctx.verify="error"``, ``ValueError`` otherwise.
    ``analysis.max_chain_depth`` names the deepest chain that fits.

    ``schedule`` forces one schedule on every hop; without it,
    ``costmodel.select_chain_schedules`` picks them jointly (on one
    device: each hop's ``select_schedule`` pick; with a mesh it prices a
    change of residency between hops).  Memoized on the context."""
    if ctx.keys is None:
        raise RuntimeError("HEContext has no keys; call ctx.keygen()")
    eng = ctx.eng
    params = eng.params
    level = params.L if level is None else level
    k = chain.k

    trace = trace_chain(eng.ctx.moduli_host, chain.hops, level=level,
                        scale=params.scale)
    if not trace.ok:        # LS001/LS003: input level < 3·k
        if ctx.verify == "error":
            raise VerificationError(trace.diagnostics)
        msgs = "; ".join(str(d) for d in trace.diagnostics
                         if d.severity == "error")
        raise ValueError(f"chain of {k} hops needs input level >= {3 * k} "
                         f"(3 per hemm hop), got {level}: {msgs}")

    if schedule is not None:
        scheds = (schedule,) * k
    else:
        scheds = select_chain_schedules(
            params,
            [dict(d=hp.ds_sigma.d, ctb=2 * hp.l, n_uniq=2,
                  nbeta=len(eng.tools.digit_bases(level - 3 * h)),
                  level=level - 3 * h)
             for h, hp in enumerate(chain.hops)],
            smem_bytes=ctx.smem_bytes, n_model=ctx.n_model, n_ct=ctx.n_ct)
    for s in scheds:
        _check_schedule(s, rotation_chunk)

    memo_key = ("hemm_chain", _StrongKey(chain), scheds, level,
                rotation_chunk, ctx.verify)
    hit = ctx._compiled.get(memo_key)
    if hit is not None:
        return hit

    hop_progs = [compile_hemm(ctx, hp, level=level - 3 * h,
                              schedule=scheds[h],
                              rotation_chunk=rotation_chunk)
                 for h, hp in enumerate(chain.hops)]
    plan = HEMMChainPlan(
        dims=chain.dims,
        shapes=tuple((hp.m, hp.l, hp.n) for hp in chain.hops),
        schedules=scheds, level=level,
        hop_levels=tuple(level - 3 * h for h in range(k)),
        hop_out=trace.hop_states, repack=chain.repack,
        hops=tuple(p.plan for p in hop_progs))
    prog = HEMMChainProgram(ctx, chain, plan, hop_progs)
    _verify.enforce(ctx, prog)
    ctx._compiled[memo_key] = prog
    return prog
