"""Arena and aliasing auditor, the verifier's AR pass — counterpart of
``repro/analysis/arena.py`` over the port's ``OperandArena`` and slot
tables.

* AR001: the owning context was invalidated after the compile (the
  static twin of the run-time generation guard).
* AR002: a batched compile's slot table is malformed — the batch index →
  diagonal-set slot tensor the fused kernel gathers by disagrees with the
  plan or points past the stacked operands (on ``"pallas"`` also: the
  stacked operands are not the arena's; on the sharded schedules: the
  table does not cover the batch padded to the ct ranks, or the hint's
  ct table disagrees with the plan); or the ``ct_slots`` hint is not in
  first-appearance order (``core/compile.py`` ``_canonical_slots``).
* AR003: a ``ct_slots`` hint whose hoist dedup the schedule cannot
  deliver (info: the plan's ``hoist_bytes`` overstates the dedup, the
  math is right).
* AR004: a ``"sharded"`` hint with more unique ciphertexts than one ct
  rank's batch share: execution takes the per-element hoist layout
  (warning: correct, but each rank hoists its share).
"""
from __future__ import annotations

import torch

from repro_torch.analysis.diagnostics import Diagnostic

# Schedules whose execution does not itself dedup hoists by object
# identity: mo/hoisted loop single executions, so the dedup happens only
# if the caller passes one hoisting product per slot; baseline never
# hoists.  Info severity: only the plan's accounting may overstate.
_LOOP_CAVEAT = ("loops single executions — the claimed dedup is only "
                "delivered if the caller passes the same pre-hoisted "
                "product per slot; repeated raw ciphertexts re-hoist "
                "per element while the plan's hoist_bytes trusts the hint")
_NO_DEDUP_SCHEDULES = {
    "mo": ("info", _LOOP_CAVEAT),
    "hoisted": ("info", _LOOP_CAVEAT),
    "baseline": ("info", "never hoists — the hint is inert"),
    "sharded_xla": ("info", "re-hoists per batch element inside the SPMD "
                            "program — the hint is inert (and the plan "
                            "already prices the per-element hoist)"),
}


def check_generation(prog, *, program: str) -> list:
    """AR001: the owning context was invalidated after this compile."""
    if prog._gen == prog.ctx._generation:
        return []
    return [Diagnostic(
        rule="AR001", severity="error", program=program, stage="arena",
        message=f"stale compiled program: context generation is "
                f"{prog.ctx._generation}, program was compiled at "
                f"{prog._gen} — its arena operands/slot tables are gone",
        hint="recompile via compile_hlt/compile_hemm/compile_blockmm "
             "after ctx.invalidate()/keygen()")]


def _slot_table_faults(run) -> list:
    """What is wrong with a batched ``"pallas"`` compile's slot table and
    stacked operands (empty when well formed)."""
    from repro_torch.core.compile import _canonical_slots
    plan = run.plan
    tab = run._diag_slots
    bad = []
    if not isinstance(tab, torch.Tensor) or tab.dim() != 1 \
            or tab.shape[0] != plan.batch:
        bad.append(f"diag table {getattr(tab, 'shape', tab)} is not a 1-D "
                   f"tensor over the batch of {plan.batch}")
    elif tab.dtype.is_floating_point or tab.dtype == torch.bool:
        bad.append(f"diag table dtype {tab.dtype} is not integral")
    else:
        ids = tab.tolist()
        if min(ids) < 0 or max(ids) >= plan.n_diag_slots:
            bad.append(f"diag slot ids outside [0, {plan.n_diag_slots})")
        elif tuple(ids) != plan.diag_slots:
            bad.append("diag table disagrees with plan.diag_slots")
    stacked = {int(t.shape[0]) for t in run._operands}
    if stacked != {plan.n_diag_slots}:
        bad.append(f"stacked operands hold {sorted(stacked)} slots, the "
                   f"plan {plan.n_diag_slots}")
    arena = run.ctx.arena
    extra = (plan.level, plan.nbeta, plan.d_pad)
    uniq = {id(ds): ds for ds in run._diags}.values()
    if any(arena.get("pallas_operands", ds, extra) is None for ds in uniq):
        bad.append(f"a diagonal set has no arena operands at (level, β', "
                   f"d_pad) = {extra}")
    if plan.ct_slots is not None and _canonical_slots(
            plan.ct_slots, len(plan.ct_slots), "ct_slots") != plan.ct_slots:
        bad.append("ct_slots hint is not first-appearance canonical")
    return bad


def _sharded_table_faults(run, batch: int) -> list:
    """What is wrong with a sharded compile's slot tables (empty when well
    formed)."""
    plan = run.plan
    tables = run._slot_tables or {}
    diag_tab = tables.get("diag")
    n_ct = max(1, run.ctx.n_ct)
    bad = []
    if not isinstance(diag_tab, torch.Tensor) or diag_tab.dim() != 1 \
            or diag_tab.shape[0] < batch or diag_tab.shape[0] % n_ct:
        return [f"diag table {getattr(diag_tab, 'shape', diag_tab)} is not "
                f"a 1-D ct-axis multiple covering the batch (batch {batch}, "
                f"n_ct {n_ct})"]
    b_pad = diag_tab.shape[0]
    ids = diag_tab.tolist()
    if diag_tab.dtype.is_floating_point or diag_tab.dtype == torch.bool:
        bad.append(f"diag table dtype {diag_tab.dtype} is not integral")
    elif min(ids) < 0 or max(ids) >= plan.n_diag_slots:
        bad.append(f"diag slot ids outside [0, {plan.n_diag_slots})")
    elif tuple(ids[:batch]) != plan.diag_slots:
        bad.append("diag table disagrees with plan.diag_slots")
    ct_tab = tables.get("ct")
    if ct_tab is not None and plan.ct_slots is not None:
        cts = ct_tab.tolist()
        if tuple(ct_tab.shape) != (b_pad,):
            bad.append(f"ct table shape {tuple(ct_tab.shape)} != ({b_pad},)")
        elif min(cts) < 0 or max(cts) >= plan.n_ct_slots:
            bad.append(f"ct slot ids outside [0, {plan.n_ct_slots})")
        elif tuple(cts[:batch]) != plan.ct_slots:
            bad.append("ct table disagrees with plan.ct_slots")
    return bad


def audit_hlt(run, *, program: str = "hlt") -> list:
    """AR002/AR003 for one CompiledHLT (its generation must be current:
    run :func:`check_generation` first)."""
    plan = run.plan
    diags = []
    batch = plan.batch if plan.batch is not None else 1

    # AR003 — the dedup claim against what the schedule's execution does
    if plan.ct_slots is not None and plan.n_ct_slots < batch \
            and plan.schedule in _NO_DEDUP_SCHEDULES:
        severity, why = _NO_DEDUP_SCHEDULES[plan.schedule]
        diags.append(Diagnostic(
            rule="AR003", severity=severity, program=program,
            stage=f"ct_slots[{plan.schedule}]",
            message=f"ct_slots hint claims {plan.n_ct_slots} unique "
                    f"ciphertexts over a batch of {batch}, but "
                    f"schedule='{plan.schedule}' {why} — the claimed "
                    f"hoist dedup will not happen",
            hint="use schedule='pallas' (identity-deduped hoisting), or "
                 "drop the hint"))

    # AR002 — the slot tables against the plan (and the arena)
    if plan.schedule.startswith("sharded"):
        faults = _sharded_table_faults(run, batch)
        if plan.ct_slots is not None and _canonical_slots_fault(plan):
            faults.append("ct_slots hint is not first-appearance canonical")
    elif plan.schedule == "pallas" and plan.batch is not None:
        faults = _slot_table_faults(run)
    else:
        faults = []
    for msg in faults:
        diags.append(Diagnostic(
            rule="AR002", severity="error", program=program,
            stage="slot_tables", message=msg,
            hint="slot tables and stacked operands are built by "
                 "compile_hlt from the arena — recompile, do not patch "
                 "them in place"))

    # AR004 — the dedup layout falls back to per-element at call time
    if plan.schedule == "sharded" and plan.n_ct_slots is not None \
            and run._slot_tables:
        b_loc = run._slot_tables["diag"].shape[0] // max(1, run.ctx.n_ct)
        if plan.n_ct_slots > b_loc:
            diags.append(Diagnostic(
                rule="AR004", severity="warning", program=program,
                stage="ct_slots[sharded]",
                message=f"dedup hint has {plan.n_ct_slots} unique "
                        f"ciphertexts but a ct rank's batch share is only "
                        f"{b_loc} — execution will fall back to the "
                        f"per-element hoist layout",
                hint="the fallback is correct but each rank hoists its "
                     "local share; expect hoist_bytes_naive, not "
                     "hoist_bytes"))
    return diags


def _canonical_slots_fault(plan) -> bool:
    from repro_torch.core.compile import _canonical_slots
    return _canonical_slots(plan.ct_slots, len(plan.ct_slots),
                            "ct_slots") != plan.ct_slots
