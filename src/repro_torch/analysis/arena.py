"""Arena and aliasing auditor, the verifier's AR pass — counterpart of
``repro/analysis/arena.py`` over the port's ``OperandArena`` and slot
tables.

* AR001: the owning context was invalidated after the compile (the
  static twin of the run-time generation guard).
* AR002: a batched ``"pallas"`` compile's slot table is malformed — the
  batch index → diagonal-set slot tensor the fused kernel gathers by
  disagrees with the plan, points past the stacked operands, or the
  stacked operands are not the arena's; or the ``ct_slots`` hint is not
  in first-appearance order (``core/compile.py`` ``_canonical_slots``).
  The reference checks the same properties of its sharded slot tables;
  the port's only slot tables are the fused kernel's.
* AR003: a ``ct_slots`` hint whose hoist dedup the schedule cannot
  deliver (info: the plan's ``hoist_bytes`` overstates the dedup, the
  math is right).
* AR004 belongs to the sharded schedule (a hint wider than one rank's
  batch share); the port has no ct axis yet (no multi-device schedule), so
  the pass cannot raise it.
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

    # AR002 — the fused kernel's slot table against the plan and the arena
    if plan.schedule == "pallas" and plan.batch is not None:
        for msg in _slot_table_faults(run):
            diags.append(Diagnostic(
                rule="AR002", severity="error", program=program,
                stage="slot_tables", message=msg,
                hint="slot tables and stacked operands are built by "
                     "compile_hlt from the arena — recompile, do not "
                     "patch them in place"))
    return diags
