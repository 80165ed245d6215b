"""The verifier's census pass, rules JX001–JX004 — counterpart of
``repro/analysis/jaxpr_lint.py``.

The reference traces a compiled program's pipeline on shapes alone and
walks its jaxpr.  The port has no tracer, so this pass runs the compiled
HLT body once, on zero ciphertexts of the plan's shapes (the aliasing of
the plan's ``ct_slots`` hint, all distinct without one), and counts what
that run does:

* JX001 — the merged ModDown+Rescale BaseConv all-reduce is the sole
  collective: exactly ``hlt_dist.expected_collectives`` all-reduces in
  the body (2 when the limb axis is sharded, else 0) and no other
  collective, counted where the port calls ``torch.distributed``
  (``distributed/collectives.py``).  The all-gather that assembles a
  sharded output after the body is not part of the body.
* JX002 — a program on the fused datapath reaches the rotation kernel:
  ``fused_hlt_indexed`` (``fused_hlt`` for a single-ciphertext compile)
  through ``kernels/ops.py``, on every rank.
* JX003 — no device-to-host synchronisation in the body: on CUDA the run
  is under ``torch.cuda.set_sync_debug_mode("error")``, after a first
  run that builds what the kernel wrappers build once a table (its
  folded constants are read back on the host).  A collective suspends
  the check while it runs (gloo stages CUDA tensors through the host).
  On the CPU there is no device to wait for, and the rule holds vacuously.
* JX004 — a program whose stages are on the kernels (``plan.datapath ==
  "pallas"``) calls none of the named int64 NTTs of ``core/ntt.py``.

Sharded programs and one-device ``"pallas"`` programs run the pass; the
reference schedules have no compiled body.  The run is counted in a scope
of its own: ``ops.launch_counts()``, ``ops.CALLS``, ``ntt.CALLS``, the
collective counters, ``fused_hlt.PATHS`` and ``ctx.counters`` are as they
were after it.  Every rank of a mesh compiles the same programs in the
same order, so the census' collectives match across ranks.  It costs one
execution of the HLT (two on CUDA) at compile time.
"""
from __future__ import annotations

from collections import Counter

import torch

from repro_torch.analysis.diagnostics import Diagnostic
from repro_torch.core import hlt_dist, ntt
from repro_torch.distributed import collectives
from repro_torch.kernels import fused_hlt, ops

#: the message torch raises for a synchronising call under sync debug mode
_SYNC_MESSAGE = "synchronizing"


def zero_items(run) -> list:
    """Zero ciphertexts at the plan's level and scale, one per unique input
    of the plan's aliasing hint, laid out as the hint says (all distinct
    without one); a single compile takes one."""
    from repro_torch.core.ckks import Ciphertext
    plan, eng = run.plan, run.ctx.eng
    shape = (plan.level + 1, eng.params.N)
    batch = 1 if plan.batch is None else plan.batch
    slots = plan.ct_slots if plan.ct_slots is not None else range(batch)
    uniq = {}
    for s in slots:
        if s not in uniq:
            z = torch.zeros(shape, dtype=torch.int32, device=eng.device)
            uniq[s] = Ciphertext(z, z.clone(), plan.level, eng.params.scale)
    items = [uniq[s] for s in slots]
    return items[0] if plan.batch is None else items


def _body(run, items):
    if run.plan.schedule.startswith("sharded"):
        return run._sharded_body([items] if run.plan.batch is None
                                 else items)
    return run._execute(items)


def _delta(after: dict, before: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in after.items()
            if v - before.get(k, 0)}


def take_census(run) -> dict:
    """Run the program's body once on zero ciphertexts and count its
    collectives by kind, its kernel entry calls, its named NTT calls and
    (CUDA) the synchronising call it made, if any; restore every counter
    it touched."""
    ctx = run.ctx
    items = zero_items(run)
    cuda = ctx.eng.device.type == "cuda"
    saved = (ops.launch_counts(), dict(ops.CALLS), dict(ntt.CALLS),
             dict(collectives.COUNTS), dict(collectives.BYTES),
             dict(ctx.counters), fused_hlt.PATHS)
    fused_hlt.PATHS = None
    try:
        if cuda:                # builds what the wrappers build once
            _body(run, items)
            torch.cuda.synchronize()
        calls0, ntt0 = dict(ops.CALLS), dict(ntt.CALLS)
        sync = None
        with collectives.scope() as coll:
            if cuda:
                torch.cuda.set_sync_debug_mode("error")
            try:
                _body(run, items)
            except RuntimeError as e:
                if not (cuda and _SYNC_MESSAGE in str(e)):
                    raise
                sync = str(e).splitlines()[0]
            finally:
                if cuda:
                    torch.cuda.set_sync_debug_mode(0)
        return dict(collectives=dict(Counter(e[0] for e in coll)),
                    calls=_delta(ops.CALLS, calls0),
                    ntt=_delta(ntt.CALLS, ntt0), sync=sync)
    finally:
        launches, calls, ntts, coll_n, coll_b, counters, paths = saved
        for counts in ops._COUNTERS:
            for k in counts:
                counts[k] = launches.get(k, 0)
        for live, old in ((ops.CALLS, calls), (ntt.CALLS, ntts),
                          (collectives.COUNTS, coll_n),
                          (collectives.BYTES, coll_b),
                          (ctx.counters, counters)):
            live.update(old)
        fused_hlt.PATHS = paths


def lint_census(census: dict, *, datapath: str, expected_psums: int,
                rotation_kernel: str = "fused_hlt_indexed",
                program: str = "hlt", stage: str = "sharded",
                stages: str = "xla") -> list:
    """JX diagnostics for one census.  ``datapath`` is the rotation
    lowering ("pallas": the kernel must be reached, JX002); ``stages``
    the hoist / ModDown lowering ("pallas": no named NTT may run, JX004)."""
    coll = dict(census["collectives"])
    n_reduce = coll.pop("all_reduce", 0)
    diags = []
    if coll:
        names = ", ".join(f"{k}×{v}" for k, v in sorted(coll.items()))
        diags.append(Diagnostic(
            rule="JX001", severity="error", program=program, stage=stage,
            message=f"collective(s) other than the all-reduce in the "
                    f"program body: {names}",
            hint="the merged ModDown+Rescale BaseConv all-reduce must be "
                 "the only collective (DESIGN.md §4)"))
    if n_reduce != expected_psums:
        diags.append(Diagnostic(
            rule="JX001", severity="error", program=program, stage=stage,
            message=f"{n_reduce} all-reduce(s) in the program body, "
                    f"expected exactly {expected_psums} (one merged "
                    f"ModDown+Rescale per output poly)",
            hint="route all cross-device reduction through "
                 "hlt_dist.make_sharded_hlt_fn's ModDown"))
    # a body cut short by a synchronising call (JX003) is not judged here
    if datapath == "pallas" and census["sync"] is None \
            and census["calls"].get(rotation_kernel, 0) < 1:
        diags.append(Diagnostic(
            rule="JX002", severity="error", program=program, stage=stage,
            message=f"datapath='pallas' but the body never reached "
                    f"{rotation_kernel} — the fused kernel is not on the path",
            hint="check the datapath plumbing of the compiled body"))
    if census["sync"] is not None:
        diags.append(Diagnostic(
            rule="JX003", severity="error", program=program, stage=stage,
            message=f"device-to-host synchronisation in the body: "
                    f"{census['sync']}",
            hint="hot-path code must stay on the device; build tables and "
                 "slot vectors at compile time"))
    if stages == "pallas" and census["ntt"]:
        names = ", ".join(f"{k}×{v}" for k, v in sorted(census["ntt"].items()))
        diags.append(Diagnostic(
            rule="JX004", severity="error", program=program, stage=stage,
            message=f"named int64 NTT/iNTT call(s) in a datapath='pallas' "
                    f"program: {names} — the hoist/ModDown stages are not "
                    f"fully on the kernels",
            hint="route the base-change transforms through "
                 "kernels/basechange.py (HEContext.datapath plumbing)"))
    return diags


def lint_compiled_hlt(run, *, program: str = "hlt") -> list:
    """The census pass for one CompiledHLT: the sharded body (datapath
    "xla" on ``sharded_xla``), or the one-device fused pipeline (hoist,
    rotation kernel, merged ModDown); none for the reference schedules."""
    plan = run.plan
    if plan.schedule.startswith("sharded"):
        expected = hlt_dist.expected_collectives(run._sharded[0])["psum"]
        return lint_census(take_census(run), datapath=run._datapath,
                           expected_psums=expected, program=program,
                           stage=f"sharded[{run._datapath}]",
                           stages=plan.datapath)
    if plan.schedule != "pallas":
        return []
    kernel = "fused_hlt" if plan.batch is None else "fused_hlt_indexed"
    return lint_census(take_census(run), datapath="pallas", expected_psums=0,
                       rotation_kernel=kernel, program=program,
                       stage="pallas[pipeline]", stages=plan.datapath)
