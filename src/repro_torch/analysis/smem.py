"""Shared-memory budget pass (VM001) — the port's counterpart of
``repro/analysis/vmem.py``.

On the TPU the fused kernels keep a working set per grid step in VMEM;
on the H100 each fused launch allocates its footprint in one block's
shared memory, exactly, when it launches.  So the pass checks every
fused stage of a ``"pallas"`` compile — the rotation kernel, the batched
hoist, the merged ModDown — against ``HEContext.smem_headroom`` × 227 KB
(``core/costmodel.py`` ``SMEM_PER_BLOCK``), with the footprint formulas
the launches use (``costmodel.fused_stage_working_sets`` over
``kernels/fused_hlt.py`` ``smem_bytes`` and ``kernels/basechange.py``
``hoist_smem_bytes`` / ``moddown_smem_bytes``).  The cost model reads
the same fraction: ``select_schedule`` takes ``"pallas"`` only where
``fused_kernels_accept`` finds each kernel's smallest footprint within
it, and this pass checks the footprint each launch of the compile really
allocates.  At the default 1.0 every compile point of the shipped sets
fits with room (the largest, a split row kernel at logN 16, is 65 KB);
below the smallest footprint both refuse: the cost model picks ``"mo"``
and a forced ``"pallas"`` fails VM001.

The rotation chunk only pads d on the port (``costmodel.py``), and the
footprints depend on the limb group, the digit count, the level and the
batch, not on a chunk; the hint names the stage and the level.  On
``HEContext(datapath="xla")`` only the rotation kernel is fused.
"""
from __future__ import annotations

from repro_torch.analysis.diagnostics import Diagnostic
from repro_torch.core.costmodel import SMEM_PER_BLOCK, fused_stage_working_sets


def stage_footprints(params, plan) -> dict:
    """Per-block shared-memory bytes of each fused stage one execution of
    the compiled HLT launches: the rotation kernel at the padded d, the
    hoist of its unique inputs, the merged ModDown of its batch."""
    batch = 1 if plan.batch is None else plan.batch
    hoists = batch if plan.n_ct_slots is None else plan.n_ct_slots
    stages = fused_stage_working_sets(params, nbeta=plan.nbeta, d=plan.d_pad,
                                      level=plan.level, batch=batch,
                                      hoists=hoists)
    if plan.datapath != "pallas":
        stages = {"rot": stages["rot"]}
    return stages


def check_smem(params, plan, *, program: str = "hlt") -> list:
    """VM001 diagnostics for one HLTPlan (empty off the fused schedule)."""
    if plan.schedule != "pallas":
        return []
    stages = stage_footprints(params, plan)
    worst, nbytes = max(stages.items(), key=lambda kv: kv[1])
    budget = plan.smem_headroom * SMEM_PER_BLOCK
    if nbytes <= budget:
        return []
    return [Diagnostic(
        rule="VM001", severity="error", program=program,
        stage=f"pallas_call[{worst},chunk={plan.chunk}]",
        message=(f"fused {worst}-stage footprint {nbytes / 1024:.2f} KB a "
                 f"block exceeds the shared-memory budget "
                 f"{budget / 1024:.2f} KB (headroom {plan.smem_headroom} × "
                 f"{SMEM_PER_BLOCK / 1024:.0f} KB) at β'={plan.nbeta}, "
                 f"N={params.N}, level={plan.level}, d_pad={plan.d_pad}"),
        hint=(f"the {worst} stage's footprint at level {plan.level} is set "
              f"by the ring, the digits and the batch — compile at a "
              f"lower level, shrink the digit width (params.alpha), take "
              f"schedule='mo', or raise HEContext(smem_headroom=...)"))]
