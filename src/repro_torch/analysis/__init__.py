"""Compile-time static verifier for the port's HE programs — counterpart
of ``repro/analysis``.

Four passes run over compiled plans before execution, from
``compile_hlt`` / ``compile_hemm`` / ``compile_blockmm`` /
``compile_hemm_chain`` behind ``HEContext(verify="error"|"warn"|"off")``:

* ``level_scale`` — symbolic CKKS level/scale tracker (LS rules)
* ``smem``        — the fused kernels' shared-memory budget (VM001)
* ``arena``       — arena generation, slot tables, aliasing hints (AR)
* ``census``      — one run of the compiled body: collectives, kernels,
  host syncs, named NTTs (JX)

``verify.verify_program(prog)`` runs every applicable pass on a compiled
program and returns the list of :class:`Diagnostic`; the CLI
(``python -m repro_torch.analysis.lint``) sweeps representative programs
over ``configs/fame_sets.py`` ``FAME_VERIFY_SETS``.
"""
from repro_torch.analysis.diagnostics import (RULES, Diagnostic,
                                              VerificationError,
                                              VerificationWarning,
                                              format_report)
from repro_torch.analysis.level_scale import (CtState, ScaleTracker, Trace,
                                              max_chain_depth, trace_chain,
                                              trace_hemm, trace_hlt)
from repro_torch.analysis.verify import verify_program

__all__ = [
    "RULES", "Diagnostic", "VerificationError", "VerificationWarning",
    "format_report", "CtState", "ScaleTracker", "Trace", "max_chain_depth",
    "trace_chain", "trace_hemm", "trace_hlt", "verify_program",
]
