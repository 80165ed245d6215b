"""Structured diagnostics shared by every verifier pass — counterpart of
``repro/analysis/diagnostics.py``, with the same rule catalog.

A :class:`Diagnostic` carries a stable rule id, a severity, the program
and stage it anchors to, a message and a fix hint.  ``verify.enforce``
turns error-severity diagnostics into a :class:`VerificationError` under
``verify="error"`` and into :class:`VerificationWarning` warnings under
``verify="warn"``.

The JX rules are the census' (``analysis/census.py``), the port's
counterpart of the reference's jaxpr linter.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence

SEVERITIES = ("error", "warning", "info")

RULES = {
    # level/scale tracker (analysis/level_scale.py)
    "LS001": "level underflow: op consumes more levels than the ciphertext has",
    "LS002": "scale mismatch between addends",
    "LS003": "rescale past the end of the modulus chain",
    "LS004": "level mismatch between operands of add/mult",
    # jaxpr invariant linter (the port's census, analysis/census.py)
    "JX001": "sole-collective invariant violated in the sharded program",
    "JX002": "pallas_call missing from the fused datapath",
    "JX003": "host round-trip (callback primitive) in the hot path",
    "JX004": "XLA-lowered NTT/iNTT in a datapath='pallas' program",
    # on-chip budget checker (analysis/smem.py: a block's shared memory)
    "VM001": "fused-kernel working set exceeds the VMEM budget",
    # arena / aliasing auditor (analysis/arena.py)
    "AR001": "stale compiled program: context generation advanced",
    "AR002": "malformed slot table",
    "AR003": "ct_slots dedup claim the schedule cannot deliver",
    "AR004": "dedup hint exceeds the per-rank batch share (element fallback)",
    # verifier plumbing
    "VF000": "verifier internal error",
}


@dataclasses.dataclass(frozen=True)
class Diagnostic:
    """One verifier finding: rule id, severity, source program/stage,
    message and a fix hint."""

    rule: str                  # RULES key, e.g. "LS001"
    severity: str              # "error" | "warning" | "info"
    program: str               # "hlt" | "hemm" | "blockmm" | "chain" | ...
    stage: str                 # op/stage anchor, e.g. "step2/eps[3]"
    message: str
    hint: str = ""

    def __post_init__(self):
        if self.rule not in RULES:
            raise ValueError(f"unknown rule {self.rule!r}")
        if self.severity not in SEVERITIES:
            raise ValueError(f"unknown severity {self.severity!r}")

    def __str__(self) -> str:
        s = (f"{self.rule} [{self.severity}] {self.program}:{self.stage}: "
             f"{self.message}")
        return s + (f" (fix: {self.hint})" if self.hint else "")


def errors(diags: Iterable[Diagnostic]) -> list:
    """The error-severity subset."""
    return [d for d in diags if d.severity == "error"]


def format_report(diags: Sequence[Diagnostic]) -> str:
    """Multi-line report, errors first."""
    if not diags:
        return "no diagnostics"
    order = {"error": 0, "warning": 1, "info": 2}
    return "\n".join(str(d) for d in
                     sorted(diags, key=lambda d: order[d.severity]))


class VerificationWarning(UserWarning):
    """Category of warn-mode diagnostics (filter it with
    ``warnings.filterwarnings("ignore", category=VerificationWarning)``)."""


class VerificationError(RuntimeError):
    """Raised by ``verify="error"`` compiles; ``.diagnostics`` holds every
    finding, not only the errors that caused the raise."""

    def __init__(self, diagnostics: Sequence[Diagnostic]):
        self.diagnostics = tuple(diagnostics)
        super().__init__("HE program verification failed:\n"
                         + format_report(self.diagnostics))
