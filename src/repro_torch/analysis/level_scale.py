"""Symbolic CKKS level/scale tracker, the verifier's LS pass — counterpart
of ``repro/analysis/level_scale.py``.

Walks a program's op sequence (hoist → Automorph → KeyIP → DiagIP →
merged ModDown+Rescale, then Mult/Rescale/Add accumulation) over a
symbolic ``(level, scale)`` state per ciphertext, without touching any
polynomial data.  The arithmetic is the port's ``core/ckks.py`` and
``core/compile.py`` expression for expression (``rescale`` divides the
scale by q_ℓ, ``mult`` multiplies the scales, ``add`` keeps the larger,
an HLT's merged ModDown+Rescale gives ``scale · ds.scale / q_ℓ``), so a
prediction equals the executed ciphertext's (level, scale) exactly.

Rules: LS001 level underflow, LS002 scale mismatch at an add, LS003
rescale past the modulus chain, LS004 operand level mismatch.

``trace_chain`` is what ``compile_hemm_chain`` runs before it builds
anything: it proves that a chain Y = X·W1·W2·… fits the modulus chain,
and ``Trace.hop_states`` carries the (level, scale) each hop's output
must have.  ``max_chain_depth`` turns a parameter set into its provable
hop budget.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

from repro_torch.analysis.diagnostics import Diagnostic

# Addend scales are compared relatively: the engine takes the larger scale
# at an add, so a real mismatch silently skews the decode.
RTOL = 1e-9


@dataclasses.dataclass(frozen=True)
class CtState:
    """Symbolic ciphertext state: level ℓ (limbs 0..ℓ live) and scale."""

    level: int
    scale: float


@dataclasses.dataclass(frozen=True)
class TraceStep:
    """One op in a trace: the state after the op."""

    op: str                    # "hoist"|"automorph"|"keyip"|"diagip"|
    #                            "moddown_rescale"|"mult"|"rescale"|"add"
    stage: str                 # source anchor, e.g. "step2/eps[3]"
    level: int
    scale: float


@dataclasses.dataclass(frozen=True)
class Trace:
    """A finished symbolic execution: final state, steps, findings.
    ``hop_states`` (``trace_chain`` only) is the predicted state at each
    hop's output, in hop order."""

    out: CtState
    steps: tuple
    diagnostics: tuple
    hop_states: tuple = ()

    @property
    def ok(self) -> bool:
        return not any(d.severity == "error" for d in self.diagnostics)


class ScaleTracker:
    """Symbolic interpreter over ``CtState``; accumulates steps and
    diagnostics.  One tracker spans a whole program or chain: feed an op's
    output state into the next op (states are immutable, so fan-out is
    reuse)."""

    def __init__(self, moduli: Sequence[float], *, program: str = "trace"):
        self.moduli = [float(q) for q in moduli]   # indexed by level
        self.program = program
        self.steps: list = []
        self.diagnostics: list = []

    def _emit(self, rule: str, stage: str, message: str, hint: str = "",
              severity: str = "error") -> None:
        self.diagnostics.append(Diagnostic(
            rule=rule, severity=severity, program=self.program, stage=stage,
            message=message, hint=hint))

    def _step(self, op: str, stage: str, st: CtState) -> CtState:
        self.steps.append(TraceStep(op=op, stage=stage, level=st.level,
                                    scale=st.scale))
        return st

    def _q(self, level: int) -> float:
        """The chain prime at ``level`` (1.0 past the chain, so that a
        flagged underflow keeps tracing)."""
        if 0 <= level < len(self.moduli):
            return self.moduli[level]
        return 1.0

    def hlt(self, st: CtState, ds_scale: float, *, stage: str = "hlt"
            ) -> CtState:
        """One HLT at ``st.level``: the hoist, Automorph and KeyIP keep
        (level, scale); DiagIP multiplies by the diagonal set's scale; the
        merged ModDown+Rescale folds out q_ℓ (``CompiledHLT``:
        ``scale · ds.scale / q_ℓ``)."""
        if st.level < 1:
            self._emit(
                "LS001", stage,
                f"HLT at level {st.level} — the merged ModDown+Rescale "
                f"consumes one level, none left",
                hint="start the program at a higher level or shorten the "
                     "circuit (each HLT costs 1 level, hemm costs 3)")
        self._step("hoist", stage, st)
        self._step("automorph", stage, st)
        self._step("keyip", stage, st)
        mid = CtState(st.level, st.scale * ds_scale)
        self._step("diagip", stage, mid)
        out = CtState(st.level - 1, mid.scale / self._q(st.level))
        return self._step("moddown_rescale", stage, out)

    def mult(self, a: CtState, b: CtState, *, stage: str = "mult") -> CtState:
        """ct × ct with relinearization, no rescale (``CkksEngine.mult``)."""
        if a.level != b.level:
            self._emit("LS004", stage,
                       f"mult operands at different levels "
                       f"({a.level} vs {b.level})",
                       hint="mod-drop the higher operand first")
        out = CtState(min(a.level, b.level), a.scale * b.scale)
        return self._step("mult", stage, out)

    def rescale(self, st: CtState, *, stage: str = "rescale") -> CtState:
        """Fold out q_ℓ, drop one level (``CkksEngine.rescale``)."""
        if st.level < 1:
            self._emit(
                "LS003", stage,
                f"rescale at level {st.level} would drop past the start of "
                f"the modulus chain",
                hint="the circuit is deeper than the chain; raise L or "
                     "start at a higher level")
        out = CtState(st.level - 1, st.scale / self._q(st.level))
        return self._step("rescale", stage, out)

    def add(self, a: CtState, b: CtState, *, stage: str = "add") -> CtState:
        """ct + ct (``CkksEngine.add``: the larger scale, meaningful only
        when the two agree)."""
        if a.level != b.level:
            self._emit("LS004", stage,
                       f"addends at different levels ({a.level} vs "
                       f"{b.level})",
                       hint="mod-drop the higher addend first")
        denom = max(abs(a.scale), abs(b.scale), 1e-300)
        if abs(a.scale - b.scale) > RTOL * denom:
            self._emit(
                "LS002", stage,
                f"addend scales differ: {a.scale:.6g} vs {b.scale:.6g} "
                f"(rel {abs(a.scale - b.scale) / denom:.2e})",
                hint="equalize diagonal-set scales so every accumulated "
                     "product lands on the same scale")
        out = CtState(min(a.level, b.level), max(a.scale, b.scale))
        return self._step("add", stage, out)

    def hemm(self, a: CtState, b: CtState, *, sigma_scale: float,
             tau_scale: float, eps_scales: Sequence[float],
             omega_scales: Sequence[float], add_fanin: int = 1,
             stage: str = "hemm") -> CtState:
        """One Algorithm-2 HE MM (depth 3): the Step-1 σ/τ HLTs, the
        Step-2 ε/ω pairs, then Mult·Rescale·Add over k.  ``add_fanin``
        repeats each k's product (a block MM adds ``gl`` tile products per
        output tile per k)."""
        if len(eps_scales) != len(omega_scales):
            raise ValueError(f"{len(eps_scales)} ε scales, "
                             f"{len(omega_scales)} ω scales")
        if a.level != b.level:
            self._emit("LS004", f"{stage}/inputs",
                       f"hemm inputs at different levels ({a.level} vs "
                       f"{b.level})",
                       hint="encrypt or mod-drop both inputs to one level")
        a0 = self.hlt(a, sigma_scale, stage=f"{stage}/step1/sigma")
        b0 = self.hlt(b, tau_scale, stage=f"{stage}/step1/tau")
        acc: Optional[CtState] = None
        for k, (es, os_) in enumerate(zip(eps_scales, omega_scales,
                                          strict=True)):
            ak = self.hlt(a0, es, stage=f"{stage}/step2/eps[{k}]")
            bk = self.hlt(b0, os_, stage=f"{stage}/step2/omega[{k}]")
            prod = self.mult(ak, bk, stage=f"{stage}/acc[{k}]")
            prod = self.rescale(prod, stage=f"{stage}/acc[{k}]")
            for _ in range(max(1, add_fanin)):
                acc = prod if acc is None else \
                    self.add(acc, prod, stage=f"{stage}/acc[{k}]")
        return acc

    def trace(self) -> Trace:
        """The tracker as an immutable :class:`Trace` (final state = the
        last step)."""
        last = self.steps[-1]
        return Trace(out=CtState(last.level, last.scale),
                     steps=tuple(self.steps),
                     diagnostics=tuple(self.diagnostics))


def trace_hlt(moduli: Sequence[float], *, level: int, scale: float,
              ds_scale: float, stage: str = "hlt",
              program: str = "hlt") -> Trace:
    """Trace one HLT from ``(level, scale)`` through a diagonal set."""
    t = ScaleTracker(moduli, program=program)
    t.hlt(CtState(level, scale), ds_scale, stage=stage)
    return t.trace()


def trace_hemm(moduli: Sequence[float], *, level: int, scale_a: float,
               scale_b: float, sigma_scale: float, tau_scale: float,
               eps_scales: Sequence[float], omega_scales: Sequence[float],
               add_fanin: int = 1, program: str = "hemm") -> Trace:
    """Trace one HE MM (depth 3) from ``(level, scale_a)`` /
    ``(level, scale_b)``."""
    t = ScaleTracker(moduli, program=program)
    t.hemm(CtState(level, scale_a), CtState(level, scale_b),
           sigma_scale=sigma_scale, tau_scale=tau_scale,
           eps_scales=eps_scales, omega_scales=omega_scales,
           add_fanin=add_fanin)
    return t.trace()


def _hop_scales(hop) -> dict:
    """The scales of one chain hop: a ``core/hemm.py`` HeMMPlan (read
    through its ``ds_*`` diagonal sets) or a dict of scales."""
    if isinstance(hop, dict):
        return hop
    return dict(sigma_scale=hop.ds_sigma.scale, tau_scale=hop.ds_tau.scale,
                eps_scales=[ds.scale for ds in hop.ds_eps],
                omega_scales=[ds.scale for ds in hop.ds_omega])


def trace_chain(moduli: Sequence[float], hops, *, level: int,
                scale: float) -> Trace:
    """Trace a chain Y = X·W1·W2·… (one hemm a hop, depth 3 each): the
    proof at compile time that levels and rescales line up across the
    hops, or the hop where the modulus chain runs out (LS001/LS003).

    ``hops``: HeMMPlans or dicts with ``sigma_scale`` / ``tau_scale`` /
    ``eps_scales`` / ``omega_scales``.  Each hop's weight is taken as
    freshly encrypted at the hop's input level with ``scale``."""
    t = ScaleTracker(moduli, program="chain")
    state = CtState(level, scale)
    hop_states = []
    for h, hop in enumerate(hops):
        state = t.hemm(state, CtState(state.level, scale),
                       **_hop_scales(hop), stage=f"hop[{h}]")
        hop_states.append(state)
    return dataclasses.replace(t.trace(), hop_states=tuple(hop_states))


def max_chain_depth(moduli: Sequence[float], hop, *, level: int,
                    scale: float) -> int:
    """The largest k such that a k-hop chain of ``hop`` (HeMMPlan or dict
    of scales) traces cleanly from ``(level, scale)``: the provable chain
    depth of a parameter set (``level // 3`` for a standard plan, proved
    through the tracker rather than assumed)."""
    depth = 0
    while depth <= len(moduli):
        if not trace_chain(moduli, [hop] * (depth + 1), level=level,
                           scale=scale).ok:
            return depth
        depth += 1
    return depth
