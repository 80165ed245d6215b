"""Verifier orchestration: run every applicable pass on a compiled program
and enforce the context's ``verify`` mode — counterpart of
``repro/analysis/verify.py``.

``verify_program(prog)`` is the entry point for an already compiled
program (the lint CLI and the tests call it); ``enforce(ctx, prog)`` is
the hook ``compile_hlt`` / ``compile_hemm`` / ``compile_blockmm`` /
``compile_hemm_chain`` run before they store a program in the memo.
Under ``verify="error"`` it raises :class:`VerificationError` on
error-severity findings; under ``"warn"`` it emits
:class:`VerificationWarning` warnings, and a crash of a pass becomes a
VF000 warning, so warn mode never breaks a working compile; ``"off"`` is
a no-op.

The passes: LS (``level_scale``), VM001 against a block's shared memory
(``smem``), AR (``arena``) and the census (``census``, JX001–JX004: the
counterpart of the reference's jaxpr linter, one run of the compiled
body on zero ciphertexts).  A program the earlier passes found in error
(stale, or with a malformed slot table) is not run by the census.
"""
from __future__ import annotations

import warnings

from repro_torch.analysis import arena, census, smem
from repro_torch.analysis.diagnostics import (Diagnostic, VerificationError,
                                              VerificationWarning, errors)
from repro_torch.analysis.level_scale import (CtState, ScaleTracker,
                                              _hop_scales, trace_chain)


def _moduli(ctx):
    return ctx.eng.ctx.moduli_host


def verify_compiled_hlt(run, *, program: str = "hlt") -> list:
    """Every pass over one CompiledHLT."""
    diags = arena.check_generation(run, program=program)
    if diags:
        return diags        # stale: its operands no longer exist
    ctx, plan = run.ctx, run.plan
    t = ScaleTracker(_moduli(ctx), program=program)
    scale = ctx.eng.params.scale
    for b, ds in enumerate(run._diags):
        t.hlt(CtState(plan.level, scale), ds.scale, stage=f"hlt[{b}]")
    diags += t.diagnostics
    diags += smem.check_smem(ctx.eng.params, plan, program=program)
    diags += arena.audit_hlt(run, program=program)
    if not errors(diags):
        diags += census.lint_compiled_hlt(run, program=program)
    return diags


def _component_hlts(step):
    """A program's step is one CompiledHLT (batched) or a tuple of them."""
    return step if isinstance(step, tuple) else (step,)


def verify_hemm(prog, *, components: bool = True) -> list:
    """The whole-program level/scale trace of an HEMMProgram, plus its
    component HLTs' passes when ``components`` (a compile skips them: each
    ``compile_hlt`` enforced itself)."""
    diags = arena.check_generation(prog, program="hemm")
    if diags:
        return diags
    scale = prog.ctx.eng.params.scale
    t = ScaleTracker(_moduli(prog.ctx), program="hemm")
    t.hemm(CtState(prog.plan.level, scale), CtState(prog.plan.level, scale),
           **_hop_scales(prog.mm_plan), stage="hemm")
    diags += t.diagnostics
    if components:
        for step in (prog._step1, prog._step2):
            for run in _component_hlts(step):
                diags += verify_compiled_hlt(run, program="hemm")
    return diags


def verify_blockmm(prog, *, components: bool = True) -> list:
    """The whole-program trace of a BlockMMProgram: each output tile adds
    ``gl`` products per k (``add_fanin``)."""
    diags = arena.check_generation(prog, program="blockmm")
    if diags:
        return diags
    scale = prog.ctx.eng.params.scale
    _, gl, _ = prog.plan.grid
    t = ScaleTracker(_moduli(prog.ctx), program="blockmm")
    t.hemm(CtState(prog.plan.level, scale), CtState(prog.plan.level, scale),
           **_hop_scales(prog.mm_plan), add_fanin=gl, stage="blockmm")
    diags += t.diagnostics
    if components:
        for run in (prog._step1, prog._step2):
            diags += verify_compiled_hlt(run, program="blockmm")
    return diags


def verify_chain(prog, *, components: bool = True) -> list:
    """The whole-chain trace of an HEMMChainProgram (one ``trace_chain``
    over the hop plans, an explicit re-pack's σ included, from the chain's
    input level), plus each hop's HEMMProgram passes when
    ``components``."""
    diags = arena.check_generation(prog, program="chain")
    if diags:
        return diags
    tr = trace_chain(_moduli(prog.ctx), [hp.mm_plan for hp in prog._hops],
                     level=prog.plan.level, scale=prog.ctx.eng.params.scale)
    diags += list(tr.diagnostics)
    if components:
        for hp in prog._hops:
            diags += verify_hemm(hp, components=True)
    return diags


def verify_program(prog, *, components: bool = True) -> list:
    """Dispatch on the compiled program's type; returns every finding."""
    from repro_torch.core import compile as compile_mod
    if isinstance(prog, compile_mod.CompiledHLT):
        return verify_compiled_hlt(prog)
    if isinstance(prog, compile_mod.HEMMProgram):
        return verify_hemm(prog, components=components)
    if isinstance(prog, compile_mod.BlockMMProgram):
        return verify_blockmm(prog, components=components)
    if isinstance(prog, compile_mod.HEMMChainProgram):
        return verify_chain(prog, components=components)
    raise TypeError(f"not a compiled HE program: {type(prog).__name__}")


def enforce(ctx, prog) -> list:
    """The compile-time hook honouring ``ctx.verify`` (module docstring).
    Program-level compiles skip re-verifying components: each inner
    ``compile_hlt`` enforced itself on the way."""
    mode = ctx.verify
    if mode == "off":
        return []
    try:
        diags = verify_program(prog, components=False)
    except VerificationError:
        raise
    except Exception as e:                            # noqa: BLE001
        if mode == "error":
            raise
        diags = [Diagnostic(
            rule="VF000", severity="warning", program="verify",
            stage="internal",
            message=f"verifier pass crashed: {type(e).__name__}: {e}",
            hint="report/fix the verifier; compile continued unchecked")]
    if mode == "error" and errors(diags):
        raise VerificationError(diags)
    for d in diags:
        if d.severity != "info":    # info findings surface through the CLI
            warnings.warn(str(d), VerificationWarning, stacklevel=3)
    return diags
