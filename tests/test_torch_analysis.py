"""The port's static verifier (``repro_torch.analysis``) against the JAX
reference's (``repro.analysis``) on the CPU.

Each case of the reference's ``tests/test_analysis.py`` runs on both
packages, on ``FAME_VERIFY_SETS`` with keys from one numpy seed, and the
port's diagnostics (rule, severity, program, stage) must equal the
reference's — except the two jaxpr-linter cases (JX rules), whose pass is
not ported, and the sharded schedules, which the port does not have.
The reference programs are compiled, never executed; the port's run on
``device="cpu"`` (the kernels' plain versions).  Level and scale are
compared exactly.  The serving cache of the reference's verify-mode case
is not in the port: its memo keys are held to the same rule here.
"""
import dataclasses
import types
import warnings

import numpy as np
import pytest

import repro  # noqa: F401
import repro.analysis as janalysis
import repro.configs.fame_sets as jfs
from repro.analysis.diagnostics import RULES as J_RULES
from repro.core.ckks import CkksEngine as JEngine
from repro.core.compile import HEContext as JContext
from repro.core.compile import compile_blockmm as j_compile_blockmm
from repro.core.compile import compile_hemm as j_compile_hemm
from repro.core.compile import compile_hlt as j_compile_hlt
from repro.core.hemm import plan_hemm as j_plan_hemm

from repro_torch.analysis import (RULES, CtState, Diagnostic, ScaleTracker,
                                  VerificationError, VerificationWarning,
                                  max_chain_depth, trace_chain, trace_hemm,
                                  verify_program)
from repro_torch.analysis import verify as verify_mod
from repro_torch.analysis.diagnostics import errors
from repro_torch.analysis.smem import stage_footprints
from repro_torch.configs.fame_sets import FAME_CHAIN_SETS, FAME_VERIFY_SETS
from repro_torch.core import costmodel
from repro_torch.core.ckks import CkksEngine
from repro_torch.core.compile import (HEContext, compile_blockmm, compile_hemm,
                                      compile_hlt)
from repro_torch.core.hemm import encrypt_matrix, plan_hemm
from repro_torch.core.params import SET_A, SET_B, SET_C
from repro_torch.kernels import basechange, fused_hlt
from test_torch_common import CPU

SCHEDULES = ("mo", "hoisted", "pallas")
SHAPE = (4, 3, 5)
#: the hemm shapes the tracker is held to execution on
TRACKER_SHAPES = (SHAPE, (1, 4, 2), (3, 2, 4), (2, 1, 3))
_CACHE: dict = {}


def _key(diags) -> list:
    return [(d.rule, d.severity, d.program, d.stage) for d in diags]


def _setup(name: str) -> dict:
    """Per verify set: the reference's context and plan, and the port's
    with keys over every tracker shape too, both verify="error" (keygen
    once a module)."""
    if name not in _CACHE:
        jctx = JContext(JEngine(jfs.FAME_VERIFY_SETS[name]), verify="error")
        jplan = j_plan_hemm(jctx.eng, *SHAPE)
        jctx.keygen(np.random.default_rng(0), rot_steps=jplan.rot_steps)
        ctx = HEContext(CkksEngine(FAME_VERIFY_SETS[name], device=CPU),
                        verify="error")
        plans = {sh: plan_hemm(ctx.eng, *sh) for sh in TRACKER_SHAPES}
        steps = set().union(*(p.rot_steps for p in plans.values()))
        ctx.keygen(np.random.default_rng(0), rot_steps=tuple(sorted(steps)))
        _CACHE[name] = dict(jctx=jctx, jplan=jplan, ctx=ctx,
                            plan=plans[SHAPE], plans=plans)
    return _CACHE[name]


# ---------------------------------------------------------------- acceptance

@pytest.mark.parametrize("name", sorted(FAME_VERIFY_SETS))
@pytest.mark.parametrize("schedule", SCHEDULES)
def test_verify_error_passes_every_schedule(name, schedule):
    """verify="error" admits every schedule the port has, and a full
    verification afterwards (components too) finds what the reference's
    finds on its program: no error."""
    s = _setup(name)
    prog = compile_hemm(s["ctx"], s["plan"], schedule=schedule)
    jprog = j_compile_hemm(s["jctx"], s["jplan"], schedule=schedule)
    diags = verify_program(prog)
    assert _key(diags) == _key(janalysis.verify_program(jprog))
    assert not errors(diags)


@pytest.mark.parametrize("name", sorted(FAME_VERIFY_SETS))
def test_verify_error_passes_blockmm_with_hints(name):
    """Block MM with aliasing hints (a shared A row, a shared B column)."""
    s = _setup(name)
    gm, gl, gn = grid = (2, 2, 2)
    hints = dict(a_slots=[k for _ in range(gm) for k in range(gl)],
                 b_slots=[k for k in range(gl) for _ in range(gn)])
    prog = compile_blockmm(s["ctx"], s["plan"], grid, schedule="pallas",
                           **hints)
    jprog = j_compile_blockmm(s["jctx"], s["jplan"], grid, schedule="pallas",
                              **hints)
    diags = verify_program(prog)
    assert _key(diags) == _key(janalysis.verify_program(jprog))
    assert not errors(diags)


# ------------------------------------------------- tracker vs real execution

@pytest.mark.parametrize("name", sorted(FAME_VERIFY_SETS))
@pytest.mark.parametrize("shape", TRACKER_SHAPES)
def test_tracker_matches_execution_exactly(name, shape):
    """The tracker's (level, scale) after a hemm equals the executed
    program's output exactly, and equals the reference tracker's on the
    same scales."""
    s = _setup(name)
    ctx = s["ctx"]
    params = ctx.eng.params
    plan = s["plans"][shape]
    m, l, n = shape
    rng = np.random.default_rng(m * 16 + l * 4 + n)
    ctA = encrypt_matrix(ctx.eng, ctx.keys, rng.uniform(-1, 1, (m, l)), rng)
    ctB = encrypt_matrix(ctx.eng, ctx.keys, rng.uniform(-1, 1, (l, n)), rng)
    out = compile_hemm(ctx, plan, schedule="mo")(ctA, ctB)
    scales = dict(sigma_scale=plan.ds_sigma.scale,
                  tau_scale=plan.ds_tau.scale,
                  eps_scales=[d.scale for d in plan.ds_eps],
                  omega_scales=[d.scale for d in plan.ds_omega])
    tr = trace_hemm(ctx.eng.ctx.moduli_host, level=params.L,
                    scale_a=ctA.scale, scale_b=ctB.scale, **scales)
    jtr = janalysis.trace_hemm(s["jctx"].eng.ctx.moduli_host, level=params.L,
                               scale_a=ctA.scale, scale_b=ctB.scale, **scales)
    assert tr.ok
    assert (out.level, out.scale) == (tr.out.level, tr.out.scale) == \
        (jtr.out.level, jtr.out.scale)          # exact, deliberately


@pytest.mark.parametrize("name", sorted({**FAME_VERIFY_SETS,
                                         **FAME_CHAIN_SETS}))
def test_trace_chain_and_max_depth_equal_reference(name):
    """``trace_chain`` (every step and diagnostic) and ``max_chain_depth``
    equal the reference's on every verify and chain set, for chains of 1
    to L//3 + 2 hops of the same scales."""
    params = {**FAME_VERIFY_SETS, **FAME_CHAIN_SETS}[name]
    jparams = {**jfs.FAME_VERIFY_SETS, **jfs.FAME_CHAIN_SETS}[name]
    moduli = CkksEngine(params, device=CPU).ctx.moduli_host
    assert tuple(moduli) == tuple(JEngine(jparams).ctx.moduli_host)
    hop = dict(sigma_scale=params.scale, tau_scale=params.scale,
               eps_scales=[params.scale] * 2, omega_scales=[params.scale] * 2)
    for k in range(1, params.L // 3 + 3):
        tr = trace_chain(moduli, [hop] * k, level=params.L,
                         scale=params.scale)
        jtr = janalysis.trace_chain(moduli, [hop] * k, level=params.L,
                                    scale=params.scale)
        assert [(t.op, t.stage, t.level, t.scale) for t in tr.steps] == \
            [(t.op, t.stage, t.level, t.scale) for t in jtr.steps]
        assert _key(tr.diagnostics) == _key(jtr.diagnostics)
        assert [(h.level, h.scale) for h in tr.hop_states] == \
            [(h.level, h.scale) for h in jtr.hop_states]
        assert tr.ok == jtr.ok == (k <= params.L // 3)
    assert max_chain_depth(moduli, hop, level=params.L, scale=params.scale) \
        == janalysis.max_chain_depth(moduli, hop, level=params.L,
                                     scale=params.scale) == params.L // 3


# ----------------------------------------------------------------- rejection

def test_chain_trace_flags_underflow():
    """One hemm hop fits L = 4, four do not, and the trace says where."""
    s = _setup("fame-s-rt")
    moduli, p = s["ctx"].eng.ctx.moduli_host, s["ctx"].eng.params
    ok = trace_chain(moduli, [s["plan"]], level=p.L, scale=p.scale)
    assert ok.ok and ok.out.level == p.L - 3
    bad = trace_chain(moduli, [s["plan"]] * 4, level=p.L, scale=p.scale)
    jbad = janalysis.trace_chain(s["jctx"].eng.ctx.moduli_host,
                                 [s["jplan"]] * 4, level=p.L, scale=p.scale)
    assert not bad.ok
    assert _key(bad.diagnostics) == _key(jbad.diagnostics)
    assert {d.rule for d in bad.diagnostics} <= {"LS001", "LS003"}


def test_compile_rejects_level_underflow():
    """A hemm at level 2 cannot pay depth 3: VerificationError at compile,
    the reference's diagnostics, and nothing memoized under that level."""
    s = _setup("fame-s-rt")
    with pytest.raises(VerificationError) as ei:
        compile_hemm(s["ctx"], s["plan"], level=2, schedule="mo")
    with pytest.raises(janalysis.VerificationError) as jei:
        j_compile_hemm(s["jctx"], s["jplan"], level=2, schedule="mo")
    assert _key(ei.value.diagnostics) == _key(jei.value.diagnostics)
    assert {d.rule for d in ei.value.diagnostics} & {"LS001", "LS003"}
    # hemm memo key: (tag, plan, schedule, level, chunk, batched, verify)
    assert not any(k[0] == "hemm" and k[3] == 2 for k in s["ctx"]._compiled)


def test_warn_mode_warns_and_compiles():
    """verify="warn" on the same program warns but returns it."""
    s = _setup("fame-s-rt")
    wctx = HEContext(s["ctx"].eng, keys=s["ctx"].keys, verify="warn")
    with pytest.warns(VerificationWarning):
        prog = compile_hemm(wctx, s["plan"], level=2, schedule="mo")
    assert prog is not None


def test_compile_rejects_over_budget_smem():
    """VM001, the twin of the reference's over-budget VMEM case: a context
    allowing 1e-6 of a block's shared memory admits no fused launch.  The
    cost model then picks "mo", and a forced "pallas" fails at compile
    with the reference's diagnostic."""
    s = _setup("fame-s-rt")
    p = s["ctx"].eng.params
    tight = HEContext(s["ctx"].eng, keys=s["ctx"].keys, smem_headroom=1e-6,
                      verify="error")
    with pytest.raises(VerificationError) as ei:
        compile_hlt(tight, s["plan"].ds_sigma, level=p.L, schedule="pallas",
                    rotation_chunk=4)
    jtight = JContext(s["jctx"].eng, keys=s["jctx"].keys, vmem_headroom=1e-6,
                      verify="error")
    with pytest.raises(janalysis.VerificationError) as jei:
        j_compile_hlt(jtight, s["jplan"].ds_sigma, level=p.L,
                      schedule="pallas", rotation_chunk=4)
    assert _key(ei.value.diagnostics) == _key(jei.value.diagnostics)
    assert {d.rule for d in ei.value.diagnostics} == {"VM001"}
    assert "level=4" in ei.value.diagnostics[0].message
    assert compile_hlt(tight, s["plan"].ds_sigma).plan.schedule == "mo"
    assert compile_hemm(tight, s["plan"]).plan.schedule == "mo"


def test_stale_generation_flagged():
    """AR001: after ``invalidate()`` every program compiled before is
    verifiably stale (a batched "pallas" HLT: the reference's case runs
    its sharded one, which the port does not have)."""
    s = _setup("fame-s-rt")
    ctx = HEContext(s["ctx"].eng, verify="error")
    plan = plan_hemm(ctx.eng, *SHAPE)
    ctx.keygen(np.random.default_rng(2), rot_steps=plan.rot_steps)
    run = compile_hlt(ctx, [plan.ds_sigma, plan.ds_tau], schedule="pallas",
                      ct_slots=(0, 1))
    assert not errors(verify_program(run))
    ctx.invalidate()
    assert {d.rule for d in verify_program(run)} == {"AR001"}


def test_malformed_slot_table_flagged():
    """AR002: a batched "pallas" HLT whose slot table no longer matches
    its plan or its stacked operands, or whose hint is not canonical."""
    s = _setup("fame-s-rt")
    ctx, plan = s["ctx"], s["plan"]
    run = compile_hlt(ctx, [plan.ds_sigma, plan.ds_tau, plan.ds_sigma],
                      schedule="pallas", ct_slots=(0, 1, 0))
    assert not verify_program(run)
    good = run._diag_slots
    bad = types.SimpleNamespace(**vars(run))
    for tab in (good[[1, 0, 1]], good + 5, good.float(), good[:2]):
        bad._diag_slots = tab
        assert {d.rule for d in verify_mod.verify_compiled_hlt(bad)} == \
            {"AR002"}
    bad._diag_slots = good
    bad._operands = tuple(t[:1] for t in run._operands)
    assert "stacked" in verify_mod.verify_compiled_hlt(bad)[0].message
    bad._operands = run._operands
    bad.plan = dataclasses.replace(run.plan, ct_slots=(1, 0, 1))
    diags = verify_mod.verify_compiled_hlt(bad)
    assert {d.rule for d in diags} == {"AR002"}
    assert "canonical" in diags[0].message


def test_diagnostic_rules_are_cataloged():
    """The port's catalog has the reference's rule ids, JX included; an
    unknown rule is refused."""
    assert RULES == J_RULES
    with pytest.raises(ValueError, match="XX999"):
        Diagnostic(rule="XX999", severity="error", program="p", stage="s",
                   message="m")


def test_scale_mismatch_add_flagged():
    """LS002: adding ciphertexts whose scales drifted apart."""
    t = ScaleTracker([2.0**26] * 5, program="test")
    t.add(CtState(2, 2.0**26), CtState(2, 2.0**27), stage="acc")
    jt = janalysis.ScaleTracker([2.0**26] * 5, program="test")
    jt.add(janalysis.CtState(2, 2.0**26), janalysis.CtState(2, 2.0**27),
           stage="acc")
    assert _key(t.diagnostics) == _key(jt.diagnostics)
    assert {d.rule for d in t.diagnostics} == {"LS002"}


# ------------------------------------------------------------- memo key

def test_compile_memo_keys_on_verify_mode():
    """Flipping ``ctx.verify`` never returns a program compiled under other
    checking: every memo key carries the mode."""
    s = _setup("fame-s-rt")
    ctx, plan = s["ctx"], s["plan"]
    p1 = compile_hemm(ctx, plan, schedule="mo")
    try:
        ctx.verify = "off"
        p2 = compile_hemm(ctx, plan, schedule="mo")
        assert p2 is not p1
        assert compile_hemm(ctx, plan, schedule="mo") is p2
    finally:
        ctx.verify = "error"
    assert compile_hemm(ctx, plan, schedule="mo") is p1
    modes = {k[6] for k in ctx._compiled if k[0] == "hemm"}
    assert modes == {"error", "off"}
    assert all("error" in k or "off" in k for k in ctx._compiled)


def test_warn_never_breaks_on_verifier_crash(monkeypatch):
    """VF000: a crashing pass becomes a warning under "warn" (the compile
    survives) and propagates under "error"."""
    s = _setup("fame-s-rt")

    def boom(prog, *, components=True):
        raise RuntimeError("pass exploded")

    monkeypatch.setattr(verify_mod, "verify_program", boom)
    wctx = HEContext(s["ctx"].eng, keys=s["ctx"].keys, verify="warn")
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        prog = compile_hemm(wctx, plan_hemm(wctx.eng, *SHAPE), schedule="mo")
    assert prog is not None
    assert any("VF000" in str(w.message) for w in rec)
    ectx = HEContext(s["ctx"].eng, keys=s["ctx"].keys, verify="error")
    with pytest.raises(RuntimeError, match="pass exploded"):
        compile_hemm(ectx, plan_hemm(ectx.eng, *SHAPE), schedule="mo")


def test_verify_modes_and_default_as_reference():
    s = _setup("fame-s-rt")
    assert HEContext.VERIFY_MODES == JContext.VERIFY_MODES
    assert HEContext(s["ctx"].eng).verify == "warn" == \
        JContext(s["jctx"].eng).verify
    with pytest.raises(ValueError, match="verify"):
        HEContext(s["ctx"].eng, verify="loud")


# ------------------------------------------------- the shared-memory pass

@pytest.mark.parametrize("name", sorted(FAME_VERIFY_SETS))
def test_smem_pass_reads_the_launch_formulas(name):
    """The VM pass's per-stage footprints are the formulas the launches
    allocate by (``fused_hlt.smem_bytes`` at the limb group of the padded
    d, ``basechange.hoist_smem_bytes`` over the unique inputs,
    ``moddown_smem_bytes`` over the batch's 2·B polynomials; the
    ``.cu`` side is held in ``test_torch_costmodel.py``)."""
    s = _setup(name)
    ctx, plan = s["ctx"], s["plan"]
    P = ctx.eng.params
    prog = compile_hemm(ctx, plan, schedule="pallas")
    for run in (prog._step1, prog._step2):
        hp = run.plan
        M = hp.level + 1 + P.k
        assert stage_footprints(P, hp) == {
            "rot": fused_hlt.smem_bytes(
                hp.nbeta, P.N, fused_hlt.limb_group(M, hp.d_pad)),
            "hoist": basechange.hoist_smem_bytes(
                hp.n_ct_slots, hp.nbeta, hp.level + 1, M, P.N),
            "moddown": basechange.moddown_smem_bytes(
                2 * hp.batch, P.k + 1, hp.level, P.N)}
    xctx = HEContext(ctx.eng, keys=ctx.keys, datapath="xla")
    xplan = compile_hlt(xctx, plan.ds_sigma, schedule="pallas").plan
    assert set(stage_footprints(P, xplan)) == {"rot"}


def test_smem_pass_clean_at_full_size_compile_points():
    """At headroom 1.0 every fused stage of the Set-A/B/C hemm steps, the
    Set-B block MM and the Set-B chain's hops fits a block's 227 KB, as
    ``fused_kernels_accept`` says of those sets; the largest is the split
    row kernels' 65 KB at logN 16."""
    worst = 0
    for P, (m, l), hops in ((SET_A, (64, 64), 1), (SET_B, (128, 128), 3),
                            (SET_B, (64, 64), 1), (SET_C, (32, 32), 1)):
        assert costmodel.fused_kernels_accept(P)
        for h in range(hops):
            lvl = P.L - 3 * h
            for level, batch, d, uniq in ((lvl, 2, 2 * m - 1, 2),
                                          (lvl - 1, 2 * l, 2, 2),
                                          (lvl - 1, 8 * l, 2, 8)):
                nbeta = len(P.digits_at_level(level))
                hp = types.SimpleNamespace(
                    nbeta=nbeta, d_pad=d, level=level, batch=batch,
                    n_ct_slots=uniq, datapath="pallas")
                worst = max(worst, *stage_footprints(P, hp).values())
    assert worst == 4 * (2 * 8192 + 256) <= costmodel.SMEM_PER_BLOCK


def test_lint_cli_passes_on_cpu(capsys):
    from repro_torch.analysis import lint
    assert lint.main(["--device", "cpu", "--sets", "fame-s-rt",
                      "--chain", "3"]) == 0
    out = capsys.readouterr().out
    assert "all programs verified clean" in out
    assert "1 hop(s) fit L=4" in out
