"""The hemm API with the cost model's defaults, the deprecated ``hemm()``
shim and the paper's §VI-A baselines, against the JAX reference on
``fame-s-rt``, hemm 4×2×3.

``compile_hemm(ctx, plan)`` and ``compile_hlt`` with no schedule, level or
chunk are array-equal to the reference's defaults (the reference's
``"pallas"`` program, Pallas in interpret mode, run once; its compiled
Step 1 is called again for the HLTs).  The chunks may differ: the port
picks no d-padding, the reference its VMEM chunk, and padding rotations
add nothing.  At the reference's chunk the plans agree field for field.  The
four ``hemm_baseline`` runs decrypt exactly as the reference's, from the
same seeds; the port runs on ``device="cpu"``.
"""
import numpy as np
import pytest

import repro  # noqa: F401
import repro.configs.fame_sets as jfs
import repro.core.hemm as jhemm
from repro.core.ckks import CkksEngine as JEngine
from repro.core.compile import HEContext as JContext
from repro.core.compile import compile_hemm as j_compile_hemm

from repro_torch.configs.fame_sets import FAME_VERIFY_SETS
from repro_torch.core import hemm
from repro_torch.core.ckks import CkksEngine
from repro_torch.core.compile import HEContext, compile_hemm, compile_hlt
from test_torch_common import CPU, PLAN_FIELDS, assert_ct_equal

NAME, SHAPE, SEED = "fame-s-rt", (4, 2, 3), 11
BASELINES = ("e2dm-s", "e2dm-r", "huang", "hegmm-en")


@pytest.fixture(scope="module")
def s():
    m, l, n = SHAPE
    rng = np.random.default_rng(SEED)
    jctx = JContext(JEngine(jfs.FAME_VERIFY_SETS[NAME]))
    jplan = jhemm.plan_hemm(jctx.eng, m, l, n)
    jctx.keygen(rng, rot_steps=jplan.rot_steps)
    A, B = rng.uniform(-1, 1, (m, l)), rng.uniform(-1, 1, (l, n))
    jA = jhemm.encrypt_matrix(jctx.eng, jctx.keys, A, rng)
    jB = jhemm.encrypt_matrix(jctx.eng, jctx.keys, B, rng)
    jprog = j_compile_hemm(jctx, jplan)
    jC = jprog(jA, jB)

    rng = np.random.default_rng(SEED)
    ctx = HEContext(CkksEngine(FAME_VERIFY_SETS[NAME], device=CPU))
    plan = hemm.plan_hemm(ctx.eng, m, l, n)
    ctx.keygen(rng, rot_steps=plan.rot_steps)
    rng.uniform(-1, 1, (m, l)), rng.uniform(-1, 1, (l, n))
    tA = hemm.encrypt_matrix(ctx.eng, ctx.keys, A, rng)
    tB = hemm.encrypt_matrix(ctx.eng, ctx.keys, B, rng)
    return dict(A=A, B=B, jctx=jctx, jplan=jplan, jA=jA, jB=jB, jprog=jprog,
                jC=jC, ctx=ctx, plan=plan, tA=tA, tB=tB)


def test_default_compile_hemm_equals_reference_default(s):
    prog = compile_hemm(s["ctx"], s["plan"])
    assert (prog.plan.schedule, prog.plan.batched) == \
        (s["jprog"].plan.schedule, s["jprog"].plan.batched) == ("pallas", True)
    for st in (prog.plan.step1, prog.plan.step2):
        assert st.d_pad == max(st.d) == st.chunk
    assert_ct_equal(s["jC"], prog(s["tA"], s["tB"]))
    assert compile_hemm(s["ctx"], s["plan"]) is prog


def test_hemm_plan_equals_reference_at_its_chunk(s):
    jp = s["jprog"].plan
    # the reference picks each step's chunk (at most that step's d); one
    # explicit chunk reproduces both picks
    chunk = max(jp.step1.chunk, jp.step2.chunk)
    for st in (jp.step1, jp.step2):
        assert st.chunk in (chunk, max(st.d))
    tp = compile_hemm(s["ctx"], s["plan"], rotation_chunk=chunk).plan
    for name in ("m", "l", "n", "schedule", "level", "batched", "depth",
                 "rotations", "operand_bytes", "operand_bytes_naive",
                 "hoist_bytes", "hoist_bytes_naive", "collective_bytes"):
        assert getattr(tp, name) == getattr(jp, name), name
    for j, t in ((jp.step1, tp.step1), (jp.step2, tp.step2)):
        for name in PLAN_FIELDS:
            assert getattr(t, name) == getattr(j, name), name


def test_default_compile_hlt_equals_reference_step1(s):
    """Step 1 of the reference's default program, called again, against
    ``compile_hlt`` at the top level with no schedule or chunk: the
    batched σ/τ pair and the single σ HLT; ``mo`` with no chunk runs all
    d rotations a step."""
    ctx, plan = s["ctx"], s["plan"]
    want = s["jprog"]._step1([s["jA"], s["jB"]])
    run = compile_hlt(ctx, [plan.ds_sigma, plan.ds_tau], ct_slots=(0, 1))
    assert (run.plan.schedule, run.plan.level) == ("pallas", ctx.eng.params.L)
    assert run.plan.d_pad == max(run.plan.d)
    for w, g in zip(want, run([s["tA"], s["tB"]]), strict=True):
        assert_ct_equal(w, g)
    single = compile_hlt(ctx, plan.ds_sigma)
    assert single.plan.batch is None and single.plan.d_pad == plan.ds_sigma.d
    assert_ct_equal(want[0], single(s["tA"]))
    mo = compile_hlt(ctx, plan.ds_sigma, schedule="mo")
    assert mo.plan.chunk == plan.ds_sigma.d
    assert_ct_equal(want[0], mo(s["tA"]))
    # "sharded" with no mesh runs on one rank (n_model = 1), as the
    # reference's does
    sharded = compile_hlt(ctx, plan.ds_sigma, schedule="sharded")
    assert (sharded.plan.n_model, sharded.plan.n_ct) == (1, 1)
    assert_ct_equal(want[0], sharded(s["tA"]))


def test_hemm_shim_warns_and_matches(s):
    eng, keys = s["ctx"].eng, s["ctx"].keys
    want = compile_hemm(s["ctx"], s["plan"])(s["tA"], s["tB"])
    for kw in (dict(), dict(schedule=None), dict(schedule="pallas",
                                                 rotation_chunk=2)):
        with pytest.warns(DeprecationWarning, match="compile_hemm"):
            got = hemm.hemm(eng, s["tA"], s["tB"], s["plan"], keys, **kw)
        assert_ct_equal(want, got)
    assert_ct_equal(s["jC"], want)


@pytest.mark.parametrize("shape", [(4, 2, 3), (2, 3, 5), (5, 3, 2),
                                   (3, 3, 3)])
def test_baseline_spec_equals_reference(shape):
    for name in BASELINES:
        assert hemm.baseline_spec(name, *shape).__dict__ == \
            jhemm.baseline_spec(name, *shape).__dict__
    with pytest.raises(ValueError):
        hemm.baseline_spec("nope", *shape)


@pytest.mark.parametrize("name", BASELINES)
def test_hemm_baseline_equals_reference(s, name):
    A, B = s["A"], s["B"]
    jeng, eng = s["jctx"].eng, s["ctx"].eng
    want, jplan = jhemm.hemm_baseline(
        jeng, name, A, B,
        lambda steps: jeng.keygen(np.random.default_rng(1), rot_steps=steps),
        np.random.default_rng(2))
    got, plan = hemm.hemm_baseline(
        eng, name, A, B,
        lambda steps: eng.keygen(np.random.default_rng(1), rot_steps=steps),
        np.random.default_rng(2))
    assert (plan.m, plan.l, plan.n, plan.rot_steps) == \
        (jplan.m, jplan.l, jplan.n, jplan.rot_steps)
    assert got.shape == A.shape[:1] + B.shape[1:]
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got, A @ B, atol=0.05)
