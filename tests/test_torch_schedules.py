"""The port's reference HLT schedules (``baseline``, ``hoisted``, ``mo``),
``HEContext(datapath="xla")`` and the engine operations they use, against
the JAX reference on both verify sets, with same-seed keys and with the
reference's keys carried across by ``repro_torch.convert``.

The same arithmetic runs on both sides, so every residue is compared
exactly: each schedule's ``compile_hlt`` and ``compile_hemm`` against the
reference's; ``mo``, ``hoisted`` and ``pallas`` against each other; the
``"xla"`` context's fused schedule against the reference's; ``sub``,
``cmult``, ``mod_drop``, ``rotate``, the merged ModDown, the hoist's chain
form and ``RnsTools.mod_down``/``rescale``.  The one tolerance is
``baseline`` against ``hoisted`` after decrypt, 1e-3, the reference
tests' (``baseline`` rescales once after its cmult terms, so it rounds
differently).
"""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest

import repro  # noqa: F401
import repro.configs.fame_sets as jfs
from repro.core.ckks import CkksEngine as JEngine
from repro.core.compile import HEContext as JContext
from repro.core.compile import compile_hemm as j_compile_hemm
from repro.core.compile import compile_hlt as j_compile_hlt
from repro.core.hemm import encrypt_matrix as j_encrypt_matrix
from repro.core.hemm import plan_hemm as j_plan_hemm
from repro.core.hlt import SCHEDULES as J_SCHEDULES
from repro.core.hlt import hoist as j_hoist

from repro_torch import convert
from repro_torch.configs.fame_sets import FAME_VERIFY_SETS
from repro_torch.core import hlt as hlt_mod
from repro_torch.core.ckks import CkksEngine, Plaintext
from repro_torch.core.compile import (SCHEDULES, HEContext, compile_hemm,
                                      compile_hlt)
from repro_torch.core.hemm import encrypt_matrix, plan_hemm
from repro_torch.core.hlt import hoist
from test_torch_common import CHUNK, CPU, assert_ct_equal, u32

SHAPE, SEED = (4, 2, 3), 21
REF_SCHEDULES = ("baseline", "hoisted", "mo")


@pytest.fixture(scope="module", params=list(FAME_VERIFY_SETS))
def s(request):
    """Reference context and inputs; the port's same-seed context (on the
    "pallas" engine) and a context holding the reference's keys."""
    name = request.param
    m, l, n = SHAPE
    rng = np.random.default_rng(SEED)
    jctx = JContext(JEngine(jfs.FAME_VERIFY_SETS[name]))
    jplan = j_plan_hemm(jctx.eng, m, l, n)
    jctx.keygen(rng, rot_steps=jplan.rot_steps)
    A, B = rng.uniform(-1, 1, (m, l)), rng.uniform(-1, 1, (l, n))
    jA = j_encrypt_matrix(jctx.eng, jctx.keys, A, rng)
    jB = j_encrypt_matrix(jctx.eng, jctx.keys, B, rng)

    rng = np.random.default_rng(SEED)
    ctx = HEContext(CkksEngine(FAME_VERIFY_SETS[name], device=CPU,
                               datapath="pallas"))
    plan = plan_hemm(ctx.eng, m, l, n)
    ctx.keygen(rng, rot_steps=plan.rot_steps)
    rng.uniform(-1, 1, (m, l)), rng.uniform(-1, 1, (l, n))
    tA = encrypt_matrix(ctx.eng, ctx.keys, A, rng)
    tB = encrypt_matrix(ctx.eng, ctx.keys, B, rng)

    cctx = HEContext(CkksEngine(FAME_VERIFY_SETS[name], device=CPU),
                     keys=convert.keys(jctx.keys, CPU))
    return dict(name=name, A=A, B=B, jctx=jctx, jplan=jplan, jA=jA, jB=jB,
                ctx=ctx, plan=plan, tA=tA, tB=tB, cctx=cctx,
                cplan=convert.hemm_plan(jplan, CPU),
                cA=convert.ciphertext(jA, CPU), cB=convert.ciphertext(jB, CPU),
                jhlt={}, thlt={})


def _hlts(s, schedule):
    """σ(A) on ``schedule``: the reference's, the port's same-seed one and
    the port's on the reference's keys (memoized per module)."""
    if schedule not in s["thlt"]:
        level = s["jA"].level
        s["jhlt"][schedule] = j_compile_hlt(
            s["jctx"], s["jplan"].ds_sigma, level=level, schedule=schedule,
            rotation_chunk=CHUNK)(s["jA"])
        s["thlt"][schedule] = (
            compile_hlt(s["ctx"], s["plan"].ds_sigma, level=level,
                        schedule=schedule, rotation_chunk=CHUNK)(s["tA"]),
            compile_hlt(s["cctx"], s["cplan"].ds_sigma, level=level,
                        schedule=schedule, rotation_chunk=CHUNK)(s["cA"]))
    return s["jhlt"][schedule], s["thlt"][schedule]


# -- single HLTs ----------------------------------------------------------------


@pytest.mark.parametrize("schedule", REF_SCHEDULES)
def test_compile_hlt_schedule_matches_reference(s, schedule):
    want, (got, carried) = _hlts(s, schedule)
    assert_ct_equal(want, got)
    assert_ct_equal(want, carried)


def _pallas_hlt(s):
    return compile_hlt(s["ctx"], s["plan"].ds_sigma, level=s["tA"].level,
                       schedule="pallas", rotation_chunk=CHUNK)(s["tA"])


def test_mo_hoisted_pallas_array_equal(s):
    """The three hoisting schedules are the same arithmetic; ``mo`` with one
    rotation a step and with all of them too."""
    (_, (hoisted, _)), (_, (mo, _)) = (_hlts(s, sch)
                                       for sch in ("hoisted", "mo"))
    pallas = _pallas_hlt(s)
    ctx, level = s["ctx"], s["tA"].level
    outs = [compile_hlt(ctx, s["plan"].ds_sigma, level=level, schedule="mo",
                        rotation_chunk=c)(s["tA"]) for c in (1, None)]
    for ct in (hoisted, mo, *outs):
        assert_ct_equal(pallas, ct)


def test_baseline_within_noise_of_hoisted(s):
    (_, (base, _)), (_, (hoisted, _)) = (_hlts(s, sch)
                                         for sch in ("baseline", "hoisted"))
    eng, keys = s["ctx"].eng, s["ctx"].keys
    vb = eng.decrypt_decode(base, keys).real
    vh = eng.decrypt_decode(hoisted, keys).real
    np.testing.assert_allclose(vb, vh, atol=1e-3)


def test_batched_reference_schedule_is_a_loop_of_singles(s):
    """A batched compile on a reference schedule runs each element as its
    single compile does (one launch counted for the batch)."""
    ctx, plan, level = s["ctx"], s["plan"], s["tA"].level
    run = compile_hlt(ctx, [plan.ds_sigma, plan.ds_tau], level=level,
                      schedule="mo", rotation_chunk=CHUNK)
    assert run.plan.datapath == "xla" and run.plan.operand_bytes == 0
    h0 = ctx.counters["hlt_launches"]
    outA, outB = run([s["tA"], s["tB"]])
    assert ctx.counters["hlt_launches"] == h0 + 1
    assert_ct_equal(_hlts(s, "mo")[1][0], outA)
    single = compile_hlt(ctx, plan.ds_tau, level=level, schedule="hoisted",
                         rotation_chunk=CHUNK)(s["tB"])
    assert_ct_equal(single, outB)


# -- HEContext(datapath="xla") ------------------------------------------------------


def test_xla_context_pallas_hlt_matches_reference(s):
    """The fused schedule with the hoist and merged ModDown on the chains
    (a single compile; the batched one runs in the "xla" hemm below),
    against the reference's "xla" context, and equal to the "pallas"
    context's output."""
    jctx, level = s["jctx"], s["jA"].level
    jx = JContext(jctx.eng, jctx.keys, datapath="xla")
    want = j_compile_hlt(jx, s["jplan"].ds_sigma, level=level,
                         schedule="pallas", rotation_chunk=CHUNK)(s["jA"])
    for ctx, plan, A in ((s["ctx"], s["plan"], s["tA"]),
                         (s["cctx"], s["cplan"], s["cA"])):
        x = HEContext(ctx.eng, ctx.keys, datapath="xla")
        run = compile_hlt(x, plan.ds_sigma, level=level, schedule="pallas",
                          rotation_chunk=CHUNK)
        assert run.plan.datapath == "xla"
        assert_ct_equal(want, run(A))
    assert_ct_equal(want, _pallas_hlt(s))


def test_context_datapath_is_checked():
    with pytest.raises(ValueError, match="datapath"):
        HEContext(CkksEngine(FAME_VERIFY_SETS["fame-s-rt"], device=CPU),
                  datapath="mo")
    # the reference's six, the multi-device pair included
    assert SCHEDULES == J_SCHEDULES == ("baseline", "hoisted", "mo",
                                        "pallas", "sharded", "sharded_xla")


# -- hemm on every schedule ---------------------------------------------------------


@pytest.fixture(scope="module")
def hemms(s):
    """One reference hemm per reference schedule, and the "xla" context's
    fused one (the reference's "pallas" hemm is held against the port's by
    ``test_torch_hemm_{s,m}.py``)."""
    jctx = s["jctx"]
    out = {sch: j_compile_hemm(jctx, s["jplan"], schedule=sch,
                               rotation_chunk=CHUNK)(s["jA"], s["jB"])
           for sch in REF_SCHEDULES}
    jx = JContext(jctx.eng, jctx.keys, datapath="xla")
    out["xla"] = j_compile_hemm(jx, s["jplan"], schedule="pallas",
                                rotation_chunk=CHUNK)(s["jA"], s["jB"])
    return out


@pytest.mark.parametrize("schedule", REF_SCHEDULES)
def test_compile_hemm_schedule_matches_reference(s, hemms, schedule):
    """Batched and not (``baseline`` is never batched), same-seed keys and
    carried keys: all array-equal to the reference's program."""
    want = hemms[schedule]
    for batched in (True, False):
        prog = compile_hemm(s["ctx"], s["plan"], schedule=schedule,
                            rotation_chunk=CHUNK, batched=batched)
        assert prog.plan.batched == (batched and schedule != "baseline")
        assert_ct_equal(want, prog(s["tA"], s["tB"]))
    carried = compile_hemm(s["cctx"], s["cplan"], schedule=schedule,
                           rotation_chunk=CHUNK)(s["cA"], s["cB"])
    assert_ct_equal(want, carried)


def test_compile_hemm_xla_context_matches_reference(s, hemms):
    """The fused schedule on an "xla" context against the reference's; the
    port's fused hemm on either context equal to the "mo" and "hoisted"
    hemms, as the reference's are."""
    x = HEContext(s["ctx"].eng, s["ctx"].keys, datapath="xla")
    got = compile_hemm(x, s["plan"], schedule="pallas",
                       rotation_chunk=CHUNK)(s["tA"], s["tB"])
    assert_ct_equal(hemms["xla"], got)
    fused = compile_hemm(s["ctx"], s["plan"], schedule="pallas",
                         rotation_chunk=CHUNK)(s["tA"], s["tB"])
    for want in (hemms["mo"], hemms["hoisted"], got):
        assert_ct_equal(want, fused)


# -- engine operations ------------------------------------------------------------


def test_engine_ops_match_reference(s):
    """sub, cmult, mod_drop and rotate, on the port's "pallas" engine (its
    keyswitch on the NTT kernels' plain versions) and on a fresh "xla"
    engine with the reference's keys."""
    jeng, jkeys = s["jctx"].eng, s["jctx"].keys
    jA, jB = s["jA"], s["jB"]
    pt = jeng.encode(np.linspace(-1, 1, 8), level=jA.level)
    step = s["jplan"].rot_steps[1]
    want = dict(sub=jeng.sub(jA, jB), cmult=jeng.cmult(jA, pt),
                drop=jeng.mod_drop(jA, jA.level - 2),
                rot=jeng.rotate(jA, step, jkeys))
    tpt = Plaintext(convert.u32(pt.data, CPU), pt.level, pt.scale)
    for eng, keys, A, B in ((s["ctx"].eng, s["ctx"].keys, s["tA"], s["tB"]),
                            (s["cctx"].eng, s["cctx"].keys, s["cA"], s["cB"])):
        got = dict(sub=eng.sub(A, B), cmult=eng.cmult(A, tpt),
                   drop=eng.mod_drop(A, A.level - 2),
                   rot=eng.rotate(A, step, keys))
        for k, w in want.items():
            assert_ct_equal(w, got[k])
    with pytest.raises(ValueError):
        s["ctx"].eng.cmult(s["tA"], Plaintext(tpt.data[:1], 0, pt.scale))


@pytest.mark.parametrize("drop_last", [False, True])
def test_mod_down_eval_matches_reference(s, drop_last):
    """The ModDown of both datapaths (``drop_last``: the merged
    ModDown+Rescale; on "pallas" the fused kernels' plain versions)."""
    jeng, eng = s["jctx"].eng, s["ctx"].eng
    ell = eng.params.L
    full = eng.tools.digit_bases(ell)[0][2]
    rng = np.random.default_rng(31 + drop_last)
    qs = np.asarray([eng.ctx.moduli_host[i] for i in full], np.uint64)[:, None]
    x = rng.integers(0, qs, (len(full), eng.params.N)).astype(np.uint32)
    want = jeng._mod_down_eval(jnp.asarray(x), ell, drop_last=drop_last)
    for dp in ("xla", "pallas"):
        got = eng._mod_down_eval(convert.u32(x, CPU), ell, drop_last=drop_last,
                                 datapath=dp)
        np.testing.assert_array_equal(u32(got), u32(want))


def test_rns_mod_down_and_rescale_match_reference(s):
    jt, t = s["jctx"].eng.tools, s["ctx"].eng.tools
    p = s["ctx"].eng.params
    ell = p.L
    rng = np.random.default_rng(33)
    Q = tuple(range(ell + 1))
    P = tuple(range(p.num_main, p.num_total))
    qs = np.asarray([t.ctx.moduli_host[i] for i in Q + P], np.uint64)[:, None]
    x = rng.integers(0, qs, (len(Q + P), p.N)).astype(np.uint32)
    xq, xp = x[:len(Q)], x[len(Q):]
    np.testing.assert_array_equal(
        u32(t.mod_down(convert.u32(xq, CPU), convert.u32(xp, CPU), P, Q)),
        u32(jt.mod_down(jnp.asarray(xq), jnp.asarray(xp), P, Q)))
    np.testing.assert_array_equal(u32(t.rescale(convert.u32(xq, CPU), ell)),
                                  u32(jt.rescale(jnp.asarray(xq), ell)))


def test_hoist_chain_matches_reference(s):
    """The hoist's "xla" form (the per-digit chain on the engine's
    transforms) equals the reference's and the fused hoist, single and
    batched."""
    jh = j_hoist(s["jctx"].eng, s["jA"], datapath="xla")
    eng = s["ctx"].eng
    h = hoist(eng, s["tA"], datapath="xla")
    hb = hlt_mod.hoist_batched(eng, [s["tA"], s["tB"]], datapath="xla")[0]
    for ours in (h, hb, hoist(eng, s["tA"], datapath="pallas")):
        np.testing.assert_array_equal(u32(ours.digits), u32(jh.digits))
        np.testing.assert_array_equal(u32(ours.c0_ext), u32(jh.c0_ext))
        np.testing.assert_array_equal(u32(ours.c1_ext), u32(jh.c1_ext))


# -- deprecated shims ---------------------------------------------------------------


def test_shims_warn_and_agree_with_compile_hlt(s):
    eng, keys, plan = s["ctx"].eng, s["ctx"].keys, s["plan"]
    with pytest.warns(DeprecationWarning, match="hlt\\(\\) is deprecated"):
        mo = hlt_mod.hlt(eng, s["tA"], plan.ds_sigma, keys, schedule="mo",
                         rotation_chunk=CHUNK)
    assert_ct_equal(_hlts(s, "mo")[1][0], mo)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        hst = hoist(eng, s["tA"])
        base = hlt_mod.hlt(eng, s["tA"], plan.ds_sigma, keys,
                           schedule="baseline", hoisted=hst)
    assert_ct_equal(_hlts(s, "baseline")[1][0], base)
    with pytest.warns(DeprecationWarning, match="hlt_batched"):
        outs = hlt_mod.hlt_batched(
            eng, [(s["tA"], plan.ds_sigma), (s["tB"], plan.ds_tau)], keys,
            rotation_chunk=CHUNK)
    want = compile_hlt(s["ctx"], [plan.ds_sigma, plan.ds_tau],
                       level=s["tA"].level, schedule="pallas",
                       rotation_chunk=CHUNK)([s["tA"], s["tB"]])
    for w, g in zip(want, outs, strict=True):
        assert_ct_equal(w, g)
