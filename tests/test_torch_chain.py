"""Chains of hemm hops, Y = X·W1·…·Wk with no decrypt between them: the
port's ``plan_hemm_chain`` / ``compile_hemm_chain`` / ``SecureLinear(chain=)``
against the JAX reference on the CPU.

Inputs come from numpy seeds.  Each chain set has one reference engine
and context (its keys carried to the port by ``repro_torch.convert``);
the reference runs each chain on its ``"hoisted"`` schedule, its cheapest
on the CPU, and its ciphertexts are converted and fed to the port's chain
on the cost model's ``"pallas"``; the port's ``"mo"`` and ``"pallas"``
chains, on both context datapaths, equal it too.
A depth-2 chain is the first two hops of the depth-3 one with the same
inputs; the reference runs it as a chain of its own through the same
memoized hop programs.  Tolerance: c0, c1 array-equal, (level, scale)
exactly equal, at every hop; decrypted within 5e-4 of numpy (the
reference tests' bound).
"""
import numpy as np
import pytest

import repro  # noqa: F401
import repro.configs.fame_sets as jfs
from repro.analysis import VerificationError as JVerificationError
from repro.analysis import max_chain_depth as j_max_chain_depth
from repro.core.ckks import CkksEngine as JEngine
from repro.core.compile import HEContext as JContext
from repro.core.compile import compile_hemm_chain as j_compile_hemm_chain
from repro.core.hemm import encrypt_matrix as j_encrypt_matrix
from repro.core.hemm import plan_hemm_chain as j_plan_hemm_chain
from repro.secure import SecureLinear as JLinear
from repro.secure import SecureMatmulEngine as JMatmulEngine

from repro_torch import convert
from repro_torch.analysis import VerificationError, max_chain_depth, trace_chain
from repro_torch.configs.fame_sets import FAME_CHAIN_SETS, FAME_VERIFY_SETS
from repro_torch.core.ckks import CkksEngine
from repro_torch.core.compile import (HEContext, compile_hemm,
                                      compile_hemm_chain)
from repro_torch.core.hemm import (decrypt_matrix, encrypt_matrix,
                                   plan_hemm_chain)
from repro_torch.secure import SecureLinear, SecureMatmulEngine
from test_torch_common import CPU, assert_ct_equal

TOL = 5e-4
#: the depth-3 chains the reference runs, per chain set
CHAINS = {"fame-s-chain": [(3, 3, 3, 3, 3)],
          "fame-m-chain": [(4, 4, 4, 4, 4), (6, 5, 7, 4, 3)]}
_CACHE: dict = {}


def _data(dims, rng):
    """Bounded inputs, so the deep products stay well inside q0."""
    X = rng.uniform(-0.5, 0.5, dims[:2])
    Ws = [rng.uniform(-0.5, 0.5, (dims[h + 1], dims[h + 2]))
          for h in range(len(dims) - 2)]
    return X, Ws


def _set(name: str) -> dict:
    """One reference context per chain set, keyed once over every chain
    of ``CHAINS``, and the port's context on the same keys."""
    if name not in _CACHE:
        jctx = JContext(JEngine(jfs.FAME_CHAIN_SETS[name]), verify="error",
                        datapath="xla")
        steps = set()
        for dims in CHAINS[name]:
            steps |= set(j_plan_hemm_chain(jctx.eng, dims).rot_steps)
        jctx.keygen(np.random.default_rng(0), rot_steps=tuple(sorted(steps)))
        ctx = HEContext(CkksEngine(FAME_CHAIN_SETS[name], device=CPU),
                        convert.keys(jctx.keys, CPU), verify="error")
        _CACHE[name] = dict(jctx=jctx, ctx=ctx, runs={})
    return _CACHE[name]


def _ref_run(name: str, dims: tuple) -> dict:
    """The reference's chain on ``dims`` (depth 3, and its depth-2
    prefix), with the inputs converted for the port."""
    s = _set(name)
    if dims not in s["runs"]:
        jctx = s["jctx"]
        rng = np.random.default_rng(sum(dims))
        X, Ws = _data(dims, rng)
        jprog = j_compile_hemm_chain(
            jctx, j_plan_hemm_chain(jctx.eng, dims), schedule="hoisted")
        jX = j_encrypt_matrix(jctx.eng, jctx.keys, X, rng)
        jW = jprog.encrypt_weights(Ws, rng)
        jprog2 = j_compile_hemm_chain(
            jctx, j_plan_hemm_chain(jctx.eng, dims[:4]), schedule="hoisted")
        s["runs"][dims] = dict(
            X=X, Ws=Ws, jplans={3: jprog.plan, 2: jprog2.plan},
            jouts={3: jprog.run_hops(jX, jW), 2: jprog2.run_hops(jX, jW[:2])},
            tX=convert.ciphertext(jX, CPU),
            tW=[convert.ciphertext(w, CPU) for w in jW])
    return s["runs"][dims]


def _check_hops(outs, jouts, plan, jplan):
    assert len(outs) == len(jouts) == plan.k
    assert [(st.level, st.scale) for st in plan.hop_out] == \
        [(st.level, st.scale) for st in jplan.hop_out]
    assert plan.hop_levels == jplan.hop_levels
    for out, jout, st in zip(outs, jouts, plan.hop_out, strict=True):
        assert_ct_equal(jout, out)
        assert (out.level, out.scale) == (st.level, st.scale)


@pytest.mark.parametrize("name,dims,depth", [
    ("fame-s-chain", (3, 3, 3, 3, 3), 2),
    ("fame-s-chain", (3, 3, 3, 3, 3), 3),
    ("fame-m-chain", (4, 4, 4, 4, 4), 2),
    ("fame-m-chain", (4, 4, 4, 4, 4), 3),
    ("fame-m-chain", (6, 5, 7, 4, 3), 2),
    ("fame-m-chain", (6, 5, 7, 4, 3), 3)])
def test_chain_equals_reference_at_every_hop(name, dims, depth):
    """The port's chain (cost model: "pallas" on every hop) against the
    reference's, hop by hop: c0/c1 array-equal, (level, scale) equal to
    the reference's and to ``plan.hop_out``; no decrypt inside the call;
    the output decrypts within 5e-4 of numpy."""
    r, ctx = _ref_run(name, dims), _set(name)["ctx"]
    chain = plan_hemm_chain(ctx.eng, dims[:depth + 2])
    prog = compile_hemm_chain(ctx, chain)
    assert prog.plan.schedules == ("pallas",) * depth
    d0 = ctx.eng.op_counts["decrypts"]
    outs = prog.run_hops(r["tX"], r["tW"][:depth])
    assert ctx.eng.op_counts["decrypts"] == d0
    _check_hops(outs, r["jouts"][depth], prog.plan, r["jplans"][depth])
    L = ctx.eng.params.L
    assert prog.plan.hop_levels == tuple(L - 3 * h for h in range(depth))
    assert prog.plan.out_level == L - 3 * depth == outs[-1].level
    want = r["X"]
    for W in r["Ws"][:depth]:
        want = want @ W
    got = decrypt_matrix(ctx.eng, ctx.keys, outs[-1], dims[0], dims[depth + 1])
    assert np.abs(got - want).max() < TOL


def test_chain_schedules_and_datapaths_equal_depth3():
    """fame-s-chain depth 3 on "pallas" (both context datapaths) and on the
    kernel-free "mo": every hop array-equal to the reference's."""
    name, dims = "fame-s-chain", (3, 3, 3, 3, 3)
    r, ctx = _ref_run(name, dims), _set(name)["ctx"]
    chain = plan_hemm_chain(ctx.eng, dims)
    xctx = HEContext(ctx.eng, ctx.keys, datapath="xla", verify="error")
    for c, schedule in ((ctx, None), (xctx, None), (xctx, "mo")):
        prog = compile_hemm_chain(c, chain, schedule=schedule)
        assert prog.plan.schedules == (schedule or "pallas",) * 3
        _check_hops(prog.run_hops(r["tX"], r["tW"]), r["jouts"][3],
                    prog.plan, r["jplans"][3])


@pytest.mark.parametrize("name", sorted(FAME_VERIFY_SETS))
def test_chain_rejected_on_shallow_sets_as_reference(name):
    """The verify sets (L = 4/5) prove one hop: a depth-2 chain raises
    VerificationError under "error", with the reference's diagnostics
    (rule, severity, program, stage; errors only LS001/LS003), and
    ValueError under "warn"; nothing is built or launched; one hop
    compiles."""
    jctx = JContext(JEngine(jfs.FAME_VERIFY_SETS[name]), verify="error")
    jchain = j_plan_hemm_chain(jctx.eng, (3, 3, 3, 3))
    jctx.keygen(np.random.default_rng(0), rot_steps=jchain.rot_steps)
    with pytest.raises(JVerificationError) as jei:
        j_compile_hemm_chain(jctx, jchain)

    ctx = HEContext(CkksEngine(FAME_VERIFY_SETS[name], device=CPU),
                    convert.keys(jctx.keys, CPU), verify="error")
    chain = plan_hemm_chain(ctx.eng, (3, 3, 3, 3))
    p = ctx.eng.params
    assert max_chain_depth(ctx.eng.ctx.moduli_host, chain.hops[0],
                           level=p.L, scale=p.scale) == 1 == \
        j_max_chain_depth(jctx.eng.ctx.moduli_host, jchain.hops[0],
                          level=p.L, scale=p.scale)
    before = (len(ctx.arena), dict(ctx.counters), len(ctx._compiled))
    with pytest.raises(VerificationError) as ei:
        compile_hemm_chain(ctx, chain)
    key = lambda d: (d.rule, d.severity, d.program, d.stage)  # noqa: E731
    assert [key(d) for d in ei.value.diagnostics] == \
        [key(d) for d in jei.value.diagnostics]
    assert {d.rule for d in ei.value.diagnostics
            if d.severity == "error"} <= {"LS001", "LS003"}
    ctx.verify = "warn"
    with pytest.raises(ValueError, match="needs input level"):
        compile_hemm_chain(ctx, chain)
    assert (len(ctx.arena), dict(ctx.counters), len(ctx._compiled)) == before
    ctx.verify = "error"
    assert compile_hemm(ctx, chain.hops[0]) is not None


def test_rejection_iff_trace_overflows():
    """Over depths 2–4 and input levels 0–9 on fame-s-chain: the compile
    raises exactly where ``trace_chain`` finds the chain too deep."""
    ctx = HEContext(CkksEngine(FAME_CHAIN_SETS["fame-s-chain"], device=CPU),
                    verify="error")
    chains = [plan_hemm_chain(ctx.eng, (2,) * (k + 2)) for k in (2, 3, 4)]
    ctx.keygen(np.random.default_rng(0), rot_steps=chains[-1].rot_steps)
    p = ctx.eng.params
    for chain in chains:
        for level in range(10):
            tr = trace_chain(ctx.eng.ctx.moduli_host, chain.hops,
                             level=level, scale=p.scale)
            assert tr.ok == (level >= 3 * chain.k)
            if tr.ok:
                prog = compile_hemm_chain(ctx, chain, level=level,
                                          schedule="mo")
                assert prog.plan.out_level == tr.out.level == \
                    level - 3 * chain.k
            else:
                with pytest.raises(VerificationError):
                    compile_hemm_chain(ctx, chain, level=level,
                                       schedule="mo")


def test_chain_launch_and_arena_accounting():
    """A k-hop chain: 2·k HLT launches, k+1 program launches, no decrypt
    and no encrypt; hops of one shape share a plan; a second compile is
    the memoized program and builds nothing; the explicit re-pack twin
    costs one arena slot a boundary and gives the same residues; Step 2
    stores 2 hoisting products a hop, not 2·l; a chain call leaves a
    stage hook set on a hop's shared program as it was."""
    ctx = HEContext(CkksEngine(FAME_CHAIN_SETS["fame-s-chain"], device=CPU),
                    verify="error")
    eng = ctx.eng
    chain = plan_hemm_chain(eng, (3, 3, 3, 3))
    assert chain.hops[0] is chain.hops[1]
    assert chain.repacks[0].window == 9
    np.testing.assert_array_equal(chain.repacks[0].matrix(), np.eye(9))
    ctx.keygen(np.random.default_rng(0), rot_steps=chain.rot_steps)
    prog = compile_hemm_chain(ctx, chain)
    slots = len(ctx.arena)
    assert slots > 0
    assert compile_hemm_chain(ctx, chain) is prog
    assert len(ctx.arena) == slots
    chain_x = plan_hemm_chain(eng, (3, 3, 3, 3), repack="explicit")
    assert chain_x.hops[1].ds_sigma is not chain.hops[1].ds_sigma
    prog_x = compile_hemm_chain(ctx, chain_x)
    assert len(ctx.arena) == slots + chain.k - 1

    rng = np.random.default_rng(41)
    X, Ws = _data(chain.dims, rng)
    ctX = encrypt_matrix(eng, ctx.keys, X, rng)
    w_cts = prog.encrypt_weights(Ws, rng)
    before = dict(ctx.counters)
    d0, e0 = eng.op_counts["decrypts"], eng.op_counts["encrypts"]
    # a hook on a hop's memoised HEMMProgram survives the chain's calls
    marks, hooked = [], prog._hops[0]
    hooked.stage_hook = marks.append
    prog.stage_hook = lambda h, name: None
    outs = prog.run_hops(ctX, w_cts)
    prog.stage_hook = None
    prog.run_hops(ctX, w_cts)
    assert hooked.stage_hook == marks.append and len(marks) > 0
    hooked.stage_hook = None
    assert ctx.counters["hlt_launches"] - before["hlt_launches"] == \
        2 * 2 * chain.k
    assert ctx.counters["program_launches"] - before["program_launches"] == \
        2 * (chain.k + 1)
    assert (eng.op_counts["decrypts"], eng.op_counts["encrypts"]) == (d0, e0)
    for a, b in zip(outs, prog_x.run_hops(ctX, w_cts), strict=True):
        assert_ct_equal(a, b)
    for hop in prog.plan.hops:
        assert hop.step2.hoist_bytes * hop.l == hop.step2.hoist_bytes_naive
    assert prog.plan.hop_bytes == tuple(h.operand_bytes
                                        for h in prog.plan.hops)
    assert prog.plan.collective_bytes == 0
    with pytest.raises(ValueError, match="level"):
        prog(ctX, w_cts[::-1])


def test_secure_linear_chain_equals_reference():
    """``SecureLinear(chain=(W2,), chain_rows=4)`` on fame-m-chain (the
    reference's MLP example: 4×5 · 5×6 · 6×3) from the same seeds as the
    reference layer: the same decrypted output, array-equal, within 1e-3
    of the plaintext (the example's bound); one decrypt a call.  The
    reference layer runs on the chain set's reference engine, in a
    context whose VMEM headroom sends its cost model to its kernel-free
    "mo" schedule (its own tests hold it array-equal to "pallas"), which
    keeps it cheap on the CPU."""
    rng = np.random.default_rng(1)
    W1, W2 = rng.uniform(-0.5, 0.5, (5, 6)), rng.uniform(-0.5, 0.5, (6, 3))
    x = rng.uniform(-0.5, 0.5, (4, 5))
    jeng = _set("fame-m-chain")["jctx"].eng
    je = JMatmulEngine(jeng.params, tile=4, ctx=JContext(
        jeng, verify="error", vmem_headroom=1e-9))
    jlayer = JLinear(je, W1, np.random.default_rng(2), chain=(W2,),
                     chain_rows=4)
    assert jlayer._chain_prog.plan.schedules == ("mo", "mo")
    want = jlayer(x, np.random.default_rng(3))

    te = SecureMatmulEngine(FAME_CHAIN_SETS["fame-m-chain"], tile=4,
                            device=CPU)
    layer = SecureLinear(te, W1, np.random.default_rng(2), chain=(W2,),
                         chain_rows=4)
    assert layer._chain_prog.plan.schedules == ("pallas", "pallas")
    d0 = te.eng.op_counts["decrypts"]
    got = layer(x, np.random.default_rng(3))
    assert te.eng.op_counts["decrypts"] - d0 == 1
    np.testing.assert_array_equal(got, want)
    assert np.abs(got - x @ W1 @ W2).max() < 1e-3
    np.testing.assert_array_equal(layer(x, None, secure=False), x @ W1 @ W2)
    with pytest.raises(ValueError, match="chain_rows"):
        SecureLinear(te, W1, np.random.default_rng(2), chain=(W2,))
