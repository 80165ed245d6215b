"""The port's single-ciphertext HLT path against the reference, both verify
sets: ``baseconv_ntt`` and ``fused_hlt`` (plain versions vs the Pallas
kernels in interpret mode), the single hoist, a single-DiagSet
``compile_hlt`` fed the reference's keys and hoisting products, and the
non-batched hemm (``compile_hemm(..., batched=False)``) on the port's
``"pallas"`` engine against the reference's non-batched hemm and the
port's batched one.  Exact equality throughout; the only tolerance is the
final decrypt (0.05, the reference tests')."""
import numpy as np
import pytest
import torch

import repro  # noqa: F401
import repro.configs.fame_sets as jfs
from repro.core import automorph as jauto
from repro.core.ckks import CkksEngine as JEngine
from repro.core.compile import HEContext as JContext
from repro.core.compile import compile_hemm as j_compile_hemm
from repro.core.compile import compile_hlt as j_compile_hlt
from repro.core.hemm import encrypt_matrix as j_encrypt_matrix
from repro.core.hemm import plan_hemm as j_plan_hemm
from repro.core.hlt import hoist as j_hoist
from repro.kernels import basechange as jbc, fused_hlt as jfh

from repro_torch import convert
from repro_torch.configs.fame_sets import FAME_VERIFY_SETS
from repro_torch.core.ckks import CkksEngine
from repro_torch.core.compile import HEContext, compile_hemm, compile_hlt
from repro_torch.core.hemm import decrypt_matrix, encrypt_matrix, plan_hemm
from repro_torch.core.hlt import hoist, hoist_batched
from repro_torch.kernels import basechange as bc, fused_hlt as fh, ops
from test_torch_common import CHUNK, CPU, assert_ct_equal, u32

SHAPE, SEED = (4, 4, 4), 12
STAGES = ["start", "step1", "step2_hoist", "step2", "mult_rescale"]


def _rand(rng, moduli, shape):
    qs = np.asarray(moduli, np.uint64)[:, None]
    return rng.integers(0, qs, shape).astype(np.uint32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.uint32).view(np.int32))


def _port_tabs(jt: dict) -> dict:
    return bc.to_device({k: np.asarray(v) if hasattr(v, "shape") else v
                         for k, v in jt.items()}, CPU)


def _assert_hoisted_equal(jh, h):
    np.testing.assert_array_equal(u32(h.digits), u32(jh.digits))
    np.testing.assert_array_equal(u32(h.c0_ext), u32(jh.c0_ext))
    np.testing.assert_array_equal(u32(h.c1_ext), u32(jh.c1_ext))
    assert (h.level, h.scale) == (jh.level, jh.scale)


@pytest.fixture(scope="module", params=list(FAME_VERIFY_SETS))
def s(request):
    """Reference non-batched hemm (default engine, as its own tests pin it
    bit-identical to the "pallas" engine); the port's same-seed keys on
    the "pallas" engine, its batched and non-batched programs."""
    name = request.param
    m, l, n = SHAPE
    rng = np.random.default_rng(SEED)
    jctx = JContext(JEngine(jfs.FAME_VERIFY_SETS[name]))
    jplan = j_plan_hemm(jctx.eng, m, l, n)
    jctx.keygen(rng, rot_steps=jplan.rot_steps)
    A, B = rng.uniform(-1, 1, (m, l)), rng.uniform(-1, 1, (l, n))
    jA = j_encrypt_matrix(jctx.eng, jctx.keys, A, rng)
    jB = j_encrypt_matrix(jctx.eng, jctx.keys, B, rng)
    jprog = j_compile_hemm(jctx, jplan, schedule="pallas",
                           rotation_chunk=CHUNK, batched=False)
    jC = jprog(jA, jB)

    rng = np.random.default_rng(SEED)
    ctx = HEContext(CkksEngine(FAME_VERIFY_SETS[name], device=CPU,
                               datapath="pallas"))
    plan = plan_hemm(ctx.eng, m, l, n)
    ctx.keygen(rng, rot_steps=plan.rot_steps)
    rng.uniform(-1, 1, (m, l)), rng.uniform(-1, 1, (l, n))
    tA = encrypt_matrix(ctx.eng, ctx.keys, A, rng)
    tB = encrypt_matrix(ctx.eng, ctx.keys, B, rng)
    prog = compile_hemm(ctx, plan, schedule="pallas", rotation_chunk=CHUNK,
                        batched=False)
    marks = []
    prog.stage_hook = marks.append
    c0 = dict(ctx.counters)
    tC = prog(tA, tB)
    c1 = dict(ctx.counters)
    prog.stage_hook = None
    bprog = compile_hemm(ctx, plan, schedule="pallas", rotation_chunk=CHUNK)
    return dict(name=name, A=A, B=B, jctx=jctx, jplan=jplan, jprog=jprog,
                jA=jA, jB=jB, jC=jC, ctx=ctx, plan=plan, prog=prog,
                bprog=bprog, tA=tA, tB=tB, tC=tC, marks=marks,
                counters=(c0, c1))


# -- kernels ------------------------------------------------------------------


@pytest.mark.parametrize("drop", [0, 1])
def test_baseconv_ntt_plain_matches_reference(s, drop):
    """On the reference's hoist tables; one of the two levels per set has
    a short last digit, whose zero-padded y rows and passthrough rows are
    covered."""
    jeng, eng = s["jctx"].eng, s["ctx"].eng
    level = eng.params.L - drop
    jt = jeng.fused_hoist_tables(level)
    t = _port_tabs(jt)
    rng = np.random.default_rng(60 + drop)
    nq, R = level + 1, t["psii_pad"].shape[0]
    M = t["psi_full"].shape[0]
    y = np.zeros((R, eng.params.N), np.uint32)
    for j in range(t["nbeta"]):
        rows = range(j * t["alpha"], min((j + 1) * t["alpha"], nq))
        y[list(rows)] = _rand(rng, np.asarray(t["q_pad"])[list(rows), 0],
                              (len(rows), eng.params.N))
    pt = np.zeros((M, eng.params.N), np.uint32)
    pt[:nq] = _rand(rng, eng.ctx.moduli_host[:nq], (nq, eng.params.N))
    want = np.asarray(jbc.baseconv_ntt(
        y, jt["w"], jt["d"], jt["inv_d"], jt["psi_full"], jt["q_full"],
        jt["qneg_full"], pt, jt["mask"], interpret=True))
    got = ops.baseconv_ntt(_t(y), t["w"], t["d"], t["inv_d"], t["psi_full"],
                           t["q_full"], t["qneg_full"], _t(pt), t["mask"])
    assert got.shape == (t["nbeta"], M, eng.params.N)
    np.testing.assert_array_equal(u32(got), want)


def test_fused_hlt_plain_matches_reference(s):
    """d = 5 real rotations (one z = 0) padded to 6 for chunk 2 with
    identity / zero / is_id entries, as the compile pads them."""
    eng, jeng = s["ctx"].eng, s["jctx"].eng
    p = eng.params
    N = p.N
    full = eng.tools.digit_bases(p.L)[0][2]
    qs = [eng.ctx.moduli_host[i] for i in full]
    M, nbeta = len(full), len(eng.tools.digit_bases(p.L))
    zs, d, d_pad = (3, 0, -1, 5, 2), 5, 6
    rng = np.random.default_rng(61)

    def limbs(*lead):
        return _rand(rng, qs, lead + (M, N))

    perms = np.tile(np.arange(N, dtype=np.int32), (d_pad, 1))
    is_id = np.ones((d_pad, 1), np.int32)
    for r, z in enumerate(zs):
        if z:
            perms[r] = jauto.eval_perm(N, jauto.galois_elt_rot(z, N))
        is_id[r, 0] = int(z == 0)
    digits, c0e, c1e = limbs(nbeta), limbs(), limbs()
    u = limbs(d_pad)
    rk0, rk1 = limbs(d_pad, nbeta), limbs(d_pad, nbeta)
    u[d:], rk0[d:], rk1[d:] = 0, 0, 0
    jv, tv = jeng.basis(full), eng.basis(full)
    j0, j1 = jfh.fused_hlt(digits, c0e, c1e, u, rk0, rk1, perms, is_id,
                           jv.moduli_u32, jv.qneg_inv, chunk=2, interpret=True)
    args = (_t(digits), _t(c0e), _t(c1e), _t(u), _t(rk0), _t(rk1),
            torch.from_numpy(perms), torch.from_numpy(is_id))
    got = ops.fused_hlt(*args, tv.moduli_u32, tv.qneg_inv)
    assert got.shape == (2, M, N)
    a0, a1 = got
    np.testing.assert_array_equal(u32(a0), np.asarray(j0))
    np.testing.assert_array_equal(u32(a1), np.asarray(j1))
    # the padding contributes nothing, and the single form is the indexed
    # one at slots (0, 0)
    unpadded = fh.fused_hlt_plain(
        _t(digits), _t(c0e), _t(c1e), _t(u[:d]), _t(rk0[:d]), _t(rk1[:d]),
        torch.from_numpy(perms[:d].copy()), torch.from_numpy(is_id[:d].copy()),
        tv.moduli_u32, tv.qneg_inv)
    assert torch.equal(got, unpadded)
    zero = torch.zeros((1,), dtype=torch.int32)
    idx = fh.fused_hlt_indexed_plain(*[a[None] for a in args], zero, zero,
                                     tv.moduli_u32, tv.qneg_inv)
    assert torch.equal(got, idx[:, 0])


def test_single_cuda_wrappers_refuse_cpu_tensors():
    x = torch.zeros((2, 1, 64), dtype=torch.int32)
    col = torch.zeros((1, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        fh.fused_hlt_cuda(x, x[0], x[0], x, x[:, None], x[:, None],
                          x[:, 0], col, col, col)
    with pytest.raises(ValueError, match="CUDA"):
        bc.baseconv_ntt_cuda(x[:, 0], x[:, :, :1], x[:, :, :1],
                             x.to(torch.float64), x[0], col, col, x[0],
                             x[:, :, :1])


# -- hoist --------------------------------------------------------------------


@pytest.mark.parametrize("drop", [0, 1])
def test_hoist_matches_reference_and_batched_hoist(s, drop):
    """The single hoist (intt_scale + baseconv_ntt) against the reference's
    fused single hoist, and against the port's batched hoist (hoist_db) of
    the same ciphertext; a one-ciphertext hoist_batched is the single
    hoist."""
    jctx, eng = s["jctx"], s["ctx"].eng
    level = eng.params.L - drop
    rng = np.random.default_rng(62 + drop)
    jct = jctx.eng.encrypt(jctx.eng.encode(rng.uniform(-1, 1, 8), level=level),
                           jctx.keys, rng)
    ct = convert.ciphertext(jct, CPU)
    h = hoist(eng, ct)
    _assert_hoisted_equal(j_hoist(jctx.eng, jct, datapath="pallas"), h)
    _assert_hoisted_equal(h, hoist_batched(eng, [ct])[0])
    _assert_hoisted_equal(h, hoist_batched(eng, [ct, ct])[0])


# -- single compile_hlt ---------------------------------------------------------


def test_single_compile_hlt_matches_reference(s):
    """σ(A) as a single-DiagSet compile on the reference's keys, fed the
    reference's own hoisting product, and fed the ciphertext (the compile
    hoists it itself)."""
    jctx, jplan, jA = s["jctx"], s["jplan"], s["jA"]
    level = jA.level
    jrun = j_compile_hlt(jctx, jplan.ds_sigma, level=level, schedule="pallas",
                         rotation_chunk=CHUNK)
    jh = j_hoist(jctx.eng, jA, datapath="pallas")
    want = jrun(jh)
    cctx = HEContext(CkksEngine(s["ctx"].eng.params, device=CPU),
                     keys=convert.keys(jctx.keys, CPU))
    ds = convert.diagset(jplan.ds_sigma, CPU)
    run = compile_hlt(cctx, ds, level=level, schedule="pallas",
                      rotation_chunk=CHUNK)
    assert run.plan.batch is None and jrun.plan.batch is None
    assert (run.plan.d, run.plan.d_pad, run.plan.chunk, run.plan.nbeta) == \
        (jrun.plan.d, jrun.plan.d_pad, jrun.plan.chunk, jrun.plan.nbeta)
    assert run.plan.operand_bytes == jrun.plan.operand_bytes
    assert compile_hlt(cctx, ds, level=level, schedule="pallas",
                       rotation_chunk=CHUNK) is run
    n0 = cctx.counters["hlt_launches"]
    got = run(convert.hoisted(jh, CPU))
    assert cctx.counters["hlt_launches"] == n0 + 1
    assert_ct_equal(want, got)
    assert_ct_equal(want, run(convert.ciphertext(jA, CPU)))
    assert cctx.counters["hlt_launches"] == n0 + 2
    # the single compile reads the DiagSet's arena slot; a batched compile
    # of the same set shares it and gives the same residues
    assert len(cctx.arena) == 1
    brun = compile_hlt(cctx, [ds], level=level, schedule="pallas",
                       rotation_chunk=CHUNK)
    assert brun is not run and len(cctx.arena) == 1
    (bout,) = brun([convert.hoisted(jh, CPU)])
    assert_ct_equal(want, bout)
    with pytest.raises(ValueError, match="level"):
        run(cctx.eng.rescale(convert.ciphertext(jA, CPU)))


# -- non-batched hemm ---------------------------------------------------------


def test_unbatched_hemm_matches_reference_unbatched(s):
    assert_ct_equal(s["jC"], s["tC"])


def test_unbatched_hemm_matches_batched_and_decrypts(s):
    m, _, n = SHAPE
    assert_ct_equal(s["jC"], s["bprog"](s["tA"], s["tB"]))
    got = decrypt_matrix(s["ctx"].eng, s["ctx"].keys, s["tC"], m, n)
    np.testing.assert_allclose(got, s["A"] @ s["B"], atol=0.05)


def test_unbatched_hemm_plan_counters_and_stages(s):
    prog, bprog, l = s["prog"], s["bprog"], SHAPE[1]
    c0, c1 = s["counters"]
    assert c1["hlt_launches"] - c0["hlt_launches"] == 2 + 2 * l
    assert c1["program_launches"] - c0["program_launches"] == 1
    assert s["marks"] == STAGES
    assert not prog.plan.batched and bprog.plan.batched
    assert bprog is not prog
    jp = s["jprog"].plan
    assert not jp.batched
    for j, t in ((jp.step1, prog.plan.step1), (jp.step2, prog.plan.step2)):
        assert (j.level, j.batch, j.nbeta, j.chunk, j.d, j.d_pad) == \
               (t.level, t.batch, t.nbeta, t.chunk, t.d, t.d_pad)
        assert j.operand_bytes == t.operand_bytes
    # one arena slot per (DiagSet, d_pad): a single compile pads d for its
    # own set, a batched one to the batch's largest d
    runs = [*prog._step1, *prog._step2, bprog._step1, bprog._step2]
    assert len(s["ctx"].arena) == len({(id(ds), r.plan.d_pad)
                                       for r in runs for ds in r._diags})
    marks = []
    bprog.stage_hook = marks.append
    n0 = s["ctx"].counters["hlt_launches"]
    bprog(s["tA"], s["tB"])
    bprog.stage_hook = None
    assert marks == STAGES and s["ctx"].counters["hlt_launches"] == n0 + 2
