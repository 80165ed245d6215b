"""The port's cost model (``repro_torch.core.costmodel``) against the JAX
reference's (``repro.core.costmodel``).

Every device-independent number is compared exactly on SET_A/B/C and
both verify sets: the paper word model, the port's ``"u32"`` model
against the reference's ``"tpu"`` (the same 4-byte words), Table I, the
diagonal counts and the byte arithmetic the plans and the serving layer
read.  ``chain_boundary_bytes`` carries the interconnect penalty, the one
device term among them, so it is compared with each package's penalty
divided out.  The schedule pick is "pallas" on every shipped set, as in
the reference.  The footprint helpers are held to the launch formulas in
the CUDA sources.  Last, the block-MM plan of the ragged 2×2×2 grid at an
explicit rotation chunk equals the reference's field for field, and its
output equals the reference's ``"pallas"`` BlockMMProgram (Pallas in
interpret mode, run once).
"""
import dataclasses
import math
import pathlib
import re

import numpy as np
import pytest

import repro  # noqa: F401
import repro.configs.fame_sets as jfs
import repro.core.costmodel as jcm
import repro.core.hemm as jhemm
import repro.core.params as jparams
from repro.core.compile import compile_blockmm as j_compile_blockmm
from repro.secure import SecureMatmulEngine as JEngine

from repro_torch.configs import fame_sets as fs
from repro_torch.core import costmodel as cm, hemm, params
from repro_torch.core.compile import compile_blockmm
from repro_torch.kernels import basechange, fused_hlt, ntt
from repro_torch.secure import SecureMatmulEngine
from test_torch_common import CHUNK, CPU, PLAN_FIELDS, assert_ct_equal

ROOT = pathlib.Path(__file__).resolve().parents[1]
SETS = {"set-a": (params.SET_A, jparams.SET_A),
        "set-b": (params.SET_B, jparams.SET_B),
        "set-c": (params.SET_C, jparams.SET_C),
        **{k: (fs.FAME_VERIFY_SETS[k], jfs.FAME_VERIFY_SETS[k])
           for k in fs.FAME_VERIFY_SETS}}
SHAPES = [(64, 64, 16), (128, 16, 128), (160, 160, 160), (4, 3, 5),
          (6, 4, 9), (5, 2, 3)]


@pytest.fixture(params=list(SETS))
def pair(request):
    p, jp = SETS[request.param]
    assert dataclasses.asdict(p) == dataclasses.asdict(jp)
    return p, jp


def test_paper_word_model_equals_reference(pair):
    p, jp = pair
    assert cm.report(p, "paper") == jcm.report(jp, "paper")
    c, j = cm.CostModel(p), jcm.CostModel(jp)
    for name in ("bytes_per_coeff", "b_limb", "m_keyswitch", "m_rot",
                 "m_hlt_s1", "m_hlt_s2", "m_hemm", "m_mo_hlt"):
        assert getattr(c, name) == getattr(j, name), name
    assert (c.b_ct(), c.b_evk(), c.b_ct(3)) == (j.b_ct(), j.b_evk(), j.b_ct(3))
    for sram in (0.5 * cm.MB, 7.6 * cm.MB, 64 * cm.MB):
        for d in (7, 255):
            assert c.baseline_hlt_traffic(d, sram) == \
                j.baseline_hlt_traffic(d, sram)
            assert c.mo_hlt_traffic(d, sram) == j.mo_hlt_traffic(d, sram)


def test_u32_word_model_equals_reference_tpu_model(pair):
    p, jp = pair
    got, want = cm.report(p, "u32"), jcm.report(jp, "tpu")
    assert got.pop("word_model") == "u32" and want.pop("word_model") == "tpu"
    assert got == want
    with pytest.raises(ValueError, match="word_model"):
        cm.CostModel(p, "tpu")


@pytest.mark.parametrize("shape", SHAPES)
def test_table1_and_diagonal_counts_equal_reference(shape):
    assert hemm.diag_count_formulas(*shape) == jhemm.diag_count_formulas(*shape)
    assert hemm.diag_count_exact(*shape) == jhemm.diag_count_exact(*shape)
    for p, jp in SETS.values():
        assert cm.CostModel(p).table1_counts(*shape) == \
            jcm.CostModel(jp).table1_counts(*shape)


def test_byte_arithmetic_equals_reference(pair):
    p, jp = pair
    for nbeta in (None, 1, p.beta):
        for m_ext in (None, p.L + p.k):
            assert cm.hlt_hoist_bytes(p, nbeta, m_ext) == \
                jcm.hlt_hoist_bytes(jp, nbeta, m_ext)
            for d in (1, 7, 255):
                assert cm.hlt_operand_bytes(
                    p, d=d, nbeta=nbeta, n_limbs_ext=m_ext) == \
                    jcm.hlt_operand_bytes(jp, d=d, nbeta=nbeta,
                                          n_limbs_ext=m_ext)
    for n_model in (1, 2, 4):
        for ctb in (1, 8):
            assert cm.sharded_collective_bytes(p, n_model=n_model, ctb=ctb) \
                == jcm.sharded_collective_bytes(jp, n_model=n_model, ctb=ctb)
    for kw in (dict(d=7, d_pad=8, nbeta=2, chunk=2, n_limbs_ext=p.L + p.k),
               dict(d=255, d_pad=255, nbeta=p.beta, chunk=255,
                    n_limbs_ext=p.L + p.k + 1, ctb=16, n_hoist=2),
               dict(d=3, d_pad=4, nbeta=1, chunk=4, n_limbs_ext=5,
                    n_model=2, ctb=4)):
        assert cm.hlt_stage_costs(p, **kw) == jcm.hlt_stage_costs(jp, **kw)
    kw = dict(n_calls=3, n_tiles=12, n_uniq_tiles=7, launches=2,
              launches_naive=24)
    assert cm.serve_amortization(p, **kw) == jcm.serve_amortization(jp, **kw)
    for level in (None, 2):
        got = cm.chain_boundary_bytes(p, level=level) / cm.ICI_PENALTY
        want = jcm.chain_boundary_bytes(jp, level=level) / jcm.ICI_PENALTY
        assert math.isclose(got, want, rel_tol=1e-15)


def test_one_device_terms_and_schedule_pick_equal_reference(pair):
    p, jp = pair
    kw = dict(nbeta=p.beta, d=2 * 16 - 1, ctb=32, n_uniq=2, n_model=1,
              n_ct=1)
    assert cm._hlt_device_costs(p, **kw) == jcm._hlt_device_costs(jp, **kw)
    for sel in (dict(), dict(d=255, ctb=256, n_uniq=2), dict(nbeta=1)):
        assert cm.select_schedule(p, **sel) == \
            jcm.select_schedule(jp, **sel) == "pallas"
    hops = [dict(d=7, ctb=8, n_uniq=2, nbeta=p.beta, level=p.L),
            dict(d=15, ctb=16, n_uniq=2, level=p.L - 3),
            dict(d=3, ctb=4, n_uniq=2, nbeta=1, level=p.L - 6)]
    assert cm.select_chain_schedules(p, hops) == \
        jcm.select_chain_schedules(jp, hops) == ("pallas",) * 3
    # what every compile on the port sees: no padding, and a footprint
    # within one block's shared memory
    assert cm.pick_rotation_chunk(255) == 255
    stages = cm.fused_stage_working_sets(p, nbeta=p.beta)
    assert 0 < max(stages.values()) <= cm.SMEM_PER_BLOCK


def test_schedule_pick_leaves_the_kernels_where_they_refuse():
    big = params.HEParams("logN17", logN=17, L=4, k=2, beta=2)
    assert not cm.fused_kernels_accept(big)
    assert cm.select_schedule(big) == "mo"
    assert cm.select_chain_schedules(big, [dict(d=3)]) == ("mo",)
    # a budget below the rotation kernel's footprint at one limb a block
    small = fused_hlt.smem_bytes(params.SET_B.beta, params.SET_B.N, 1) - 4
    assert not cm.fused_kernels_accept(params.SET_B, smem_bytes=small)
    assert cm.select_schedule(params.SET_B, smem_bytes=small) == "mo"
    assert cm.select_schedule(params.SET_B, smem_bytes=small + 4) == "pallas"


def _cuda_expr(path: str, pattern: str) -> str:
    text = (ROOT / "src/repro_torch/csrc" / path).read_text()
    found = re.search(pattern, text, re.S)
    assert found, f"{path}: {pattern}"
    return found.group(1)


def test_footprint_helpers_equal_the_launch_formulas():
    """``fused_hlt.smem_bytes`` and ``basechange.split_smem_bytes`` against
    the expressions the CUDA launches allocate, read from the sources."""
    rows = _cuda_expr("fused_hlt.cu", r"int stage_rows\(int nbeta\) \{\s*"
                      r"return ([^;]+);")
    smem = _cuda_expr("fused_hlt.cu", r"const size_t smem =\s*"
                      r"sizeof\(uint32_t\) \* ([^;]+);")
    split = _cuda_expr("common.cuh", r"split_smem_bytes\(int n\) \{\s*"
                       r"return sizeof\(uint32_t\) \* ([^;]+);")
    assert rows == "3 * nbeta + 2"
    for logN in (6, 7, 13, 15, 16):
        N = 1 << logN
        T = min(256, N)
        for nbeta in (1, 2, 3, 5):
            for g in (1, 2, 4, 8):
                want = 4 * eval(smem.replace("static_cast<size_t>(g)", "g")
                                .replace("stage_rows(nbeta)", f"({rows})"),
                                {"g": g, "nbeta": nbeta, "T": T})
                assert fused_hlt.smem_bytes(nbeta, N, g) == want
        for r in (1, 8, 36, 4608):
            n = N // ntt.cluster_size(r, N)
            want = 4 * eval(split.replace("static_cast<size_t>", ""),
                            {"n": n})
            assert basechange.split_smem_bytes(r, N) == want == \
                4 * (2 * n + (n >> 5))
    # the stages at Set-B's Step 1: one hoisted ciphertext, two polynomials
    p = params.SET_B
    stages = cm.fused_stage_working_sets(p, nbeta=2, d=255)
    assert stages == {"rot": fused_hlt.smem_bytes(2, p.N, 2),
                      "hoist": basechange.split_smem_bytes(16, p.N),
                      "moddown": basechange.split_smem_bytes(18, p.N)}


# ---------------------------------------------------------------------------
# the block-MM plan, and the one run of the reference's "pallas" program
# ---------------------------------------------------------------------------


NAME, TILE, SEED = "fame-s-rt", 4, 17
A_SHAPE, B_SHAPE = (6, 5), (5, 7)
GRID = (2, 2, 2)


@pytest.fixture(scope="module")
def blockmm():
    rng = np.random.default_rng(SEED)
    je = JEngine(jfs.FAME_VERIFY_SETS[NAME], tile=TILE)
    je.keygen(rng)
    A, B = rng.uniform(-1, 1, A_SHAPE), rng.uniform(-1, 1, B_SHAPE)
    jAt, jBt = je.encrypt_tiles(A, rng), je.encrypt_tiles(B, rng)
    jprog = j_compile_blockmm(je.ctx, je._plan, GRID, schedule="pallas",
                              rotation_chunk=CHUNK)
    rng = np.random.default_rng(SEED)
    te = SecureMatmulEngine(fs.FAME_VERIFY_SETS[NAME], tile=TILE, device=CPU)
    te.keygen(rng)
    rng.uniform(-1, 1, A_SHAPE), rng.uniform(-1, 1, B_SHAPE)
    tAt, tBt = te.encrypt_tiles(A, rng), te.encrypt_tiles(B, rng)
    prog = compile_blockmm(te.ctx, te._plan, GRID, schedule="pallas",
                           rotation_chunk=CHUNK)
    return dict(jprog=jprog, jAt=jAt, jBt=jBt, prog=prog, tAt=tAt, tBt=tBt)


def test_blockmm_plan_equals_reference_at_explicit_chunk(blockmm):
    jp, tp = blockmm["jprog"].plan, blockmm["prog"].plan
    for name in ("m", "l", "n", "grid", "schedule", "level", "depth",
                 "hlt_launches", "hlt_launches_naive", "rotations",
                 "operand_bytes", "operand_bytes_naive", "hoist_bytes",
                 "hoist_bytes_naive", "collective_bytes"):
        assert getattr(tp, name) == getattr(jp, name), name
    for j, t in ((jp.step1, tp.step1), (jp.step2, tp.step2)):
        for name in PLAN_FIELDS:
            assert getattr(t, name) == getattr(j, name), name
    assert (tp.hlt_launches, tp.hlt_launches_naive) == (2, 16)


def test_blockmm_pallas_output_equals_reference_pallas_program(blockmm):
    want = blockmm["jprog"](blockmm["jAt"], blockmm["jBt"])
    got = blockmm["prog"](blockmm["tAt"], blockmm["tBt"])
    for i in range(GRID[0]):
        for j in range(GRID[2]):
            assert_ct_equal(want[i][j], got[i][j])
