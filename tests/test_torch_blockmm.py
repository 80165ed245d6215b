"""Block MM over a tile grid: the port's ``compile_blockmm`` /
``BlockMMProgram``, ``SecureMatmulEngine`` and ``SecureLinear`` against the
JAX reference on ``fame-s-rt`` with tile 4 and A 6×5 @ B 5×7, a ragged
2×2×2 grid (every dimension padded).

The reference runs its kernel-free ``"mo"`` block MM (its engine built
with ``schedule="mo", batched=True``, the deprecated knob), once per
product; its ``"pallas"`` program is held against the port's in
``test_torch_costmodel.py``.  The port runs on ``device="cpu"``, the
kernels' plain versions, from the same numpy seeds.  Residues are
compared exactly (c0, c1, level, scale); decrypted products within 0.08
of A @ B (the reference tests' bound) and exactly against the
reference's decryption.
"""
import warnings

import numpy as np
import pytest

import repro  # noqa: F401
import repro.configs.fame_sets as jfs
from repro.core.compile import compile_blockmm as j_compile_blockmm
from repro.secure import SecureLinear as JLinear
from repro.secure import SecureMatmulEngine as JEngine

from repro_torch.configs.fame_sets import FAME_VERIFY_SETS
from repro_torch.core.compile import compile_blockmm
from repro_torch.secure import SecureLinear, SecureMatmulEngine
from test_torch_common import CPU, assert_ct_equal

NAME, TILE, SEED = "fame-s-rt", 4, 3
A_SHAPE, B_SHAPE = (6, 5), (5, 7)
GRID = (2, 2, 2)
TOL = 0.08


def _grid_equal(want, got):
    assert len(want) == len(got) == GRID[0]
    for wrow, grow in zip(want, got, strict=True):
        assert len(wrow) == len(grow) == GRID[2]
        for w, g in zip(wrow, grow, strict=True):
            assert_ct_equal(w, g)


@pytest.fixture(scope="module")
def s():
    rng = np.random.default_rng(SEED)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        je = JEngine(jfs.FAME_VERIFY_SETS[NAME], tile=TILE, schedule="mo",
                     batched=True)
    je.keygen(rng)
    A, B = rng.uniform(-1, 1, A_SHAPE), rng.uniform(-1, 1, B_SHAPE)
    jAt, jBt = je.encrypt_tiles(A, rng), je.encrypt_tiles(B, rng)
    jC = je.matmul_encrypted(jAt, jBt)

    rng = np.random.default_rng(SEED)
    te = SecureMatmulEngine(FAME_VERIFY_SETS[NAME], tile=TILE, device=CPU)
    te.keygen(rng)
    rng.uniform(-1, 1, A_SHAPE), rng.uniform(-1, 1, B_SHAPE)
    tAt, tBt = te.encrypt_tiles(A, rng), te.encrypt_tiles(B, rng)
    return dict(A=A, B=B, je=je, jAt=jAt, jBt=jBt, jC=jC, te=te, tAt=tAt,
                tBt=tBt)


def test_engine_defaults_to_the_cost_models_pick(s):
    te = s["te"]
    assert (te.schedule, te.batched) == ("pallas", True)
    assert te.eng.device.type == "cpu"
    assert len(s["tAt"]) == 2 and len(s["tAt"][0]) == 2
    for jrow, trow in zip(s["jAt"] + s["jBt"], s["tAt"] + s["tBt"],
                          strict=True):
        for j, t in zip(jrow, trow, strict=True):
            assert_ct_equal(j, t)


@pytest.mark.parametrize("schedule", ["pallas", "mo"])
def test_blockmm_equals_reference_mo(s, schedule):
    te = s["te"]
    prog = compile_blockmm(te.ctx, te._plan, GRID, schedule=schedule)
    c0 = dict(te.ctx.counters)
    got = prog(s["tAt"], s["tBt"])
    _grid_equal(s["jC"], got)
    assert te.ctx.counters["hlt_launches"] - c0["hlt_launches"] == 2
    assert te.ctx.counters["program_launches"] - c0["program_launches"] == 1
    assert compile_blockmm(te.ctx, te._plan, GRID, schedule=schedule) is prog


def test_default_compile_picks_pallas_without_padding(s):
    te = s["te"]
    prog = compile_blockmm(te.ctx, te._plan, GRID)
    plan = prog.plan
    assert plan.schedule == "pallas" and plan.grid == GRID
    assert plan.step1.d_pad == max(plan.step1.d) == plan.step1.chunk
    assert plan.step2.d_pad == max(plan.step2.d)
    nA, nB, l = 4, 4, TILE
    assert plan.step1.batch == nA + nB and plan.step1.n_diag_slots == 2
    assert plan.step2.batch == l * (nA + nB)
    assert plan.step2.n_diag_slots == 2 * l
    assert plan.step2.ct_slots == tuple(t for _ in range(l) for t in
                                        range(nA)) + \
        tuple(nA + t for _ in range(l) for t in range(nB))
    assert (plan.hlt_launches, plan.hlt_launches_naive) == (2, 16)
    _grid_equal(s["jC"], prog(s["tAt"], s["tBt"]))


def test_loop_equals_batched(s):
    te = s["te"]
    loop = te.matmul_encrypted(s["tAt"], s["tBt"], batched=False)
    _grid_equal(s["jC"], loop)


def test_aliased_a_tiles_same_residues_and_reference_hoist_bytes(s):
    """A tile object repeated at (1, 0): the hint (0, 1, 0, 3) saves one
    hoisting product a stage, as the reference's plan says, and changes no
    residue."""
    te, je = s["te"], s["je"]
    At = [list(r) for r in s["tAt"]]
    At[1][0] = At[0][0]
    hint = (0, 1, 0, 3)
    plain = compile_blockmm(te.ctx, te._plan, GRID)
    aliased = compile_blockmm(te.ctx, te._plan, GRID, a_slots=hint)
    jplan = j_compile_blockmm(je.ctx, je._plan, GRID, schedule="mo",
                              a_slots=hint).plan
    for tplan in (aliased.plan, compile_blockmm(
            te.ctx, te._plan, GRID, schedule="mo", a_slots=hint).plan):
        for name in ("hoist_bytes", "hoist_bytes_naive"):
            assert getattr(tplan, name) == getattr(jplan, name)
            for st in ("step1", "step2"):
                assert getattr(getattr(tplan, st), name) == \
                    getattr(getattr(jplan, st), name)
    p1, p2 = plain.plan, aliased.plan
    unit = p1.step1.hoist_bytes // 8, p1.step2.hoist_bytes // 8
    assert p1.step1.hoist_bytes - p2.step1.hoist_bytes == unit[0]
    assert p1.step2.hoist_bytes - p2.step2.hoist_bytes == unit[1]
    _grid_equal(plain(At, s["tBt"]),
                te._matmul_encrypted_batched(At, s["tBt"], a_slots=hint))


def test_secure_matmul_decrypts_to_product_and_equals_reference(s):
    want = s["je"].secure_matmul(s["A"], s["B"], np.random.default_rng(7))
    got = s["te"].secure_matmul(s["A"], s["B"], np.random.default_rng(7))
    assert got.shape == (A_SHAPE[0], B_SHAPE[1])
    np.testing.assert_allclose(got, s["A"] @ s["B"], atol=TOL)
    np.testing.assert_array_equal(got, want)


def test_secure_linear_matches_reference(s):
    W, x = s["B"], s["A"]
    want = JLinear(s["je"], W, np.random.default_rng(8))(
        x, np.random.default_rng(9))
    layer = SecureLinear(s["te"], W, np.random.default_rng(8))
    got = layer(x, np.random.default_rng(9))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got, x @ W, atol=TOL)
    np.testing.assert_array_equal(layer(x, None, secure=False), x @ W)


def test_mesh_and_chain_raise_and_schedule_knob_warns(s):
    p = FAME_VERIFY_SETS[NAME]
    with pytest.raises(TypeError, match="not a mesh"):
        SecureMatmulEngine(p, tile=TILE, mesh=object(), device=CPU)
    with pytest.raises(ValueError, match="chain_rows"):
        SecureLinear(s["te"], s["B"], np.random.default_rng(0),
                     chain=(np.eye(7),))
    with pytest.warns(DeprecationWarning, match="schedule"):
        eng = SecureMatmulEngine(p, tile=TILE, schedule="mo",
                                 ctx=s["te"].ctx)
    assert (eng.schedule, eng.batched) == ("mo", False)
    with pytest.raises(ValueError, match="tile"):
        SecureMatmulEngine(p, tile=8, ctx=s["te"].ctx)
