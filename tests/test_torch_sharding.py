"""The multi-device schedule's host side against the JAX reference, in one
process (no ranks): the sharding rules on duck-typed meshes, the sharded
program's tables for 1–4 model ranks, and the port's ``"sharded"``
schedule with no mesh (one rank) against the reference's meshless
``"sharded"`` program.
"""
import types

import numpy as np
import pytest

import repro  # noqa: F401
from repro.core import hlt_dist as jdist
from repro.core.ckks import CkksEngine as JEngine
from repro.core.compile import HEContext as JContext
from repro.core.compile import compile_hemm as j_compile_hemm
from repro.core.hemm import encrypt_matrix as j_encrypt
from repro.core.hemm import plan_hemm as j_plan_hemm
from repro.core.params import toy_params as j_toy
from repro.distributed import sharding as jsharding

from repro_torch.core import hlt_dist
from repro_torch.core.ckks import CkksEngine
from repro_torch.core.compile import HEContext, compile_hemm, compile_hlt
from repro_torch.core.hemm import encrypt_matrix, plan_hemm
from repro_torch.core.params import toy_params
from repro_torch.distributed import sharding
from repro_torch.launch import mesh as mesh_mod
from test_torch_common import CPU, PLAN_FIELDS, assert_ct_equal, u32

MESHES = [None, {"data": 2, "model": 2}, {"pod": 2, "data": 4, "model": 4},
          {"data": 4}, {"model": 8}, {"data": 1, "model": 3}]
LOGICAL = [("batch", "seq", "d_model"), ("limbs",), ("ct_batch", "limbs", None),
           ("heads", "kv_heads"), ("batch", "fsdp"), ("experts", "ff"),
           ("vocab", "seq_sp", "coeff"), (None, None)]
#: (toy_params arguments, levels): the second has M = 6 extended limbs at
#: its top level, which 4 model ranks do not divide
TABLE_CASES = [(dict(logN=6, L=4, k=3, beta=2), (4, 3)),
               (dict(logN=6, L=3, k=2, beta=2), (3, 2))]


def _mesh(shape):
    if shape is None:
        return None
    return types.SimpleNamespace(axis_names=tuple(shape), shape=dict(shape))


@pytest.mark.parametrize("shape", MESHES, ids=[str(m) for m in MESHES])
def test_rules_equal_reference(shape):
    mine = sharding.make_rules(_mesh(shape))
    ref = jsharding.make_rules(_mesh(shape))
    assert mine.rules == ref.rules == jsharding.DEFAULT_RULES
    for logical in LOGICAL:
        assert mine.spec(*logical) == tuple(ref.spec(*logical)), logical
        for ax in logical:
            assert sharding.logical_axis_size(mine, ax) == \
                jsharding.logical_axis_size(ref, ax)
        for dims in ((8,) * len(logical), (6,) * len(logical),
                     (3,) * len(logical)):
            assert sharding.sanitize_spec(mine, logical, dims) == \
                jsharding.sanitize_spec(ref, logical, dims)
    over = {"limbs": ("data",)}
    assert sharding.make_rules(_mesh(shape), over).spec("limbs") == \
        tuple(jsharding.make_rules(_mesh(shape), over).spec("limbs"))


def test_current_rules_and_mesh_refusals():
    saved = sharding.get_rules()
    try:
        r = sharding.make_rules(_mesh({"model": 2}))
        sharding.set_rules(r)
        assert sharding.get_rules() is r
    finally:
        sharding.set_rules(saved)
    assert sharding.get_rules().mesh is None
    # no process group: a mesh refuses to exist; not-a-mesh is refused
    with pytest.raises(RuntimeError, match="process group"):
        mesh_mod.make_mesh_for(1, device=CPU)
    with pytest.raises(TypeError, match="not a mesh"):
        mesh_mod.check_mesh(_mesh({"model": 2}))
    assert mesh_mod.default_backend("cuda") == "nccl"
    assert mesh_mod.default_backend(CPU) == "gloo"


def _assert_tree_equal(a, b, what):
    if isinstance(b, dict):
        assert set(a) == set(b), what
        for k in b:
            _assert_tree_equal(a[k], b[k], f"{what}.{k}")
    elif isinstance(b, (list, tuple)) and not isinstance(b, np.ndarray):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b, strict=True)):
            _assert_tree_equal(x, y, f"{what}[{i}]")
    elif hasattr(a, "detach"):
        np.testing.assert_array_equal(u32(a) if a.dtype != bool
                                      else a.numpy(), np.asarray(b),
                                      err_msg=what)
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype, (what, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=what)


@pytest.mark.parametrize("kw,levels", TABLE_CASES,
                         ids=[f"L{c[0]['L']}k{c[0]['k']}" for c in TABLE_CASES])
@pytest.mark.parametrize("n_model", [1, 2, 3, 4])
def test_shard_tables_equal_reference(kw, levels, n_model):
    for level in levels:
        mine = hlt_dist.build_shard_tables(toy_params(**kw), level, n_model)
        ref = jdist.build_shard_tables(j_toy(**kw), level, n_model)
        what = f"level {level}, n_model {n_model}"
        assert (mine.level, mine.n_model, mine.full, mine.M, mine.M_pad,
                mine.rows_loc) == (ref.level, ref.n_model, ref.full, ref.M,
                                   ref.M_pad, ref.rows_loc), what
        for name in ("q_main", "qneg_main", "psii_main", "ninv_main", "q32",
                     "qneg", "psi_m", "psii_m", "ninv_m", "p_raise_m",
                     "digits", "md"):
            _assert_tree_equal(getattr(mine, name), getattr(ref, name),
                               f"{what}: {name}")
        _assert_tree_equal(hlt_dist.shard_operand_arrays(mine),
                           {k: np.asarray(v) for k, v in
                            jdist.shard_operand_arrays(ref).items()},
                           f"{what}: operand arrays")
        assert hlt_dist.expected_collectives(mine) == \
            jdist.expected_collectives(ref)
        # every rank's block is its slice of the padded row axis
        arrs = hlt_dist.shard_operand_arrays(mine)
        for r in range(n_model):
            t = hlt_dist.rank_tables(mine, r, CPU)
            rows = slice(r * mine.rows_loc, (r + 1) * mine.rows_loc)
            np.testing.assert_array_equal(u32(t["q32"]), arrs["q32"][rows])
            np.testing.assert_array_equal(u32(t["w_stack"]),
                                          arrs["w_stack"][:, rows])
            dst, src = np.nonzero(arrs["sel_drop"][:, rows])
            assert t["drop_src"].tolist() == src.tolist()
            assert t["drop_dst"].tolist() == dst.tolist()
    if kw["L"] == 3 and n_model == 4:
        assert (mine.M, mine.M_pad) == (5, 8)   # level 2: M = 5 on 4 ranks


@pytest.mark.parametrize("diag,ct,b_pad", [
    ((0, 1), (0, 1), 2), ((0, 1, 0), (0, 1, 0), 4), ((0, 1, 2), None, 6),
    ((0,), (0,), 3)])
def test_slot_tables_equal_reference(diag, ct, b_pad):
    mine = hlt_dist.build_slot_tables(diag, ct, b_pad)
    ref = jdist.build_slot_tables(diag, ct, b_pad)
    np.testing.assert_array_equal(mine["diag"].numpy(), np.asarray(ref["diag"]))
    if ct is None:
        assert mine["ct"] is None and ref["ct"] is None
    else:
        np.testing.assert_array_equal(mine["ct"].numpy(), np.asarray(ref["ct"]))
    with pytest.raises(ValueError):
        hlt_dist.build_slot_tables(diag, ct, len(diag) - 1)


# -- the meshless "sharded" program ------------------------------------------

SHAPE, SEED, CHUNK = (4, 3, 5), 11, 2
TOY = dict(logN=6, L=4, k=3, beta=2, scale_bits=26)


@pytest.fixture(scope="module")
def meshless():
    """The reference's meshless "sharded" hemm, once; the port's inputs
    from the same seed."""
    m, l, n = SHAPE
    rng = np.random.default_rng(SEED)
    jctx = JContext(JEngine(j_toy(**TOY)))
    jplan = j_plan_hemm(jctx.eng, m, l, n)
    jctx.keygen(rng, rot_steps=jplan.rot_steps)
    A, B = rng.uniform(-1, 1, (m, l)), rng.uniform(-1, 1, (l, n))
    jA = j_encrypt(jctx.eng, jctx.keys, A, rng)
    jB = j_encrypt(jctx.eng, jctx.keys, B, rng)
    jprog = j_compile_hemm(jctx, jplan, schedule="sharded",
                           rotation_chunk=CHUNK)
    jC = jprog(jA, jB)

    rng = np.random.default_rng(SEED)
    ctx = HEContext(CkksEngine(toy_params(**TOY), device=CPU),
                    verify="error")
    plan = plan_hemm(ctx.eng, m, l, n)
    ctx.keygen(rng, rot_steps=plan.rot_steps)
    rng.uniform(-1, 1, (m, l)), rng.uniform(-1, 1, (l, n))
    tA = encrypt_matrix(ctx.eng, ctx.keys, A, rng)
    tB = encrypt_matrix(ctx.eng, ctx.keys, B, rng)
    return dict(jprog=jprog, jC=jC, ctx=ctx, plan=plan, tA=tA, tB=tB)


@pytest.mark.parametrize("schedule", ["sharded", "sharded_xla"])
def test_meshless_sharded_equals_reference(meshless, schedule):
    prog = compile_hemm(meshless["ctx"], meshless["plan"], schedule=schedule,
                        rotation_chunk=CHUNK)
    assert_ct_equal(meshless["jC"], prog(meshless["tA"], meshless["tB"]))
    assert prog.plan.batched and prog.plan.collective_bytes == 0
    if schedule == "sharded":
        jp, tp = meshless["jprog"].plan, prog.plan
        for j, t in ((jp.step1, tp.step1), (jp.step2, tp.step2)):
            for name in PLAN_FIELDS:
                assert getattr(t, name) == getattr(j, name), name
            assert t.datapath == j.datapath == "pallas"


def test_meshless_sharded_single_and_unbatched(meshless):
    ctx, plan = meshless["ctx"], meshless["plan"]
    prog = compile_hemm(ctx, plan, schedule="sharded", rotation_chunk=CHUNK,
                        batched=False)
    assert not prog.plan.batched
    assert_ct_equal(meshless["jC"], prog(meshless["tA"], meshless["tB"]))
    one = compile_hlt(ctx, plan.ds_sigma, schedule="sharded")
    mo = compile_hlt(ctx, plan.ds_sigma, schedule="mo")
    assert_ct_equal(mo(meshless["tA"]), one(meshless["tA"]))
    assert one.plan.batch is None and one._slot_tables["diag"].tolist() == [0]
    with pytest.raises(TypeError, match="Ciphertexts"):
        compile_hlt(ctx, [plan.ds_sigma], schedule="sharded")(
            [compile_hlt(ctx, plan.ds_sigma, schedule="pallas")._hoist_items(
                [meshless["tA"]])[0][0]])
