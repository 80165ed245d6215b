"""The port's first slice end to end on ``fame-s-rt`` (logN 6, L 4, k 3,
β 2), hemm 4×3×5: ``compile_hemm(..., schedule="pallas",
rotation_chunk=2)`` is array-equal to the JAX reference program (c0, c1,
level, scale) with same-seed keys and with the reference's keys carried
across, decrypts to A·B, and counts launches and hoisting slots as the
reference does.  The sibling file ``test_torch_hemm_m.py`` runs
``fame-m-rt``; the two sit in separate files so workers split them.
"""
import numpy as np
import pytest
import torch

from repro.core.hemm import decrypt_matrix as j_decrypt_matrix

from repro_torch.core.hemm import decrypt_matrix
from repro_torch.core.hlt import hoist_batched
from test_torch_common import assert_ct_equal, run_slice, u32

NAME, SHAPE, SEED = "fame-s-rt", (4, 3, 5), 3


@pytest.fixture(scope="module")
def s():
    return run_slice(NAME, SHAPE, SEED)


def test_same_seed_keys_ciphertexts_and_plan_are_array_equal(s):
    jk, tk = s["jctx"].keys, s["ctx"].keys
    np.testing.assert_array_equal(u32(jk.s_eval), u32(tk.s_eval))
    np.testing.assert_array_equal(u32(jk.evk_mult.k0), u32(tk.evk_mult.k0))
    assert set(jk.galois) == set(tk.galois)
    for g in jk.galois:
        np.testing.assert_array_equal(u32(jk.galois[g].k1), u32(tk.galois[g].k1))
    assert_ct_equal(s["jA"], s["tA"])
    assert_ct_equal(s["jB"], s["tB"])
    jp, tp = s["jplan"], s["plan"]
    assert jp.rot_steps == tp.rot_steps
    for jd, td in zip([jp.ds_sigma, jp.ds_tau, *jp.ds_eps, *jp.ds_omega],
                      [tp.ds_sigma, tp.ds_tau, *tp.ds_eps, *tp.ds_omega],
                      strict=True):
        assert jd.zs == td.zs and jd.scale == td.scale
        np.testing.assert_array_equal(u32(jd.pt), u32(td.pt))


def test_hemm_array_equal_to_reference_same_seed(s):
    assert_ct_equal(s["jC"], s["tC"])


def test_hemm_array_equal_with_reference_keys_carried_across(s):
    assert_ct_equal(s["jC"], s["cC"])


def test_hemm_decrypts_to_product(s):
    m, _, n = SHAPE
    got = decrypt_matrix(s["ctx"].eng, s["ctx"].keys, s["tC"], m, n)
    np.testing.assert_allclose(got, s["A"] @ s["B"], atol=0.05)
    want = j_decrypt_matrix(s["jctx"].eng, s["jctx"].keys, s["jC"], m, n)
    np.testing.assert_array_equal(got, want)


def test_launch_counts_and_plan_match_reference(s):
    c0, c1 = s["counters"]
    assert c1["hlt_launches"] - c0["hlt_launches"] == 2
    assert c1["program_launches"] - c0["program_launches"] == 1
    jp, tp = s["jprog"].plan, s["prog"].plan
    for j, t in ((jp.step1, tp.step1), (jp.step2, tp.step2)):
        assert (j.level, j.batch, j.nbeta, j.chunk, j.d, j.d_pad) == \
               (t.level, t.batch, t.nbeta, t.chunk, t.d, t.d_pad)
        assert (j.diag_slots, j.n_diag_slots, j.ct_slots, j.n_ct_slots) == \
               (t.diag_slots, t.n_diag_slots, t.ct_slots, t.n_ct_slots)
        assert j.operand_bytes == t.operand_bytes
    assert tp.step1.d_pad > max(tp.step1.d)          # the padding path ran
    assert len(s["ctx"].arena) == 2 + 2 * SHAPE[1]   # one slot per DiagSet


def test_step2_stores_two_hoist_slots(s):
    """Step 2 runs 2·l HLTs off exactly 2 unique hoisting products and 2·l
    diagonal slots (as tests/test_compile_api.py pins for the reference)."""
    prog, l = s["prog"], SHAPE[1]
    step2 = prog._step2
    assert step2.plan.batch == 2 * l and step2.plan.n_diag_slots == 2 * l
    ctA0, ctB0 = prog._step1([s["tA"], s["tB"]])
    h1, h2 = hoist_batched(s["ctx"].eng, [ctA0, ctB0])
    hoisted, ct_slots = step2._hoist_items([h1] * l + [h2] * l)
    assert len(hoisted) == 2
    assert ct_slots == [0] * l + [1] * l


def test_stale_program_refuses_after_rekeygen(s):
    from repro_torch.core.ckks import CkksEngine
    from repro_torch.core.compile import HEContext, compile_hemm
    ctx = HEContext(CkksEngine(s["ctx"].eng.params, device="cpu"),
                    keys=s["ctx"].keys)
    prog = compile_hemm(ctx, s["plan"], schedule="pallas", rotation_chunk=2)
    assert compile_hemm(ctx, s["plan"], schedule="pallas",
                        rotation_chunk=2) is prog
    ctx.invalidate()
    with pytest.raises(RuntimeError, match="stale"):
        prog(s["tA"], s["tB"])
    with pytest.raises(ValueError):
        compile_hemm(ctx, s["plan"], schedule="pallas", rotation_chunk=0)
    # "sharded" with no mesh runs on one rank (n_model = 1), as the
    # reference's does: the fused program's residues
    sharded = compile_hemm(ctx, s["plan"], schedule="sharded",
                           rotation_chunk=2)
    assert (sharded.plan.step2.n_model, sharded.plan.step2.n_ct) == (1, 1)
    assert sharded.plan.collective_bytes == 0
    assert_ct_equal(s["jC"], sharded(s["tA"], s["tB"]))


def test_d_padding_gives_identical_residues(s):
    """Identity-perm, zero-diagonal, is_id=1 padding contributes nothing:
    no padding (chunk 1) and padding (chunk 4) give the same residues."""
    from repro_torch.core.compile import HEContext, compile_hlt
    ctx = HEContext(s["ctx"].eng, keys=s["ctx"].keys)
    sets = [s["plan"].ds_sigma, s["plan"].ds_tau]
    outs = {}
    for chunk in (1, 4):
        run = compile_hlt(ctx, sets, level=s["tA"].level, schedule="pallas",
                          rotation_chunk=chunk)
        outs[chunk] = (run.plan.d_pad, run([s["tA"], s["tB"]]))
    assert outs[1][0] == max(ds.d for ds in sets) < outs[4][0]
    for a, b in zip(outs[1][1], outs[4][1], strict=True):
        assert torch.equal(a.c0, b.c0) and torch.equal(a.c1, b.c1)
