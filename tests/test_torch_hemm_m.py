"""The port's first slice end to end on ``fame-m-rt`` (logN 7, L 5, k 2,
β 3), hemm 4×4×4 — the sibling of ``test_torch_hemm_s.py`` (which also
holds the checks that need only one parameter set)."""
import importlib.util
import pathlib

import numpy as np
import pytest

from repro_torch.core.hemm import decrypt_matrix
from test_torch_common import assert_ct_equal, run_slice, u32

NAME, SHAPE, SEED = "fame-m-rt", (4, 4, 4), 5
ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def s():
    return run_slice(NAME, SHAPE, SEED)


def test_same_seed_keys_and_ciphertexts_are_array_equal(s):
    jk, tk = s["jctx"].keys, s["ctx"].keys
    np.testing.assert_array_equal(u32(jk.s_eval), u32(tk.s_eval))
    for g in jk.galois:
        np.testing.assert_array_equal(u32(jk.galois[g].k0), u32(tk.galois[g].k0))
    assert_ct_equal(s["jA"], s["tA"])
    assert_ct_equal(s["jB"], s["tB"])


def test_hemm_array_equal_to_reference_same_seed(s):
    assert_ct_equal(s["jC"], s["tC"])


def test_hemm_array_equal_with_reference_keys_carried_across(s):
    assert_ct_equal(s["jC"], s["cC"])


def test_hemm_decrypts_to_product(s):
    m, _, n = SHAPE
    got = decrypt_matrix(s["ctx"].eng, s["ctx"].keys, s["tC"], m, n)
    np.testing.assert_allclose(got, s["A"] @ s["B"], atol=0.05)


def test_launch_counts_and_hoist_slots_match_reference(s):
    c0, c1 = s["counters"]
    assert c1["hlt_launches"] - c0["hlt_launches"] == 2
    assert c1["program_launches"] - c0["program_launches"] == 1
    jp, tp = s["jprog"].plan, s["prog"].plan
    for j, t in ((jp.step1, tp.step1), (jp.step2, tp.step2)):
        assert (j.d, j.d_pad, j.diag_slots, j.ct_slots, j.n_ct_slots) == \
               (t.d, t.d_pad, t.diag_slots, t.ct_slots, t.n_ct_slots)
    assert tp.step2.n_ct_slots == 2 and tp.step2.n_diag_slots == 2 * SHAPE[1]
    assert tp.step1.d_pad > max(tp.step1.d)


def test_smoke_rounded_division_witness(s):
    """``chip_smoke.py``'s witness for the floor-rescale bias: with every
    floor division of the program rounded, the product lies closer to A·B;
    undoing the patch restores the program bit for bit."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    ctx, prog = s["ctx"], s["prog"]
    undo = smoke.round_divisions(ctx.eng)
    try:
        rounded = prog(s["tA"], s["tB"])
    finally:
        undo()
    assert_ct_equal(s["jC"], prog(s["tA"], s["tB"]))
    m, _, n = SHAPE
    want = s["A"] @ s["B"]
    floor_err = np.abs(decrypt_matrix(ctx.eng, ctx.keys, s["tC"], m, n) - want)
    round_err = np.abs(decrypt_matrix(ctx.eng, ctx.keys, rounded, m, n) - want)
    assert round_err.max() < floor_err.max()


def test_cost_model_compile_equals_reference(s):
    """``compile_hemm(ctx, plan)`` with no schedule and no chunk: the cost
    model's fused pick with no d-padding, array-equal to the reference's
    program (whose chunk pads d: padding rotations add nothing)."""
    from repro_torch.core.compile import compile_hemm
    prog = compile_hemm(s["ctx"], s["plan"])
    assert (prog.plan.schedule, prog.plan.batched) == ("pallas", True)
    for st in (prog.plan.step1, prog.plan.step2):
        assert st.d_pad == max(st.d) == st.chunk
    assert_ct_equal(s["jC"], prog(s["tA"], s["tB"]))
