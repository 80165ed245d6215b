"""The frozen least-work functions against counts made by hand."""
import math

import pytest

from costs import PEAK_BYTES_PER_S, PEAK_OPS_PER_S
from costs import hemm as costs

# fame-s-rt (FAME_VERIFY_SETS): logN 6, L 4, k 3, beta 2, so alpha = 3
TOY = dict(logN=6, L=4, k=3, beta=2)


def test_diagonals_of_a_2x2x2_product_by_hand():
    """σ(2,2): z = 0 on rows {0,2}, z = 2 on {1}, z = −2 on {3};
    τ(2,2): z = 0 on {0,1}, z = 1 on {2}, z = −1 on {3}.  Rows {3} appear
    twice, so 5 distinct vectors; rotations 2, −2, 1, −1 (mod 32)."""
    vectors, steps = costs.diagonals([costs._sigma(2, 2), costs._tau(2, 2)],
                                     32)
    assert vectors == 5
    assert steps == {2, 30, 1, 31}
    maps2 = ([costs._eps(k, 2, 2, 2) for k in range(2)]
             + [costs._omega(k, 2, 2, 2) for k in range(2)])
    # ε^0 and ω^0 share the all-rows diagonal; ε^1: {0,1}, {2,3};
    # ω^1: {0,2}, {1,3}
    vectors, steps = costs.diagonals(maps2, 32)
    assert vectors == 5
    assert steps == {2, 30, 1, 31}


def test_stage_counts_by_hand():
    """N = 64.  A ciphertext at level ℓ is 2·(ℓ+1)·64 words; a key at ℓ is
    2·digits·(ℓ+1+3)·64 with digits = ⌈(ℓ+1)/3⌉."""
    got = costs.least(TOY, 2, 2, 2)
    # Step 1 at level 4: 2 inputs of 640, 5 diagonals of 5·64, 4 keys of
    # 2·2·8·64 = 2048, 2 outputs of 512
    assert got["step1"]["words"] == 2 * 640 + 5 * 320 + 4 * 2048 + 2 * 512
    assert got["step1"]["products"] == 5 * 2 * 320 + 4 * 2048
    # Step 2 at level 3: 2 inputs of 512, 5 diagonals of 4·64, 4 keys of
    # 2·2·7·64 = 1792, 4 outputs of 384
    assert got["step2"]["words"] == 2 * 512 + 5 * 256 + 4 * 1792 + 4 * 384
    assert got["step2"]["products"] == 5 * 2 * 256 + 4 * 1792
    # the loop at level 2: 4 inputs of 384, the relinearisation key
    # 2·1·6·64 = 768, one output of 256; 2 products of 3·3·64 + 768
    assert got["loop"]["words"] == 4 * 384 + 768 + 256
    assert got["loop"]["products"] == 2 * (3 * 3 * 64 + 768)
    # the request: both inputs, both stages' diagonals, Step 1's 4 keys
    # (Step 2 uses the same rotations), the relinearisation key, the output
    assert got["request"]["words"] == (2 * 640 + 5 * 320 + 5 * 256
                                       + 4 * 2048 + 768 + 256)
    assert got["hlt"]["words"] == got["step1"]["words"] + got["step2"]["words"]


def test_seconds_take_the_longer_bound():
    assert costs.seconds(10 ** 9, 0) == pytest.approx(4e9 / PEAK_BYTES_PER_S)
    assert costs.seconds(1, 10 ** 12) == pytest.approx(1e12 / PEAK_OPS_PER_S)


@pytest.mark.parametrize("shape", [(2, 2, 2), (4, 4, 4), (4, 2, 4)])
def test_rotations_match_the_programs_plan(shape):
    """The distinct rotations the costs count are the plan's key steps."""
    from repro_torch.configs.fame_sets import FAME_VERIFY_SETS
    from repro_torch.core.ckks import CkksEngine
    from repro_torch.core.hemm import plan_hemm
    p = FAME_VERIFY_SETS["fame-s-rt"]
    plan = plan_hemm(CkksEngine(p, device="cpu"), *shape)
    m, l, n = shape
    slots = p.N // 2
    _, st1 = costs.diagonals([costs._sigma(m, l), costs._tau(l, n)], slots)
    _, st2 = costs.diagonals([costs._eps(k, m, l, n) for k in range(l)]
                             + [costs._omega(k, m, l, n) for k in range(l)],
                             slots)
    assert st1 | st2 == {z % slots for z in plan.rot_steps}


def test_set_b_128_counts():
    """381 rotations at Set-B 128³ (the keys the program generates), and
    the request's least bytes below the HLT's and the loop's together."""
    sizes = dict(logN=15, L=15, k=8, beta=2)
    got = costs.least(sizes, 128, 128, 128)
    assert got["request"]["words"] < (got["hlt"]["words"]
                                      + got["loop"]["words"])
    _, st1 = costs.diagonals([costs._sigma(128, 128), costs._tau(128, 128)],
                             1 << 14)
    assert len(st1) == 381
    assert math.isclose(got["loop"]["seconds"],
                        got["loop"]["words"] * 4 / PEAK_BYTES_PER_S)
