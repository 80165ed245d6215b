"""The plain reference: its tables and transform against the program's (the
one place a test may read them), its decoding of the program's ciphertexts,
and the product against numpy."""
import numpy as np
import pytest
import torch

from reference import ckks, hemm

TOY_SETS = ["fame-s-rt", "fame-m-rt"]


def _params(name):
    from repro_torch.configs.fame_sets import FAME_VERIFY_SETS
    from repro_torch.core.params import SET_B, SET_C
    return {"set-b": SET_B, "set-c": SET_C, **FAME_VERIFY_SETS}[name]


def _sizes(p):
    return {k: getattr(p, k) for k in ("logN", "L", "k", "beta",
                                       "scale_bits", "q0_bits", "sp_bits")}


@pytest.mark.parametrize("name", TOY_SETS + ["set-b", "set-c"])
def test_primes_and_transform_agree_with_the_program(name):
    from repro_torch.core import ntt
    from repro_torch.core.params import get_context, host_tables
    p = _params(name)
    qs = ckks.moduli(p.logN, p.L, p.k, p.q0_bits, p.scale_bits, p.sp_bits)
    assert qs == tuple(host_tables(p).moduli)
    rows = [0, 1, p.L, p.num_total - 1]
    tr = ckks.Transform(p.N, [qs[i] for i in rows],
                        [ckks.roots(p.logN, qs)[i] for i in rows], "cpu")
    x = torch.from_numpy(np.random.default_rng(1).integers(
        0, 1 << 30, (len(rows), p.N))) % tr.q
    ctx = get_context(p, "cpu")
    want = ntt.ntt_raw(x, ctx.psi_brv[rows].to(torch.int64), ctx.moduli[rows])
    assert torch.equal(tr.forward(x), want)
    assert torch.equal(tr.inverse(want), x)


@pytest.mark.parametrize("name", TOY_SETS)
def test_decodes_a_fresh_ciphertext_of_the_program(name):
    """The program encrypts a vector under a key from generator g; the
    reference, given a generator built as g, decodes it."""
    from repro_torch.core.ckks import CkksEngine
    p = _params(name)
    eng = CkksEngine(p, device="cpu")
    keys = eng.keygen(np.random.default_rng([7, 2]))
    msg = np.random.default_rng(3).uniform(-1, 1, p.slots)
    ct = eng.encrypt(eng.encode(msg), keys, np.random.default_rng(4))
    dec = ckks.Decryptor(_sizes(p), np.random.default_rng([7, 2]), p.L,
                         p.scale, "cpu")
    got = dec.decode(ct.c0, ct.c1, p.slots)
    assert got is not None
    assert np.abs(got.numpy() - msg).max() < 1e-3


def test_a_ciphertext_of_another_key_is_undecodable():
    from repro_torch.core.ckks import CkksEngine
    p = _params("fame-m-rt")
    eng = CkksEngine(p, device="cpu")
    keys = eng.keygen(np.random.default_rng(11))
    ct = eng.encrypt(eng.encode(np.ones(4)), keys, np.random.default_rng(4))
    dec = ckks.Decryptor(_sizes(p), np.random.default_rng(12), p.L, p.scale,
                         "cpu")
    assert dec.decode(ct.c0, ct.c1, 4) is None
    assert dec.decode(ct.c0[:-1], ct.c1[:-1], 4) is None


def test_product_and_column_major_layout_against_numpy():
    rng = np.random.default_rng(5)
    A, B = rng.uniform(-1, 1, (3, 4)), rng.uniform(-1, 1, (4, 2))
    assert np.allclose(hemm.product(A, B).numpy(), A @ B, rtol=0, atol=0)
    C = A @ B
    slots = torch.from_numpy(np.concatenate([C.flatten(order="F"),
                                             np.zeros(5)]))
    assert np.array_equal(hemm.as_matrix(slots, 3, 2).numpy(), C)


def test_judge_counts_and_limits():
    limits = {"undecodable": 0, "worst_median_err": 0.01,
              "worst_trimmed_err": 0.2}
    j = hemm.Judge(limits)
    want = torch.zeros(3, 3, dtype=torch.float64)
    j.add(want + 0.001, want)
    assert j.correct() and j.failed == 0
    j.add(None, want)
    assert not j.correct() and j.numbers()["undecodable"] == 1
    j = hemm.Judge(limits)
    gaps = torch.zeros(3, 3, dtype=torch.float64)
    gaps[0, :] = 0.5                    # 3 of 9 entries far off: median 0
    j.add(want + gaps, want)
    assert j.correct() and j.failed == 0
    assert j.not_compared() == {"mean_abs_err": pytest.approx(1.5 / 9),
                                "max_abs_err": 0.5, "worst_far_entries": 3}
    assert j.numbers()["worst_trimmed_err"] == pytest.approx(1.5 / 9)
    gaps[1, :] = 0.5                    # 6 of 9: the median moves
    j.add(want + gaps, want)
    assert not j.correct() and j.failed == 1
    assert j.numbers()["worst_median_err"] == 0.5


def test_one_row_off_moves_the_trimmed_mean_and_not_the_median():
    """A fault on one row of a 128x128 answer: the median stays, the mean
    without the farthest TRIM share does not; a few far entries alone (the
    floor rescaling's slots) are left out of it."""
    limits = {"undecodable": 0, "worst_median_err": 1e-3,
              "worst_trimmed_err": 1e-3}
    want = torch.zeros(128, 128, dtype=torch.float64)
    noise = torch.full_like(want, 2e-4)
    few = noise.clone()
    few.view(-1)[:3] = 0.75
    j = hemm.Judge(limits)
    j.add(want + few, want)
    assert j.correct()
    assert j.numbers()["worst_trimmed_err"] == pytest.approx(2e-4)
    row = noise.clone()
    row[5, :] = 0.3
    j.add(want + row, want)
    assert not j.correct() and j.failed == 1
    assert j.numbers()["worst_median_err"] == pytest.approx(2e-4)
    assert j.numbers()["worst_trimmed_err"] > 1e-3


def test_control_is_bfloat16():
    rng = np.random.default_rng(6)
    A, B = rng.uniform(-1, 1, (32, 32)), rng.uniform(-1, 1, (32, 32))
    got = hemm.control(A, B, "cpu")
    want = (torch.from_numpy(A).bfloat16() @ torch.from_numpy(B).bfloat16())
    assert torch.equal(got, want.double())
    assert (got - hemm.product(A, B)).abs().mean() > 1e-3
