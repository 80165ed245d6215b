"""The port's CKKS engine against the reference's, same numpy seed: keygen,
encrypt, encode and encode_diagonals give array-equal residues; mult then
rescale match; the vectorised integer-to-residue map equals the reference's
object-int loop; the sparse diagonal encoding equals the dense scan."""
import numpy as np
import pytest

import repro  # noqa: F401
import repro.configs.fame_sets as jfs
from repro.core import hemm as jhemm
from repro.core.ckks import CkksEngine as JEngine
from repro.core.hlt import encode_diagonals as j_encode_diagonals

from repro_torch import convert
from repro_torch.configs.fame_sets import FAME_VERIFY_SETS
from repro_torch.core import hemm
from repro_torch.core.ckks import CkksEngine
from repro_torch.core.hlt import encode_diagonals
from test_torch_common import assert_ct_equal, u32

STEPS = (1, -2, 5)


@pytest.fixture(scope="module", params=list(FAME_VERIFY_SETS))
def pair(request):
    jeng = JEngine(jfs.FAME_VERIFY_SETS[request.param])
    eng = CkksEngine(FAME_VERIFY_SETS[request.param], device="cpu")
    jrng, trng = np.random.default_rng(41), np.random.default_rng(41)
    jkeys = jeng.keygen(jrng, rot_steps=STEPS)
    keys = eng.keygen(trng, rot_steps=STEPS)
    msgs = np.random.default_rng(42).uniform(-1, 1, (2, eng.params.slots))
    jcts = [jeng.encrypt(jeng.encode(m), jkeys, jrng) for m in msgs]
    cts = [eng.encrypt(eng.encode(m), keys, trng) for m in msgs]
    return dict(jeng=jeng, eng=eng, jkeys=jkeys, keys=keys, jcts=jcts,
                cts=cts, msgs=msgs)


def test_keygen_same_seed_array_equal(pair):
    jk, k = pair["jkeys"], pair["keys"]
    np.testing.assert_array_equal(u32(k.s_eval), u32(jk.s_eval))
    np.testing.assert_array_equal(u32(k.evk_mult.k0), u32(jk.evk_mult.k0))
    np.testing.assert_array_equal(u32(k.evk_mult.k1), u32(jk.evk_mult.k1))
    assert k.rot.keys() == jk.rot.keys() and k.galois.keys() == jk.galois.keys()
    for r in STEPS:
        np.testing.assert_array_equal(u32(k.rot[r].k0), u32(jk.rot[r].k0))
        np.testing.assert_array_equal(u32(k.rot[r].k1), u32(jk.rot[r].k1))


def test_encrypt_same_seed_array_equal_and_decrypts(pair):
    for jct, ct, m in zip(pair["jcts"], pair["cts"], pair["msgs"], strict=True):
        assert_ct_equal(jct, ct)
        got = pair["eng"].decrypt_decode(ct, pair["keys"]).real
        np.testing.assert_allclose(got, m, atol=1e-4)


def test_mult_then_rescale_matches_reference(pair):
    jeng, eng = pair["jeng"], pair["eng"]
    (ja, jb), (a, b) = pair["jcts"], pair["cts"]
    want = jeng.rescale(jeng.mult(ja, jb, pair["jkeys"]))
    got = eng.rescale(eng.mult(a, b, pair["keys"]))
    assert_ct_equal(want, got)
    assert_ct_equal(jeng.add(ja, jb), eng.add(a, b))
    # the reference's keys carried across give the same product
    keys = convert.keys(pair["jkeys"], "cpu")
    assert keys.rot[1] is keys.galois[next(iter(
        g for g, v in pair["jkeys"].galois.items()
        if v is pair["jkeys"].rot[1]))]
    assert_ct_equal(want, eng.rescale(eng.mult(
        convert.ciphertext(ja, "cpu"), convert.ciphertext(jb, "cpu"), keys)))


def test_int_coeffs_to_basis_vectorised_equals_object_loop(pair):
    """int64 floor-mod == the reference's per-coefficient Python-int loop,
    for integer-valued float64 coefficients of either sign and up to 2^62."""
    jeng, eng = pair["jeng"], pair["eng"]
    rng = np.random.default_rng(43)
    N = eng.params.N
    mags = [2.0 ** 20, 2.0 ** 40, 2.0 ** 62]
    coeffs = np.round(rng.uniform(-1, 1, N) * np.resize(mags, N))
    coeffs[:4] = [0.0, -1.0, -(2.0 ** 62), 2.0 ** 62]
    idx = list(range(eng.params.num_total))
    want = jeng._int_coeffs_to_basis(coeffs.astype(object), idx)
    np.testing.assert_array_equal(eng._int_coeffs_to_basis(coeffs, idx), want)


def test_encode_diagonals_matches_reference(pair):
    jeng, eng = pair["jeng"], pair["eng"]
    for U in (jhemm.u_sigma(4, 3), jhemm.u_tau(3, 5), jhemm.u_eps(2, 4, 3, 5),
              jhemm.u_omega(1, 4, 3, 5)):
        jd, td = j_encode_diagonals(jeng, U), encode_diagonals(eng, U)
        assert jd.zs == td.zs and jd.scale == td.scale and jd.shape == td.shape
        np.testing.assert_array_equal(u32(td.pt), u32(jd.pt))


def test_sparse_transformation_maps_equal_dense_reference():
    """plan_hemm encodes from the one-entry-per-row sparse maps; they are
    the reference's dense matrices entry for entry."""
    for m, l, n in ((4, 3, 5), (4, 4, 4), (3, 5, 2)):
        np.testing.assert_array_equal(hemm.u_sigma(m, l), jhemm.u_sigma(m, l))
        np.testing.assert_array_equal(hemm.u_tau(l, n), jhemm.u_tau(l, n))
        for k in range(l):
            np.testing.assert_array_equal(hemm.u_eps(k, m, l, n),
                                          jhemm.u_eps(k, m, l, n))
            np.testing.assert_array_equal(hemm.u_omega(k, m, l, n),
                                          jhemm.u_omega(k, m, l, n))
