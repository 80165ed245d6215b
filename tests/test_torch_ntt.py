"""The port's NTT / iNTT kernels' plain versions and
``CkksEngine(datapath="pallas")`` against the reference, both verify sets.

``ntt_plain`` / ``intt_plain`` are held against the reference's Pallas
``ntt`` / ``intt`` (interpret mode) at B = 2; the port's ``"pallas"``
engine against its own ``"xla"`` engine and the reference's ``"pallas"``
engine: the transforms themselves, on whole bases and on row slices,
same-seed keygen, and one ``mult → rescale``.  Exact equality throughout;
the only tolerance is the final decode.  The CUDA kernels are held against
these plain versions on the card by ``chip_smoke.py``."""
import numpy as np
import pytest
import torch

import repro  # noqa: F401
import repro.configs.fame_sets as jfs
from repro.core.ckks import CkksEngine as JEngine
from repro.kernels import ntt as jntt

from repro_torch.configs.fame_sets import FAME_VERIFY_SETS
from repro_torch.core.ckks import CkksEngine
from repro_torch.kernels import ntt as kntt, ops
from test_torch_common import assert_ct_equal, u32

STEPS = (1, -3)


def _rand(rng, moduli, shape):
    qs = np.asarray(moduli, np.uint64)[:, None]
    return rng.integers(0, qs, shape).astype(np.uint32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.uint32).view(np.int32))


@pytest.fixture(scope="module", params=list(FAME_VERIFY_SETS))
def engs(request):
    """The port's "pallas" and "xla" engines and the reference's "pallas"
    engine, each keyed from the same seed, with two same-seed ciphertexts."""
    name = request.param
    out = dict(peng=CkksEngine(FAME_VERIFY_SETS[name], device="cpu",
                               datapath="pallas"),
               xeng=CkksEngine(FAME_VERIFY_SETS[name], device="cpu"),
               jeng=JEngine(jfs.FAME_VERIFY_SETS[name], datapath="pallas"))
    msgs = np.random.default_rng(52).uniform(
        -1, 1, (2, out["peng"].params.slots))
    for k in ("peng", "xeng", "jeng"):
        eng, rng = out[k], np.random.default_rng(51)
        keys = eng.keygen(rng, rot_steps=STEPS)
        out[k + "_keys"] = keys
        out[k + "_cts"] = [eng.encrypt(eng.encode(m), keys, rng) for m in msgs]
    out["msgs"] = msgs
    return out


def test_engine_datapath_knob():
    p = FAME_VERIFY_SETS["fame-s-rt"]
    assert CkksEngine(p, device="cpu").datapath == "xla"
    with pytest.raises(ValueError, match="datapath"):
        CkksEngine(p, device="cpu", datapath="mo")


def test_ntt_intt_plain_match_reference_kernels(engs):
    eng, jeng = engs["peng"], engs["jeng"]
    full = np.arange(eng.params.num_total)
    view, jview = eng.basis(full), jeng.basis(full)
    rng = np.random.default_rng(53)
    x = np.stack([_rand(rng, view.moduli_host, (len(full), eng.params.N))
                  for _ in range(2)])
    before = dict(ops.launch_counts())
    want = np.asarray(jntt.ntt(x, jview.psi_brv_mont, jview.moduli_u32,
                               jview.qneg_inv, interpret=True))
    got = ops.ntt(_t(x), view.psi_brv_mont, view.moduli_u32, view.qneg_inv)
    assert got.shape == x.shape
    np.testing.assert_array_equal(u32(got), want)
    np.testing.assert_array_equal(
        u32(kntt.ntt_plain(_t(x), view.psi_brv_mont, view.moduli_u32,
                           view.qneg_inv)), want)
    want_i = np.asarray(jntt.intt(x, jview.psi_inv_brv_mont,
                                  jview.n_inv_mont, jview.moduli_u32,
                                  jview.qneg_inv, interpret=True))
    got_i = ops.intt(_t(x), view.psi_inv_brv_mont, view.n_inv_mont,
                     view.moduli_u32, view.qneg_inv)
    np.testing.assert_array_equal(u32(got_i), want_i)
    back = ops.intt(got, view.psi_inv_brv_mont, view.n_inv_mont,
                    view.moduli_u32, view.qneg_inv)
    np.testing.assert_array_equal(u32(back), x)
    # CPU tensors take the plain versions: no kernel launch is counted
    assert ops.launch_counts() == before


def test_ntt_cuda_wrappers_refuse_cpu_tensors():
    x = torch.zeros((1, 1, 64), dtype=torch.int32)
    col = torch.zeros((1, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        kntt.ntt_cuda(x, x[0], col, col)
    with pytest.raises(ValueError, match="CUDA"):
        kntt.intt_cuda(x, x[0], col, col, col)


def test_engine_transforms_equal_xla_and_reference(engs):
    """_ntt / _intt on whole bases, on the special limbs, on one limb, and
    on row slices of a larger polynomial (as keyswitch and rescale pass
    them)."""
    peng, xeng, jeng = engs["peng"], engs["xeng"], engs["jeng"]
    p = peng.params
    rng = np.random.default_rng(54)
    full = list(range(p.num_total))
    cases = [full, list(range(p.L + 1)), list(range(p.num_main, p.num_total)),
             [p.L], [1, 2]]
    for idx in cases:
        x = _rand(rng, [peng.ctx.moduli_host[i] for i in idx], (len(idx), p.N))
        for fn in ("_ntt", "_intt"):
            want = np.asarray(getattr(jeng, fn)(x, jeng.basis(idx)))
            got = getattr(peng, fn)(_t(x), peng.basis(idx))
            np.testing.assert_array_equal(u32(got), want, err_msg=f"{fn} {idx}")
            np.testing.assert_array_equal(
                u32(getattr(xeng, fn)(_t(x), xeng.basis(idx))), want)
    # a row slice of a polynomial is transformed in place of a copy
    x = _t(_rand(rng, [peng.ctx.moduli_host[i] for i in full], (len(full), p.N)))
    rows = list(range(1, 3))
    np.testing.assert_array_equal(
        u32(peng._ntt(x[1:3], peng.basis(rows))),
        u32(peng._ntt(x[1:3].clone(), peng.basis(rows))))


def test_pallas_engine_keygen_same_seed(engs):
    for other in ("xeng", "jeng"):
        k, o = engs["peng_keys"], engs[other + "_keys"]
        np.testing.assert_array_equal(u32(k.s_eval), u32(o.s_eval))
        np.testing.assert_array_equal(u32(k.evk_mult.k0), u32(o.evk_mult.k0))
        np.testing.assert_array_equal(u32(k.evk_mult.k1), u32(o.evk_mult.k1))
        for r in STEPS:
            np.testing.assert_array_equal(u32(k.rot[r].k0), u32(o.rot[r].k0))
            np.testing.assert_array_equal(u32(k.rot[r].k1), u32(o.rot[r].k1))
    for a, b in zip(engs["peng_cts"], engs["jeng_cts"], strict=True):
        assert_ct_equal(b, a)


def test_pallas_engine_mult_rescale(engs):
    peng, keys = engs["peng"], engs["peng_keys"]
    a, b = engs["peng_cts"]
    got = peng.rescale(peng.mult(a, b, keys))
    xa, xb = engs["xeng_cts"]
    want_x = engs["xeng"].rescale(engs["xeng"].mult(xa, xb, engs["xeng_keys"]))
    ja, jb = engs["jeng_cts"]
    want_j = engs["jeng"].rescale(engs["jeng"].mult(ja, jb, engs["jeng_keys"]))
    assert_ct_equal(want_j, got)
    assert_ct_equal(want_j, want_x)
    dec = peng.decrypt_decode(got, keys).real
    np.testing.assert_allclose(dec, engs["msgs"][0] * engs["msgs"][1],
                               atol=0.05)
