"""The plain versions of the port's four kernels against the JAX Pallas
kernels (interpret mode) on random residues, both verify sets, through the
reference's own table builders: ``intt_scale``, ``hoist_db`` (with a
padded digit row), ``moddown_finish`` (via the merged ModDown over a batch
of polynomials) and ``fused_hlt_indexed`` (with a d that is not a chunk
multiple, padded as the reference pads it).  Exact equality throughout.
The CUDA kernels are held against these plain versions on the card by
``chip_smoke.py``."""
import pathlib

import numpy as np
import pytest
import torch

import repro  # noqa: F401
import repro.configs.fame_sets as jfs
from repro.core import automorph as jauto
from repro.core.ckks import CkksEngine as JEngine
from repro.kernels import basechange as jbc, fused_hlt as jfh

from repro_torch.configs.fame_sets import FAME_VERIFY_SETS
from repro_torch.core.ckks import CkksEngine
from repro_torch.kernels import basechange as bc, fused_hlt as fh, ops
from test_torch_common import u32

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", params=list(FAME_VERIFY_SETS))
def engs(request):
    return (CkksEngine(FAME_VERIFY_SETS[request.param], device="cpu"),
            JEngine(jfs.FAME_VERIFY_SETS[request.param]))


def _port_tabs(jt: dict) -> dict:
    """The reference's table dict (jax/numpy arrays) as port tensors."""
    return bc.to_device({k: np.asarray(v) if hasattr(v, "shape") else v
                         for k, v in jt.items()}, "cpu")


def _rand(rng, moduli, shape):
    qs = np.asarray(moduli, np.uint64)[:, None]
    return rng.integers(0, qs, shape).astype(np.uint32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.uint32).view(np.int32))


def _levels(eng):
    return (eng.params.L, eng.params.L - 1)


def test_table_builders_match_reference_and_stay_float64(engs):
    """Same digit-padded layout, same values; the BaseConv correction table
    is float64 (the reference is bit-exact only in f64; f32 would drift)."""
    eng, jeng = engs
    for level in _levels(eng):
        for ours, theirs in ((eng.fused_hoist_tables(level),
                              jeng.fused_hoist_tables(level)),
                             (eng.fused_moddown_tables(level),
                              jeng.fused_moddown_tables(level))):
            assert set(ours) == set(theirs)
            for k, v in theirs.items():
                if not hasattr(v, "shape"):
                    assert ours[k] == v, k
                elif np.asarray(v).dtype == np.uint32:
                    np.testing.assert_array_equal(u32(ours[k]), np.asarray(v))
                else:
                    assert ours[k].dtype in (torch.float64, torch.int64), k
                    np.testing.assert_array_equal(ours[k].numpy(), np.asarray(v))
        assert eng.fused_hoist_tables(level)["inv_d"].dtype == torch.float64
    assert bc.CORRECTION_EPS == jbc.CORRECTION_EPS
    src = (ROOT / "src/repro_torch/csrc/common.cuh").read_text()
    assert "double" in src and "0.5e-6" in src


def test_intt_scale_matches_reference(engs):
    eng, jeng = engs
    rng = np.random.default_rng(10)
    jt = jeng.fused_moddown_tables(eng.params.L)
    t = _port_tabs(jt)
    nd = t["psii_drop"].shape[0]
    x = _rand(rng, [eng.ctx.moduli_host[i] for i in
                    [*range(eng.params.num_main, eng.params.num_total),
                     eng.params.L]], (nd, eng.params.N))
    want = jbc.intt_scale(x, jt["psii_drop"], jt["ninv_drop"], jt["hat_drop"],
                          jt["q_drop"], jt["qneg_drop"], interpret=True)
    got = ops.intt_scale(_t(x), t["psii_drop"], t["ninv_drop"],
                         t["hat_drop"], t["q_drop"], t["qneg_drop"])
    np.testing.assert_array_equal(u32(got), np.asarray(want))


@pytest.mark.parametrize("drop", [0, 1])
def test_hoist_db_matches_reference(engs, drop):
    """Batched hoist of 3 ciphertexts; one of the two levels per set has a
    short last digit, so its padded row is covered."""
    eng, jeng = engs
    level = eng.params.L - drop
    rng = np.random.default_rng(11 + drop)
    c1s = np.stack([_rand(rng, eng.ctx.moduli_host[: level + 1],
                          (level + 1, eng.params.N)) for _ in range(3)])
    jt = jeng.fused_hoist_tables(level)
    want = jbc.hoist_fused_db(c1s, jt, interpret=True)
    got = ops.hoist_fused_db(_t(c1s), _port_tabs(jt))
    np.testing.assert_array_equal(u32(got), np.asarray(want))


def test_some_hoist_level_has_a_padded_digit_row(engs):
    eng, _ = engs
    padded = [lv for lv in _levels(eng)
              if (lv + 1) % eng.fused_hoist_tables(lv)["alpha"] != 0]
    assert padded


@pytest.mark.parametrize("drop", [0, 1])
def test_moddown_matches_reference(engs, drop):
    """The merged ModDown+Rescale over 2 polynomials in one call (one
    intt_scale + one moddown_finish) against the reference per polynomial,
    and moddown_finish alone against the reference kernel."""
    eng, jeng = engs
    p = eng.params
    level = p.L - drop
    rng = np.random.default_rng(20 + drop)
    ext = [*range(level + 1), *range(p.num_main, p.num_total)]
    x = np.stack([_rand(rng, [eng.ctx.moduli_host[i] for i in ext],
                        (len(ext), p.N)) for _ in range(2)])
    jt = jeng.fused_moddown_tables(level)
    t = _port_tabs(jt)
    got = ops.moddown_fused(_t(x), t)
    for b in range(2):
        want = jbc.moddown_fused(x[b], jt, interpret=True)
        np.testing.assert_array_equal(u32(got[b]), np.asarray(want))
    y = np.asarray(jbc.intt_scale(
        x[0][jt["drop_idx"]], jt["psii_drop"], jt["ninv_drop"], jt["hat_drop"],
        jt["q_drop"], jt["qneg_drop"], interpret=True))
    want = jbc.moddown_finish(x[0][: jt["n_out"]], y, jt["w"], jt["d"],
                              jt["inv_d"], jt["psi_out"], jt["p_inv"],
                              jt["q_out"], jt["qneg_out"], interpret=True)
    got = ops.moddown_finish(_t(x[:1, : jt["n_out"]]), _t(y[None]), t["w"],
                             t["d"], t["inv_d"], t["psi_out"], t["p_inv"],
                             t["q_out"], t["qneg_out"])
    np.testing.assert_array_equal(u32(got[0]), np.asarray(want))


def test_fused_hlt_indexed_matches_reference(engs):
    """3 unique diagonal sets of d = 5 real rotations (one z = 0), padded to
    d_pad = 6 for chunk 2 with identity/zero/is_id entries, 2 hoisting
    slots, a batch of 4 routed through both slot vectors."""
    eng, jeng = engs
    p = eng.params
    N, level = p.N, p.L
    full = eng.tools.digit_bases(level)[0][2]
    qs = [eng.ctx.moduli_host[i] for i in full]
    M, nbeta = len(full), len(eng.tools.digit_bases(level))
    H, S, d, d_pad, chunk = 2, 3, 5, 6, 2
    rng = np.random.default_rng(30)

    def limbs(*lead):
        return _rand(rng, qs, lead + (M, N)).astype(np.uint32)

    zsets = [(0, 1, -1, 3, 5), (2, -3, 0, 7, -6), (1, 2, 3, 4, 0)]
    perms = np.tile(np.arange(N, dtype=np.int32), (S, d_pad, 1))
    is_id = np.ones((S, d_pad, 1), np.int32)
    for s, zs in enumerate(zsets):
        for r, z in enumerate(zs):
            if z:
                perms[s, r] = jauto.eval_perm(N, jauto.galois_elt_rot(z, N))
            is_id[s, r, 0] = int(z == 0)
    digits = limbs(H, nbeta)
    c0e, c1e = limbs(H), limbs(H)
    u = limbs(S, d_pad)
    u[:, d:] = 0
    rk0, rk1 = limbs(S, d_pad, nbeta), limbs(S, d_pad, nbeta)
    rk0[:, d:] = 0
    rk1[:, d:] = 0
    ct_slots = np.array([0, 1, 1, 0], np.int32)
    diag_slots = np.array([2, 0, 1, 2], np.int32)
    view = jeng.basis(full)
    j0, j1 = jfh.fused_hlt_indexed(
        digits, c0e, c1e, u, rk0, rk1, perms, is_id, ct_slots, diag_slots,
        view.moduli_u32, view.qneg_inv, chunk=chunk, interpret=True)
    tv = eng.basis(full)
    got = ops.fused_hlt_indexed(
        _t(digits), _t(c0e), _t(c1e), _t(u), _t(rk0), _t(rk1),
        torch.from_numpy(perms), torch.from_numpy(is_id),
        torch.from_numpy(ct_slots), torch.from_numpy(diag_slots),
        tv.moduli_u32, tv.qneg_inv)
    assert got.shape == (2, 4, M, N)
    np.testing.assert_array_equal(u32(got[0]), np.asarray(j0))
    np.testing.assert_array_equal(u32(got[1]), np.asarray(j1))
    # the padding contributes nothing: the unpadded operands agree
    got_d = fh.fused_hlt_indexed_plain(
        _t(digits), _t(c0e), _t(c1e), _t(u[:, :d]), _t(rk0[:, :d]),
        _t(rk1[:, :d]), torch.from_numpy(perms[:, :d].copy()),
        torch.from_numpy(is_id[:, :d].copy()), torch.from_numpy(ct_slots),
        torch.from_numpy(diag_slots), tv.moduli_u32, tv.qneg_inv)
    assert torch.equal(got, got_d)


def test_cuda_wrappers_refuse_cpu_tensors_and_large_rings():
    """A wrapper's kernel path never takes a CPU tensor (no silent plain
    fallback inside the CUDA wrapper), and N > 2^16, beyond what a
    cluster of blocks splits, raises rather than falling back."""
    x = torch.zeros((1, 64), dtype=torch.int32)
    col = torch.zeros((1, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        bc.intt_scale_cuda(x, x, col, col, col, col)
    with pytest.raises(ValueError, match="2\\^17"):
        bc.intt_scale_cuda(torch.zeros((1, 1 << 17), dtype=torch.int32),
                           x, col, col, col, col)
