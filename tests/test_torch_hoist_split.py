"""The order of ``csrc/intt_scale.cu`` and ``csrc/hoist.cu`` (each row over
a thread-block cluster of C blocks) in plain torch, against the plain
versions and the reference.

``intt_scale_split_plain`` runs ``intt_split_plain`` with the kernel's one
epilogue product by montmul(N⁻¹, scale), optionally through the kernel's
row table; ``hoist_db_split_plain`` and ``baseconv_ntt_split_plain``
compute the BaseConv for each block's r-slice and run ``ntt_split_plain``,
the own limbs passed through.  Each must be array-equal to its plain
version for every C at logN 10 (fame-m-rt's tables with seeded random
Montgomery twiddles: its primes have no 2048th root of unity, and the
butterfly network is the same function of any twiddle table), and to the
reference's Pallas ``intt_scale`` / ``hoist_db`` / ``baseconv_ntt`` in
interpret mode at logN 6 and 7 on both verify sets, at the two top levels
(one of which has a short last digit; every level has passthrough rows).
Tolerance: none.  The CUDA kernels are held against the plain versions on
the card by ``chip_smoke.py``."""
import numpy as np
import pytest
import torch

import repro  # noqa: F401
import repro.configs.fame_sets as jfs
from repro.core.ckks import CkksEngine as JEngine
from repro.kernels import basechange as jbc

from repro_torch.configs.fame_sets import FAME_VERIFY_SETS
from repro_torch.core.ckks import CkksEngine
from repro_torch.core.params import SET_C
from repro_torch.kernels import basechange as bc, ntt as kntt
from test_torch_common import u32

HOIST_KEYS = ("psii_pad", "ninv_pad", "hat_pad", "q_pad", "qneg_pad", "w",
              "d", "inv_d", "psi_full", "q_full", "qneg_full", "mask")
BC_KEYS = ("w", "d", "inv_d", "psi_full", "q_full", "qneg_full")
DROP_KEYS = ("psii_drop", "ninv_drop", "hat_drop", "q_drop", "qneg_drop")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.uint32).view(np.int32))


def _np(t):
    return t.numpy().view(np.uint32)


def _rand(rng, q_col, lead, N):
    """Residues (*lead, len(q_col), N) below the (R, 1) moduli column."""
    q = np.asarray(q_col, np.uint64).reshape(-1, 1)
    return rng.integers(0, q, lead + (len(q), N)).astype(np.uint32)


def _digit_rows(rng, t, N):
    """Scaled digit rows y (nbeta·alpha, N), a short digit's padded rows
    zero, and a passthrough (M, N), as the single hoist passes them."""
    y = _rand(rng, _np(t["q_pad"]), (), N)
    y[t["nq"]:] = 0
    return _t(y), _t(_rand(rng, _np(t["q_full"]), (), N))


# ---------------------------------------------------------------------------
# logN 10: every cluster size against the plain versions
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ring10():
    """fame-m-rt's tables at levels L and L − 1 (a short last digit) with
    random (·, 1024) Montgomery twiddle tables, and random inputs."""
    eng = CkksEngine(FAME_VERIFY_SETS["fame-m-rt"], device="cpu")
    N = 1 << 10
    rng = np.random.default_rng(1610)
    out = {}
    for level in (eng.params.L, eng.params.L - 1):
        t = dict(eng.fused_hoist_tables(level))
        t["psii_pad"] = _t(_rand(rng, _np(t["q_pad"]), (), N))
        t["psi_full"] = _t(_rand(rng, _np(t["q_full"]), (), N))
        c1s = _t(_rand(rng, _np(t["q_full"])[:t["nq"]], (3,), N))
        out[level] = (t, c1s) + _digit_rows(rng, t, N)
    md = dict(eng.fused_moddown_tables(eng.params.L))
    md["psii_drop"] = _t(_rand(rng, _np(md["q_drop"]), (), N))
    p = eng.params
    q_ext = [eng.ctx.moduli_host[i] for i in
             [*range(p.L + 1), *range(p.num_main, p.num_total)]]
    out["moddown"] = (md, _t(_rand(rng, q_ext, (3,), N)))
    return out


@pytest.mark.parametrize("C", [1, 2, 4, 8, 16])
def test_intt_scale_split_equals_plain_at_logn10(ring10, C):
    t, c1s = ring10[max(k for k in ring10 if k != "moddown")][:2]
    nq = c1s.shape[1]
    tabs = tuple(t[k][:nq] for k in HOIST_KEYS[:5])
    want = bc.intt_scale_plain(c1s, *tabs)
    assert torch.equal(bc.intt_scale_split_plain(c1s, *tabs, C), want)


@pytest.mark.parametrize("C", [1, 2, 4, 8, 16])
def test_intt_scale_split_row_table_equals_gather_at_logn10(ring10, C):
    """The merged ModDown's launch: the drop rows read in place through
    the row table, against the plain version of the gathered rows."""
    md, x_full = ring10["moddown"]
    tabs = tuple(md[k] for k in DROP_KEYS)
    want = bc.intt_scale_plain(x_full[:, md["drop_idx"]], *tabs)
    got = bc.intt_scale_split_plain(x_full, *tabs, C, rows=md["drop_idx"])
    assert torch.equal(got, want)


@pytest.mark.parametrize("C", [1, 2, 4, 8, 16])
def test_hoist_db_split_equals_plain_at_logn10(ring10, C):
    for level in (k for k in ring10 if k != "moddown"):
        t, c1s = ring10[level][:2]
        tabs = tuple(t[k] for k in HOIST_KEYS)
        kw = dict(nbeta=t["nbeta"], alpha=t["alpha"])
        assert torch.equal(bc.hoist_db_split_plain(c1s, *tabs, C=C, **kw),
                           bc.hoist_db_plain(c1s, *tabs, **kw))


@pytest.mark.parametrize("C", [1, 2, 4, 8, 16])
def test_baseconv_ntt_split_equals_plain_at_logn10(ring10, C):
    for level in (k for k in ring10 if k != "moddown"):
        t, _, y, pt = ring10[level]
        args = (y,) + tuple(t[k] for k in BC_KEYS) + (pt, t["mask"])
        assert torch.equal(bc.baseconv_ntt_split_plain(*args, C),
                           bc.baseconv_ntt_plain(*args))


# ---------------------------------------------------------------------------
# logN 6/7: against the reference's Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=list(FAME_VERIFY_SETS))
def verify_set(request):
    """Both verify sets at their own logN: the port's and the reference's
    tables at levels L and L − 1, random inputs, and the reference's
    interpret-mode outputs."""
    name = request.param
    eng = CkksEngine(FAME_VERIFY_SETS[name], device="cpu")
    jeng = JEngine(jfs.FAME_VERIFY_SETS[name])
    p = eng.params
    rng = np.random.default_rng(160 + p.logN)
    out = dict(N=p.N, levels={})
    for level in (p.L, p.L - 1):
        jt, t = jeng.fused_hoist_tables(level), eng.fused_hoist_tables(level)
        nq = level + 1
        c1s = _rand(rng, np.asarray(jt["q_full"])[:nq], (2,), p.N)
        y, pt = _digit_rows(rng, t, p.N)
        out["levels"][level] = dict(
            t=t, c1s=_t(c1s), y=y, pt=pt,
            hoist=np.asarray(jbc.hoist_fused_db(c1s, jt, interpret=True)),
            bcntt=np.asarray(jbc.baseconv_ntt(
                _np(y), jt["w"], jt["d"], jt["inv_d"], jt["psi_full"],
                jt["q_full"], jt["qneg_full"], _np(pt), jt["mask"],
                interpret=True)))
    jm, md = jeng.fused_moddown_tables(p.L), eng.fused_moddown_tables(p.L)
    x_full = _rand(rng, [eng.ctx.moduli_host[i] for i in
                         [*range(p.L + 1), *range(p.num_main, p.num_total)]],
                   (2,), p.N)
    out["moddown"] = dict(md=md, x_full=_t(x_full), want=np.stack([
        np.asarray(jbc.intt_scale(
            x[jm["drop_idx"]], jm["psii_drop"], jm["ninv_drop"],
            jm["hat_drop"], jm["q_drop"], jm["qneg_drop"], interpret=True))
        for x in x_full]))
    return out


@pytest.mark.parametrize("C", [1, 2, 4, 8])
def test_intt_scale_split_equals_reference_on_verify_sets(verify_set, C):
    """The row-table launch of the merged ModDown, and the same rows
    gathered first, against the reference's interpret-mode intt_scale."""
    m = verify_set["moddown"]
    md, x_full = m["md"], m["x_full"]
    tabs = tuple(md[k] for k in DROP_KEYS)
    got = bc.intt_scale_split_plain(x_full, *tabs, C, rows=md["drop_idx"])
    np.testing.assert_array_equal(u32(got), m["want"])
    gathered = bc.intt_scale_split_plain(x_full[:, md["drop_idx"]], *tabs, C)
    np.testing.assert_array_equal(u32(gathered), m["want"])
    np.testing.assert_array_equal(
        u32(bc.intt_scale_plain(x_full[:, md["drop_idx"]], *tabs)), m["want"])


@pytest.mark.parametrize("C", [1, 2, 4, 8])
def test_hoist_split_equals_reference_on_verify_sets(verify_set, C):
    """hoist_db (2 ciphertexts) and baseconv_ntt at levels L and L − 1,
    short last digit and passthrough rows included."""
    short = 0
    for v in verify_set["levels"].values():
        t = v["t"]
        short += t["nq"] % t["alpha"] != 0
        assert int(t["mask"].sum()) == t["nq"]      # passthrough rows
        got = bc.hoist_db_split_plain(v["c1s"], *(t[k] for k in HOIST_KEYS),
                                      nbeta=t["nbeta"], alpha=t["alpha"], C=C)
        np.testing.assert_array_equal(u32(got), v["hoist"])
        got = bc.baseconv_ntt_split_plain(
            v["y"], *(t[k] for k in BC_KEYS), v["pt"], t["mask"], C)
        np.testing.assert_array_equal(u32(got), v["bcntt"])
    assert short


# ---------------------------------------------------------------------------
# cluster sizes at Set-C
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rows", [
    2 * 3 * 44,              # hoist_db's BaseConv+NTT: 2 ciphertexts, β 3, M 44
    3 * 44,                  # baseconv_ntt: one ciphertext
    2 * 32, 2 * 31,          # hoist_db's intt_scale: 2 × nq at levels 31, 30
    4 * 13, 128 * 13, 2 * 13,  # the merged ModDowns' intt_scale (nd 13):
                             # Step 1, Step 2 of hemm 32³, unbatched
    4 * 31, 128 * 30, 2 * 30,  # their moddown_finish
    4, 1])                   # the smoke's Set-C rows
def test_cluster_size_at_set_c_shapes(rows):
    """At logN 16 a chunk holds at most 2^13 values, so every launch of the
    Set-C path splits a row over at least 8 blocks."""
    C = kntt.cluster_size(rows, SET_C.N)
    assert C >= 8 and SET_C.N // C <= 1 << 13
    assert bc._logc(rows, SET_C.N) == C.bit_length() - 1
