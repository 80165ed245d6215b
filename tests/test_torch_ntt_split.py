"""The split schedule of ``csrc/ntt.cu`` (a row over a thread-block
cluster) in plain torch, against the plain transforms and the reference.

``ntt_split_plain`` / ``intt_split_plain`` run the kernel's butterflies in
the kernel's order — cross stages on the (C, N/C) view, the exchange, the
chunk-local stages with global twiddle indices — for every cluster size C
the entry point can pick.  They must be array-equal to ``ntt_mont_raw`` /
``intt_mont_raw`` and to the reference's Pallas ``ntt`` / ``intt`` in
interpret mode (tolerance: none).  At logN 6 and 7 the tables are the
verify sets' own; at logN 10 the rows are fame-m-rt's moduli with seeded
random Montgomery twiddles (their primes have no 2048th root of unity; the
butterfly network is the same function of any twiddle table).  The CUDA
kernel is held against the plain versions on the card by
``chip_smoke.py``."""
import numpy as np
import pytest
import torch

import repro  # noqa: F401
from repro.kernels import ntt as jntt

from repro_torch.configs.fame_sets import FAME_VERIFY_SETS
from repro_torch.core import ntt as core_ntt
from repro_torch.core.params import get_context
from repro_torch.kernels import ntt as kntt
from test_torch_common import u32

CASES = [(6, 1), (6, 2), (6, 4), (6, 8), (7, 1), (7, 2), (7, 4), (7, 8),
         (10, 1), (10, 2), (10, 4), (10, 8), (10, 16)]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.uint32).view(np.int32))


@pytest.fixture(scope="module")
def ring(request):
    """Inputs (B = 2, all limbs), tables, and the reference's interpret-mode
    outputs at one logN."""
    logN = request.param
    p = {6: FAME_VERIFY_SETS["fame-s-rt"], 7: FAME_VERIFY_SETS["fame-m-rt"],
         10: FAME_VERIFY_SETS["fame-m-rt"]}[logN]
    N = 1 << logN
    host = get_context(p, "cpu").host
    qs = np.asarray(host.moduli, np.uint64)[:, None]
    M = len(host.moduli)
    rng = np.random.default_rng(140 + logN)
    if logN == p.logN:
        psi, psii = host.psi_brv_mont, host.psi_inv_brv_mont
        ninv = host.n_inv_mont[:, None]
    else:
        psi, psii = (rng.integers(0, qs, (M, N)).astype(np.uint32)
                     for _ in range(2))
        ninv = rng.integers(0, qs, (M, 1)).astype(np.uint32)
    q32 = qs.astype(np.uint32)
    qneg = host.qneg_inv[:, None]
    x = rng.integers(0, qs, (2, M, N)).astype(np.uint32)
    return dict(
        logN=logN, x=x, real=logN == p.logN,
        fwd=(_t(psi), _t(q32), _t(qneg)),
        inv=(_t(psii), _t(ninv), _t(q32), _t(qneg)),
        want=np.asarray(jntt.ntt(x, psi, q32, qneg, interpret=True)),
        want_i=np.asarray(jntt.intt(x, psii, ninv, q32, qneg, interpret=True)))


@pytest.mark.parametrize("ring,C", CASES, indirect=["ring"])
def test_split_schedule_equals_plain_and_reference(ring, C):
    x = _t(ring["x"])
    got = kntt.ntt_split_plain(x, *ring["fwd"], C)
    np.testing.assert_array_equal(u32(got), ring["want"])
    np.testing.assert_array_equal(
        u32(core_ntt.ntt_mont_raw(x, *ring["fwd"])), ring["want"])
    got_i = kntt.intt_split_plain(x, *ring["inv"], C)
    np.testing.assert_array_equal(u32(got_i), ring["want_i"])
    np.testing.assert_array_equal(
        u32(core_ntt.intt_mont_raw(x, *ring["inv"])), ring["want_i"])
    if ring["real"]:
        back = kntt.intt_split_plain(got, *ring["inv"], C)
        np.testing.assert_array_equal(u32(back), ring["x"])


@pytest.mark.parametrize("rows,want", [(1, 16), (6, 16), (8, 16), (13, 8),
                                       (14, 8), (16, 8), (22, 8)])
def test_cluster_size_for_engine_row_counts(rows, want):
    """The engine's launches at Set-B (logN 15): 1-22 rows.  One cluster of
    16 a row while 16·rows fits the 132 SMs, else the portable 8; a 2^16
    row the same; small rings shrink C so a chunk keeps >= 1024 values."""
    assert kntt.cluster_size(rows, 1 << 15) == want
    assert kntt.cluster_size(rows, 1 << 16) == want
    for logN, c in ((6, 1), (7, 1), (10, 1), (11, 2), (12, 4), (13, 8)):
        assert kntt.cluster_size(rows, 1 << logN) == c
    assert kntt.cluster_size(rows, 1 << 14) == min(want, 16)


def test_split_refuses_clusters_larger_than_a_chunk_and_large_rings():
    x = torch.zeros((1, 1, 64), dtype=torch.int32)
    col = torch.ones((1, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="cannot split"):
        kntt.ntt_split_plain(x, x[0], col, col, 16)
    with pytest.raises(ValueError, match="cannot split"):
        kntt.intt_split_plain(x, x[0], col, col, col, 3)
    big = torch.zeros((1, 1, 1 << 17), dtype=torch.int32)
    with pytest.raises(ValueError, match="2\\^17"):
        kntt._logn(big.shape[-1])
    assert kntt._logn(1 << 16) == 16


def test_split_schedule_on_a_row_slice_batch_stride():
    """Row slices of a larger polynomial, as the engine passes them: the
    schedule reads the same values as on a contiguous copy."""
    p = FAME_VERIFY_SETS["fame-m-rt"]
    ctx = get_context(p, "cpu")
    rng = np.random.default_rng(141)
    qs = np.asarray(ctx.moduli_host, np.uint64)[:, None]
    full = _t(rng.integers(0, qs, (2, len(qs), p.N)).astype(np.uint32))
    v = ctx.slc(np.arange(2, 5))
    xs = full[:, 2:5]
    for C in (1, 4):
        assert torch.equal(
            kntt.ntt_split_plain(xs, v.psi_brv_mont, v.moduli_u32,
                                 v.qneg_inv, C),
            core_ntt.ntt_mont_raw(xs.contiguous(), v.psi_brv_mont,
                                  v.moduli_u32, v.qneg_inv))
