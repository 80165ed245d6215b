"""The order of ``csrc/moddown.cu`` (one (polynomial, target row) over a
thread-block cluster, the BaseConv computed into the NTT's cross stages)
in plain torch, against the plain ``moddown_finish`` and the reference.

``moddown_finish_split_plain`` computes the BaseConv for each block's
r-slice, runs ``ntt_split_plain`` and the epilogue (x − conv)·P⁻¹ for a
cluster of C blocks.  It must be array-equal to ``moddown_finish_plain``
for every C at logN 10 (fame-m-rt's merged-ModDown tables with seeded
random Montgomery twiddles: its primes have no 2048th root of unity, and
the butterfly network is the same function of any twiddle table) and to
the reference's Pallas ``moddown_finish`` in interpret mode at logN 6 and 7
on both verify sets (tolerance: none).  The CUDA kernel is held against
the plain version on the card by ``chip_smoke.py``."""
import pathlib

import numpy as np
import pytest
import torch

import repro  # noqa: F401
import repro.configs.fame_sets as jfs
from repro.core.ckks import CkksEngine as JEngine
from repro.kernels import basechange as jbc

from repro_torch.configs.fame_sets import FAME_VERIFY_SETS
from repro_torch.core.ckks import CkksEngine
from repro_torch.kernels import basechange as bc, ntt as kntt
from test_torch_common import u32

TABLE_KEYS = ("w", "d", "inv_d", "psi_out", "p_inv", "q_out", "qneg_out")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.uint32).view(np.int32))


def _operands(rng, q_out, q_drop, P, N):
    """Random target rows x (P, R, N) and scaled drop rows y (P, nd, N);
    q_out (R, 1) and q_drop (nd, 1) their moduli."""
    q_out = np.asarray(q_out, np.uint64)
    q_drop = np.asarray(q_drop, np.uint64)
    x = rng.integers(0, q_out, (P, len(q_out), N)).astype(np.uint32)
    y = rng.integers(0, q_drop, (P, len(q_drop), N)).astype(np.uint32)
    return x, y


@pytest.fixture(scope="module", params=list(FAME_VERIFY_SETS))
def verify_set(request):
    """Both verify sets at their own logN: inputs, the port's tables and the
    reference's interpret-mode output per polynomial."""
    name = request.param
    eng = CkksEngine(FAME_VERIFY_SETS[name], device="cpu")
    jeng = JEngine(jfs.FAME_VERIFY_SETS[name])
    level = eng.params.L
    jt = jeng.fused_moddown_tables(level)
    t = eng.fused_moddown_tables(level)
    rng = np.random.default_rng(150 + eng.params.logN)
    x, y = _operands(rng, jt["q_out"], jt["q_drop"], 2, eng.params.N)
    want = np.stack([np.asarray(jbc.moddown_finish(
        x[p], y[p], *(jt[k] for k in TABLE_KEYS), interpret=True))
        for p in range(2)])
    return dict(x=_t(x), y=_t(y), tabs=tuple(t[k] for k in TABLE_KEYS),
                want=want, N=eng.params.N)


@pytest.mark.parametrize("C", [1, 2, 4, 8])
def test_split_order_equals_reference_on_verify_sets(verify_set, C):
    v = verify_set
    got = bc.moddown_finish_split_plain(v["x"], v["y"], *v["tabs"], C)
    np.testing.assert_array_equal(u32(got), v["want"])
    np.testing.assert_array_equal(
        u32(bc.moddown_finish_plain(v["x"], v["y"], *v["tabs"])), v["want"])


@pytest.fixture(scope="module")
def ring10():
    """fame-m-rt's merged-ModDown tables at level L with a random (R, 1024)
    Montgomery twiddle table; 3 polynomials."""
    eng = CkksEngine(FAME_VERIFY_SETS["fame-m-rt"], device="cpu")
    t = dict(eng.fused_moddown_tables(eng.params.L))
    N = 1 << 10
    rng = np.random.default_rng(1510)
    q_out = t["q_out"].numpy().view(np.uint32)
    t["psi_out"] = _t(rng.integers(0, q_out.astype(np.uint64),
                                   (len(q_out), N)))
    x, y = _operands(rng, q_out, t["q_drop"].numpy().view(np.uint32), 3, N)
    tabs = tuple(t[k] for k in TABLE_KEYS)
    want = bc.moddown_finish_plain(_t(x), _t(y), *tabs)
    return dict(x=_t(x), y=_t(y), tabs=tabs, want=want)


@pytest.mark.parametrize("C", [1, 2, 4, 8, 16])
def test_split_order_equals_plain_at_logn10(ring10, C):
    r = ring10
    got = bc.moddown_finish_split_plain(r["x"], r["y"], *r["tabs"], C)
    assert torch.equal(got, r["want"])


def test_split_order_reads_a_row_slice_batch_stride(ring10):
    """x as the merged ModDown passes it: the target rows of a larger
    polynomial (a batch stride above R·N)."""
    r = ring10
    P, R, N = r["x"].shape
    wide = torch.zeros((P, R + 5, N), dtype=torch.int32)
    wide[:, :R] = r["x"]
    got = bc.moddown_finish_split_plain(wide[:, :R], r["y"], *r["tabs"], 4)
    assert torch.equal(got, r["want"])


@pytest.mark.parametrize("P,R,logN,want", [
    (4, 15, 15, 8),                          # Set-B batched Step 1
    (512, 14, 15, 8),                        # Set-B batched Step 2
    (2, 15, 15, 8),                          # Set-B unbatched, level 15
    (2, 14, 15, 8),                          # Set-B unbatched, level 14
    (1, 8, 15, 16), (1, 1, 15, 16),          # one cluster of 16 a row fits
    (4, 31, 16, 8),                          # Set-C: a chunk <= 2^13
    (2, 3, 7, 1), (2, 3, 10, 1), (2, 3, 11, 2), (60, 3, 12, 4)])
def test_cluster_size_for_set_b_shapes(P, R, logN, want):
    """moddown_finish_cuda spreads its P·R rows as ntt does: C = 8 at every
    Set-B shape (the fastest of 4, 8 and 16 there), 8 at Set-C."""
    assert kntt.cluster_size(P * R, 1 << logN) == want


def test_moddown_takes_logn16_and_names_the_one_block_kernels():
    """Every row kernel splits its row over a cluster, so each takes 2^16
    and stops at 2^17 with the one limit's message; none holds a row in
    one block any more."""
    assert bc._logn(1 << 16) == bc.SPLIT_MAX_LOGN == 16
    with pytest.raises(ValueError, match="2\\^17"):
        bc._logn(1 << 17)
    x = torch.zeros((1, 1, 1 << 17), dtype=torch.int32)
    col = torch.zeros((1, 1), dtype=torch.int32)
    for call in (lambda: bc.intt_scale_cuda(x, x[0], col, col, col, col),
                 lambda: bc.moddown_finish_cuda(x, x, col, col, col, x[0],
                                                col, col, col),
                 lambda: bc.baseconv_ntt_cuda(x[0], col[None], col[None],
                                              col[None].double(), x[0], col,
                                              col, x[0], col[None]),
                 lambda: bc.hoist_db_cuda(x, x[0], col, col, col, col,
                                          col[None], col[None],
                                          col[None].double(), x[0], col, col,
                                          col[None], nbeta=1, alpha=1)):
        with pytest.raises(ValueError, match="N <= 2\\^16"):
            call()
    src = (pathlib.Path(__file__).resolve().parents[1]
           / "src/repro_torch/csrc/common.cuh").read_text()
    for gone in ("block_ntt_fwd", "block_intt", "row_threads",
                 "reserve_row_smem"):
        assert gone not in src
