"""The indexing of ``csrc/fused_hlt.cu``: output tiles, staged source
tiles and limb groups.

A Galois automorphism in bit-reversed evaluation order maps every aligned
tile of T output positions onto one aligned tile of T source positions
(multiplying an odd exponent by g mod 2N fixes its low bits as a function
of its low bits; bit reversal makes those the high bits of the position).
The kernel relies on that to copy one source tile per rotation into shared
memory; it votes per block and gathers from the whole row where the
property fails, as for a random permutation.  Here: the property for
every Galois element of the Set-B hemm 128³ (σ: 128·i, τ: i, Step 2:
k and k − 128) at logN 6, 7, 10 and 15 (numpy only); its failure for a
random permutation; and ``fused_hlt_tiled_plain`` (the kernel's indexing
in torch: source tile, offset, limb groups, path counts) array-equal to
``fused_hlt_indexed_plain`` and to the reference's Pallas
``fused_hlt_indexed`` in interpret mode, on Galois and on random
permutations at logN 6/7 (tolerance: none)."""
import numpy as np
import pytest
import torch

import repro  # noqa: F401
import repro.configs.fame_sets as jfs
from repro.core import automorph as jauto
from repro.core.ckks import CkksEngine as JEngine
from repro.kernels import fused_hlt as jfh

from repro_torch.configs.fame_sets import FAME_VERIFY_SETS
from repro_torch.core import automorph
from repro_torch.core.ckks import CkksEngine
from repro_torch.kernels import fused_hlt as fh
from test_torch_common import u32

#: rotations of the Set-B hemm 128^3: Step 1's σ (128·i) and τ (i) sets,
#: i in [-127, 127], and Step 2's {k, k - 128} for k < 128
SET_B_ROTATIONS = sorted({128 * i for i in range(-127, 128)}
                         | set(range(-128, 128)))


def _tile_local(perm: np.ndarray, T: int) -> bool:
    src = perm.reshape(-1, T) // T
    return bool((src == src[:, :1]).all())


@pytest.mark.parametrize("logN", [6, 7, 10, 15])
def test_galois_permutations_map_tiles_onto_tiles(logN):
    N = 1 << logN
    elts = sorted({automorph.galois_elt_rot(z, N) for z in SET_B_ROTATIONS})
    for g in elts:
        # uncached: at logN 15 the cache would hold ~130 MB of rows
        perm = automorph.eval_perm.__wrapped__(N, g)
        for T in (32, 256, 1024):
            if T <= N:
                assert _tile_local(perm, T), (logN, g, T)
        src = fh.tile_sources(torch.from_numpy(perm), fh.tile_size(N))
        assert int(src.min()) >= 0


def test_a_random_permutation_is_not_tile_local():
    rng = np.random.default_rng(152)
    for logN in (6, 7, 10):
        N = 1 << logN
        perm = rng.permutation(N)
        for T in (8, 32):
            assert not _tile_local(perm, T)
            assert int(fh.tile_sources(torch.from_numpy(perm), T).min()) == -1


def test_tile_sources_names_the_source_tile():
    N, T = 64, 16
    g = automorph.galois_elt_rot(3, N)
    perm = automorph.eval_perm(N, g)
    src = fh.tile_sources(torch.from_numpy(perm), T)
    assert src.tolist() == [int(perm[t * T]) // T for t in range(N // T)]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.uint32).view(np.int32))


@pytest.fixture(scope="module", params=list(FAME_VERIFY_SETS))
def batch(request):
    """2 hoisting slots, 3 diagonal sets of d = 4 (one z = 0 each), a batch
    of 4 through both slot vectors; set 2 holds random permutations.  The
    reference's interpret-mode output and the plain one."""
    name = request.param
    eng = CkksEngine(FAME_VERIFY_SETS[name], device="cpu")
    jeng = JEngine(jfs.FAME_VERIFY_SETS[name])
    N, level = eng.params.N, eng.params.L
    full = eng.tools.digit_bases(level)[0][2]
    qs = np.asarray([eng.ctx.moduli_host[i] for i in full], np.uint64)[:, None]
    M, nbeta = len(full), len(eng.tools.digit_bases(level))
    H, S, d = 2, 3, 4
    rng = np.random.default_rng(153 + eng.params.logN)

    def limbs(*lead):
        return rng.integers(0, qs, lead + (M, N)).astype(np.uint32)

    perms = np.tile(np.arange(N, dtype=np.int32), (S, d, 1))
    is_id = np.zeros((S, d, 1), np.int32)
    for s, zs in enumerate([(0, 1, -3, 128), (7, 0, -128, 5)]):
        for r, z in enumerate(zs):
            if z:
                perms[s, r] = jauto.eval_perm(N, jauto.galois_elt_rot(z, N))
            is_id[s, r, 0] = int(z == 0)
    for r in range(1, d):
        perms[2, r] = rng.permutation(N)
    is_id[2, 0, 0] = 1
    digits = limbs(H, nbeta)
    c0e, c1e = limbs(H), limbs(H)
    u = limbs(S, d)
    rk0, rk1 = limbs(S, d, nbeta), limbs(S, d, nbeta)
    ct_slots = np.array([0, 1, 1, 0], np.int32)
    diag_slots = np.array([2, 0, 1, 2], np.int32)
    view = jeng.basis(full)
    want = jfh.fused_hlt_indexed(
        digits, c0e, c1e, u, rk0, rk1, perms, is_id, ct_slots, diag_slots,
        view.moduli_u32, view.qneg_inv, chunk=2, interpret=True)
    tv = eng.basis(full)
    args = (_t(digits), _t(c0e), _t(c1e), _t(u), _t(rk0), _t(rk1),
            torch.from_numpy(perms), torch.from_numpy(is_id),
            torch.from_numpy(ct_slots), torch.from_numpy(diag_slots),
            tv.moduli_u32, tv.qneg_inv)
    return dict(args=args, M=M, N=N, d=d, want=np.stack(
        [np.asarray(w) for w in want]), plain=fh.fused_hlt_indexed_plain(*args))


@pytest.mark.parametrize("T,g", [(None, None), (32, 1), (16, 2), (8, 3),
                                 (32, 4), (16, 8)])
def test_tiled_indexing_equals_plain_and_reference(batch, T, g):
    out, paths = fh.fused_hlt_tiled_plain(*batch["args"], T=T, g=g)
    np.testing.assert_array_equal(u32(out), batch["want"])
    assert torch.equal(out, batch["plain"])
    # paths per (block, rotation): batch elements 0 and 3 run set 2 (one
    # identity, 3 random rotations), 1 set 0 and 2 set 1 (one identity,
    # 3 Galois rotations each)
    N, M = batch["N"], batch["M"]
    T = T or fh.tile_size(N)
    g = g or fh.limb_group(M, batch["d"])
    blocks = (N // T) * -(-M // g)
    staged, gathered, ident = paths
    assert ident == 4 * blocks
    assert staged + gathered == 4 * 3 * blocks
    assert staged >= 2 * 3 * blocks          # every Galois rotation staged
    if T == N:                               # one tile: always its own
        assert gathered == 0
    elif T <= 32:                            # random rows miss the vote
        assert gathered == 2 * 3 * blocks


def test_limb_group_fits_the_kernel():
    """g limbs of T/4 threads each: at most 512 threads a block, never more
    limbs than there are; 2 at the Set-B Step-1 shape (d = 255), 1 at
    Step 2 (d = 2)."""
    for M in (1, 3, 23, 24, 40):
        for d in (1, 2, 8, 255):
            g = fh.limb_group(M, d)
            assert 1 <= g <= min(M, 8)
            assert g * fh.tile_size(1 << 15) // 4 <= 512
    assert fh.limb_group(24, 255) == 2 and fh.limb_group(23, 2) == 1
