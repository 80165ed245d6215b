"""The port's block MM and serving pool on the multi-device HE schedule,
on spawned gloo ranks of the CPU, against the JAX reference's one-device
``mo`` run in this process from the same seeds — the counterparts of
``tests/test_sharded.py``'s block MM cases:

* ``SecureMatmulEngine(mesh=)`` block MM at tile 4, 6×5·5×7 and
  10×7·7×13 (a ragged (3, 2, 4) grid), every output tile array-equal;
* ``SessionPool(mesh=)`` on 2 ranks: one flush of two tenants' calls equal
  to the one-device pool's flush.
"""
import warnings

import numpy as np
import pytest

import repro  # noqa: F401
from repro.core.params import toy_params as j_toy
from repro.secure import SecureMatmulEngine as JSecureMatmulEngine

import _sharded_ranks as ranks
from repro_torch.launch.mesh import spawn
from test_torch_sharded import assert_equal

BLOCKMM_SHAPES = ((6, 5, 7), (10, 7, 13))


@pytest.fixture(scope="module")
def mesh2x2():
    return spawn(ranks.blockmm_on_2x2, 4, BLOCKMM_SHAPES, device="cpu",
                 backend="gloo")


@pytest.fixture(scope="module")
def e_mo():
    """The reference's one-device engine, keys from seed 9 (as each rank's
    engine); its compiled tile programs serve both shapes."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        eng = JSecureMatmulEngine(j_toy(logN=6, L=4, k=3, beta=2), tile=4,
                                  schedule="mo")
    eng.keygen(np.random.default_rng(9))
    return eng


@pytest.mark.parametrize("shape", BLOCKMM_SHAPES,
                         ids=["x".join(map(str, s)) for s in BLOCKMM_SHAPES])
def test_secure_matmul_engine_mesh_block_mm(mesh2x2, e_mo, shape):
    m, l, n = shape
    rng = np.random.default_rng(4)
    A, B = rng.uniform(-1, 1, (m, l)), rng.uniform(-1, 1, (l, n))
    At, Bt = e_mo.encrypt_tiles(A, rng), e_mo.encrypt_tiles(B, rng)
    want = e_mo.matmul_encrypted(At, Bt, batched=True)
    for rank in mesh2x2:
        got = rank[shape]
        assert got["batched"] and got["device"] == "cpu"
        assert len(got["tiles"]) == len(want)
        for wr, gr in zip(want, got["tiles"], strict=True):
            for w, g in zip(wr, gr, strict=True):
                assert_equal(w, g)
        assert got["err"] < 0.1


def test_session_pool_mesh_flush_equals_one_device():
    for rank in spawn(ranks.pool_flush, 2, 2, device="cpu", backend="gloo"):
        mesh, one = rank["mesh"], rank["one"]
        assert (mesh["schedule"], one["schedule"]) == ("sharded", "pallas")
        assert mesh["rows"].keys() == one["rows"].keys()
        for key, row in one["rows"].items():
            np.testing.assert_array_equal(mesh["rows"][key], row)
            np.testing.assert_allclose(row, rank["x_w"][key[0]], atol=0.1)
        assert mesh["launches"] == one["launches"] == (2, 4)
