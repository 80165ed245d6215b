"""The depth-3 chain on the multi-device HE schedule, on spawned gloo
ranks of the CPU (data 2 × model 2), against the JAX reference's
one-device ``mo`` chain run in this process from the same seeds — the
counterpart of ``tests/test_hemm_chain.py``'s sharded chain: every hop
array-equal under ``verify="error"``, 0 decrypts, each of the 6 HLT
launches with exactly 2 all-reduces and no other collective, levels
[6, 3, 0], the trace met.
"""
import numpy as np
import pytest

import repro  # noqa: F401
from repro.core.ckks import CkksEngine as JEngine
from repro.core.compile import HEContext as JContext
from repro.core.compile import compile_hemm_chain as j_compile_hemm_chain
from repro.core.hemm import encrypt_matrix as j_encrypt
from repro.core.hemm import plan_hemm_chain as j_plan_hemm_chain
from repro.core.params import toy_params as j_toy

import _sharded_ranks as ranks
from repro_torch.launch.mesh import spawn
from test_torch_sharded import assert_equal


@pytest.fixture(scope="module")
def mesh2x2():
    return spawn(ranks.chain_on_2x2, 4, device="cpu", backend="gloo")


def test_sharded_chain_bit_exact_sole_collective_per_hop(mesh2x2):
    params = j_toy(logN=6, L=9, k=3, beta=5, scale_bits=26)
    rng = np.random.default_rng(17)
    ctx = JContext(JEngine(params))
    chain = j_plan_hemm_chain(ctx.eng, (3, 3, 3, 3, 3))
    ctx.keygen(rng, rot_steps=chain.rot_steps)
    prog = j_compile_hemm_chain(ctx, chain, schedule="mo")
    X = rng.uniform(-0.5, 0.5, (3, 3))
    Ws = [rng.uniform(-0.5, 0.5, (3, 3)) for _ in range(3)]
    ctX = j_encrypt(ctx.eng, ctx.keys, X, rng)
    want = prog.run_hops(ctX, prog.encrypt_weights(Ws, rng))
    for rank in mesh2x2:
        got = rank
        for w, g in zip(want, got["outs"], strict=True):
            assert_equal(w, g)
        assert got["err"] < 5e-4
        assert got["decrypts"] == 0
        assert got["census"] == [[2, 0]] * 6
        assert got["levels"] == [6, 3, 0]
        assert all(got["exact"])
        assert got["coll"] > 0 and got["n_model"] == 2
