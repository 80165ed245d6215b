"""``ops.baseconv`` on the CPU (the plain version, which ``chip_smoke.py``
holds the CUDA kernel array-equal to on the card) against the reference's
Pallas ``baseconv`` in interpret mode, at the shape families the card
checks beyond the kernel API's Set-B shapes: a ragged N that is a multiple
neither of 4 nor of the reference's block, Set-C's ModUp (11 -> 33) and
merged ModDown (13 -> 31) limb counts, and a wide source basis.  Inputs
from a numpy seed; exact equality (tolerance 0).  (The float64 oracles
are compared at the reference's own shapes in ``test_torch_ops.py``.)
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.params import get_context as j_get_context
from repro.core.params import toy_params as j_toy_params
from repro.core.rns import RnsTools as JRnsTools
from repro.kernels import ops as jops
from repro_torch.kernels import ops
from test_torch_common import u32
from test_torch_ops import _baseconv_operands, _rand, _t

NAMES = ("hat_inv_m", "q_own", "qneg_own", "W_m", "D_mod_m", "inv_d",
         "q_gen", "qneg_gen")

#: a logN 7 ring with Set-C's limb structure (L 31, k 12, β 3: digits of
#: 11, 11, 10 at level 31)
SET_C_LIKE = dict(logN=7, L=31, k=12, beta=3)


def _port_and_reference(jctx, S, T, x, block):
    """(port ``ops.baseconv``, reference Pallas ``baseconv``) as uint32."""
    o = _baseconv_operands(jctx, S, T)
    got = ops.baseconv(_t(x), *[torch.from_numpy(o[k]) if k == "inv_d"
                                else _t(o[k]) for k in NAMES])
    want = jops.baseconv(jnp.asarray(x), *[jnp.asarray(o[k]) for k in NAMES],
                         block=block)
    return u32(got), u32(want)


def _set_c_like_case(which):
    jctx = j_get_context(j_toy_params(**SET_C_LIKE))
    p = jctx.params
    L = p.L
    own, gen, _ = JRnsTools(jctx).digit_bases(L)[0]
    spec = tuple(range(p.num_main, p.num_total))
    if which == "modup":
        return jctx, tuple(own), tuple(gen)
    if which == "moddown":
        return jctx, spec + (L,), tuple(range(L))
    return jctx, tuple(range(24)), spec                 # wide: 24 -> 12


@pytest.mark.parametrize("which,ns,nt", [("modup", 11, 33),
                                         ("moddown", 13, 31),
                                         ("wide", 24, 12)])
def test_baseconv_set_c_limb_counts(which, ns, nt):
    jctx, S, T = _set_c_like_case(which)
    assert (len(S), len(T)) == (ns, nt)
    qs_own = np.array([jctx.moduli_host[i] for i in S], np.uint64)[:, None]
    x = _rand(np.random.default_rng(25), qs_own, (ns, jctx.params.N))
    got, want = _port_and_reference(jctx, S, T, x, block=jctx.params.N)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("cols", [101, 1])
def test_baseconv_ragged_columns(cols):
    """The reference test's 3 -> 4 case on the first ``cols`` columns of a
    logN 7 ring: the reference's 32-column blocks clamp the last one."""
    jctx = j_get_context(j_toy_params(logN=7, L=4, k=3, beta=2))
    p = jctx.params
    S = (0, 1, 2)
    T = (3, 4, p.num_main, p.num_main + 1)
    qs_own = np.array([jctx.moduli_host[i] for i in S], np.uint64)[:, None]
    x = _rand(np.random.default_rng(101), qs_own, (len(S), p.N))[:, :cols]
    got, want = _port_and_reference(jctx, S, T, x, block=32)
    assert got.shape == (len(T), cols)
    np.testing.assert_array_equal(got, want)
