"""The port's foundations against the JAX reference: the prime/twiddle
tables (byte-equal on both verify sets and on Set-B), the Montgomery and
u64 arithmetic, the four NTT families, the Galois permutations; plus the
import guard (no jax, no repro) and the no-CPU-fallback device default."""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro  # noqa: F401
import repro.configs.fame_sets as jfs
from repro.core import automorph as jauto, modmath as jmm, ntt as jntt
from repro.core.params import SET_B as J_SET_B, get_context as j_get_context

from repro_torch.configs.fame_sets import FAME_VERIFY_SETS
from repro_torch.core import automorph, modmath as mm, ntt
from repro_torch.core.params import SET_B, get_context
from test_torch_common import u32

ROOT = pathlib.Path(__file__).resolve().parents[1]
TABLES = ("moduli_u32", "qneg_inv", "r2", "psi_brv", "psi_inv_brv",
          "psi_brv_mont", "psi_inv_brv_mont", "n_inv", "n_inv_mont")
SETS = [(name, FAME_VERIFY_SETS[name], jfs.FAME_VERIFY_SETS[name])
        for name in FAME_VERIFY_SETS] + [("set-b", SET_B, J_SET_B)]


@pytest.mark.parametrize("name,tp,jp", SETS, ids=[s[0] for s in SETS])
def test_context_tables_byte_equal(name, tp, jp):
    assert (tp.logN, tp.L, tp.k, tp.beta, tp.scale_bits, tp.q0_bits,
            tp.sp_bits) == (jp.logN, jp.L, jp.k, jp.beta, jp.scale_bits,
                            jp.q0_bits, jp.sp_bits)
    jc, tc = j_get_context(jp), get_context(tp)
    assert tc.moduli_host == jc.moduli_host
    for f in TABLES:
        want = np.asarray(getattr(jc, f))
        assert want.dtype == np.uint32, f
        np.testing.assert_array_equal(u32(getattr(tc, f)), want, err_msg=f)
    np.testing.assert_array_equal(tc.rot_group, jc.rot_group)
    np.testing.assert_array_equal(tc.moduli.cpu().numpy(),
                                  np.asarray(jc.moduli).astype(np.int64))


@pytest.fixture(scope="module", params=list(FAME_VERIFY_SETS))
def ctxs(request):
    return (get_context(FAME_VERIFY_SETS[request.param]),
            j_get_context(jfs.FAME_VERIFY_SETS[request.param]))


def _rand(rng, moduli, n):
    qs = np.asarray(moduli, np.uint64)[:, None]
    return rng.integers(0, qs, (len(moduli), n)).astype(np.uint32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.uint32).view(np.int32))


def test_arithmetic_matches_reference(ctxs):
    tc, jc = ctxs
    rng = np.random.default_rng(1)
    N = tc.params.N
    a, b = _rand(rng, tc.moduli_host, N), _rand(rng, tc.moduli_host, N)
    stack = np.stack([_rand(rng, tc.moduli_host, N) for _ in range(5)])
    q32, qneg, r2 = np.asarray(jc.moduli_u32), np.asarray(jc.qneg_inv), \
        np.asarray(jc.r2)
    tq, tqn, tr2 = tc.moduli_u32, tc.qneg_inv, tc.r2
    pairs = [
        (mm.montmul(_t(a), _t(b), tq, tqn), jmm.montmul(a, b, q32, qneg)),
        (mm.montadd(_t(a), _t(b), tq), jmm.montadd(a, b, q32)),
        (mm.montsub(_t(a), _t(b), tq), jmm.montsub(a, b, q32)),
        (mm.montsum(_t(stack), tq, axis=0), jmm.montsum(stack, q32, axis=0)),
        (mm.to_mont(_t(a), tq, tqn, tr2), jmm.to_mont(a, q32, qneg, r2)),
        (mm.mulmod(_t(a), _t(b), tc.moduli),
         jmm.mulmod(a, b, np.asarray(jc.moduli))),
        (mm.addmod(_t(a), _t(b), tc.moduli),
         jmm.addmod(a, b, np.asarray(jc.moduli))),
        (mm.submod(_t(a), _t(b), tc.moduli),
         jmm.submod(a, b, np.asarray(jc.moduli))),
    ]
    for got, want in pairs:
        np.testing.assert_array_equal(u32(got), np.asarray(want))
    # qneg_inv >= 2^31 is carried as an int32 view of the same bits
    assert (u32(tqn) >= 1 << 31).any() and (tqn < 0).any()
    # montmul of a value >= q (a cross-prime residue, as in BaseConv)
    big = np.full_like(a, max(tc.moduli_host))
    np.testing.assert_array_equal(
        u32(mm.montmul(_t(big), _t(b), tq, tqn)),
        np.asarray(jmm.montmul(big, b, q32, qneg)))


def test_ntt_families_match_reference(ctxs):
    tc, jc = ctxs
    rng = np.random.default_rng(2)
    x = _rand(rng, tc.moduli_host, tc.params.N)
    jx = np.asarray(x)
    got = ntt.ntt_raw(_t(x), tc.psi_brv, tc.moduli)
    np.testing.assert_array_equal(
        u32(got), np.asarray(jntt.ntt_raw(jx, jc.psi_brv, jc.moduli)))
    np.testing.assert_array_equal(
        u32(ntt.intt_raw(_t(x), tc.psi_inv_brv, tc.n_inv, tc.moduli)),
        np.asarray(jntt.intt_raw(jx, jc.psi_inv_brv, jc.n_inv, jc.moduli)))
    np.testing.assert_array_equal(
        u32(ntt.ntt_mont_raw(_t(x), tc.psi_brv_mont, tc.moduli_u32,
                             tc.qneg_inv)),
        np.asarray(jntt.ntt_mont_raw(jx, jc.psi_brv_mont, jc.moduli_u32,
                                     jc.qneg_inv)))
    back = ntt.intt_mont_raw(ntt.ntt_mont_raw(_t(x), tc.psi_brv_mont,
                                              tc.moduli_u32, tc.qneg_inv),
                             tc.psi_inv_brv_mont, tc.n_inv_mont,
                             tc.moduli_u32, tc.qneg_inv)
    np.testing.assert_array_equal(u32(back), x)
    np.testing.assert_array_equal(
        u32(ntt.intt_mont_raw(_t(x), tc.psi_inv_brv_mont, tc.n_inv_mont,
                              tc.moduli_u32, tc.qneg_inv)),
        np.asarray(jntt.intt_mont_raw(jx, jc.psi_inv_brv_mont, jc.n_inv_mont,
                                      jc.moduli_u32, jc.qneg_inv)))


def test_galois_permutations_match_reference(ctxs):
    """Eval-domain layout: automorphisms are int gather indices in
    bit-reversed order, identical to the reference's."""
    N = ctxs[0].params.N
    rng = np.random.default_rng(3)
    x = _rand(rng, ctxs[0].moduli_host, N)
    for r in (1, -1, 3, N // 4 - 1, -(N // 4)):
        g = automorph.galois_elt_rot(r, N)
        assert g == jauto.galois_elt_rot(r, N)
        np.testing.assert_array_equal(automorph.eval_perm(N, g),
                                      jauto.eval_perm(N, g))
        np.testing.assert_array_equal(u32(automorph.apply_eval(_t(x), N, g)),
                                      np.asarray(jauto.apply_eval(x, N, g)))


def test_host_helpers_match_reference():
    for q in (12289, (1 << 29) - 3, 1073479681):
        assert mm.mont_constants(q) == jmm.mont_constants(q)
        assert mm.is_prime(q) == jmm.is_prime(q)
    assert mm.gen_ntt_primes(3, 30, 1 << 16) == jmm.gen_ntt_primes(3, 30, 1 << 16)
    np.testing.assert_array_equal(mm.bit_reverse_indices(64),
                                  jmm.bit_reverse_indices(64))
    x = np.arange(1000, dtype=np.uint64)
    q = np.uint64(1073479681)
    np.testing.assert_array_equal(mm.to_mont_host_arr(x, q),
                                  jmm.to_mont_host_arr(x, q))
    pw = mm.host_powers(7, 1000, 12289)
    assert [int(v) for v in pw[:5]] == [1, 7, 49, 343, 2401]
    assert int(pw[999]) == pow(7, 999, 12289)


def test_port_imports_neither_jax_nor_repro():
    """Every repro_torch module, and chip_smoke.py, imports without jax or
    the reference package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or "
        "k.startswith(('jax.', 'jaxlib')) or k == 'repro' or "
        "k.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "print(len([k for k in sys.modules if k.startswith('repro_torch')]))\n")
    env = dict(os.environ, PYTHONPATH=f"{ROOT / 'src'}:{ROOT}")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=120, env=env)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 26


def test_entry_points_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    from repro_torch.core.ckks import CkksEngine
    from repro_torch.core.compile import HEContext
    p = FAME_VERIFY_SETS["fame-s-rt"]
    with pytest.raises(RuntimeError, match="CUDA"):
        CkksEngine(p)
    with pytest.raises(RuntimeError, match="CUDA"):
        HEContext.create(p, np.random.default_rng(0))
    assert CkksEngine(p, device="cpu").device.type == "cpu"
