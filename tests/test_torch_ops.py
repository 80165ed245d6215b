"""The port's kernel API (``repro_torch.kernels.ops``: ``modmul``,
``modadd``, ``fused_hlt_batched``, ``baseconv``) and its oracles
(``repro_torch.kernels.ref``) against the reference's (``repro.kernels.ops``
in interpret mode, as ``tests/test_kernels.py`` runs it, and
``repro.kernels.ref``) on the same numpy inputs, with the same
parametrisations as ``tests/test_kernels.py``.  CPU tensors take the
kernels' plain versions; the CUDA kernels are held against those on the
card by ``chip_smoke.py``.  Exact equality throughout (tolerance 0).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import repro  # noqa: F401
from repro.core import modmath as jmm
from repro.core.params import get_context as j_get_context
from repro.core.params import toy_params as j_toy_params
from repro.core.rns import RnsTools as JRnsTools
from repro.kernels import ops as jops, ref as jref

from repro_torch.core.params import get_context, toy_params
from repro_torch.kernels import baseconv as kbc
from repro_torch.kernels import ops, ref
from test_torch_common import u32


def _ctxs(logN=6, L=3, k=2, beta=2):
    kw = dict(logN=logN, L=L, k=k, beta=beta)
    return j_get_context(j_toy_params(**kw)), get_context(toy_params(**kw))


def _rand(rng, qs, shape):
    return rng.integers(0, qs, size=shape).astype(np.uint32)


def _t(a):
    """uint32 numpy -> the port's int32 tensor (same bits)."""
    return torch.from_numpy(np.ascontiguousarray(a, np.uint32).view(np.int32))


def _tables(ctx):
    return ctx.moduli_u32, ctx.qneg_inv


@pytest.mark.parametrize("logN,M", [(5, 3), (6, 6), (8, 4)])
def test_modmul_modadd(logN, M):
    jctx, ctx = _ctxs(logN=logN, L=M - 1, k=1)
    rng = np.random.default_rng(0)
    N = jctx.params.N
    qs = np.asarray(jctx.moduli_host[:M], dtype=np.uint64)[:, None]
    x = _rand(rng, qs, (M, N))
    y = _rand(rng, qs, (M, N))
    jq, jqn = jnp.asarray(jctx.moduli_u32[:M]), jnp.asarray(jctx.qneg_inv[:M])
    q, qn = ctx.moduli_u32[:M], ctx.qneg_inv[:M]
    want = jops.modmul(jnp.asarray(x), jnp.asarray(y), jq, jqn, block=32)
    got = ops.modmul(_t(x), _t(y), q, qn)
    np.testing.assert_array_equal(u32(got), u32(want))
    np.testing.assert_array_equal(
        u32(ref.modmul_ref(_t(x), _t(y), q, qn)),
        u32(jref.modmul_ref(jnp.asarray(x), jnp.asarray(y), jq, jqn)))
    want = jops.modadd(jnp.asarray(x), jnp.asarray(y), jq, block=32)
    got = ops.modadd(_t(x), _t(y), q)
    np.testing.assert_array_equal(u32(got), u32(want))
    np.testing.assert_array_equal(
        u32(ref.modadd_ref(_t(x), _t(y), q)),
        u32(jref.modadd_ref(jnp.asarray(x), jnp.asarray(y), jq)))


@pytest.mark.parametrize("logN,B", [(5, 1), (6, 2), (7, 3)])
def test_ntt_intt_ref(logN, B):
    jctx, ctx = _ctxs(logN=logN)
    rng = np.random.default_rng(1)
    p = jctx.params
    qs = np.asarray(jctx.moduli_host, dtype=np.uint64)[:, None]
    x = _rand(rng, qs, (B, p.num_total, p.N))
    want = jref.ntt_ref(jnp.asarray(x), jctx.psi_brv_mont, jctx.moduli_u32,
                        jctx.qneg_inv)
    got = ref.ntt_ref(_t(x), ctx.psi_brv_mont, *_tables(ctx))
    np.testing.assert_array_equal(u32(got), u32(want))
    jninv = jmm.to_mont(jctx.n_inv, jctx.moduli_u32, jctx.qneg_inv, jctx.r2)
    back = ref.intt_ref(got, ctx.psi_inv_brv_mont, ctx.n_inv_mont,
                        *_tables(ctx))
    np.testing.assert_array_equal(
        u32(back), u32(jref.intt_ref(want, jctx.psi_inv_brv_mont, jninv,
                                     jctx.moduli_u32, jctx.qneg_inv)))
    np.testing.assert_array_equal(u32(back), x)
    perm = np.random.default_rng(2).permutation(p.N)
    np.testing.assert_array_equal(
        u32(ref.automorph_ref(_t(x), perm)),
        u32(jref.automorph_ref(jnp.asarray(x), perm)))


def _fused_inputs(jctx, rng, lead, d, nbeta):
    """Random fused-HLT operands with ``lead`` leading batch axes (() for
    one ciphertext, (B,) for a stacked batch)."""
    p = jctx.params
    M, N = p.num_total, p.N
    qs = np.asarray(jctx.moduli_host, dtype=np.uint64)[:, None]
    return dict(
        digits=_rand(rng, qs, lead + (nbeta, M, N)),
        c0e=_rand(rng, qs, lead + (M, N)),
        c1e=_rand(rng, qs, lead + (M, N)),
        u=_rand(rng, qs, lead + (d, M, N)),
        rk0=_rand(rng, qs, lead + (d, nbeta, M, N)),
        rk1=_rand(rng, qs, lead + (d, nbeta, M, N)))


@pytest.mark.parametrize("logN,d,nbeta,chunk", [(5, 4, 1, 2), (6, 6, 2, 3),
                                                (6, 8, 3, 8), (7, 5, 2, 1)])
def test_fused_hlt_ref(logN, d, nbeta, chunk):
    """The port's single-ciphertext oracle against the reference's, and
    against the Pallas kernel itself."""
    jctx, ctx = _ctxs(logN=logN, L=5, k=2, beta=nbeta)
    rng = np.random.default_rng(2)
    N = jctx.params.N
    a = _fused_inputs(jctx, rng, (), d, nbeta)
    perms = np.stack([np.random.default_rng(i).permutation(N)
                      for i in range(d)]).astype(np.int32)
    id_idx = d // 2
    order = ("digits", "c0e", "c1e", "u", "rk0", "rk1")
    jargs = [jnp.asarray(a[k]) for k in order] + [jnp.asarray(perms)]
    targs = [_t(a[k]) for k in order] + [torch.from_numpy(perms)]
    want = jref.fused_hlt_ref(*jargs, jctx.moduli_u32, jctx.qneg_inv, id_idx)
    got = ref.fused_hlt_ref(*targs, *_tables(ctx), id_idx)
    is_id = np.zeros((d, 1), np.int32)
    is_id[id_idx] = 1
    kern = jops.fused_hlt(*jargs, jnp.asarray(is_id), jctx.moduli_u32,
                          jctx.qneg_inv, chunk=chunk)
    for g, w, k in zip(got, want, kern, strict=True):
        np.testing.assert_array_equal(u32(g), u32(w))
        np.testing.assert_array_equal(u32(g), u32(k))


@pytest.mark.parametrize("logN,B,d,nbeta,chunk", [(5, 2, 4, 1, 2),
                                                  (6, 3, 6, 2, 3),
                                                  (6, 1, 4, 2, 4)])
def test_fused_hlt_batched(logN, B, d, nbeta, chunk):
    """ops.fused_hlt_batched (plain) == the reference's Pallas kernel ==
    both packages' batched oracles; and == the slot-indexed datapath on
    identity slots."""
    jctx, ctx = _ctxs(logN=logN, L=5, k=2, beta=nbeta)
    rng = np.random.default_rng(5)
    N = jctx.params.N
    a = _fused_inputs(jctx, rng, (B,), d, nbeta)
    perms = np.stack([[np.random.default_rng(10 * b + i).permutation(N)
                       for i in range(d)] for b in range(B)]).astype(np.int32)
    is_id = np.zeros((B, d, 1), np.int32)
    for b in range(B):           # different identity slot per batch element
        is_id[b, b % d] = 1
    order = ("digits", "c0e", "c1e", "u", "rk0", "rk1")
    jargs = ([jnp.asarray(a[k]) for k in order]
             + [jnp.asarray(perms), jnp.asarray(is_id), jctx.moduli_u32,
                jctx.qneg_inv])
    targs = ([_t(a[k]) for k in order]
             + [torch.from_numpy(perms), torch.from_numpy(is_id),
                *_tables(ctx)])
    want = jops.fused_hlt_batched(*jargs, chunk=chunk)
    got = ops.fused_hlt_batched(*targs)
    assert tuple(got.shape) == (2, B) + a["c0e"].shape[1:]
    oracle = ref.fused_hlt_batched_ref(*targs)
    joracle = jref.fused_hlt_batched_ref(*jargs)
    slots = torch.arange(B, dtype=torch.int32)
    indexed = ops.fused_hlt_indexed(*targs[:8], slots, slots, *targs[8:])
    for i in range(2):
        np.testing.assert_array_equal(u32(got[i]), u32(want[i]))
        np.testing.assert_array_equal(u32(oracle[i]), u32(joracle[i]))
        np.testing.assert_array_equal(u32(got[i]), u32(oracle[i]))
        np.testing.assert_array_equal(u32(got[i]), u32(indexed[i]))


@pytest.mark.parametrize("logN,H,S,B,d,nbeta",
                         [(5, 2, 3, 5, 4, 1), (6, 3, 2, 6, 6, 2)])
def test_fused_hlt_indexed_is_batched_on_gathered_operands(logN, H, S, B, d,
                                                           nbeta):
    """The port's slot-indexed datapath == its batched one on the gathered
    (replicated) operands, as the reference defines it."""
    jctx, ctx = _ctxs(logN=logN, L=5, k=2, beta=nbeta)
    rng = np.random.default_rng(8)
    N = jctx.params.N
    a = _fused_inputs(jctx, rng, (H,), d, nbeta)
    b = _fused_inputs(jctx, rng, (S,), d, nbeta)
    perms = np.stack([[np.random.default_rng(10 * s + i).permutation(N)
                       for i in range(d)] for s in range(S)]).astype(np.int32)
    is_id = np.zeros((S, d, 1), np.int32)
    for s in range(S):
        is_id[s, s % d] = 1
    cts = rng.integers(0, H, B).astype(np.int32)
    dgs = rng.integers(0, S, B).astype(np.int32)
    got = ops.fused_hlt_indexed(
        _t(a["digits"]), _t(a["c0e"]), _t(a["c1e"]), _t(b["u"]), _t(b["rk0"]),
        _t(b["rk1"]), torch.from_numpy(perms), torch.from_numpy(is_id),
        torch.from_numpy(cts), torch.from_numpy(dgs), *_tables(ctx))
    want = ops.fused_hlt_batched(
        _t(a["digits"][cts]), _t(a["c0e"][cts]), _t(a["c1e"][cts]),
        _t(b["u"][dgs]), _t(b["rk0"][dgs]), _t(b["rk1"][dgs]),
        torch.from_numpy(perms[dgs]), torch.from_numpy(is_id[dgs]),
        *_tables(ctx))
    np.testing.assert_array_equal(u32(got), u32(want))


def _baseconv_operands(jctx, S, T):
    """The reference's ``RnsTools._bc_tables`` in Montgomery form, as
    ``tests/test_kernels.py`` builds them: numpy uint32 / float64."""
    hat_inv, W, D_mod_t, inv_d = JRnsTools(jctx)._bc_tables(S, T)
    qs_own = np.array([jctx.moduli_host[i] for i in S], np.uint64)[:, None]
    qs_gen = np.array([jctx.moduli_host[i] for i in T], np.uint64)[:, None]

    def mont(v, q):
        return ((np.asarray(v).astype(np.uint64) << np.uint64(32))
                % q).astype(np.uint32)

    def qneg(qs):
        return np.array([[jmm.mont_constants(int(q))[0]] for q in qs[:, 0]],
                        np.uint32)
    return dict(hat_inv_m=mont(hat_inv, qs_own), q_own=qs_own.astype(np.uint32),
                qneg_own=qneg(qs_own), W_m=mont(W, qs_gen),
                D_mod_m=mont(D_mod_t, qs_gen), inv_d=np.asarray(inv_d),
                q_gen=qs_gen.astype(np.uint32), qneg_gen=qneg(qs_gen))


def _baseconv_both(jctx, S, T, x, block):
    """(port plain, reference Pallas kernel, port f64 oracle, reference f64
    oracle), all as uint32 numpy."""
    o = _baseconv_operands(jctx, S, T)
    names = ("hat_inv_m", "q_own", "qneg_own", "W_m", "D_mod_m", "inv_d",
             "q_gen", "qneg_gen")
    tv = {k: (torch.from_numpy(o[k]) if k == "inv_d" else _t(o[k]))
          for k in names}
    jv = {k: jnp.asarray(o[k]) for k in names}
    got = ops.baseconv(_t(x), *[tv[k] for k in names])
    want = jops.baseconv(jnp.asarray(x), *[jv[k] for k in names], block=block)
    oracle = ref.baseconv_ref(
        _t(x), tv["hat_inv_m"], tv["W_m"][:, :, None], tv["D_mod_m"],
        tv["inv_d"], tv["q_own"], tv["qneg_own"], tv["q_gen"], tv["qneg_gen"])
    joracle = jref.baseconv_ref(
        jnp.asarray(x), jv["hat_inv_m"], jv["W_m"][:, :, None], jv["D_mod_m"],
        jv["inv_d"], jv["q_own"], jv["qneg_own"], jv["q_gen"], jv["qneg_gen"])
    return u32(got), u32(want), u32(oracle), u32(joracle)


@pytest.mark.parametrize("logN,block", [(5, 32), (6, 32), (7, 32),
                                        (5, 24), (6, 48)])
def test_baseconv(logN, block):
    """The reference's own case: S = 3 main limbs -> T = 2 main + 2
    special; ragged Pallas blocks (24, 48) change nothing."""
    jctx, _ = _ctxs(logN=logN, L=4, k=3, beta=2)
    p = jctx.params
    S = (0, 1, 2)
    T = (3, 4, p.num_main, p.num_main + 1)
    qs_own = np.array([jctx.moduli_host[i] for i in S], np.uint64)[:, None]
    x = _rand(np.random.default_rng(3), qs_own, (len(S), p.N))
    got, want, oracle, joracle = _baseconv_both(jctx, S, T, x, block)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(oracle, joracle)
    np.testing.assert_array_equal(got, oracle)


@pytest.mark.parametrize("ns,seed", [(8, s) for s in range(4)]
                         + [(9, s) for s in range(4)])
def test_baseconv_wide_source(ns, seed):
    """|S| = 8 (one Set-B ModUp digit's width) and 9 (the merged ModDown's
    P ∪ {q_ℓ}) source limbs at logN 7, several seeds: the float32
    correction summed left to right equals the Pallas kernel's, and the two
    packages' float64 oracles agree.  (How often f32 and f64 differ is a
    finding at Set-B, printed by ``chip_smoke.py``, not a gate.)"""
    jctx, _ = _ctxs(logN=7, L=ns + 3, k=4, beta=2)
    p = jctx.params
    S = tuple(range(ns))
    T = tuple(range(ns, p.num_main)) + tuple(range(p.num_main, p.num_total))
    qs_own = np.array([jctx.moduli_host[i] for i in S], np.uint64)[:, None]
    x = _rand(np.random.default_rng(100 + seed), qs_own, (ns, p.N))
    got, want, oracle, joracle = _baseconv_both(jctx, S, T, x, block=32)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(oracle, joracle)


def test_floor_count_f32_sums_left_to_right():
    """The plain correction adds the terms in ascending source order, in
    float32: a case whose three-term sum rounds differently in another
    order."""
    y = torch.tensor([[1 << 24], [1], [1]], dtype=torch.int64)
    inv = torch.ones((3, 1), dtype=torch.float64)
    # (2^24 + 1) + 1 rounds to 2^24 twice in f32; 2^24 + (1 + 1) does not
    assert int(kbc.floor_count_f32(y, inv)[0]) == 1 << 24
