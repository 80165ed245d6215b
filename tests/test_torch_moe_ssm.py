"""The MoE and SSD layers (``repro_torch.models.moe`` / ``ssm``) against the
reference's (``repro.models.moe`` / ``ssm``), and Step 2 of a batched
fused HLT run in chunks (``core/compile.py`` ``CompiledHLT``).

Layers get the same numpy-seeded float32 inputs and parameters on both
packages and must agree within ``rtol = atol = 1e-5``; the MoE's expert
choice and capacity drops must be the same, so its outputs are compared
at that tolerance with tied router scores (a zero router: every
probability equal, the lower expert index first) and with a capacity
factor small enough to drop tokens.  The chunked Step 2 runs the
``fame-s-rt`` block MM (tile 4, a (2, 2, 2) grid) with the byte budget
patched small: several chunks, residues array-equal to one chunk.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro  # noqa: F401
from repro.models import common as jc
from repro.models import moe as jmoe
from repro.models import ssm as jssm

from repro_torch.configs.fame_sets import FAME_VERIFY_SETS
from repro_torch.core import costmodel
from repro_torch.core.compile import compile_blockmm
from repro_torch.kernels import ops
from repro_torch.models import common as tc
from repro_torch.models import moe as tmoe
from repro_torch.models import ssm as tssm
from repro_torch.secure import SecureMatmulEngine
from test_torch_common import CPU, assert_ct_equal

TOL = dict(rtol=1e-5, atol=1e-5)


def _cfgs(**kw):
    """The same ModelConfig on both packages."""
    base = dict(name="t", family="moe", num_layers=1, d_model=32,
                num_heads=4, num_kv_heads=2, d_ff=24, vocab_size=40,
                dtype="float32", num_experts=6, experts_per_token=2,
                ssm_state=8, ssm_head_dim=8, ssm_chunk=4)
    base.update(kw)
    return jc.ModelConfig(**base), tc.ModelConfig(**base)


def _f32(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _close(got, want, tol=TOL):
    if isinstance(got, torch.Tensor):
        got = got.detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want, np.float32), **tol)


# -- MoE ---------------------------------------------------------------------


@pytest.mark.parametrize("case", ["random", "tied", "drops", "squared_relu"])
def test_moe_forward(case):
    """``random``: distinct scores, dropless; ``tied``: a zero router, so
    every token picks experts 0..k-1 and the later (token, k) pairs
    overflow their capacity; ``drops``: capacity factor 0.5; and the
    squared-ReLU experts."""
    kw = dict(capacity_factor={"drops": 0.5, "tied": 1.0}.get(case, 8.0))
    if case == "squared_relu":
        kw["mlp"] = "squared_relu"
    jcfg, tcfg = _cfgs(**kw)
    jp = jmoe.moe_init(jcfg, jax.random.PRNGKey(3))
    if case == "tied":
        jp = dict(jp, router=jnp.zeros_like(jp["router"]))
    tp = {k: _t(v) for k, v in jp.items()}
    assert tp["router"].dtype == torch.float32
    x = _f32(np.random.default_rng(3), 2, 6, 32)
    jy, jaux = jmoe.moe_forward(jcfg, jp, jnp.asarray(x))
    ty, taux = tmoe.moe_forward(tcfg, tp, _t(x))
    _close(ty, jy)
    _close(taux, jaux)
    if case in ("tied", "drops"):      # some tokens lost an expert
        roomy = dataclasses.replace(tcfg, capacity_factor=8.0)
        assert not torch.allclose(tmoe.moe_forward(roomy, tp, _t(x))[0], ty)
    own = tmoe.moe_init(tcfg, torch.Generator().manual_seed(0))
    assert {k: (tuple(v.shape), v.dtype) for k, v in own.items()} == \
        {k: (tuple(v.shape), tp[k].dtype) for k, v in jp.items()}


def test_moe_top_k_order_on_ties():
    probs = torch.tensor([[0.25, 0.5, 0.25, 0.0], [0.25, 0.25, 0.25, 0.25]])
    vals, idx = tmoe._top_k(probs, 3)
    jv, ji = jax.lax.top_k(jnp.asarray(probs.numpy()), 3)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))


# -- SSD ---------------------------------------------------------------------


def test_segsum():
    x = _f32(np.random.default_rng(5), 2, 3, 7)
    got, want = tssm._segsum(_t(x)).numpy(), np.asarray(jssm._segsum(x))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    _close(got[fin], want[fin])


@pytest.mark.parametrize("with_state", [False, True],
                         ids=["no-state", "state"])
def test_causal_conv(with_state):
    rng = np.random.default_rng(6)
    x, w, b = _f32(rng, 2, 5, 12), _f32(rng, 4, 12), _f32(rng, 12)
    st = _f32(rng, 2, 3, 12) if with_state else None
    jo, jst = jssm._causal_conv(jnp.asarray(x), jnp.asarray(w),
                                jnp.asarray(b),
                                None if st is None else jnp.asarray(st))
    to, tst = tssm._causal_conv(_t(x), _t(w), _t(b),
                                None if st is None else _t(st))
    _close(to, jo)
    _close(tst, jst)


@pytest.mark.parametrize("S", [8, 11, 3], ids=["whole", "ragged", "short"])
def test_ssd_chunked(S):
    """Chunk Q = 4: S a multiple of Q, S not a multiple (right padding),
    and S < Q (one chunk of S)."""
    jcfg, tcfg = _cfgs(family="ssm")
    rng = np.random.default_rng(7)
    B, H, hd, n = 2, 3, 4, 5
    xs, Bm, Cm = _f32(rng, B, S, H, hd), _f32(rng, B, S, n), _f32(rng, B, S, n)
    dt = np.abs(_f32(rng, B, S, H)) * 0.5
    dA = -dt * 0.7
    want = jssm._ssd_chunked(jcfg, *map(jnp.asarray, (xs, Bm, Cm, dA, dt)))
    got = tssm._ssd_chunked(tcfg, *map(_t, (xs, Bm, Cm, dA, dt)))
    assert tuple(got.shape) == (B, S, H, hd)
    _close(got, want)


def _ssm_params(jcfg, rng):
    jp = jssm.ssm_init(jcfg, jax.random.PRNGKey(8))
    nh = jp["a_log"].shape[0]
    # non-trivial scalars (init makes them 0, 0, 1)
    return dict(jp, a_log=jnp.asarray(_f32(rng, nh) * 0.3),
                dt_bias=jnp.asarray(_f32(rng, nh) * 0.3),
                d_skip=jnp.asarray(_f32(rng, nh)))


@pytest.mark.parametrize("mode", ["chunked", "recurrence"])
def test_ssm_forward(mode):
    """``chunked``: no state, S = 10 over chunks of 4; ``recurrence``: 3
    tokens from a random state (h, conv), the new state compared too."""
    jcfg, tcfg = _cfgs(family="ssm")
    rng = np.random.default_rng(8)
    jp = _ssm_params(jcfg, rng)
    tp = {k: _t(v) for k, v in jp.items()}
    S = 10 if mode == "chunked" else 3
    x = _f32(rng, 2, S, 32)
    jst = tst = None
    if mode == "recurrence":
        st = {k: _f32(rng, *v.shape) for k, v in
              jssm.ssm_init_state(jcfg, 2, jnp.float32).items()}
        jst = {k: jnp.asarray(v) for k, v in st.items()}
        tst = {k: _t(v) for k, v in st.items()}
    jy, jnew = jssm.ssm_forward(jcfg, jp, jnp.asarray(x), state=jst)
    ty, tnew = tssm.ssm_forward(tcfg, tp, _t(x), state=tst)
    _close(ty, jy)
    if mode == "recurrence":
        for k in ("h", "conv"):
            _close(tnew[k], jnew[k])
    else:
        assert tnew is None and jnew is None
    # the recurrence from a zero state equals the chunked form
    if mode == "chunked":
        zero = tssm.ssm_init_state(tcfg, 2, torch.float32, CPU)
        ry, _ = tssm.ssm_forward(tcfg, tp, _t(x), state=zero)
        _close(ry, ty, dict(rtol=1e-4, atol=1e-4))


# -- cross-attention ---------------------------------------------------------


@pytest.mark.parametrize("mode", ["cross", "non-causal"])
def test_attn_forward_cross_and_non_causal(mode):
    """``kv_override``: the vlm's cross-attention to frontend keys and
    values (no RoPE, no mask); ``causal=False`` on the self-attention."""
    jcfg, tcfg = _cfgs(family="vlm", qkv_bias=True, attn_block=4)
    rng = np.random.default_rng(9)
    jp = jc.attn_init(jcfg, jax.random.PRNGKey(9))
    jp = dict(jp, **{n: jnp.asarray(_f32(rng, jp[n].shape[0]))
                     for n in ("bq", "bk", "bv")})
    tp = {k: _t(v) for k, v in jp.items()}
    x = _f32(rng, 2, 5, 32)
    pos = np.arange(5, dtype=np.int32)[None]
    if mode == "cross":
        kx, vx = _f32(rng, 2, 7, 2, 8), _f32(rng, 2, 7, 2, 8)
        jo, jkv = jc.attn_forward(jcfg, jp, jnp.asarray(x), jnp.asarray(pos),
                                  kv_override=(jnp.asarray(kx),
                                               jnp.asarray(vx)))
        to, tkv = tc.attn_forward(tcfg, tp, _t(x), torch.from_numpy(pos),
                                  kv_override=(_t(kx), _t(vx)))
    else:
        jo, jkv = jc.attn_forward(jcfg, jp, jnp.asarray(x), jnp.asarray(pos),
                                  causal=False)
        to, tkv = tc.attn_forward(tcfg, tp, _t(x), torch.from_numpy(pos),
                                  causal=False)
    assert tkv is None and jkv is None
    _close(to, jo)


# -- Step 2 in chunks --------------------------------------------------------


def test_step2_chunk_sizes():
    """The budget keeps the smoke run's Set-B and Set-C batches in one
    chunk and splits the LM groups' Step 2 into near-equal chunks."""
    from repro_torch.core.params import SET_B, SET_C
    assert costmodel.hlt_transient_bytes(SET_B, 14) == 12058624
    for params, level, batch in ((SET_B, 14, 256), (SET_B, 14, 512),
                                 (SET_B, 14, 640), (SET_B, 11, 256),
                                 (SET_C, 30, 64)):
        assert costmodel.step2_chunk(params, level, batch) == batch
    assert costmodel.step2_chunk(SET_B, 14, 4096) == 683     # 6 chunks
    assert costmodel.step2_chunk(SET_B, 14, 3072) == 615     # 5 chunks
    assert costmodel.step2_chunk(SET_B, 14, 1) == 1


@pytest.fixture(scope="module")
def blockmm():
    rng = np.random.default_rng(3)
    te = SecureMatmulEngine(FAME_VERIFY_SETS["fame-s-rt"], tile=4,
                            device=CPU)
    te.keygen(rng)
    A, B = rng.uniform(-1, 1, (6, 5)), rng.uniform(-1, 1, (5, 7))
    return te, te.encrypt_tiles(A, rng), te.encrypt_tiles(B, rng)


@pytest.mark.parametrize("hlts_a_chunk", [3, 5])
def test_step2_runs_in_chunks(blockmm, monkeypatch, hlts_a_chunk):
    """A budget of a few HLTs' transients: the Step-2 launch of 32 HLTs
    runs in several consecutive chunks (Step 1's 8 too), every output
    ciphertext array-equal to the one-chunk program's, one
    ``hlt_launches`` a stage as before."""
    te, At, Bt = blockmm
    prog = compile_blockmm(te.ctx, te._plan, (2, 2, 2))
    calls = []
    real = ops.fused_hlt_indexed

    def counted(*a):
        calls.append(a[8].shape[0])
        return real(*a)

    monkeypatch.setattr(ops, "fused_hlt_indexed", counted)
    h0 = te.ctx.counters["hlt_launches"]
    one = prog(At, Bt)
    assert calls == [8, 32]
    assert te.ctx.counters["hlt_launches"] - h0 == 2
    level = prog.plan.step2.level
    per = costmodel.hlt_transient_bytes(te.params, level)
    monkeypatch.setattr(costmodel, "STEP2_BUDGET_BYTES", per * hlts_a_chunk)
    calls.clear()
    h0 = te.ctx.counters["hlt_launches"]
    many = prog(At, Bt)
    n2 = -(-32 // hlts_a_chunk)
    assert len(calls) > 2 and sum(calls) == 8 + 32
    assert calls[-n2:] == [costmodel.step2_chunk(te.params, level, 32)] * (
        n2 - 1) + [32 - (n2 - 1) * costmodel.step2_chunk(te.params, level, 32)]
    assert te.ctx.counters["hlt_launches"] - h0 == 2
    for row1, row2 in zip(one, many, strict=True):
        for a, b in zip(row1, row2, strict=True):
            assert_ct_equal(a, b)
