"""The dense model stack: the port's layers (``repro_torch.models.common``),
dense transformer (``repro_torch.models.transformer``) and config registry
(``repro_torch.configs``) against the reference's (``repro.models``,
``repro.configs``).

Layers get the same numpy-seeded float32 inputs on both packages and must
agree within ``rtol = atol = 1e-5``.  The ``internlm2-1.8b`` and
``qwen2-7b`` smoke configs in float32 run ``forward``, ``prefill`` and two
``decode_step``s on the reference's ``init_params`` pytree carried across
by ``convert.model_params``: logits and caches within 1e-4.  The port's
own serve path equals its ``forward`` in bfloat16 within the reference
test's 6e-2 (``tests/test_models_smoke.py``).  The port runs on
``device="cpu"``; the reference on JAX's CPU backend.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro  # noqa: F401
import repro.configs.registry as jreg
from repro.configs import get_config as j_get_config
from repro.configs import get_smoke_config as j_get_smoke_config
from repro.models import common as jc
from repro.models import transformer as jtf

import repro_torch.configs.registry as reg
from repro_torch import convert
from repro_torch.configs import ARCHS, get_config, get_smoke_config
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models import common as tc
from repro_torch.models import transformer as tf
from repro_torch.serve import serve_decode_step, serve_prefill_step
from test_torch_common import CPU

TOL = dict(rtol=1e-5, atol=1e-5)        # one layer, float32
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)  # a whole model, float32
BF16_TOL = dict(rtol=6e-2, atol=6e-2)   # the reference test's bf16 bound
DENSE = ("internlm2-1.8b", "qwen2-7b")


def _cfgs(**kw):
    """The same ModelConfig on both packages."""
    base = dict(name="t", family="dense", num_layers=1, d_model=32,
                num_heads=4, num_kv_heads=2, d_ff=48, vocab_size=40,
                dtype="float32", attn_block=4)
    base.update(kw)
    return jc.ModelConfig(**base), tc.ModelConfig(**base)


def _f32(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _j(a):
    return jnp.asarray(a)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(_np(got), _np(want), **tol)


def _params(ref_tree):
    """A reference parameter dict (numpy leaves) -> torch, recursively."""
    if isinstance(ref_tree, dict):
        return {k: _params(v) for k, v in ref_tree.items()}
    return _t(np.asarray(ref_tree, np.float32))


# -- layers ------------------------------------------------------------------


def test_rmsnorm():
    rng = np.random.default_rng(0)
    x, w = _f32(rng, 2, 5, 16), _f32(rng, 16)
    _close(tc.rmsnorm(_t(x), _t(w), 1e-5), jc.rmsnorm(_j(x), _j(w), 1e-5))


@pytest.mark.parametrize("positions", ["scalar", "vector"])
def test_rope(positions):
    rng = np.random.default_rng(1)
    if positions == "scalar":       # a uniform batch: (1, S), from 3
        x = _f32(rng, 2, 6, 4, 8)
        pos = (np.arange(6, dtype=np.int32) + 3)[None]
    else:                           # per-slot decode positions: (B, 1)
        x = _f32(rng, 3, 1, 4, 8)
        pos = np.array([[5], [0], [17]], np.int32)
    _close(tc.rope(_t(x), _t(pos), 1e6), jc.rope(_j(x), _j(pos), 1e6))


@pytest.mark.parametrize("kv_len", [6, (2, 9, 0)], ids=["scalar", "per-slot"])
def test_decode_attention(kv_len):
    rng = np.random.default_rng(2)
    q, k, v = _f32(rng, 3, 1, 4, 8), _f32(rng, 3, 10, 2, 8), _f32(rng, 3, 10, 2, 8)
    jl = kv_len if isinstance(kv_len, int) else _j(np.array(kv_len, np.int32))
    tl = kv_len if isinstance(kv_len, int) else _t(np.array(kv_len, np.int64))
    _close(tc.decode_attention(_t(q), _t(k), _t(v), tl),
           jc.decode_attention(_j(q), _j(k), _j(v), jl))


@pytest.mark.parametrize("causal,q_offset,Sq,Skv", [
    (True, 0, 11, 11),      # self-attention, Skv not a multiple of 4
    (True, 6, 5, 11),       # queries after a prefix (q_offset > 0)
    (False, 0, 5, 11),      # no causal mask, the padding still masked
    (True, 0, 8, 8),        # whole blocks, no padding
])
def test_blockwise_attention(causal, q_offset, Sq, Skv):
    rng = np.random.default_rng(3)
    q, k, v = _f32(rng, 2, Sq, 4, 8), _f32(rng, 2, Skv, 2, 8), _f32(rng, 2, Skv, 2, 8)
    _close(tc.blockwise_attention(_t(q), _t(k), _t(v), causal=causal,
                                  q_offset=q_offset, block=4),
           jc.blockwise_attention(_j(q), _j(k), _j(v), causal=causal,
                                  q_offset=q_offset, block=4))


@pytest.mark.parametrize("mlp", ["swiglu", "squared_relu", "gelu"])
def test_mlp(mlp):
    jcfg, tcfg = _cfgs(mlp=mlp)
    jp = jc.mlp_init(jcfg, jax.random.PRNGKey(4))
    x = _f32(np.random.default_rng(4), 2, 3, 32)
    _close(tc.mlp_forward(tcfg, _params(jp), _t(x)),
           jc.mlp_forward(jcfg, jp, _j(x)))
    tp = tc.mlp_init(tcfg, torch.Generator().manual_seed(0))
    assert {k: v.shape for k, v in tp.items()} == \
        {k: tuple(v.shape) for k, v in jp.items()}


def _attn_params(jcfg, qkv_bias, rng):
    jp = jc.attn_init(jcfg, jax.random.PRNGKey(5))
    if qkv_bias:        # non-zero biases (init makes them zero)
        jp = dict(jp, **{n: _j(_f32(rng, jp[n].shape[0]))
                         for n in ("bq", "bk", "bv")})
    return jp


@pytest.mark.parametrize("qkv_bias", [False, True], ids=["no-bias", "bias"])
@pytest.mark.parametrize("cache", ["none", "scalar", "vector"])
def test_attn_forward(qkv_bias, cache):
    """No cache (the train path); a scalar cache_len (prefill 4 rows, then
    decode the 5th: a slice write); a (B,) cache_len (one row per slot at
    its own position)."""
    jcfg, tcfg = _cfgs(qkv_bias=qkv_bias)
    rng = np.random.default_rng(6)
    jp = _attn_params(jcfg, qkv_bias, rng)
    tp = _params(jp)
    B, S, Smax = 2, 4, 9
    kvshape = (B, Smax, 2, 8)
    if cache == "none":
        x = _f32(rng, B, S, 32)
        pos = np.arange(S, dtype=np.int32)[None]
        jo, _ = jc.attn_forward(jcfg, jp, _j(x), _j(pos))
        to, _ = tc.attn_forward(tcfg, tp, _t(x), _t(pos))
        _close(to, jo)
        return
    jkv = {"k": _j(_f32(rng, *kvshape)), "v": _j(_f32(rng, *kvshape))}
    tkv = {n: _t(np.asarray(a)) for n, a in jkv.items()}
    if cache == "scalar":
        steps = [(np.arange(S, dtype=np.int32)[None], 0, S),
                 (np.array([[S]], np.int32), S, 1)]
    else:
        cl = np.array([3, 7], np.int32)
        steps = [(cl[:, None], cl, 1)]
    for pos, cl, s in steps:
        x = _f32(rng, B, s, 32)
        jl = cl if isinstance(cl, int) else _j(cl)
        tl = cl if isinstance(cl, int) else _t(cl.astype(np.int64))
        jo, jkv = jc.attn_forward(jcfg, jp, _j(x), _j(pos), kv_cache=jkv,
                                  cache_len=jl)
        to, tkv = tc.attn_forward(tcfg, tp, _t(x), _t(pos), kv_cache=tkv,
                                  cache_len=tl)
        _close(to, jo)
        for n in ("k", "v"):
            _close(tkv[n], jkv[n])


# -- the dense model ---------------------------------------------------------


def _leaf_shapes(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaf_shapes(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_leaf_shapes(v, f"{prefix}/{i}"))
        return out
    return {prefix: tuple(tree.shape)}


@pytest.fixture(scope="module", params=DENSE)
def model(request):
    """One smoke config in float32 on both packages, the port's weights
    carried across from the reference's."""
    arch = request.param
    jcfg = dataclasses.replace(j_get_smoke_config(arch), dtype="float32")
    tcfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    jp = jtf.init_params(jcfg, jax.random.PRNGKey(1))
    return arch, jcfg, tcfg, jp, convert.model_params(jp, tcfg, CPU)


def test_model_params_map_onto_the_reference_pytree(model):
    """Block b of the port holds index b of every stacked reference leaf,
    and the port's own init has the same names and shapes."""
    _, _, tcfg, jp, tp = model
    nb = tcfg.num_layers
    assert len(tp["layers"]) == nb
    stacked = _leaf_shapes(jp["layers"])
    for b in range(nb):
        got = _leaf_shapes(tp["layers"][b])
        assert got == {k: v[1:] for k, v in stacked.items()}
        np.testing.assert_array_equal(
            tp["layers"][b]["attn_layers"][0]["attn"]["wq"].numpy(),
            np.asarray(jp["layers"]["attn_layers"][0]["attn"]["wq"])[b])
    own = tf.init_params(tcfg, torch.Generator().manual_seed(0))
    assert _leaf_shapes(own) == _leaf_shapes(tp)
    assert all(t.dtype == torch.float32 for t in own["layers"][0]
               ["attn_layers"][0]["attn"].values())


def test_forward_prefill_decode_equal_reference(model):
    arch, jcfg, tcfg, jp, tp = model
    rng = np.random.default_rng(7)
    B, S = 2, 16
    tokens = rng.integers(0, jcfg.vocab_size, size=(B, S + 2)).astype(np.int32)
    jfull, _ = jtf.forward(jcfg, jp, _j(tokens))
    tfull, aux = tf.forward(tcfg, tp, _t(tokens.astype(np.int64)))
    assert aux == 0.0 and tfull.dtype == torch.float32
    _close(tfull, jfull, MODEL_TOL)

    jcache = jtf.init_cache(jcfg, B, S + 8)
    tcache = tf.init_cache(tcfg, B, S + 8, device=CPU)
    assert tuple(tcache["kv"]["k"].shape) == tuple(jcache["kv"]["k"].shape)
    jl, jcache = jtf.prefill(jcfg, jp, _j(tokens[:, :S]), jcache)
    tl, tcache = tf.prefill(tcfg, tp, _t(tokens[:, :S]), tcache)
    steps = [(jl, tl)]
    for i in range(2):
        tok = tokens[:, S + i:S + i + 1]
        jl, jcache = jtf.decode_step(jcfg, jp, _j(tok), jcache, S + i)
        tl, tcache = tf.decode_step(tcfg, tp, _t(tok), tcache, S + i)
        steps.append((jl, tl))
    for jl, tl in steps:
        assert tuple(tl.shape) == (B, 1, jcfg.vocab_size)
        _close(tl, jl, MODEL_TOL)
    for n in ("k", "v"):
        _close(tcache["kv"][n], jcache["kv"][n], MODEL_TOL)
    # the serve path agrees with the train path, as the reference test holds
    _close(steps[-1][1][:, 0], tfull[:, S + 1], MODEL_TOL)


def test_ragged_decode_equals_reference(model):
    """Per-slot positions (a (B,) pos): each slot writes and reads its own
    cache length."""
    arch, jcfg, tcfg, jp, tp = model
    rng = np.random.default_rng(8)
    tokens = rng.integers(0, jcfg.vocab_size, size=(2, 12)).astype(np.int32)
    jcache = jtf.init_cache(jcfg, 2, 16)
    tcache = tf.init_cache(tcfg, 2, 16, device=CPU)
    _, jcache = jtf.prefill(jcfg, jp, _j(tokens[:, :10]), jcache)
    _, tcache = tf.prefill(tcfg, tp, _t(tokens[:, :10]), tcache)
    pos = np.array([4, 10], np.int32)
    tok = tokens[:, 10:11]
    jl, jcache = jtf.decode_step(jcfg, jp, _j(tok), jcache, _j(pos))
    tl, tcache = tf.decode_step(tcfg, tp, _t(tok), tcache, pos.astype(np.int64))
    _close(tl, jl, MODEL_TOL)
    for n in ("k", "v"):
        _close(tcache["kv"][n], jcache["kv"][n], MODEL_TOL)


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_decode_matches_forward_bf16(arch):
    """The port's own weights in bfloat16: prefill + two decode steps give
    the logits of a full forward over the sequence (the reference test's
    check and bound)."""
    cfg = get_smoke_config(arch)
    assert cfg.adtype is torch.bfloat16
    params = tf.init_params(cfg, torch.Generator().manual_seed(1))
    rng = np.random.default_rng(1)
    B, S = 2, 16
    tokens = _t(rng.integers(0, cfg.vocab_size, size=(B, S + 2)))
    full, _ = tf.forward(cfg, params, tokens)
    cache = tf.init_cache(cfg, B, S + 8, device=CPU)
    lg, cache = serve_prefill_step(cfg, params, tokens[:, :S], cache)
    _close(lg[:, 0], full[:, S - 1], BF16_TOL)
    for i in range(2):
        lg, cache = serve_decode_step(cfg, params, tokens[:, S + i:S + i + 1],
                                      cache, S + i)
        _close(lg[:, 0], full[:, S + i], BF16_TOL)


# -- configs -----------------------------------------------------------------


def test_registry_equals_reference():
    assert ARCHS == jreg.ARCHS
    assert reg.SHAPES == jreg.SHAPES and reg.SUBQUADRATIC == jreg.SUBQUADRATIC
    assert reg.all_cells() == jreg.all_cells()
    for arch in ARCHS:
        assert reg.cells_for(arch) == jreg.cells_for(arch)
        for shape in reg.SHAPES:
            assert reg.cell_enabled(arch, shape) == jreg.cell_enabled(arch, shape)


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_reference(arch):
    for got, want in ((get_config(arch), j_get_config(arch)),
                      (get_smoke_config(arch), j_get_smoke_config(arch))):
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.param_count() == want.param_count()


# -- what is not ported ------------------------------------------------------


def test_audio_train_and_mesh_raise(tmp_path):
    """Both launchers run ``--tp 2`` (2 spawned gloo ranks, a (data 1 ×
    model 2) mesh): the served tokens are one device's, and a train step
    takes one device's first loss (the audio family's frame input is
    covered by ``tests/test_torch_families.py``)."""
    serve = ["--arch", "internlm2-1.8b", "--smoke", "--requests", "2",
             "--max-new", "3", "--device", CPU]
    assert launch_serve.main(serve + ["--tp", "2"]).results == \
        launch_serve.main(serve).results
    train = ["--arch", "internlm2-1.8b", "--smoke", "--steps", "1",
             "--global-batch", "2", "--seq", "16", "--device", CPU]
    mesh = launch_train.main(train + ["--tp", "2", "--ckpt-dir",
                                      str(tmp_path / "a")])
    one = launch_train.main(train + ["--ckpt-dir", str(tmp_path / "b")])
    np.testing.assert_allclose(float(mesh.metrics[0]["loss"]),
                               float(one.metrics[0]["loss"]), rtol=1e-6)


def test_cache_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        tf.init_cache(get_smoke_config("qwen2-7b"), 1, 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        launch_serve.main(["--arch", "qwen2-7b", "--smoke"])
