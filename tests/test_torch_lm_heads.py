"""Heads that do not divide the model axis, on spawned gloo ranks of the
CPU (data 1 × model 4), against the one-device port run in this process
from the same seeds, in float32 within ``test_torch_lm_sharded.TOL``.

The reference's ``constrain`` drops an axis that does not divide and so
replicates such heads; the port runs the attention (or SSM) sub-layer
whole on every model rank from whole weights and adds its output once.
Two smoke configs (``_lm_ranks.heads_config``): the dense one with 6 Q
and 3 KV heads (the KV cache's sequence still splits over ``model``) and
the SSM one with 6 SSM heads.  At full width this is the case of
``granite-moe-3b-a800m`` (24 heads), ``qwen2.5-14b`` (40) and
``qwen2-7b`` (28) on the production mesh's model axis of 16.
"""
import numpy as np
import pytest
import torch

import _lm_ranks as lr
from repro_torch.launch.mesh import spawn
from repro_torch.models import transformer as tf

TOL = 1e-4


@pytest.fixture(scope="module")
def mesh1x4():
    return spawn(lr.on_1x4_heads, 4, device="cpu", backend="gloo")


def _one_device(kind: str) -> dict:
    cfg = lr.heads_config(kind)
    p = lr.params(cfg)
    with torch.no_grad():
        fwd = tf.forward(cfg, p, lr.tokens(cfg))[0]
    serve, _ = lr.serve_steps(cfg, p, lr.one_device_steps(cfg))
    _, ms = lr.train(cfg, lr.tcfg(), 1)
    return dict(forward=fwd, serve=serve, tokens=lr.batcher_tokens(cfg, p),
                train=ms, params=p)


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=TOL)


@pytest.mark.parametrize("kind", ["dense", "ssm"])
def test_heads_not_dividing_match_one_device(mesh1x4, kind):
    """Forward and serve logits within TOL, the batcher's tokens equal,
    the first train step's loss and metrics within TOL."""
    want = _one_device(kind)
    for r in mesh1x4:
        _close(r[kind, "forward"], want["forward"])
        for g, w in zip(r[kind, "serve"], want["serve"], strict=True):
            _close(g, w)
        assert r[kind, "tokens"] == want["tokens"]
        (got,), (ms,) = r[kind, "train"], want["train"]
        assert set(got) == set(ms)
        for k in ms:
            np.testing.assert_allclose(got[k], ms[k], rtol=TOL, atol=TOL,
                                       err_msg=k)


@pytest.mark.parametrize("kind", ["dense", "ssm"])
def test_replicated_leaves_are_whole(mesh1x4, kind):
    """Every rank holds the whole attention (or SSM) weights."""
    want = _one_device(kind)["params"]["layers"][0]
    sub = (want["attn_layers"][0]["attn"] if kind == "dense"
           else want["ssm"][0])
    for r in mesh1x4:
        assert r[kind, "local"] == {k: tuple(t.shape) for k, t in sub.items()}


def test_replicated_attention_adds_no_all_reduce(mesh1x4):
    """A decode step of the dense config on model 4, 2 layers: the MLP's
    all-reduce and the flash-decoding pair over the sequence-split cache
    (a maximum and a sum) a layer, one for the vocab-parallel embedding,
    one all-gather of the logits; the replicated attention adds none."""
    layers = lr.heads_config("dense").num_layers
    for r in mesh1x4:
        c = {k: v for k, v in r["dense", "decode_counts"].items() if v}
        assert c == dict(all_reduce=2 * layers + 1, all_reduce_max=layers,
                         all_gather=1)
