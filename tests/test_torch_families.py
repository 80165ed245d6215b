"""The non-dense model families: the port's ``models/transformer.py`` on the
``moe``, ``ssm``, ``hybrid``, ``vlm`` and ``audio`` smoke configs against
the reference's (``repro.models.transformer``).

Each smoke config runs in float32 on the reference's ``init_params``
pytree carried across by ``convert.model_params``: ``forward`` (logits and
the MoE aux loss), ``prefill`` + two ``decode_step``s (logits), and the kv
and ssm caches after them, within ``MODEL_TOL`` (1e-4).  The vlm runs
with a ``frontend`` (cross-attention); the audio model reads frame
embeddings (``serve_prefill_step`` / ``serve_decode_step`` on float
input).  Each reference case runs once (a module-scoped fixture: the
reference's eager ``lax.scan`` recompiles at every call).  The port runs
on ``device="cpu"``; the reference on JAX's CPU backend.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro  # noqa: F401
from repro.configs import get_smoke_config as j_get_smoke_config
from repro.models import transformer as jtf
from repro.serve import engine as jengine

from repro_torch import convert
from repro_torch.configs import get_smoke_config
from repro_torch.launch import serve as launch_serve
from repro_torch.models import transformer as tf
from repro_torch.serve import (ContinuousBatcher, ServeConfig,
                               serve_decode_step, serve_prefill_step)
from test_torch_common import CPU

MODEL_TOL = dict(rtol=1e-4, atol=1e-4)   # a whole model, float32
FAMILIES = ("mamba2-780m", "granite-moe-3b-a800m", "zamba2-2.7b",
            "llama-3.2-vision-90b", "musicgen-large")
B, S = 2, 16


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, tol=MODEL_TOL):
    np.testing.assert_allclose(_np(got), _np(want), **tol)


def _leaves(tree, prefix=""):
    """{path: (shape, dtype name)} of a nested dict / list."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = enumerate(tree)
    else:
        return {prefix: (tuple(tree.shape), str(tree.dtype).split(".")[-1])}
    out = {}
    for k, v in items:
        out.update(_leaves(v, f"{prefix}/{k}"))
    return out


def _inputs(cfg, rng):
    """Tokens (B, S+2) — or, for the audio model, frame embeddings
    (B, S+2, d) — and the vlm's frontend (B, T, frontend_dim)."""
    if cfg.family == "audio":
        seq = rng.normal(size=(B, S + 2, cfg.d_model)).astype(np.float32)
    else:
        seq = rng.integers(0, cfg.vocab_size, size=(B, S + 2)).astype(np.int32)
    front = None
    if cfg.family == "vlm":
        front = rng.normal(size=(B, cfg.frontend_tokens, cfg.frontend_dim)
                           ).astype(np.float32)
    return seq, front


def _reference(jcfg, jp, seq, front):
    """forward, prefill + 2 decode steps and the caches on the reference."""
    fkw = {} if front is None else {"frontend": jnp.asarray(front)}
    audio = jcfg.family == "audio"
    x = jnp.asarray(seq)
    full, aux = (jtf.forward(jcfg, jp, None, embeds=x, **fkw) if audio
                 else jtf.forward(jcfg, jp, x, **fkw))
    cache = jtf.init_cache(jcfg, B, S + 8)
    if audio:
        lg, cache = jengine.serve_prefill_step(jcfg, jp, x[:, :S], cache)
    else:
        lg, cache = jtf.prefill(jcfg, jp, x[:, :S], cache, **fkw)
    steps = [lg]
    for i in range(2):
        if audio:
            lg, cache = jengine.serve_decode_step(jcfg, jp, x[:, S + i:S + i + 1],
                                                  cache, S + i)
        else:
            lg, cache = jtf.decode_step(jcfg, jp, x[:, S + i:S + i + 1], cache,
                                        S + i, **fkw)
        steps.append(lg)
    return dict(full=np.asarray(full), aux=float(aux),
                steps=[np.asarray(s) for s in steps],
                cache=jax.tree.map(np.asarray, cache))


def _port(tcfg, tp, seq, front):
    fkw = {} if front is None else {"frontend": torch.from_numpy(front)}
    audio = tcfg.family == "audio"
    x = torch.from_numpy(seq if audio else seq.astype(np.int64))
    full, aux = (tf.forward(tcfg, tp, None, embeds=x, **fkw) if audio
                 else tf.forward(tcfg, tp, x, **fkw))
    cache = tf.init_cache(tcfg, B, S + 8, device=CPU)
    if audio:
        lg, cache = serve_prefill_step(tcfg, tp, x[:, :S], cache)
    else:
        lg, cache = tf.prefill(tcfg, tp, x[:, :S], cache, **fkw)
    steps = [lg]
    for i in range(2):
        if audio:
            lg, cache = serve_decode_step(tcfg, tp, x[:, S + i:S + i + 1],
                                          cache, S + i)
        else:
            lg, cache = tf.decode_step(tcfg, tp, x[:, S + i:S + i + 1], cache,
                                       S + i, **fkw)
        steps.append(lg)
    return dict(full=full, aux=aux, steps=steps, cache=cache)


@pytest.fixture(scope="module", params=FAMILIES)
def fam(request):
    """One smoke config in float32 on both packages, the port's weights
    carried across from the reference's, and both runs."""
    arch = request.param
    jcfg = dataclasses.replace(j_get_smoke_config(arch), dtype="float32")
    tcfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    jp = jtf.init_params(jcfg, jax.random.PRNGKey(1))
    tp = convert.model_params(jp, tcfg, CPU)
    seq, front = _inputs(tcfg, np.random.default_rng(7))
    return dict(arch=arch, jcfg=jcfg, tcfg=tcfg, jp=jp, tp=tp, seq=seq,
                front=front, ref=_reference(jcfg, jp, seq, front),
                port=_port(tcfg, tp, seq, front))


def _unstacked(ref_layers) -> dict:
    return {k: (s[1:], d) for k, (s, d) in _leaves(ref_layers).items()}


def test_params_map_onto_the_reference_pytree(fam):
    """Block b holds index b of every stacked reference leaf; in bfloat16
    each leaf keeps the reference's dtype (float32 router and SSM
    scalars), and the port's own init has the same names, shapes and
    dtypes as the reference's."""
    jp, tp = fam["jp"], fam["tp"]
    nb = next(iter(_leaves(jp["layers"]).values()))[0][0]
    assert len(tp["layers"]) == nb
    for block in tp["layers"]:
        assert _leaves(block) == _unstacked(jp["layers"])
    for got, want in zip(jax.tree.leaves(tp["layers"][-1]),
                         jax.tree.leaves(jp["layers"]), strict=True):
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(want, np.float32)[-1])
    jcfg = dataclasses.replace(fam["jcfg"], dtype="bfloat16")
    tcfg = dataclasses.replace(fam["tcfg"], dtype="bfloat16")
    jpb = jtf.init_params(jcfg, jax.random.PRNGKey(0))
    for tree in (convert.model_params(jpb, tcfg, CPU),
                 tf.init_params(tcfg, torch.Generator().manual_seed(0))):
        assert _leaves(tree["layers"][0]) == _unstacked(jpb["layers"])
        assert {k: v for k, v in _leaves(tree).items()
                if not k.startswith("/layers/")} == \
            {k: v for k, v in _leaves(jpb).items()
             if not k.startswith("/layers/")}
    dtypes = {d for _, d in _unstacked(jpb["layers"]).values()}
    assert dtypes == ({"bfloat16", "float32"}
                      if tcfg.family in ("moe", "ssm", "hybrid")
                      else {"bfloat16"})


def test_forward_equals_reference(fam):
    ref, port = fam["ref"], fam["port"]
    assert port["full"].dtype == torch.float32
    assert tuple(port["full"].shape) == (B, S + 2, fam["tcfg"].vocab_size)
    _close(port["full"], ref["full"])
    if fam["tcfg"].family == "moe":
        assert ref["aux"] > 0
        np.testing.assert_allclose(float(port["aux"]), ref["aux"], rtol=1e-5)
    else:
        assert port["aux"] == 0.0 == ref["aux"]


def test_prefill_decode_equal_reference(fam):
    ref, port = fam["ref"], fam["port"]
    for got, want in zip(port["steps"], ref["steps"], strict=True):
        assert tuple(got.shape) == (B, 1, fam["tcfg"].vocab_size)
        _close(got, want)
    # the serve path agrees with the train path, as the reference test holds
    _close(port["steps"][-1][:, 0], port["full"][:, S + 1], MODEL_TOL)


def test_caches_equal_reference(fam):
    """The kv cache (nb, sub, B, S, KV, hd) and the ssm state h
    (nb, sub, B, H, hd, n) and conv (nb, sub, B, K-1, C), after prefill
    and two decode steps."""
    ref, port = fam["ref"]["cache"], fam["port"]["cache"]
    assert sorted(port) == sorted(ref)
    for group, tree in ref.items():
        assert sorted(port[group]) == sorted(tree)
        for name, want in tree.items():
            got = port[group][name]
            assert tuple(got.shape) == want.shape, (group, name)
            _close(got, want)


# -- the serving loop and launcher ------------------------------------------


@pytest.mark.parametrize("arch", ["mamba2-780m", "granite-moe-3b-a800m"])
def test_continuous_batcher_equals_reference(arch):
    """Greedy decoding over 2 slots, 3 requests of different prompt
    lengths (slot reuse copies every cache leaf, the ssm state included):
    the reference's tokens."""
    jcfg = dataclasses.replace(j_get_smoke_config(arch), dtype="float32")
    tcfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    jp = jtf.init_params(jcfg, jax.random.PRNGKey(2))
    tp = convert.model_params(jp, tcfg, CPU)
    scfg = dict(max_batch=2, max_len=24)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, tcfg.vocab_size, n).astype(np.int32)
               for n in (5, 7, 6)]
    results = []
    for batcher in (jengine.ContinuousBatcher(jcfg,
                                              jengine.ServeConfig(**scfg), jp),
                    ContinuousBatcher(tcfg, ServeConfig(**scfg), tp)):
        for p, n in zip(prompts, (3, 2, 3)):
            batcher.submit(p, n)
        while batcher.step():
            pass
        results.append(batcher.results)
    assert results[1] == results[0]
    assert [len(r) for r in results[1].values()] == [4, 3, 4]


@pytest.mark.parametrize("arch", FAMILIES)
def test_launcher_serves_every_family(arch):
    b = launch_serve.main(["--arch", arch, "--smoke", "--requests", "2",
                           "--max-new", "2", "--device", CPU])
    assert [len(r) for r in b.results.values()] == [3, 3]
    assert all(0 <= t < b.cfg.vocab_size for r in b.results.values()
               for t in r)
