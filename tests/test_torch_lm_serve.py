"""The LM serving loop: the port's ``ContinuousBatcher`` (``repro_torch.serve``)
against the reference's (``repro.serve.engine``), and the port's serving
launcher (``repro_torch.launch.serve``).

The four engine cases of ``tests/test_serve_secure.py`` run on both
packages: the one-layer float32 model of that file, its weights drawn by
the reference's ``init_params`` and carried across by
``convert.model_params``, the same prompts, seeds and (for the secure
cases) the same W and ``toy_params(logN=6, L=4, k=3, beta=2)`` at tile 4.
Generated tokens must be identical, every secure output row array-equal
and every step's ``StepStats`` equal, as ``tests/test_torch_serve.py``
holds the tier; the reference test's own checks run on the port too.
The reference runs its kernel-free ``"mo"`` block MM (the deprecated
``he_schedule`` knob: its interpret-mode ``"pallas"`` one is what makes
its own file slow), the port its default, the cost model's ``"pallas"``,
on ``device="cpu"``; the two give the same residues.
"""
import dataclasses
import types
import warnings

import jax
import numpy as np
import pytest

import repro  # noqa: F401
from repro.core.params import toy_params as j_toy_params
from repro.models import transformer as jtf
from repro.models.common import ModelConfig as JModelConfig
from repro.serve.engine import ContinuousBatcher as JContinuousBatcher
from repro.serve.engine import ServeConfig as JServeConfig
from repro.serve.engine import build_secure_serving as j_build_secure_serving

from repro_torch import convert
from repro_torch.core.params import toy_params
from repro_torch.launch import serve as launch_serve
from repro_torch.models.common import ModelConfig
from repro_torch.serve import (ContinuousBatcher, ServeConfig,
                               build_secure_serving)
from test_torch_common import CPU

TOY = dict(logN=6, L=4, k=3, beta=2)
TOL = 0.1          # decrypted row against x @ W (the reference tests' bound)
REF = types.SimpleNamespace(
    ModelConfig=JModelConfig, ServeConfig=JServeConfig,
    Batcher=JContinuousBatcher, build=j_build_secure_serving,
    params=j_toy_params(**TOY), scfg=dict(he_schedule="mo"), kw={})
PORT = types.SimpleNamespace(
    ModelConfig=ModelConfig, ServeConfig=ServeConfig,
    Batcher=ContinuousBatcher, build=build_secure_serving,
    params=toy_params(**TOY), scfg={}, kw=dict(device=CPU))


def _cfg(ns, secure=()):
    return ns.ModelConfig(name="t", family="dense", num_layers=1, d_model=8,
                          num_heads=2, d_ff=16, vocab_size=16,
                          dtype="float32", remat=False, secure_layers=secure)


@pytest.fixture(scope="module")
def weights():
    """The reference test's model weights on both packages, and the
    embedding table as float64 (the secure layer's input rows)."""
    jp = jtf.init_params(_cfg(REF), jax.random.PRNGKey(0))
    return {"ref": jp, "port": convert.model_params(jp, _cfg(PORT), CPU),
            "embed": np.asarray(jp["embed"], np.float64)}


def _params(ns, weights):
    return weights["ref" if ns is REF else "port"]


def _serve(ns, weights, scfg: dict, prompts, max_new, tenants=None,
           secure_seed=None):
    """One ContinuousBatcher run to completion: its tokens and secure rows
    per request, its StepStats as dicts, and the secure layer's W."""
    secure = W = None
    if secure_seed is None:
        cfg, sc = _cfg(ns), ns.ServeConfig(**scfg)
    else:
        cfg, sc = _cfg(ns, (0,)), ns.ServeConfig(**scfg, **ns.scfg)
        rng = np.random.default_rng(secure_seed)
        W = rng.standard_normal((8, 4)) * 0.4
        with warnings.catch_warnings():
            # the reference's he_schedule="mo" warns at every session
            warnings.simplefilter("ignore", DeprecationWarning)
            secure = ns.build(cfg, sc, {0: W}, rng, he_params=ns.params,
                              **ns.kw)
    b = ns.Batcher(cfg, sc, _params(ns, weights), secure=secure)
    tenants = tenants or ["default"] * len(prompts)
    rids = [b.submit(p, max_new, tenant=t) for p, t in zip(prompts, tenants)]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        while b.step():
            pass
    steps = ([] if secure is None else
             [dataclasses.asdict(s) for s in secure.batcher.steps])
    return types.SimpleNamespace(
        tokens=[b.results[r] for r in rids],
        rows=[[out[0] for out in b.secure_results[r]] for r in rids],
        steps=steps, W=W)


def _assert_runs_equal(got, want):
    assert got.tokens == want.tokens
    assert got.steps == want.steps
    assert len(got.rows) == len(want.rows)
    for g, w in zip(got.rows, want.rows, strict=True):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _assert_rows_plaintext(run, embed):
    """Each secure output is the embedding row of the token it read,
    times W (the reference test's check)."""
    for toks, outs in zip(run.tokens, run.rows, strict=True):
        assert len(outs) >= 1
        for t, out in zip(toks, outs):
            np.testing.assert_allclose(out, embed[t] @ run.W, atol=TOL)


def test_continuous_batcher_one_secure_launch_per_decode_step(weights):
    args = (dict(max_batch=3, max_len=16, he_tile=4),
            [np.arange(2, dtype=np.int32), np.arange(4, dtype=np.int32),
             np.arange(3, dtype=np.int32)], 2)
    ref = _serve(REF, weights, *args, secure_seed=8)
    port = _serve(PORT, weights, *args, secure_seed=8)
    _assert_runs_equal(port, ref)
    assert len(port.steps) >= 2
    for s in port.steps:
        assert s["program_launches"] == 1   # one launch per decode step
    _assert_rows_plaintext(port, weights["embed"])


def test_ragged_positions_regression(weights):
    """Prompts of different lengths served together give the tokens each
    gives alone, and the reference's tokens."""
    scfg = dict(max_batch=2, max_len=24)
    p_short = np.arange(3, dtype=np.int32)
    p_long = np.arange(8, dtype=np.int32)[::-1].copy()
    runs = {}
    for name, ns in (("ref", REF), ("port", PORT)):
        runs[name] = [_serve(ns, weights, scfg, prompts, 6).tokens
                      for prompts in ([p_short, p_long], [p_short], [p_long])]
    assert runs["port"] == runs["ref"]
    together, short, long_ = runs["port"]
    assert together == [short[0], long_[0]]


def test_temperature_sampling_seeded_and_greedy(weights):
    """Greedy ignores the seed; temperature 2 samples from the host rng
    seeded by ServeConfig.seed: the reference's tokens for the same seed,
    the same tokens again under it, and others under another seed."""
    prompt = np.arange(4, dtype=np.int32)

    def run(ns, temperature, seed):
        return _serve(ns, weights, dict(max_batch=1, max_len=24,
                                        temperature=temperature, seed=seed),
                      [prompt], 8).tokens[0]

    for t, seed in ((0.0, 0), (2.0, 7), (2.0, 8)):
        assert run(PORT, t, seed) == run(REF, t, seed), (t, seed)
    greedy = run(PORT, 0.0, 0)
    assert greedy == run(PORT, 0.0, 99)
    hot_a = run(PORT, 2.0, 7)
    assert hot_a == run(PORT, 2.0, 7)
    assert any(run(PORT, 2.0, s) != hot_a for s in range(8, 14))


def test_two_tenant_serving_end_to_end(weights):
    """Two tenants: per-step launches equal the tenants in flight, rows
    equal the reference's and match plaintext per tenant."""
    args = (dict(max_batch=2, max_len=16, he_tile=4),
            [np.arange(3, dtype=np.int32), np.arange(5, dtype=np.int32)], 2,
            ["acme", "globex"])
    ref = _serve(REF, weights, *args, secure_seed=9)
    port = _serve(PORT, weights, *args, secure_seed=9)
    _assert_runs_equal(port, ref)
    for s in port.steps:
        assert s["program_launches"] == s["n_groups"] <= 2
    assert max(s["n_groups"] for s in port.steps) == 2
    _assert_rows_plaintext(port, weights["embed"])


def test_serve_launcher_smoke_on_cpu(capsys):
    """``python -m repro_torch.launch.serve --smoke --device cpu`` through
    ``main(argv)``: every request decodes ``--max-new`` tokens after its
    prefill token, four slots at a time."""
    b = launch_serve.main(["--arch", "qwen2-7b", "--smoke", "--requests",
                           "5", "--max-new", "3", "--device", CPU])
    assert "[serve] 5 requests, 6 decode steps" in capsys.readouterr().out
    assert sorted(b.results) == list(range(5))
    for toks in b.results.values():
        assert len(toks) == 4
        assert all(0 <= t < b.cfg.vocab_size for t in toks)
    assert b.cache["kv"]["k"].device.type == CPU
