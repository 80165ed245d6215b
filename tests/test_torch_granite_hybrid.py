"""granite-4.0-h-small on the port's normal path, against the plain float32
reference (``tests/ref_granite_hybrid.py``), on the smoke configuration:
one period [m, m, m, m, m, a, m, m, m, m], 8 experts top-2 and a shared
expert, NoPE attention, Granite's three multipliers, float32, seeded
random weights drawn by the reference (``ref.draw``) and loaded into the
port's tree by its checkpoint loader (``hybrid_moe_params``).

- ``forward``'s logits, and a ``ContinuousBatcher`` (2 slots, greedy)
  prefill and 3 decode steps, against the reference's full forward;
- Granite's routing (top-k of the logits, then a softmax over k) against
  the port's gates (a softmax over all experts, top-k, renormalised);
- the shared expert counted once; the sub-layers' order;
- the port's Mamba-2 SSD at d_state 128, chunk 256, n_groups 1 with a
  conv bias against the reference's token recurrence;
- the serve path's spans and counters, and that nothing records outside a
  scope;
- a toy secure layer on the batcher (the path that shares the HE engine).

Tolerances: both sides compute in float32; the port's SSD is the chunked
form (a different order of the same sums) and its MoE dispatch is by
one-hot products, so logits agree to rounding: 2e-5 absolute on logits
of size ~0.1–0.3, where one token routed to another expert would move
them by ~1e-2.
"""
import dataclasses

import numpy as np
import pytest
import torch

import ref_granite_hybrid as ref
from repro_torch.configs import ARCHS, get_config, get_smoke_config
from repro_torch.configs.granite_4_0_h_small import PERIOD
from repro_torch.core import trace
from repro_torch.core.params import toy_params
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import transformer as tf
from repro_torch.models.common import HybridMoEConfig, ModelConfig
from repro_torch.serve import (ContinuousBatcher, ServeConfig,
                               build_secure_serving)
from repro_torch.tree import leaves

ARCH = "granite-4.0-h-small"
ATOL = 2e-5        # float32 on both sides (module docstring)
SECURE_TOL = 0.1   # a decrypted row against x @ W (the serve tests' bound)


def published(cfg: HybridMoEConfig) -> dict:
    """The configuration under the published (``config.json``) keys."""
    return dict(
        hidden_size=cfg.d_model, num_attention_heads=cfg.num_heads,
        num_key_value_heads=cfg.num_kv_heads, mamba_expand=cfg.ssm_expand,
        mamba_n_heads=cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim,
        mamba_d_head=cfg.ssm_head_dim, mamba_d_state=cfg.ssm_state,
        mamba_d_conv=cfg.conv_kernel, rms_norm_eps=cfg.norm_eps,
        attention_multiplier=cfg.attention_multiplier,
        num_experts_per_tok=cfg.experts_per_token,
        num_local_experts=cfg.num_experts,
        embedding_multiplier=cfg.embedding_multiplier,
        residual_multiplier=cfg.residual_multiplier,
        logits_scaling=cfg.logits_scaling, vocab_size=cfg.vocab_size,
        intermediate_size=cfg.d_ff, shared_intermediate_size=cfg.shared_ff,
        num_hidden_layers=cfg.num_layers,
        layer_types=list(cfg.layer_pattern) * (cfg.num_layers
                                               // len(cfg.layer_pattern)))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this file's small tensors: in a suite of
    several workers a pool per worker only contends for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    cfg = get_smoke_config(ARCH)
    weights = ref.draw(published(cfg), 0, "cpu", torch.float32)
    return cfg, tf.hybrid_moe_params(cfg, weights), weights


def reference(cfg, weights, tokens, positions=None):
    with torch.no_grad():
        return ref.forward(published(cfg), weights,
                           torch.as_tensor(np.asarray(tokens)), positions)


def test_config_found_by_name_and_registry_unchanged():
    cfg = get_config(ARCH)
    assert isinstance(cfg, HybridMoEConfig) and ARCH not in ARCHS
    assert cfg.layer_pattern == PERIOD and PERIOD.index("attention") == 5
    assert cfg.num_layers == 40 and cfg.num_layers % len(PERIOD) == 0
    assert round(cfg.param_count() / 1e9, 1) == 32.2      # 32B-A9B
    # dropless: an expert's capacity holds every token of a group
    g = 4096
    assert cfg.capacity_factor == cfg.num_experts / cfg.experts_per_token
    assert np.ceil(g * cfg.experts_per_token / cfg.num_experts
                   * cfg.capacity_factor) >= g
    # the settings live on the subclass: ModelConfig's fields are unchanged
    base = {f.name for f in dataclasses.fields(ModelConfig)}
    assert "layer_pattern" not in base and "shared_ff" not in base
    smoke = get_smoke_config(ARCH)
    assert smoke.layer_pattern == PERIOD and smoke.shared_ff
    assert smoke.position_embedding == "nope" and not smoke.rotary
    assert smoke.num_experts >= 8 and smoke.experts_per_token >= 2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loaded_weights_have_the_ports_tree(dtype):
    """The loader gives ``init_params``' tree, leaf for leaf in shape and
    dtype, and the reference's draw is the same for a seed each time."""
    cfg = dataclasses.replace(get_smoke_config(ARCH), dtype=dtype)
    want = tf.init_params(cfg, torch.Generator().manual_seed(0))
    weights = ref.draw(published(cfg), 7, "cpu", cfg.adtype)
    got = tf.hybrid_moe_params(cfg, weights)
    assert [(t.shape, t.dtype) for t in leaves(got)] == [
        (t.shape, t.dtype) for t in leaves(want)]
    again = ref.draw(published(cfg), 7, "cpu", cfg.adtype)
    other = ref.draw(published(cfg), 8, "cpu", cfg.adtype)
    assert torch.equal(again["layers"][5]["wk"], weights["layers"][5]["wk"])
    assert not torch.equal(other["embed"], weights["embed"])
    with pytest.raises(ValueError, match="layers"):
        tf.hybrid_moe_params(cfg, dict(weights,
                                       layers=weights["layers"][::-1]))


def test_forward_matches_reference(model):
    cfg, params, weights = model
    tokens = torch.randint(0, cfg.vocab_size, (2, 21),
                           generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        logits, _ = tf.forward(cfg, params, tokens)
    for b in range(2):
        want = reference(cfg, weights, tokens[b])
        torch.testing.assert_close(logits[b], want, atol=ATOL, rtol=0)


def test_serving_prefill_and_decode_match_reference(model):
    """Two slots of prompts 9 and 12 tokens (chunk 8: a padded chunk each),
    greedy: prefill, then 3 decode steps through the batcher's cache."""
    cfg, params, weights = model
    b = ContinuousBatcher(cfg, ServeConfig(max_batch=2, max_len=32), params)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (9, 12)]
    rids = [b.submit(p, max_new=10) for p in prompts]
    steps = []
    for _ in range(3):
        assert b.step()
        steps.append(b.last_logits.copy())
    for slot, (rid, prompt) in enumerate(zip(rids, prompts)):
        seq = np.concatenate([prompt, b.results[rid]])
        P = len(prompt)
        want = reference(cfg, weights, seq, list(range(P - 1, P + 3)))
        # the prefill's last logits chose the first token, greedily
        assert b.results[rid][0] == int(want[0].argmax())
        for j in range(3):
            torch.testing.assert_close(torch.from_numpy(steps[j][slot]),
                                       want[j + 1], atol=ATOL, rtol=0)
    c = b.counters
    assert c["lm.step.calls"] == 3 and c["lm.tokens"] == 6
    assert c["lm.prefill.calls"] == 2 and int(c["lm.moe.dropped"]) == 0
    # 9 SSD layers, 1 attention layer, 10 MoE layers a model call
    calls = 2 + 3
    assert c["lm.ssm.calls"] == 9 * calls and c["lm.attn.calls"] == calls
    assert c["lm.moe.calls"] == 10 * calls


def test_cache_keeps_the_mamba_state_in_float32():
    """At bfloat16 the serve cache holds the Mamba state h in float32 (the
    conv window and the KV in bfloat16) and prefill and decode run on it;
    the other configurations keep h in the activations' dtype."""
    cfg = dataclasses.replace(get_smoke_config(ARCH), dtype="bfloat16")
    params = tf.init_params(cfg, torch.Generator().manual_seed(9))
    cache = tf.init_cache(cfg, 2, 16, device="cpu")
    assert cache["ssm"]["h"].dtype == torch.float32
    assert cache["ssm"]["conv"].dtype == torch.bfloat16
    assert cache["kv"]["k"].dtype == torch.bfloat16
    with torch.no_grad():
        _, cache = tf.prefill(cfg, params, torch.arange(10).reshape(2, 5),
                              cache)
        logits, cache = tf.decode_step(cfg, params, torch.tensor([[1], [2]]),
                                       cache, 5)
    assert cache["ssm"]["h"].dtype == torch.float32
    assert torch.isfinite(logits).all()
    for arch in ("mamba2-780m", "zamba2-2.7b"):
        assert get_config(arch).ssm_state_dtype is None


def test_nothing_recorded_without_a_scope(model):
    """The model's spans and counts record only inside the batcher's
    step: the same calls outside it leave its table as it was."""
    cfg, params, _ = model
    b = ContinuousBatcher(cfg, ServeConfig(max_batch=1, max_len=16), params)
    b.submit(np.arange(4, dtype=np.int32), max_new=4)
    b.step()
    before = dict(b.counters)
    assert before["lm.ssm.calls"] and not trace.active()
    cache = tf.init_cache(cfg, 1, 16, device="cpu")
    with torch.no_grad():
        tf.prefill(cfg, params, torch.arange(5)[None], cache)
        tf.decode_step(cfg, params, torch.tensor([[3]]), cache, 5)
        tf.forward(cfg, params, torch.arange(4)[None])
        with trace.span("lm.step"):
            trace.count("lm.tokens", 1)
    assert b.counters == before


def test_spans_synchronise_only_where_asked(model):
    cfg, params, _ = model
    calls = []
    b = ContinuousBatcher(cfg, ServeConfig(max_batch=1, max_len=16), params)
    b.submit(np.arange(4, dtype=np.int32), max_new=4)
    b.step()
    assert calls == []
    with trace.synced(lambda: calls.append(1)):
        b.step()
    # lm.step, 9 SSD, 1 attention and 10 MoE spans: open and close each
    assert len(calls) == 2 * (1 + 9 + 1 + 10)


def test_granite_routing_equals_the_ports_gates():
    """Top-k of the logits then a softmax over k (GraniteMoe) against the
    port's softmax over all experts, top-k, renormalised: the same experts
    and the same gates, on the same logits."""
    logits = torch.randn((64, 72), generator=torch.Generator().manual_seed(3))
    want_gates, want_idx = ref.granite_gates(logits, 10)
    gates, idx = moe_mod._top_k(torch.softmax(logits, dim=-1), 10)
    gates = gates / gates.sum(-1, keepdim=True)
    assert torch.equal(idx, want_idx)
    torch.testing.assert_close(gates, want_gates, atol=1e-6, rtol=1e-6)


def test_shared_expert_counted_once(model):
    cfg, params, weights = model
    lp = params["layers"][0]["ssm"][0]["ffn"]
    x = torch.randn((1, 6, cfg.d_model),
                    generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        y, _ = moe_mod.shared_forward(cfg, lp, x)
        routed, _ = moe_mod.moe_forward(cfg, lp["moe"], x)
        shared = ref.swiglu(x[0], lp["shared"]["wi_gate"],
                            lp["shared"]["wi_up"], lp["shared"]["wo"])
        want = ref.moe(published(cfg), weights["layers"][0], x[0],
                       lambda t: t.float())
    torch.testing.assert_close(y[0], routed[0] + shared, atol=1e-6, rtol=0)
    torch.testing.assert_close(y[0], want, atol=ATOL, rtol=0)
    # with every routed expert zeroed, the output is the shared expert once
    zero = dict(lp, moe={k: v if k == "router" else torch.zeros_like(v)
                         for k, v in lp["moe"].items()})
    with torch.no_grad():
        y0, _ = moe_mod.shared_forward(cfg, zero, x)
    torch.testing.assert_close(y0[0], shared, atol=1e-6, rtol=0)


def test_layer_order(model, monkeypatch):
    """A hook on the three sub-layer kinds records the published order:
    each mixer followed by its MoE."""
    cfg, params, _ = model
    seen = []

    def hook(kind, fn):
        def wrapped(*a, **k):
            seen.append(kind)
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(ssm_mod, "ssm_forward",
                        hook("mamba", ssm_mod.ssm_forward))
    monkeypatch.setattr(tf, "attn_forward", hook("attention",
                                                 tf.attn_forward))
    monkeypatch.setattr(moe_mod, "shared_forward",
                        hook("moe", moe_mod.shared_forward))
    with torch.no_grad():
        tf.forward(cfg, params, torch.arange(5)[None])
    want = [k for kind in PERIOD for k in (kind, "moe")]
    assert seen == want


@pytest.mark.parametrize("split", [None, 200])
def test_ssd_at_published_state_matches_the_recurrence(split):
    """Mamba-2 at d_state 128, chunk 256, n_groups 1, conv bias: the port's
    chunked SSD (split None), and its chunked prefill from a cache's state
    in two pieces (200 + 100 tokens), against the reference's recurrence
    over 300 tokens (two chunks, the second padded)."""
    cfg = dataclasses.replace(get_smoke_config(ARCH), d_model=16,
                              ssm_state=128, ssm_chunk=256, ssm_head_dim=8)
    p = tf._hybrid_moe_init(cfg, torch.Generator().manual_seed(5))["ssm"][0]
    assert p["conv_b"].abs().sum() > 0
    x = torch.randn((1, 300, 16), generator=torch.Generator().manual_seed(6))
    with torch.no_grad():
        want = ref.mamba(published(cfg), p, x[0], lambda t: t.float())
        if split is None:
            got, _ = ssm_mod.ssm_forward(cfg, p, x)
        else:
            st = ssm_mod.ssm_init_state(cfg, 1, torch.float32, "cpu")
            a, st = ssm_mod.ssm_forward(cfg, p, x[:, :split], state=st)
            b, _ = ssm_mod.ssm_forward(cfg, p, x[:, split:], state=st)
            got = torch.cat([a, b], dim=1)
    torch.testing.assert_close(got[0], want, atol=1e-5, rtol=1e-5)


def test_secure_layer_on_the_batcher(model):
    """A toy secure layer (logN 6, tile 4) on layer 0: the tokens of a
    plain run, each secure row the plaintext x·W within the serve tests'
    tolerance, one program launch a (tenant, layer) group each step."""
    cfg, params, _ = model
    prompts = [np.arange(3, dtype=np.int32), np.arange(5, dtype=np.int32)]

    def serve(secure_cfg=None):
        c = cfg if secure_cfg is None else secure_cfg
        scfg = ServeConfig(max_batch=2, max_len=16, he_tile=4)
        secure = W = None
        if secure_cfg is not None:
            rng = np.random.default_rng(8)
            W = rng.standard_normal((cfg.d_model, 4)) * 0.4
            secure = build_secure_serving(
                c, scfg, {0: W}, rng, he_params=toy_params(
                    logN=6, L=4, k=3, beta=2), device="cpu")
        b = ContinuousBatcher(c, scfg, params, secure=secure)
        rids = [b.submit(p, 2) for p in prompts]
        with torch.no_grad():
            while b.step():
                pass
        return b, rids, secure, W

    plain, prid, _, _ = serve()
    b, rids, secure, W = serve(dataclasses.replace(cfg, secure_layers=(0,)))
    assert [b.results[r] for r in rids] == [plain.results[r] for r in prid]
    embed = params["embed"].double().numpy()
    for r in rids:
        outs = b.secure_results[r]
        assert len(outs) >= 1
        for t, out in zip(b.results[r], outs):
            np.testing.assert_allclose(out[0], embed[t] @ W,
                                       atol=SECURE_TOL)
    assert len(secure.batcher.steps) >= 2
    for s in secure.batcher.steps:
        assert s.program_launches == 1
