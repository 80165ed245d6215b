"""Model assembly for all families (dense / moe / ssm / hybrid / vlm /
audio) — counterpart of ``repro/models/transformer.py``.

Parameters are plain dicts of tensors under the reference pytree's names,
with one difference of layout: the reference stacks every layer leaf on a
leading ``nb`` axis for ``lax.scan``, the port keeps ``params["layers"]``
as a list of ``nb`` block dicts and loops over it in Python
(``convert.model_params`` unstacks a reference pytree).  The serve cache
keeps the reference layout and is written in place: ``kv`` k / v of
(nb, sub, B, S, KV, hd) and ``ssm`` h of (nb, sub, B, H, hd, n) and conv
of (nb, sub, B, K−1, C).

Public entry points:
  init_params(cfg, gen)                          -> params dict
  forward(cfg, params, tokens|embeds, frontend=) -> (logits, aux)
  train_loss(cfg, params, batch)                 -> (total, metrics)
  init_cache(cfg, batch, max_len, device)        -> serve cache dict
  prefill(cfg, params, tokens|embeds, cache, start=0) -> (logits_last, cache)
  decode_step(cfg, params, token, cache, pos)    -> (logits, cache)
  decode_step_embeds(cfg, params, embeds, cache, pos) -> (logits, cache)

With ``cfg.remat`` and grad enabled, ``forward`` recomputes each block in
the backward pass (``torch.utils.checkpoint``), as the reference wraps
its scanned block in ``jax.checkpoint``; the values are the same.

Under a mesh (the current rules of ``distributed/sharding.py``) the
parameters and the cache are a rank's blocks
(``train_step.param_shardings``, ``serve.engine.cache_shardings``):
``init_params`` draws the whole tree from the generator, as on one
device, and keeps the rank's blocks; ``init_cache`` makes the rank's
blocks.  Before a block runs, its leaves split over ``fsdp`` (data) are
gathered (ZeRO-3; inside the remat, so the backward gathers again).
``embed`` is a vocab-parallel lookup (ids outside the rank's rows
masked, then one all-reduce over ``model``); ``_logits`` multiplies by
the rank's vocabulary columns (the tied ``embed`` the same slice) and
gathers the logits over ``model`` (backward: a rank's block), so serving
and the loss see every logit: the loss gathers (B, S, V) float32 logits
rather than computing a vocab-parallel cross-entropy (4 × 512 × 92544 ×
4 B = 758 MB a rank at ``internlm2-1.8b``, the one-device path's own
size).  With the batch split over the batch axes (``sharding.
batch_split``), ``train_loss`` divides by the global token count and the
aux loss by the data ranks, so the sum over data ranks is the one-device
loss.
"""
from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core import trace
from repro_torch.core.ckks import resolve_device
from repro_torch.distributed import collectives as coll
from repro_torch.distributed import sharding as sh
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import (HybridMoEConfig, ModelConfig,
                                       attn_forward, attn_init,
                                       attn_replicated, dense_init,
                                       mlp_forward, mlp_init, rmsnorm)
from repro_torch.tree import leaves, tree_map, unflatten


# ---------------------------------------------------------------------------
# block definitions (one "block" = the reference's scanned unit)
# ---------------------------------------------------------------------------


def _block_structure(cfg: ModelConfig):
    """(num_blocks, sub-layer plan per block). A block:
    dense/moe/audio: 1 attn+ffn layer; ssm: 1 ssd layer;
    hybrid: (attn_period-1) ssd + 1 attn+mlp;
    hybrid_moe: one period of ``layer_pattern``, each layer a mixer (ssd
    or attn) and a routed + shared MoE, run in the pattern's order;
    vlm: 1 cross-attn + (cross_attn_period-1) self-attn layers."""
    f = cfg.family
    if f == "hybrid_moe":
        pattern = cfg.layer_pattern
        if (not pattern or cfg.num_layers % len(pattern)
                or set(pattern) - {"mamba", "attention"}):
            raise ValueError(f"layer_pattern {pattern} for "
                             f"{cfg.num_layers} layers")
        if sh.get_rules().mesh is not None:
            raise NotImplementedError(f"{cfg.name}: family hybrid_moe runs "
                                      "on one device")
        return cfg.num_layers // len(pattern), {
            "attn": pattern.count("attention"),
            "ssm": pattern.count("mamba"), "cross": 0}
    if f in ("dense", "moe", "audio"):
        return cfg.num_layers, {"attn": 1, "ssm": 0, "cross": 0}
    if f == "ssm":
        return cfg.num_layers, {"attn": 0, "ssm": 1, "cross": 0}
    if f == "hybrid":
        period = cfg.attn_period
        if period < 2 or cfg.num_layers % period:
            raise ValueError(f"attn_period {period} for {cfg.num_layers} "
                             f"layers")
        return cfg.num_layers // period, {"attn": 1, "ssm": period - 1,
                                          "cross": 0}
    if f == "vlm":
        period = cfg.cross_attn_period
        if period < 2 or cfg.num_layers % period:
            raise ValueError(f"cross_attn_period {period} for "
                             f"{cfg.num_layers} layers")
        return cfg.num_layers // period, {"attn": period - 1, "ssm": 0,
                                          "cross": 1}
    raise ValueError(f)


def _hybrid_moe_init(cfg: HybridMoEConfig, gen: torch.Generator) -> dict:
    """A period's layers, drawn in the pattern's order: ``ssm`` (the SSD
    layers, each with ``ln`` before the mixer) and ``attn_layers`` (``ln1``
    before it), each layer with ``ln2`` and ``ffn`` (``moe`` and
    ``shared``).  The SSD's conv bias is drawn, and A and dt's bias as
    Mamba-2 draws them: A uniform in [1, 16], dt log-uniform in
    [0.001, 0.1]."""
    d = cfg.d_model

    def ones():
        return torch.ones((d,), dtype=cfg.adtype, device=gen.device)

    def uniform(n, lo, hi):
        return lo + (hi - lo) * torch.rand((n,), generator=gen,
                                           device=gen.device)

    p = {"ssm": [], "attn_layers": []}
    for kind in cfg.layer_pattern:
        if kind == "mamba":
            sp = ssm_mod.ssm_init(cfg, gen)
            H, C = sp["a_log"].shape[0], sp["conv_b"].shape[0]
            sp["conv_b"] = (uniform(C, -1, 1) / cfg.conv_kernel ** 0.5).to(
                cfg.adtype)
            sp["a_log"] = torch.log(uniform(H, 1.0, 16.0))
            dt = torch.exp(uniform(H, math.log(1e-3), math.log(1e-1)))
            sp["dt_bias"] = dt + torch.log(-torch.expm1(-dt))
            layer = dict(sp, ln=ones())
            p["ssm"].append(layer)
        else:
            layer = {"attn": attn_init(cfg, gen), "ln1": ones()}
            p["attn_layers"].append(layer)
        layer.update(ln2=ones(), ffn=moe_mod.shared_init(cfg, gen))
    return p


#: a ``hybrid_moe`` checkpoint's leaves that the port keeps in float32
_HYBRID_FLOAT32 = ("router", "a_log", "dt_bias", "d_skip")
_SSD_LEAVES = ("in_proj", "conv_w", "conv_b", "a_log", "dt_bias", "d_skip",
               "norm_w", "out_proj")


def hybrid_moe_params(cfg: HybridMoEConfig, weights: dict) -> dict:
    """The param tree of a ``hybrid_moe`` model from a checkpoint's layout:
    ``embed``, ``final_norm`` and ``layers``, a dict a layer in the
    published order with its ``kind`` ("mamba" or "attention"),
    ``input_layernorm`` and ``post_attention_layernorm``, the mixer's
    matrices (the SSD's as ``ssm_init`` names them; ``wq``, ``wk``, ``wv``,
    ``wo``), ``router``, ``experts_gate``, ``experts_up`` and
    ``experts_down`` (an expert a row) and ``shared_gate``, ``shared_up``
    and ``shared_down``.  Each leaf takes the dtype the port keeps it in
    (the router and the SSD's A, dt bias and D float32, the rest
    ``cfg.adtype``), without a copy where it has it."""
    pattern = cfg.layer_pattern
    kinds = [lp["kind"] for lp in weights["layers"]]
    if kinds != list(pattern) * (cfg.num_layers // len(pattern)):
        raise ValueError(f"layers {kinds} for {cfg.num_layers} layers of "
                         f"the pattern {pattern}")

    def leaf(lp, k):
        return lp[k].to(torch.float32 if k in _HYBRID_FLOAT32
                        else cfg.adtype)

    blocks = []
    for b in range(0, cfg.num_layers, len(pattern)):
        block = {"ssm": [], "attn_layers": []}
        for lp in weights["layers"][b:b + len(pattern)]:
            if lp["kind"] == "mamba":
                layer = {k: leaf(lp, k) for k in _SSD_LEAVES}
                layer["ln"] = leaf(lp, "input_layernorm")
                block["ssm"].append(layer)
            else:
                layer = {"attn": {k: leaf(lp, k)
                                  for k in ("wq", "wk", "wv", "wo")},
                         "ln1": leaf(lp, "input_layernorm")}
                block["attn_layers"].append(layer)
            layer["ln2"] = leaf(lp, "post_attention_layernorm")
            layer["ffn"] = {
                "moe": {"router": leaf(lp, "router"),
                        "wi_up": leaf(lp, "experts_up"),
                        "wo": leaf(lp, "experts_down"),
                        "wi_gate": leaf(lp, "experts_gate")},
                "shared": {"wi_up": leaf(lp, "shared_up"),
                           "wo": leaf(lp, "shared_down"),
                           "wi_gate": leaf(lp, "shared_gate")}}
        blocks.append(block)
    return {"embed": leaf(weights, "embed"), "layers": blocks,
            "final_norm": leaf(weights, "final_norm")}


def _layer_init(cfg: ModelConfig, gen: torch.Generator) -> dict:
    _, plan = _block_structure(cfg)
    d = cfg.d_model
    if cfg.family == "hybrid_moe":
        return _hybrid_moe_init(cfg, gen)

    def ones():
        return torch.ones((d,), dtype=cfg.adtype, device=gen.device)

    p = {}
    if plan["ssm"]:
        p["ssm"] = [dict(ssm_mod.ssm_init(cfg, gen), ln=ones())
                    for _ in range(plan["ssm"])]
    if plan["cross"]:
        p["cross"] = dict(attn_init(cfg, gen), ln=ones())
        kv_shape = (cfg.frontend_dim or d, cfg.kv_heads * cfg.hdim)
        p["kx"] = dense_init(gen, kv_shape, cfg.adtype)
        p["vx"] = dense_init(gen, kv_shape, cfg.adtype)
    if plan["attn"]:
        ffn_init = moe_mod.moe_init if cfg.family == "moe" else mlp_init
        p["attn_layers"] = [{"attn": attn_init(cfg, gen), "ln1": ones(),
                             "ln2": ones(), "ffn": ffn_init(cfg, gen)}
                            for _ in range(plan["attn"])]
    return p


def _attn_sublayer(cfg, p, x, positions, kv_cache=None, cache_len=None):
    """Returns (x, aux): aux is the MoE's load-balance loss, else 0.0."""
    with trace.span("lm.attn"):
        h, _ = attn_forward(cfg, p["attn"],
                            rmsnorm(x, p["ln1"], cfg.norm_eps), positions,
                            kv_cache=kv_cache, cache_len=cache_len)
    x = x + h
    hn = rmsnorm(x, p["ln2"], cfg.norm_eps)
    if cfg.family == "moe":
        with trace.span("lm.moe"):
            y, aux = moe_mod.moe_forward(cfg, p["ffn"], hn)
    else:
        y, aux = mlp_forward(cfg, p["ffn"], hn), 0.0
    return x + y, aux


def _sub(tree: dict, i: int) -> dict:
    """Sub-layer ``i`` of a block's cache group: views, written in place."""
    return {n: c[i] for n, c in tree.items()}


def _block_forward(cfg: ModelConfig, p: dict, x, positions, *, frontend=None,
                   cache=None, cache_len=None):
    """One block.  ``cache``: {"kv": {"k", "v"}, "ssm": {"h", "conv"}} (the
    groups the block has) with a leading sub-layer axis, written in
    place.  Cross-attention runs only when ``frontend`` is given.
    Returns (x, aux)."""
    if cfg.family == "hybrid_moe":
        return _hybrid_moe_block(cfg, p, x, positions, cache, cache_len)
    aux = 0.0
    for i, sp in enumerate(p.get("ssm", ())):
        st = None if cache is None else _sub(cache["ssm"], i)
        x = x + _ssm_mixer(cfg, sp, x, st)
    if "cross" in p and frontend is not None:
        B = x.shape[0]
        fe = frontend.to(p["kx"].dtype)
        R = sh.ranks()
        if R is not None and R.M > 1 and not attn_replicated(cfg, R.M):
            kx, vx = _cross_kv(cfg, p, fe, R)
        else:
            kx = (fe @ p["kx"]).reshape(B, -1, cfg.kv_heads, cfg.hdim)
            vx = (fe @ p["vx"]).reshape(B, -1, cfg.kv_heads, cfg.hdim)
        h, _ = attn_forward(cfg, p["cross"],
                            rmsnorm(x, p["cross"]["ln"], cfg.norm_eps),
                            positions, kv_override=(kx, vx))
        x = x + h
    for i, ap in enumerate(p.get("attn_layers", ())):
        kv = None if cache is None else _sub(cache["kv"], i)
        x, a = _attn_sublayer(cfg, ap, x, positions, kv_cache=kv,
                              cache_len=cache_len)
        aux = aux + a
    return x, aux


def _ssm_mixer(cfg: ModelConfig, sp: dict, x, st):
    """An SSD layer's output from ``rms(x)``; ``st`` (its cache views, or
    None) is written in place."""
    with trace.span("lm.ssm"):
        h, new = ssm_mod.ssm_forward(cfg, sp, rmsnorm(x, sp["ln"],
                                                      cfg.norm_eps), state=st)
        if st is not None:
            for n, c in st.items():
                c.copy_(new[n])
    return h


def _hybrid_moe_block(cfg: HybridMoEConfig, p: dict, x, positions, cache,
                      cache_len):
    """One period of a ``hybrid_moe`` model, its layers in the pattern's
    order: x ← x + r·mixer(rms(x)), then x ← x + r·(moe(rms(x)) +
    shared(rms(x)))."""
    r, eps = cfg.residual_multiplier, cfg.norm_eps
    aux, n_ssm, n_attn = 0.0, 0, 0
    for kind in cfg.layer_pattern:
        if kind == "mamba":
            lp = p["ssm"][n_ssm]
            st = None if cache is None else _sub(cache["ssm"], n_ssm)
            n_ssm += 1
            h = _ssm_mixer(cfg, lp, x, st)
        else:
            lp = p["attn_layers"][n_attn]
            kv = None if cache is None else _sub(cache["kv"], n_attn)
            n_attn += 1
            with trace.span("lm.attn"):
                h, _ = attn_forward(cfg, lp["attn"],
                                    rmsnorm(x, lp["ln1"], eps), positions,
                                    kv_cache=kv, cache_len=cache_len)
        x = x + h * r
        with trace.span("lm.moe"):
            y, a = moe_mod.shared_forward(cfg, lp["ffn"],
                                          rmsnorm(x, lp["ln2"], eps))
        x = x + y * r
        aux = aux + a
    return x, aux


def _cross_kv(cfg: ModelConfig, p: dict, fe, R):
    """The vlm's cross-attention K/V from the frontend on a mesh: the KV
    heads this rank's Q heads read (``kx`` / ``vx`` are over
    ``kv_heads``)."""
    from repro_torch.models.common import kv_heads_of_rank, project_kv
    kv = kv_heads_of_rank(cfg, R)
    out = []
    for w in (p["kx"], p["vx"]):
        t, t_all = project_kv(cfg, R, fe, w, None, kv)
        out.append(t if t_all is None else
                   coll.copy_to(t_all, R.model_group)[:, :, kv[0]:kv[1]])
    return out


def _block_call(cfg: ModelConfig, lp: dict, pl, x, positions, **kw):
    """``_block_forward`` after the block's ``fsdp`` leaves are gathered
    (``pl``: the block's placements, None without a mesh)."""
    return _block_forward(cfg, sh.gather_params(lp, pl), x, positions, **kw)


def _placements(cfg: ModelConfig):
    """The parameters' placements under the current rules (None without
    a mesh), cached per (config, rules)."""
    rules = sh.get_rules()
    if rules.mesh is None:
        return None
    key = (cfg, id(rules))
    if key not in _PLACEMENTS:
        from repro_torch.train.train_step import param_shardings
        _PLACEMENTS.clear()
        _PLACEMENTS[key] = (rules, param_shardings(cfg, abstract_params(cfg),
                                                   rules))
    return _PLACEMENTS[key][1]


_PLACEMENTS: dict = {}


def _top(params: dict, pl, name: str):
    """A top-level leaf gathered over ``fsdp``."""
    return sh.gather_params(params[name], None if pl is None else pl[name])


def _block_pl(pl):
    return None if pl is None else pl["layers"][0]


# ---------------------------------------------------------------------------
# parameter init
# ---------------------------------------------------------------------------


def abstract_params(cfg: ModelConfig) -> dict:
    """The whole parameter tree's shapes and dtypes as ``meta`` tensors
    (nothing allocated)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        p = _init_whole(cfg, torch.Generator())
    return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                          device="meta"), p)


def init_params(cfg: ModelConfig, gen: torch.Generator) -> dict:
    """Random weights drawn from ``gen`` on its device: the embedding,
    then the ``nb`` blocks in order, then the head.  Under a mesh the
    whole tree is drawn, as on one device, and a rank keeps its blocks
    (``param_shardings``)."""
    p = _init_whole(cfg, gen)
    pl = _placements(cfg)
    if pl is None:
        return p
    return unflatten(p, [q.local(t) for t, q in zip(leaves(p), leaves(pl),
                                                      strict=True)])


def _init_whole(cfg: ModelConfig, gen: torch.Generator) -> dict:
    nb, _ = _block_structure(cfg)
    p = {"embed": dense_init(gen, (cfg.vocab_size, cfg.d_model), cfg.adtype),
         "layers": [_layer_init(cfg, gen) for _ in range(nb)],
         "final_norm": torch.ones((cfg.d_model,), dtype=cfg.adtype,
                                  device=gen.device)}
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init(gen, (cfg.d_model, cfg.vocab_size),
                                  cfg.adtype)
    return p


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _embed(cfg, params, tokens=None, embeds=None):
    """Token ids through the table, or precomputed (frame) embeddings cast
    to the activation dtype."""
    if embeds is not None:
        return embeds.to(cfg.adtype)
    R = sh.ranks()
    if R is None:
        x = params["embed"][tokens]
        m = cfg.embedding_multiplier
        return x if m == 1 else x * m
    embed = _top(params, _placements(cfg), "embed")
    if not R.split(cfg.vocab_size):
        x = embed[tokens]
    else:               # vocab-parallel: this rank's rows, then a sum
        lo = R.m * embed.shape[0]
        ids = tokens - lo
        mine = (ids >= 0) & (ids < embed.shape[0])
        x = embed[torch.where(mine, ids, torch.zeros_like(ids))]
        x = coll.reduce_from(x * mine[..., None].to(x.dtype), R.model_group)
    return sh.shard(x, "batch", "seq", None, full=(None, x.shape[1],
                                                    cfg.d_model))


def embed_rows(cfg: ModelConfig, params: dict, ids: torch.Tensor):
    """Whole embedding rows of token ``ids`` (any shape) on every rank."""
    return _embed(cfg, params, ids.reshape(1, -1)).reshape(
        *ids.shape, cfg.d_model)


def _logits(cfg, params, x):
    R = sh.ranks()
    if R is None:
        x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
        head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
        c = cfg.logits_scaling
        return (x @ head).float() if c == 1 else (x @ head).float() / c
    pl = _placements(cfg)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    head = (_top(params, pl, "embed").T if cfg.tie_embeddings
            else _top(params, pl, "lm_head"))
    if not R.split(cfg.vocab_size):
        logits = (x @ head).float()
    else:
        from repro_torch.models.common import col_in, col_mm
        logits = col_mm(col_in(x, R.model_group), head, x.dtype).float()
    logits = sh.shard(logits, "batch", "seq", "vocab",
                      full=(None, x.shape[1], cfg.vocab_size))
    return coll.gather_from(logits, R.model_group, R.M, R.m, 2) \
        if R.split(cfg.vocab_size) else logits


def forward(cfg: ModelConfig, params: dict, tokens=None, *, embeds=None,
            frontend=None):
    """tokens (B, S) or embeds (B, S, d), and for the vlm an optional
    ``frontend`` (B, T, frontend_dim): logits of every position (B, S, V)
    in float32, and the aux loss summed over blocks (0.0 without a
    router).  Each block is recomputed in the backward pass when
    ``cfg.remat`` and grad are on."""
    x = _embed(cfg, params, tokens, embeds)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    remat = cfg.remat and torch.is_grad_enabled()
    bpl = _block_pl(_placements(cfg))
    aux = 0.0
    for lp in params["layers"]:
        if remat:
            x, a = checkpoint(_block_call, cfg, lp, bpl, x, positions,
                              frontend=frontend, use_reentrant=False)
        else:
            x, a = _block_call(cfg, lp, bpl, x, positions, frontend=frontend)
        aux = aux + a
    return _logits(cfg, params, x), aux


def train_loss(cfg: ModelConfig, params, batch):
    """batch: dict(tokens (B, S) | embeds (B, S, d), targets (B, S)[,
    mask (B, S)][, frontend]).  The mean next-token NLL over the
    (masked) positions from the float32 logits, plus 0.01 × the aux
    loss: (total, {"loss", "aux_loss", "ppl_proxy"})."""
    logits, aux = forward(cfg, params, batch.get("tokens"),
                          embeds=batch.get("embeds"),
                          frontend=batch.get("frontend"))
    tgt = batch["targets"].long()
    mask = batch.get("mask")
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, tgt[..., None])[..., 0]
    R = sh.ranks()
    if R is not None and R.D > 1 and sh.is_batch_split():
        return _split_loss(nll, tgt, mask, aux, R)
    if mask is not None:
        nll = nll * mask
        denom = torch.clamp_min(mask.sum(), 1.0)
    else:
        denom = float(tgt.numel())
    loss = nll.sum() / denom
    aux = torch.as_tensor(aux, dtype=torch.float32, device=loss.device)
    total = loss + 0.01 * aux
    return total, {"loss": loss, "aux_loss": aux,
                   "ppl_proxy": torch.exp(torch.clamp_max(loss, 20.0))}


def _split_loss(nll, tgt, mask, aux, R):
    """``train_loss`` on a rank's rows of the batch: the masked NLL sum
    over the global count, plus 0.01 × aux / D (every data rank holds the
    global batch's aux), so the ranks' totals sum to the one-device total
    (the gradients are summed over the batch axes).  The metrics are the
    global ones."""
    g = R.batch_group
    if mask is not None:
        nll = nll * mask
        denom = torch.clamp_min(
            coll.all_reduce_sum(mask.sum().float().reshape(1), g)[0], 1.0)
    else:
        denom = float(tgt.numel() * R.D)
    local = nll.sum() / denom
    aux = torch.as_tensor(aux, dtype=torch.float32, device=local.device)
    total = local + 0.01 * aux / R.D
    loss = coll.all_reduce_sum(local.detach().reshape(1), g)[0]
    return total, {"loss": loss, "aux_loss": aux.detach(),
                   "ppl_proxy": torch.exp(torch.clamp_max(loss, 20.0))}


# ---------------------------------------------------------------------------
# serving: prefill + decode with caches
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device=None) -> dict:
    """Zeroed serve cache in the reference's layout (module docstring):
    ``kv`` when the blocks hold attention, ``ssm`` when they hold SSD
    layers; CUDA unless ``device`` says otherwise."""
    nb, plan = _block_structure(cfg)
    dev = resolve_device(device)
    if sh.get_rules().mesh is not None:
        return _init_cache_mesh(cfg, batch, max_len, dev)
    c = {}
    if plan["attn"]:
        shape = (nb, plan["attn"], batch, max_len, cfg.kv_heads, cfg.hdim)
        c["kv"] = {n: torch.zeros(shape, dtype=cfg.adtype, device=dev)
                   for n in ("k", "v")}
    if plan["ssm"]:
        st = ssm_mod.ssm_init_state(cfg, batch, cfg.adtype, dev)
        c["ssm"] = {n: t.expand((nb, plan["ssm"]) + t.shape).contiguous()
                    for n, t in st.items()}
    return c


def cache_placements(cfg: ModelConfig, batch: int, max_len: int):
    """The serve cache's placements under the current rules (None without
    a mesh): ``serve.engine.cache_shardings`` of its whole shapes."""
    rules = sh.get_rules()
    if rules.mesh is None:
        return None
    from repro_torch.serve.engine import cache_shardings
    return cache_shardings(rules, _cache_shapes(cfg, batch, max_len),
                           cfg=cfg)


def _cache_shapes(cfg: ModelConfig, batch: int, max_len: int) -> dict:
    nb, plan = _block_structure(cfg)
    c = {}
    if plan["attn"]:
        shape = (nb, plan["attn"], batch, max_len, cfg.kv_heads, cfg.hdim)
        c["kv"] = {n: torch.empty(shape, dtype=cfg.adtype, device="meta")
                   for n in ("k", "v")}
    if plan["ssm"]:
        st = ssm_mod.ssm_init_state(cfg, batch, cfg.adtype, "meta")
        c["ssm"] = {n: torch.empty((nb, plan["ssm"]) + t.shape,
                                   dtype=t.dtype, device="meta")
                    for n, t in st.items()}
    return c


def _init_cache_mesh(cfg: ModelConfig, batch: int, max_len: int, dev):
    """A rank's blocks of the zeroed serve cache.  A cache whose KV heads
    do not split over ``model`` holds a block of the sequence: ⌈max_len /
    model⌉ positions, the last rank's tail past ``max_len`` never written
    and masked by the attention's key positions."""
    shapes = _cache_shapes(cfg, batch, max_len)
    pl = cache_placements(cfg, batch, max_len)
    cache = {g: {n: torch.zeros(pl[g][n].local_shape(t.shape), dtype=t.dtype,
                                device=dev) for n, t in tree.items()}
             for g, tree in shapes.items()}
    for n, c in cache.get("kv", {}).items():     # the reference's constraint
        sh.shard(c, "layers", None, "batch", None, "kv_heads", None,
                 full=(None, None, batch, None, cfg.kv_heads, None))
    return cache


def _serve_scan(cfg, params, x, positions, cache, cache_len, frontend=None):
    """The reference's ``lax.scan`` over blocks as a Python loop; block b
    reads and writes ``cache[...][b]`` in place."""
    bpl = _block_pl(_placements(cfg))
    for b, lp in enumerate(params["layers"]):
        lc = {g: {n: c[b] for n, c in tree.items()}
              for g, tree in cache.items()}
        x, _ = _block_call(cfg, lp, bpl, x, positions, cache=lc,
                           cache_len=cache_len, frontend=frontend)
    return x, cache


def prefill(cfg: ModelConfig, params: dict, tokens, cache: dict, *,
            embeds=None, frontend=None, start: int = 0):
    """tokens (B, S) or embeds (B, S, d): fill cache rows [start, start +
    S) (a prompt in chunks: each from where the last ended) and run the
    SSD recurrence from the cache's state; logits of the last position
    (B, 1, V) and the cache."""
    x = _embed(cfg, params, tokens, embeds)
    positions = torch.arange(start, start + x.shape[1],
                             device=x.device)[None, :]
    x, cache = _serve_scan(cfg, params, x, positions, cache, start,
                           frontend=frontend)
    return _logits(cfg, params, x[:, -1:]), cache


def _decode_positions(pos, device) -> torch.Tensor:
    """Scalar pos (uniform batch) -> (1, 1); (B,) vector (continuous
    batching, per-slot lengths) -> (B, 1) so RoPE and the KV write use each
    slot's own position."""
    pos = torch.as_tensor(pos, device=device)
    return pos.reshape(-1, 1) if pos.ndim else pos.reshape(1, 1)


def _decode(cfg, params, x, cache, pos, frontend=None):
    if not isinstance(pos, int):
        pos = torch.as_tensor(pos, device=x.device)
    positions = _decode_positions(pos, x.device)
    x, cache = _serve_scan(cfg, params, x, positions, cache, pos,
                           frontend=frontend)
    return _logits(cfg, params, x), cache


def decode_step(cfg: ModelConfig, params: dict, token, cache: dict, pos, *,
                frontend=None):
    """token: (B, 1) integer; pos: an int (the current length), or a (B,)
    array of per-slot lengths."""
    return _decode(cfg, params, _embed(cfg, params, token), cache, pos,
                   frontend)


def decode_step_embeds(cfg: ModelConfig, params: dict, embeds, cache: dict,
                       pos):
    """[audio] decode: one precomputed frame embedding (B, 1, d)."""
    return _decode(cfg, params, _embed(cfg, params, None, embeds), cache,
                   pos)
