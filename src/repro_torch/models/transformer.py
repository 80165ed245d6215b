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
  prefill(cfg, params, tokens|embeds, cache)     -> (logits_last, cache)
  decode_step(cfg, params, token, cache, pos)    -> (logits, cache)
  decode_step_embeds(cfg, params, embeds, cache, pos) -> (logits, cache)

With ``cfg.remat`` and grad enabled, ``forward`` recomputes each block in
the backward pass (``torch.utils.checkpoint``), as the reference wraps
its scanned block in ``jax.checkpoint``; the values are the same.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.ckks import resolve_device
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import (ModelConfig, attn_forward, attn_init,
                                       dense_init, mlp_forward, mlp_init,
                                       rmsnorm)


# ---------------------------------------------------------------------------
# block definitions (one "block" = the reference's scanned unit)
# ---------------------------------------------------------------------------


def _block_structure(cfg: ModelConfig):
    """(num_blocks, sub-layer plan per block). A block:
    dense/moe/audio: 1 attn+ffn layer; ssm: 1 ssd layer;
    hybrid: (attn_period-1) ssd + 1 attn+mlp;
    vlm: 1 cross-attn + (cross_attn_period-1) self-attn layers."""
    f = cfg.family
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


def _layer_init(cfg: ModelConfig, gen: torch.Generator) -> dict:
    _, plan = _block_structure(cfg)
    d = cfg.d_model

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
    h, _ = attn_forward(cfg, p["attn"], rmsnorm(x, p["ln1"], cfg.norm_eps),
                        positions, kv_cache=kv_cache, cache_len=cache_len)
    x = x + h
    hn = rmsnorm(x, p["ln2"], cfg.norm_eps)
    if cfg.family == "moe":
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
    aux = 0.0
    for i, sp in enumerate(p.get("ssm", ())):
        st = None if cache is None else _sub(cache["ssm"], i)
        h, new = ssm_mod.ssm_forward(cfg, sp, rmsnorm(x, sp["ln"],
                                                      cfg.norm_eps), state=st)
        x = x + h
        if st is not None:
            for n, c in st.items():
                c.copy_(new[n])
    if "cross" in p and frontend is not None:
        B = x.shape[0]
        fe = frontend.to(p["kx"].dtype)
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


# ---------------------------------------------------------------------------
# parameter init
# ---------------------------------------------------------------------------


def init_params(cfg: ModelConfig, gen: torch.Generator) -> dict:
    """Random weights drawn from ``gen`` on its device: the embedding,
    then the ``nb`` blocks in order, then the head."""
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
    return params["embed"][tokens]


def _logits(cfg, params, x):
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return (x @ head).float()


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
    aux = 0.0
    for lp in params["layers"]:
        if remat:
            x, a = checkpoint(_block_forward, cfg, lp, x, positions,
                              frontend=frontend, use_reentrant=False)
        else:
            x, a = _block_forward(cfg, lp, x, positions, frontend=frontend)
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


def _serve_scan(cfg, params, x, positions, cache, cache_len, frontend=None):
    """The reference's ``lax.scan`` over blocks as a Python loop; block b
    reads and writes ``cache[...][b]`` in place."""
    for b, lp in enumerate(params["layers"]):
        lc = {g: {n: c[b] for n, c in tree.items()}
              for g, tree in cache.items()}
        x, _ = _block_forward(cfg, lp, x, positions, cache=lc,
                              cache_len=cache_len, frontend=frontend)
    return x, cache


def prefill(cfg: ModelConfig, params: dict, tokens, cache: dict, *,
            embeds=None, frontend=None):
    """tokens (B, S) or embeds (B, S, d): fill cache rows [0, S) and run
    the SSD recurrence from the cache's state; logits of the last
    position (B, 1, V) and the cache."""
    x = _embed(cfg, params, tokens, embeds)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    x, cache = _serve_scan(cfg, params, x, positions, cache, 0,
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
